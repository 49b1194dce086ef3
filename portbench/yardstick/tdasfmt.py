"""The tdas file format, frozen for the benchmark: a writer for the
generated pool and a reader for the outputs the program writes.

A tdas file is a 64-byte little-endian header followed by a row-major
(time, channel) payload of float32, or of int16 with a dequantization
scale in the header.  Header fields, in order: magic ``b"TDAS"``,
version (1), t0 and the sample step in integer nanoseconds, rows,
channels, the dtype code (0 float32, 1 int16), the scale (float32),
the first distance and the distance step (float64), and a reserved
word.  Plain NumPy, so the yardstick reads and writes the files
without the program.
"""

from __future__ import annotations

import os
import struct

import numpy as np

HEADER = struct.Struct("<4sIQQIIIfddQ")
HEADER_SIZE = 64
MAGIC = b"TDAS"
DTYPES = {0: np.dtype(np.float32), 1: np.dtype(np.int16)}
CODES = {np.dtype(np.float32): 0, np.dtype(np.int16): 1}


def pack_header(t0_ns, dt_ns, n_time, n_ch, code, scale, d0, dx) -> bytes:
    return HEADER.pack(MAGIC, 1, int(t0_ns), int(dt_ns), int(n_time),
                       int(n_ch), int(code), float(scale), float(d0),
                       float(dx), 0)


def read_header(path) -> dict:
    with open(path, "rb") as fh:
        raw = fh.read(HEADER_SIZE)
    if len(raw) != HEADER_SIZE:
        raise ValueError(f"{path}: truncated tdas header")
    magic, version, t0_ns, dt_ns, n_time, n_ch, code, scale, d0, dx, _ = (
        HEADER.unpack(raw))
    if magic != MAGIC or version != 1 or code not in DTYPES:
        raise ValueError(f"{path}: not a version-1 tdas file")
    return {"t0_ns": t0_ns, "dt_ns": dt_ns, "n_time": n_time,
            "n_ch": n_ch, "code": code, "scale": scale, "d0": d0, "dx": dx}


def write(path, payload, t0_ns, dt_ns, scale=1.0, d0=0.0, dx=1.0,
          fsync=False) -> str:
    """Write a (time, channel) int16 or float32 ``payload``."""
    payload = np.ascontiguousarray(payload)
    code = CODES[payload.dtype]
    if code == 0:
        scale = 1.0
    with open(path, "wb") as fh:
        fh.write(pack_header(t0_ns, dt_ns, payload.shape[0],
                             payload.shape[1], code, scale, d0, dx))
        payload.tofile(fh)
        if fsync:
            fh.flush()
            os.fsync(fh.fileno())
    return str(path)


def read(path, decode=True):
    """(header, payload): the payload as stored (``decode=False``) or
    as float64 values (int16 times its scale)."""
    hdr = read_header(path)
    dt = DTYPES[hdr["code"]]
    expected = HEADER_SIZE + hdr["n_time"] * hdr["n_ch"] * dt.itemsize
    if os.path.getsize(path) != expected:
        raise ValueError(f"{path}: payload size does not match its header")
    raw = np.fromfile(path, dtype=dt, offset=HEADER_SIZE).reshape(
        hdr["n_time"], hdr["n_ch"])
    if not decode:
        return hdr, raw
    data = raw.astype(np.float64)
    if hdr["code"] == 1:
        data *= float(np.float32(hdr["scale"]))
    return hdr, data


def times_ns(hdr) -> np.ndarray:
    """The file's sample times, integer nanoseconds."""
    return hdr["t0_ns"] + hdr["dt_ns"] * np.arange(hdr["n_time"],
                                                   dtype=np.int64)
