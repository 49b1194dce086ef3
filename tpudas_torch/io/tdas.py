"""``tdas``: flat binary stream format for the real-time ingest path.

The port's copy of :mod:`tpudas.io.tdas`.  A tdas file is a 64-byte
header + a row-major (time, channel) payload (float32, or int16 with a
scale for 2x ingest bandwidth).  Range reads are exact byte offsets —
no chunk B-trees — executed by the threaded C++ runtime
(:mod:`tpudas_torch.native`, built at first use; a build failure
raises).  The numpy functions of the same semantics run only when the
caller asks for them with ``TPUDAS_NO_NATIVE=1``.

The format registers in the IO registry, so spools index and read
``*.tdas`` interrogator directories exactly like dasdae ones.  The
window planner (:func:`plan_window_from_records`) assembles one
contiguous window straight from index records; for a uniform int16
spool it keeps the RAW payload and its scale, so the engine ships
half the bytes to the card and the first FIR stage reads int16.  The
assemblers take an optional destination array, so the engine's
prefetch thread fills a page-locked buffer with no extra copy.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from tpudas_torch.core.patch import Patch
from tpudas_torch.core.timeutils import to_datetime64
from tpudas_torch.native import load_streamio, native_enabled

FORMAT_NAME = "tdas"
_MAGIC = b"TDAS"
_HEADER = struct.Struct("<4sIQQIIIfddQ")  # 64 bytes
_HEADER_SIZE = 64
_DTYPES = {0: np.float32, 1: np.int16}


def _default_threads() -> int:
    n = os.cpu_count() or 1
    return max(1, min(8, n - 1))


def _pack_header(t0_ns, dt_ns, n_time, n_ch, dtype_code, scale, d0, dx):
    return _HEADER.pack(
        _MAGIC, 1, t0_ns, dt_ns, n_time, n_ch, dtype_code, scale, d0, dx, 0
    )


def _unpack_header(raw: bytes) -> dict:
    magic, version, t0_ns, dt_ns, n_time, n_ch, dtype_code, scale, d0, dx, _ = (
        _HEADER.unpack(raw)
    )
    if magic != _MAGIC:
        raise ValueError("not a tdas file (bad magic)")
    if version != 1:
        raise ValueError(f"unsupported tdas version {version}")
    if dtype_code not in _DTYPES:
        raise ValueError(f"unsupported tdas dtype code {dtype_code}")
    return dict(
        t0_ns=t0_ns,
        dt_ns=dt_ns,
        n_time=n_time,
        n_ch=n_ch,
        dtype_code=dtype_code,
        scale=scale,
        d0=d0,
        dx=dx,
    )


def read_tdas_header(path) -> dict:
    with open(path, "rb") as fh:
        raw = fh.read(_HEADER_SIZE)
    if len(raw) != _HEADER_SIZE:
        raise ValueError("truncated tdas header")
    return _unpack_header(raw)


# ---------------------------------------------------------------------------
# write


def write_tdas(patch, path, dtype="float32", scale=None, **_):
    """Write a 2-D (time, distance) Patch. ``dtype="int16"`` quantizes
    by ``scale`` (default: max|x|/32000, stored in the header)."""
    taxis = np.asarray(patch.coords["time"]).astype("datetime64[ns]")
    step = patch.attrs.get("time_step")
    if taxis.size == 1 and step is not None:
        # one sample has no spacing of its own (a stream emits single
        # output samples): the patch's time step gives the header's
        steps = np.array([np.timedelta64(step, "ns").astype(np.int64)])
    elif taxis.size < 2:
        raise ValueError(
            "tdas requires >= 2 time samples, or one with a time step"
        )
    else:
        steps = np.diff(taxis.astype(np.int64))
    if not np.all(steps == steps[0]):
        raise ValueError("tdas requires a uniform time axis")
    dist = np.asarray(patch.coords["distance"], np.float64)
    dx = float(dist[1] - dist[0]) if dist.size > 1 else 0.0
    if dist.size > 2 and not np.allclose(np.diff(dist), dx):
        raise ValueError("tdas requires a uniform distance axis")

    data = np.asarray(patch.host_data())
    ax = patch.axis_of("time")
    if ax != 0:
        data = np.moveaxis(data, ax, 0)
    data = np.ascontiguousarray(data, np.float32)

    if dtype == "int16":
        code = 1
        if scale is None:
            peak = float(np.abs(data).max()) or 1.0
            scale = peak / 32000.0
        payload = np.clip(
            np.round(data / scale), -32768, 32767
        ).astype(np.int16)
    elif dtype == "float32":
        code = 0
        scale = 1.0
        payload = data
    else:
        raise ValueError(f"tdas dtype must be float32|int16, got {dtype!r}")

    t0_ns = int(taxis[0].astype(np.int64))
    d0 = float(dist[0]) if dist.size else 0.0
    if native_enabled():
        rc = load_streamio().tdas_write(
            os.fsencode(path), t0_ns, int(steps[0]), data.shape[0],
            data.shape[1], code, float(scale), d0, dx,
            payload.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise OSError(rc, f"tdas_write failed for {path}")
        return path
    with open(path, "wb") as fh:
        fh.write(
            _pack_header(
                t0_ns, int(steps[0]), data.shape[0], data.shape[1], code,
                float(scale), d0, dx,
            )
        )
        fh.write(payload.tobytes())
    return path


# ---------------------------------------------------------------------------
# read / scan


def _row_range(hdr, time):
    """[lo, hi) row range selected by a (t_lo, t_hi) datetime window —
    inclusive bounds, matching Patch.select semantics."""
    n = hdr["n_time"]
    lo, hi = 0, n
    if time is not None:
        t_lo, t_hi = time
        if t_lo is not None:
            t = to_datetime64(t_lo).astype("datetime64[ns]").astype(np.int64)
            lo = max(
                0, int(np.ceil((t - hdr["t0_ns"]) / hdr["dt_ns"]))
            )
        if t_hi is not None:
            t = to_datetime64(t_hi).astype("datetime64[ns]").astype(np.int64)
            hi = min(
                n, int(np.floor((t - hdr["t0_ns"]) / hdr["dt_ns"])) + 1
            )
    return lo, max(lo, hi)


def _ch_range(hdr, distance):
    n = hdr["n_ch"]
    lo, hi = 0, n
    if distance is not None and hdr["dx"] != 0:
        d_lo, d_hi = distance
        if d_lo is not None:
            lo = max(0, int(np.ceil((float(d_lo) - hdr["d0"]) / hdr["dx"])))
        if d_hi is not None:
            hi = min(
                n, int(np.floor((float(d_hi) - hdr["d0"]) / hdr["dx"])) + 1
            )
    return lo, max(lo, hi)


def _read_rows_raw_numpy(path, hdr, t_lo, t_hi, c_lo, c_hi):
    """Raw payload rows (no numeric conversion), channel-sliced."""
    dt = _DTYPES[hdr["dtype_code"]]
    es = dt().itemsize
    n_ch = hdr["n_ch"]
    rows = t_hi - t_lo
    with open(path, "rb") as fh:
        fh.seek(_HEADER_SIZE + t_lo * n_ch * es)
        raw = np.fromfile(fh, dtype=dt, count=rows * n_ch)
    return raw.reshape(rows, n_ch)[:, c_lo:c_hi]


def _read_block_numpy(path, hdr, t_lo, t_hi, c_lo, c_hi):
    raw = _read_rows_raw_numpy(path, hdr, t_lo, t_hi, c_lo, c_hi)
    if hdr["dtype_code"] == 1:
        return raw.astype(np.float32) * np.float32(hdr["scale"])
    return np.ascontiguousarray(raw, np.float32)


def read_tdas_block(path, t_lo, t_hi, c_lo, c_hi, n_threads=None):
    """(t_hi-t_lo, c_hi-c_lo) decoded float32 block, read by the native
    threaded reader (numpy under ``TPUDAS_NO_NATIVE=1``)."""
    hdr = read_tdas_header(path)
    if not (0 <= t_lo <= t_hi <= hdr["n_time"]):
        raise ValueError(f"row range [{t_lo}, {t_hi}) out of bounds")
    if not (0 <= c_lo <= c_hi <= hdr["n_ch"]):
        raise ValueError(f"channel range [{c_lo}, {c_hi}) out of bounds")
    if not native_enabled():
        return _read_block_numpy(path, hdr, t_lo, t_hi, c_lo, c_hi)
    out = np.empty((t_hi - t_lo, c_hi - c_lo), np.float32)
    rc = load_streamio().tdas_read_block(
        os.fsencode(path), int(t_lo), int(t_hi), int(c_lo), int(c_hi),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads or _default_threads()),
    )
    if rc != 0:
        raise OSError(rc, f"tdas_read_block failed for {path}")
    return out


def _patch_from_block(hdr, block, t_lo, c_lo):
    t0 = np.datetime64(hdr["t0_ns"] + t_lo * hdr["dt_ns"], "ns")
    taxis = t0 + np.arange(block.shape[0]) * np.timedelta64(
        hdr["dt_ns"], "ns"
    )
    dist = hdr["d0"] + (c_lo + np.arange(block.shape[1])) * hdr["dx"]
    return Patch(
        data=block,
        coords={"time": taxis, "distance": dist},
        dims=("time", "distance"),
        # the header's step: a one-sample patch has no spacing to
        # derive it from, and merging needs it
        attrs={"time_step": np.timedelta64(hdr["dt_ns"], "ns")},
    )


def read_tdas(path, time=None, distance=None, **_):
    """Read (a range of) a tdas file -> [Patch]."""
    hdr = read_tdas_header(path)
    t_lo, t_hi = _row_range(hdr, time)
    c_lo, c_hi = _ch_range(hdr, distance)
    if t_hi - t_lo == 0 or c_hi - c_lo == 0:
        return []
    block = read_tdas_block(path, t_lo, t_hi, c_lo, c_hi)
    return [_patch_from_block(hdr, block, t_lo, c_lo)]


def scan_tdas(path):
    """Metadata record for the directory index (no payload IO).

    Verifies the payload length against the header before trusting the
    record: a file the interrogator is still writing (or a torn copy)
    has ``size != 64 + n_time*n_ch*es`` and raises here — the index
    skips it and re-scans once its (mtime, size) settles.  The record
    carries the exact header ``dx``, dtype code and scale for the
    window planner.
    """
    hdr = read_tdas_header(path)
    es = _DTYPES[hdr["dtype_code"]]().itemsize
    expected = _HEADER_SIZE + hdr["n_time"] * hdr["n_ch"] * es
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            f"tdas payload size mismatch for {path}: header promises "
            f"{expected} bytes, file has {actual} (still being written?)"
        )
    t0 = np.datetime64(hdr["t0_ns"], "ns")
    dt = np.timedelta64(hdr["dt_ns"], "ns")
    return [
        {
            "path": str(path),
            "format": FORMAT_NAME,
            "dims": "time,distance",
            "time_min": t0,
            "time_max": t0 + (hdr["n_time"] - 1) * dt,
            "time_step": dt,
            "distance_min": float(hdr["d0"]),
            "distance_max": float(
                hdr["d0"] + (hdr["n_ch"] - 1) * hdr["dx"]
            ),
            "ntime": int(hdr["n_time"]),
            "ndistance": int(hdr["n_ch"]),
            "dx": float(hdr["dx"]),
            "dtype_code": int(hdr["dtype_code"]),
            "scale": float(hdr["scale"]),
        }
    ]


def plan_window_from_records(records, t_lo, t_hi, distance=None):
    """Plan a contiguous window assembly straight from index records.

    ``records``: iterable of directory-index rows (dicts) sorted by
    ``time_min``.  Returns a plan dict for :func:`assemble_window_patch`
    (segments, c_lo, c_hi, total_rows, t0_ns, dt_ns, d0, dx, payload,
    scale) or None when the planned path does not apply (non-tdas
    files, mixed geometry, or a coverage gap — the generic merge path
    then handles gap policy).

    Row selection matches :func:`_row_range` (inclusive bounds) so the
    assembled window is byte-identical to per-file read + merge.
    """
    recs = list(records)
    if not recs:
        return None
    first = recs[0]
    if any(r.get("format") != FORMAT_NAME for r in recs):
        return None
    dt_ns = np.timedelta64(first["time_step"], "ns").astype(np.int64)
    if dt_ns <= 0:
        return None
    nd = int(first["ndistance"])
    d0 = float(first["distance_min"])
    d_max = float(first["distance_max"])
    dx = float(first["dx"])
    for r in recs:
        if (
            np.timedelta64(r["time_step"], "ns").astype(np.int64) != dt_ns
            or int(r["ndistance"]) != nd
            or float(r["distance_min"]) != d0
            or float(r["distance_max"]) != d_max
            or float(r["dx"]) != dx
        ):
            return None
    # uniform int16 payload (one quantization scale everywhere) -> the
    # raw path: assemble int16, decode on the card.  Anything else
    # assembles decoded float32.
    codes = {r.get("dtype_code") for r in recs}
    scales = {r.get("scale") for r in recs}
    if codes == {1} and len(scales) == 1:
        (scale,) = scales
        payload = (
            ("int16", float(scale))
            if scale is not None and np.isfinite(scale)
            else ("float32", None)
        )
    else:
        payload = ("float32", None)
    c_lo, c_hi = _ch_range(
        {"n_ch": nd, "d0": d0, "dx": dx}, distance
    )
    if c_hi - c_lo == 0:
        return None
    segments, total, next_ns, t0_out = [], 0, None, None
    for r in recs:
        f0 = np.datetime64(r["time_min"], "ns").astype(np.int64)
        r_lo, r_hi = _row_range(
            {"n_time": int(r["ntime"]), "t0_ns": f0, "dt_ns": dt_ns},
            (t_lo, t_hi),
        )
        if r_hi <= r_lo:
            continue
        seg_t0 = f0 + r_lo * dt_ns
        if next_ns is None:
            t0_out = seg_t0
        elif seg_t0 != next_ns:
            return None  # coverage gap or overlap: generic path decides
        segments.append((r["path"], r_lo, r_hi, total))
        total += r_hi - r_lo
        next_ns = f0 + r_hi * dt_ns
    if total == 0:
        return None
    return {
        "segments": segments,
        "c_lo": c_lo,
        "c_hi": c_hi,
        "total_rows": total,
        "t0_ns": int(t0_out),
        "dt_ns": int(dt_ns),
        "d0": d0,
        "dx": dx,
        "payload": payload[0],
        "scale": payload[1],
    }


def window_array_spec(plan):
    """(shape, dtype) of the buffer a plan assembles into: raw int16
    for an ``int16`` plan, decoded float32 otherwise."""
    dtype = np.int16 if plan.get("payload") == "int16" else np.float32
    return (plan["total_rows"], plan["c_hi"] - plan["c_lo"]), np.dtype(dtype)


def assemble_window_patch(plan, n_threads=None, out=None) -> Patch:
    """Execute a :func:`plan_window_from_records` plan: one threaded
    multi-file read into ONE contiguous buffer (``out`` when given, of
    :func:`window_array_spec`'s shape and dtype), wrapped as a Patch.

    An ``int16`` plan assembles the RAW quantized payload and returns
    an int16 Patch carrying its quantization scale as the
    ``data_scale`` attr — the engine transfers half the bytes to the
    card and the first FIR stage reads int16.  Such quantized patches
    exist only inside the engine's window path; the public read API
    (:func:`read_tdas`) always decodes to float32.
    """
    if plan.get("payload") == "int16":
        data = assemble_window_raw(
            plan["segments"], plan["c_lo"], plan["c_hi"],
            plan["total_rows"], dtype_code=1, n_threads=n_threads, out=out,
        )
        patch = _patch_from_block(plan, data, 0, plan["c_lo"])
        return patch.update_attrs(data_scale=float(plan["scale"]))
    data = assemble_window(
        plan["segments"], plan["c_lo"], plan["c_hi"], plan["total_rows"],
        n_threads=n_threads, out=out,
    )
    return _patch_from_block(plan, data, 0, plan["c_lo"])


def _segment_arrays(segments):
    """ctypes marshaling shared by both native assemblers."""
    n = len(segments)
    return (
        (ctypes.c_char_p * n)(*[os.fsencode(s[0]) for s in segments]),
        (ctypes.c_uint64 * n)(*[int(s[1]) for s in segments]),
        (ctypes.c_uint64 * n)(*[int(s[2]) for s in segments]),
        (ctypes.c_uint64 * n)(*[int(s[3]) for s in segments]),
        n,
    )


def _destination(out, shape, dtype):
    """``out`` checked against the assembly's shape and dtype (the
    native runtime writes through its pointer), or a fresh array."""
    if out is None:
        return np.empty(shape, dtype)
    if (
        not isinstance(out, np.ndarray)
        or out.shape != tuple(shape)
        or out.dtype != dtype
        or not out.flags.c_contiguous
        or not out.flags.writeable
    ):
        raise ValueError(
            f"out must be a writeable C-contiguous {np.dtype(dtype)} array "
            f"of shape {tuple(shape)}"
        )
    return out


def assemble_window_raw(
    segments, c_lo, c_hi, total_rows, dtype_code, n_threads=None, out=None
):
    """Fill one contiguous (total_rows, c_hi-c_lo) buffer of the RAW
    payload dtype (no numeric conversion) from per-file row segments
    ``(path, row_lo, row_hi, out_row0)``.  Every file must carry
    ``dtype_code`` (the planner guarantees it; the native runtime
    re-checks per file)."""
    out = _destination(out, (total_rows, c_hi - c_lo), _DTYPES[dtype_code])
    if not native_enabled():
        for path, r_lo, r_hi, o0 in segments:
            hdr = read_tdas_header(path)
            if hdr["dtype_code"] != dtype_code:
                raise ValueError(
                    f"{path}: payload dtype {hdr['dtype_code']} != "
                    f"planned {dtype_code}"
                )
            out[o0 : o0 + (r_hi - r_lo)] = _read_rows_raw_numpy(
                path, hdr, r_lo, r_hi, c_lo, c_hi
            )
        return out
    paths, row_lo, row_hi, out_r0, n = _segment_arrays(segments)
    rc = load_streamio().tdas_assemble_window_raw(
        paths, row_lo, row_hi, out_r0, n, int(c_lo), int(c_hi),
        int(dtype_code), out.ctypes.data_as(ctypes.c_void_p),
        int(n_threads or _default_threads()),
    )
    if rc != 0:
        raise OSError(rc, "tdas_assemble_window_raw failed")
    return out


def assemble_window(segments, c_lo, c_hi, total_rows, n_threads=None,
                    out=None):
    """Fill one contiguous (total_rows, c_hi-c_lo) float32 window from
    per-file row segments ``(path, row_lo, row_hi, out_row0)``, int16
    files decoded."""
    out = _destination(out, (total_rows, c_hi - c_lo), np.float32)
    if not native_enabled():
        for path, r_lo, r_hi, o0 in segments:
            hdr = read_tdas_header(path)
            out[o0 : o0 + (r_hi - r_lo)] = _read_block_numpy(
                path, hdr, r_lo, r_hi, c_lo, c_hi
            )
        return out
    paths, row_lo, row_hi, out_r0, n = _segment_arrays(segments)
    rc = load_streamio().tdas_assemble_window(
        paths, row_lo, row_hi, out_r0, n, int(c_lo), int(c_hi),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads or _default_threads()),
    )
    if rc != 0:
        raise OSError(rc, "tdas_assemble_window failed")
    return out
