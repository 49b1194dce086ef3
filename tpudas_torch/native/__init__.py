"""Native (C++) ingest runtime, bound via ctypes.

The port's counterpart of :mod:`tpudas.native`, with its own copy of
``streamio.cpp`` (the threaded tdas writer, block reader and window
assemblers).  :func:`load_streamio` compiles it on first use with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into the port's build
directory (``build/tpudas_torch/``, beside the CUDA kernels), under a
file name keyed by the source's digest, and returns the bound library.

Unlike the JAX loader, a build or load failure raises with the
compiler's output: the port never drops to the numpy reader on its
own.  The numpy reader of :mod:`tpudas_torch.io.tdas` runs only when
the caller asks for it with ``TPUDAS_NO_NATIVE=1`` (read at every call,
see :func:`native_enabled`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CXX", "CXX_FLAGS", "load_streamio", "native_enabled",
           "streamio_path"]

CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_SRC = Path(__file__).resolve().with_name("streamio.cpp")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def native_enabled() -> bool:
    """False when the caller asked for the numpy reader
    (``TPUDAS_NO_NATIVE=1``), the same switch as the JAX package's."""
    return os.environ.get("TPUDAS_NO_NATIVE") != "1"


def streamio_path() -> Path:
    """Where the library for the current source and flags lives."""
    from tpudas_torch.ops._build import build_dir

    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"libstreamio-{digest}.so"


def _compile(so: Path) -> None:
    """Build ``so`` from the source; raises with the compiler's output.
    Each process compiles to its own temp name and renames it into
    place, so concurrent builds (test workers) never publish a partial
    library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    if shutil.which(CXX) is None:
        raise RuntimeError(
            f"cannot build {_SRC.name}: compiler {CXX!r} not found "
            "(set TPUDAS_NO_NATIVE=1 to read with numpy)"
        )
    cmd = [CXX, *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {_SRC.name} failed (rc {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, u32, f32, f64 = (
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.c_float,
        ctypes.c_double,
    )
    p = ctypes.POINTER
    lib.tdas_write.restype = ctypes.c_int
    lib.tdas_write.argtypes = [
        ctypes.c_char_p, u64, u64, u32, u32, u32, f32, f64, f64,
        ctypes.c_void_p,
    ]
    lib.tdas_read_header.restype = ctypes.c_int
    lib.tdas_read_header.argtypes = [
        ctypes.c_char_p, p(u64), p(u64), p(u32), p(u32), p(u32), p(f32),
        p(f64), p(f64),
    ]
    lib.tdas_read_block.restype = ctypes.c_int
    lib.tdas_read_block.argtypes = [
        ctypes.c_char_p, u64, u64, u32, u32, p(f32), ctypes.c_int,
    ]
    lib.tdas_assemble_window.restype = ctypes.c_int
    lib.tdas_assemble_window.argtypes = [
        p(ctypes.c_char_p), p(u64), p(u64), p(u64), ctypes.c_int, u32, u32,
        p(f32), ctypes.c_int,
    ]
    lib.tdas_assemble_window_raw.restype = ctypes.c_int
    lib.tdas_assemble_window_raw.argtypes = [
        p(ctypes.c_char_p), p(u64), p(u64), p(u64), ctypes.c_int, u32, u32,
        u32, ctypes.c_void_p, ctypes.c_int,
    ]
    return lib


def load_streamio() -> ctypes.CDLL:
    """The compiled, bound native library (built at first use; raises
    when it cannot be built or loaded)."""
    global _lib
    with _lock:
        if _lib is None:
            so = streamio_path()
            if not so.exists():
                _compile(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        return _lib
