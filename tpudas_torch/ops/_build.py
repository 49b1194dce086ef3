"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
at first use, into ``build/tpudas_torch/`` beside the package; the
library is loaded with ``ctypes``.  The file name carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
is reused; :func:`build_libraries` compiles several sources at once,
one nvcc process each.  Each nvcc build and each library's first load
is reported to the device telemetry as one compile of its seconds
(:mod:`tpudas_torch.obs.devprof`), attributed to the calling thread's
declared kernel key.  Nothing here runs at import time: the CPU-only test
environment has no ``nvcc`` and imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from tpudas_torch.obs import devprof

__all__ = [
    "NVCC_FLAGS", "KernelError", "build_dir", "build_libraries",
    "load_library", "build_info", "kernel_resources",
]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PKG = Path(__file__).resolve().parents[1]
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_INFO: dict[str, dict] = {}
# the device telemetry's compile event (a name ending as the JAX
# package's backend-compile duration event does)
_COMPILE_EVENT = "/tpudas_torch/kernel/backend_compile_duration"


class KernelError(RuntimeError):
    """A hand-written kernel failed to build or to launch.  Callers that
    degrade on other failures (the window-DP latch of
    :class:`tpudas_torch.proc.lfproc.LFProc`) re-raise it: a fallback
    around a broken kernel would hide it."""


def build_dir() -> Path:
    """``build/tpudas_torch/`` at the root of the checkout (listed in
    ``.gitignore``)."""
    return _PKG.parent / "build" / "tpudas_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own toolkit lookup (CUDA_HOME / CUDA_PATH / the default
    # install prefix)
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelError(
        "nvcc not found (PATH, CUDA_HOME); the CUDA kernels are built "
        "with nvcc at first use on the machine with the card"
    )


def _so_path(name: str) -> tuple[Path, Path]:
    """(source, library path) of ``csrc/<name>.cu``; the library name
    carries a hash of the source and the flags."""
    src = _PKG / "csrc" / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, build_dir() / f"lib{name}-{digest}.so"


def build_libraries(names) -> None:
    """Compile every missing ``csrc/<name>.cu`` of ``names`` at once: one
    nvcc process each, all started together, then waited for.  Raises
    with the compiler's output when a build fails (after every nvcc has
    ended)."""
    with _LOCK:
        build_dir().mkdir(parents=True, exist_ok=True)
        started = []
        for name in names:
            src, so = _so_path(name)
            _INFO.setdefault(name, {
                "source": str(src.relative_to(_PKG.parent)), "cached": True,
                "seconds": 0.0, "ptxas": [],
            })
            if name in _LIBS or so.exists():
                continue
            tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started.append((name, src, so, tmp, proc, time.perf_counter()))
        failed = []
        for name, src, so, tmp, proc, t0 in started:
            out, _ = proc.communicate()
            info = _INFO[name]
            info["seconds"] = time.perf_counter() - t0
            info["cached"] = False
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed for {src.name} "
                              f"(rc {proc.returncode}):\n{out}")
                continue
            info["ptxas"] = [
                ln.strip() for ln in out.splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln
            ]
            os.replace(tmp, so)
            devprof._on_compile_duration(_COMPILE_EVENT, info["seconds"])
        if failed:
            raise KernelError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library.
    Raises with the compiler's output when the build fails."""
    build_libraries([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            t0 = time.perf_counter()
            lib = _LIBS[name] = ctypes.CDLL(str(_so_path(name)[1]))
            devprof._on_compile_duration(
                _COMPILE_EVENT, time.perf_counter() - t0)
        return lib


def build_info(name: str) -> dict:
    """How ``name`` was obtained in this process: source path, whether
    the library was reused from the build directory, the build's
    seconds, and ``-Xptxas -v``'s register/shared-memory lines."""
    return dict(_INFO.get(name, {}))


def kernel_resources(name: str) -> dict:
    """Registers and spill bytes of each kernel of ``csrc/<name>.cu``,
    from ``-Xptxas -v`` (empty when the library was reused rather than
    built in this process): ``{mangled entry: {"registers", "spill_stores",
    "spill_loads"}}``."""
    out, cur = {}, None
    for ln in _INFO.get(name, {}).get("ptxas", []):
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([A-Za-z0-9_]+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out
