"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
at first use, into ``build/tpudas_torch/`` beside the package; the
library is loaded with ``ctypes``.  The file name carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
is reused.  Nothing here runs at import time: the CPU-only test
environment has no ``nvcc`` and imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "load_library", "build_info"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_PKG = Path(__file__).resolve().parents[1]
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_INFO: dict[str, dict] = {}


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
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME); the CUDA kernels are built "
        "with nvcc at first use on the machine with the card"
    )


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library.
    Raises with the compiler's output when the build fails."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = _PKG / "csrc" / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"lib{name}-{digest}.so"
        info = {"source": str(src.relative_to(_PKG.parent)), "cached": True,
                "seconds": 0.0, "ptxas": []}
        if not so.exists():
            tmp = out_dir / f".{so.name}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            info["seconds"] = time.perf_counter() - t0
            info["cached"] = False
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed for {src.name} (rc {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            info["ptxas"] = [
                ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln
            ]
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
        _INFO[name] = info
        return lib


def build_info(name: str) -> dict:
    """How ``name`` was obtained in this process: source path, whether
    the library was reused from the build directory, the build's
    seconds, and ``-Xptxas -v``'s register/shared-memory lines."""
    return dict(_INFO.get(name, {}))
