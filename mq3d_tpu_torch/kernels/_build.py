"""Build, load and count the port's hand-written CUDA kernels.

All sources in ``mq3d_tpu_torch/csrc/*.cu`` are compiled by ONE ``nvcc``
call into one shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``),
placed in ``<repo>/build/`` and loaded with ctypes.  The build happens on
the first launch of any kernel, never at import, and is redone when the
hash of the sources or the flags changes.  No source includes PyTorch's
headers, so the build takes seconds.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrapper raises when it is not 0.  Every pointer and the stream are passed
as ``ctypes.c_void_p``.

Launch counts: each wrapper calls ``count_launch(name)`` where it launches
its kernel and nowhere else, so a run can show that its main path went
through the kernels (``reset_launch_counts`` / ``launch_counts``).
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
from typing import Dict, Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# C entry points: name -> argtypes.  P = pointer, I = int.
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (patch, vi, ui, out, TP, PS, V, stream)
    "mq3d_patch_lookup": (_P, _P, _P, _P, _I, _I, _I, _P),
    # (y, u, v, out, N, H, W, stream)
    "mq3d_i420_to_bgr": (_P, _P, _P, _P, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_last_build_seconds: Optional[float] = None
_launches: Dict[str, int] = {"patch_lookup": 0, "i420_to_bgr": 0}


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def last_build_seconds() -> Optional[float]:
    """Seconds the nvcc call took in this process (None: loaded from an
    earlier build or not built yet)."""
    return _last_build_seconds


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from torch's CUDA_HOME, else from PATH; raise if neither."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (torch.utils.cpp_extension.CUDA_HOME and PATH); "
        "the CUDA kernels cannot be built")


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu into build/libmq3d_kernels_<hash>.so if it is not
    there yet (or always, with force=True).  Returns the library path."""
    global _last_build_seconds
    lib_path = BUILD_DIR / f"libmq3d_kernels_{_source_hash()}.so"
    if lib_path.exists() and not force:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    _last_build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
