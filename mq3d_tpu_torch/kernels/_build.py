"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``mq3d_tpu_torch/csrc/*.cu`` is compiled by its own
``nvcc`` process, all started together
(``-gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC -Xptxas -v``),
so the build takes as long as its slowest source however many sources
there are; one more ``nvcc`` call links the objects into one shared
library with a plain C interface, placed in ``<repo>/build/`` and loaded
with ctypes.
The build happens on the first launch of any kernel, never at import, and
is redone when the hash of the sources or the flags changes.  No source
includes PyTorch's headers, so the build takes seconds.  ptxas's report
(registers, shared memory, spills of each kernel) is kept
(``last_build_report``).

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrapper raises when it is not 0.  Every pointer and the stream are passed
as ``ctypes.c_void_p``.

The steps shared with the native IO runtime (``utils/native.py``, built
with g++) live here too: the hash that names a library
(``source_hash``), the compile to a name of this process and thread moved
into place with ``os.replace`` (``build_into``), so builds that start
together in several processes each load a whole library, and the typed
load cached once per process (``load_typed``, ``LazyLibrary``).

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
from typing import Callable, Dict, Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C entry points: name -> (restype, argtypes); each returns a cudaError_t.
# P = pointer, I = int.
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (patch, vi, ui, out, TP, PS, V, stream)
    "mq3d_patch_lookup": (_I, (_P, _P, _P, _P, _I, _I, _I, _P)),
    # (y, u, v, out, N, H, W, stream)
    "mq3d_i420_to_bgr": (_I, (_P, _P, _P, _P, _I, _I, _I, _P)),
    # (table, n, idx, out, m, mode, stream)
    "mq3d_gather": (_I, (_P, _I, _P, _P, ctypes.c_longlong, _I, _P)),
}

_last_build_seconds: Optional[float] = None
_last_build_report: str = ""
_launches: Dict[str, int] = {"patch_lookup": 0, "i420_to_bgr": 0, "gather": 0}


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def last_build_seconds() -> Optional[float]:
    """Seconds the build took in this process (None: loaded from an
    earlier build or not built yet)."""
    return _last_build_seconds


def last_build_report() -> str:
    """ptxas's lines (registers, shared memory, spills per kernel) from the
    build in this process ("" when none ran)."""
    return _last_build_report


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash(flags, sources) -> str:
    """16 hex digits of the hash of the flags and the sources (names and
    bytes): the key of a built library's file name."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _source_hash() -> str:
    return source_hash(NVCC_FLAGS, _sources())


def run_tool(cmd, what: str) -> str:
    """Run a compiler command; return its output, raise with it on failure."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build_into(lib_path: Path, make: Callable[[Path], object]) -> None:
    """Have make(tmp) write a library at a name of this process and thread,
    then move it to lib_path with os.replace: builds that start together
    (xdist workers, the ranks of a process group) each load a whole file.
    The temporary is removed when make raises."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(
        f"{lib_path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        make(tmp)
        os.replace(tmp, lib_path)
    finally:
        tmp.unlink(missing_ok=True)


def load_typed(lib_path: Path, signatures) -> ctypes.CDLL:
    """Load a shared library and type the C entry points of `signatures`
    (name -> (restype, argtypes))."""
    lib = ctypes.CDLL(str(lib_path))
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib


class LazyLibrary:
    """A library built and loaded on first use, once per process."""

    def __init__(self, build: Callable[[], Path], signatures):
        self._build = build
        self._signatures = signatures
        self._lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self.lib is None:
                self.lib = load_typed(self._build(), self._signatures)
            return self.lib


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


def compile_library(sources, lib_path: Path) -> str:
    """Compile `sources` (one nvcc process each, all started together) and
    link them into `lib_path`.  Returns ptxas's report; raises on failure."""
    nvcc = find_nvcc()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [lib_path.with_name(f"{tag}.{src.stem}.o") for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    outs = [p.communicate() for p in procs]
    try:
        for cmd, p, (out, err) in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        build_into(lib_path, lambda tmp: run_tool(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)], "nvcc link"))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "\n".join(line.strip() for out, err in outs
                     for line in (out + err).splitlines()
                     if "ptxas" in line or "spill" in line)


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu into build/libmq3d_kernels_<hash>.so if it is not
    there yet (or always, with force=True).  Returns the library path."""
    global _last_build_seconds, _last_build_report
    lib_path = BUILD_DIR / f"libmq3d_kernels_{_source_hash()}.so"
    if lib_path.exists() and not force:
        return lib_path
    t0 = time.perf_counter()
    _last_build_report = compile_library(_sources(), lib_path)
    _last_build_seconds = time.perf_counter() - t0
    return lib_path


def load(lib_path: Path, names=None) -> ctypes.CDLL:
    """Load a built library and type its C entry points (`names`, default
    all of them)."""
    return load_typed(lib_path, {n: _SIGNATURES[n] for n in names or _SIGNATURES})


_kernels = LazyLibrary(build, _SIGNATURES)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    return _kernels.get()


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
