"""The native IO runtime: batched raw reads, PNG writes and plane
de-striding in C++ (``mq3d_tpu_torch/csrc/mqio.cpp``), loaded with ctypes.

Counterpart of the JAX build's utils/native.py, with the same contracts:
  * ``read_raw_batch``: n files of one frame size into one (n, frame_bytes)
    uint8 buffer and an ok mask.  A frame is ok when its first frame_bytes
    bytes were read: a longer file gives its first frame, a short file its
    bytes and zeros (ok False), a missing file zeros (ok False).
  * ``write_png`` / ``write_png_batch``: (H, W) gray or (H, W, 3) BGR uint8
    in, RGB stored (the channel swap rides on the C row copy and leaves a
    gray image as it is); filter 0 on every row, one zlib stream at the
    given level, so the bytes equal ``utils/png.encode_png``'s where both
    link the same zlib.
  * ``destride_plane``: a (height, width) plane out of a strided Android
    image buffer, zero past the buffer's end.
  * The batch functions run one thread per core (``n_threads=0`` of the C
    entry points).

The library is built on first use, never at import, with
``g++ -O3 -shared -fPIC -pthread mqio.cpp -o <so> -lz`` into
``<repo>/build/libmqio_<hash>.so``, the hash taken over the source and the
flags, through the build steps it shares with the CUDA kernels
(``kernels/_build.py``: each process compiles to a name of its own and
moves the result into place with ``os.replace``).  There is no fallback:
when g++ is missing, the build fails or the library does not load, the
call raises with the compiler's output.

The plain versions (``read_raw_batch_plain`` here,
``utils/png.write_png_batch_plain`` and ``ops/yuv.destride_plane``)
compute the same results in numpy and zlib; the tests and chip_smoke hold
the native functions against them.  The main path
(``dataio/depth_io.load_depth_stack``, ``dataio/image_io.save_bgr_batch``,
``utils/png.imwrite``) runs the native ones.  ``destride_plane`` is on no
path: the YUV stage keeps the numpy version, which was faster on the
card's host (PERF.md).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from mq3d_tpu_torch.kernels._build import (
    BUILD_DIR, CSRC_DIR, LazyLibrary, build_into, load_typed, run_tool, source_hash)

SOURCE = CSRC_DIR / "mqio.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
LIBS = ("-lz",)

_P = ctypes.c_void_p
_S = ctypes.c_char_p
_I = ctypes.c_int
_L = ctypes.c_long
# C entry points: name -> (restype, argtypes).
_SIGNATURES = {
    # (path, out, max_bytes) -> bytes read, -1 when the file does not open
    "mqio_read_file": (_L, (_S, _P, _L)),
    # (paths, n_files, frame_bytes, out, ok) -> complete frames
    "mqio_read_raw_batch": (_I, (ctypes.POINTER(_S), _I, _L, _P, _P)),
    # (paths, n_files, frame_bytes, out, ok, n_threads) -> complete frames
    "mqio_read_raw_batch_mt": (_I, (ctypes.POINTER(_S), _I, _L, _P, _P, _I)),
    # (src, src_len, offset, width, height, row_stride, pixel_stride, out)
    "mqio_destride_plane": (None, (_P, _L, _L, _I, _I, _I, _I, _P)),
    # (path, data, width, height, channels, level) -> 0 on success; the
    # _bgr variants take BGR pixels and store RGB (gray as it is), and are
    # the ones the Python functions call; the RGB-input ones keep the JAX
    # runtime's C interface
    "mqio_write_png": (_I, (_S, _P, _I, _I, _I, _I)),
    "mqio_write_png_bgr": (_I, (_S, _P, _I, _I, _I, _I)),
    # (paths, data, n, width, height, channels, level, ok, n_threads) -> written
    "mqio_write_png_batch": (_I, (ctypes.POINTER(_S), _P, _I, _I, _I, _I, _I, _P, _I)),
    "mqio_write_png_batch_bgr": (_I, (ctypes.POINTER(_S), _P, _I, _I, _I, _I, _I, _P, _I)),
    "mqio_default_threads": (_I, ()),
    "mqio_zlib_compiled_version": (_S, ()),
    "mqio_zlib_runtime_version": (_S, ()),
}

_last_build_seconds: Optional[float] = None


def _lib_path() -> Path:
    return BUILD_DIR / f"libmqio_{source_hash(GXX_FLAGS + LIBS, [SOURCE])}.so"


def find_gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH; the native IO runtime "
                           f"({SOURCE}) cannot be built")
    return found


def build(force: bool = False) -> Path:
    """Compile csrc/mqio.cpp into build/libmqio_<hash>.so unless it is
    there already (always, with force=True).  Returns the library path;
    raises with g++'s output when the compile fails."""
    global _last_build_seconds
    lib_path = _lib_path()
    if lib_path.exists() and not force:
        return lib_path
    gxx = find_gxx()
    t0 = time.perf_counter()
    build_into(lib_path, lambda tmp: run_tool(
        [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS], "g++"))
    _last_build_seconds = time.perf_counter() - t0
    return lib_path


def last_build_seconds() -> Optional[float]:
    """Seconds the g++ build took in this process (None: loaded from an
    earlier build or not built yet)."""
    return _last_build_seconds


def load(lib_path: Path) -> ctypes.CDLL:
    """Load a built runtime and type its C entry points."""
    return load_typed(lib_path, _SIGNATURES)


_runtime = LazyLibrary(build, _SIGNATURES)


def library() -> ctypes.CDLL:
    """The loaded runtime (built on first use)."""
    return _runtime.get()


def runtime_info() -> Dict[str, object]:
    """The compiler, the zlib versions (compiled against, loaded, and
    Python's own) and the thread count that n_threads=0 gives."""
    import zlib

    lib = library()
    gxx = subprocess.run([find_gxx(), "--version"], capture_output=True, text=True)
    return {
        "gxx": gxx.stdout.splitlines()[0] if gxx.stdout else "unknown",
        "zlib_compiled": lib.mqio_zlib_compiled_version().decode(),
        "zlib_runtime": lib.mqio_zlib_runtime_version().decode(),
        "zlib_python": zlib.ZLIB_RUNTIME_VERSION,
        "threads": int(lib.mqio_default_threads()),
    }


def _paths_array(paths) -> ctypes.Array:
    return (_S * len(paths))(*[os.fsencode(p) for p in paths])


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def read_raw_batch(paths: List[Path], frame_bytes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Read n frames of frame_bytes each into one (n, frame_bytes) uint8
    buffer, one thread per core.  Returns (buffer, ok mask)."""
    if frame_bytes < 0:
        raise ValueError(f"frame_bytes {frame_bytes} < 0")
    n = len(paths)
    out = np.zeros((n, frame_bytes), np.uint8)
    ok = np.zeros(n, np.uint8)
    if n:
        library().mqio_read_raw_batch_mt(_paths_array(paths), n, frame_bytes,
                                         _ptr(out), _ptr(ok), 0)
    return out, ok.astype(bool)


def read_raw_batch_plain(paths: List[Path], frame_bytes: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Plain version of read_raw_batch: one np.fromfile per file."""
    n = len(paths)
    out = np.zeros((n, frame_bytes), np.uint8)
    ok = np.zeros(n, bool)
    for i, p in enumerate(paths):
        try:
            buf = np.fromfile(p, dtype=np.uint8, count=frame_bytes)
        except OSError:
            continue
        out[i, :buf.size] = buf
        ok[i] = buf.size == frame_bytes
    return out, ok


def _check_pixels(imgs: np.ndarray, stack: bool) -> np.ndarray:
    """Contiguous uint8 gray or BGR pixels: (H, W[, 3]), or a stack of them."""
    if imgs.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, not {imgs.dtype}")
    nd = imgs.ndim - stack
    if not (nd == 2 or (nd == 3 and imgs.shape[-1] == 3)):
        raise ValueError(f"unsupported image shape {imgs.shape}")
    return np.ascontiguousarray(imgs)


def write_png(path: Path, img: np.ndarray, compression_level: int = 3) -> bool:
    """Encode one (H, W) gray or (H, W, 3) BGR uint8 image to a PNG file.
    Returns whether the file was written."""
    img = _check_pixels(img, stack=False)
    rc = library().mqio_write_png_bgr(os.fsencode(path), _ptr(img), img.shape[1],
                                      img.shape[0], 1 if img.ndim == 2 else 3,
                                      compression_level)
    return rc == 0


def write_png_batch(paths: List[Path], imgs: np.ndarray,
                    compression_level: int = 3) -> np.ndarray:
    """Encode a (n, H, W) gray or (n, H, W, 3) BGR uint8 stack to n PNG
    files, one thread per core.  Returns the mask of files written."""
    n = len(paths)
    if len(imgs) != n:
        raise ValueError(f"{len(imgs)} images for {n} paths")
    imgs = _check_pixels(imgs, stack=True)
    ok = np.zeros(n, np.uint8)
    if n:
        library().mqio_write_png_batch_bgr(
            _paths_array(paths), _ptr(imgs), n, imgs.shape[2], imgs.shape[1],
            1 if imgs.ndim == 3 else 3, compression_level, _ptr(ok), 0)
    return ok.astype(bool)


def destride_plane(data, offset: int, width: int, height: int, row_stride: int,
                   pixel_stride: int) -> np.ndarray:
    """Extract a (height, width) uint8 plane from a strided Android image
    buffer; bytes past the buffer's end read 0 (plain version:
    ops/yuv.destride_plane)."""
    if min(offset, width, height, row_stride, pixel_stride) < 0:
        raise ValueError("destride_plane: negative offset, size or stride")
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((height, width), np.uint8)
    library().mqio_destride_plane(_ptr(src), src.size, offset, width, height,
                                  row_stride, pixel_stride, _ptr(out))
    return out
