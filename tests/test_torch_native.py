"""mq3d_tpu_torch's native IO runtime (utils/native.py, csrc/mqio.cpp)
against the JAX package's (utils/native.py, native/mqio.cpp) and against
its own plain versions, on the CPU.

Tolerances: none.  Raw reads give equal buffers and ok masks (present,
missing, short and oversized files: a file longer than a frame gives its
first frame, as the JAX runtime reads it); PNG files are equal byte for
byte to the JAX native writer's, and to utils/png.encode_png's where
Python's zlib is the one the runtime links; their pixels read back equal;
de-striding equals the JAX package's numpy version.  The depth stack and
the PNG batch of step 0 go through the runtime in both packages and give
equal arrays and equal files.  A failed build raises.
"""

import os
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.ops.yuv import destride_plane as jax_destride_plane
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu.utils import native as jax_native
from mq3d_tpu.utils.png import imwrite as jax_imwrite
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.ops.yuv import destride_plane
from mq3d_tpu_torch.utils import native
from mq3d_tpu_torch.utils.png import encode_png, imread_bgr, imwrite, write_png_batch_plain

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's runtime, loaded.  Its first use compiles
    native/_mqio.so in place, so another test process may be writing the
    file at this moment: wait for a whole library instead of taking the
    JAX module's Python fallback (which reads oversized files otherwise)."""
    deadline = time.monotonic() + 120
    while not jax_native.native_available():
        assert time.monotonic() < deadline, "the JAX native runtime did not load"
        jax_native._TRIED = False
        time.sleep(0.5)


def _raw_files(tmp_path, rng, frame_bytes):
    frames = rng.integers(0, 256, (4, frame_bytes), np.uint8)
    paths = []
    for i, fr in enumerate(frames):
        p = tmp_path / f"{i}.raw"
        p.write_bytes(fr.tobytes())
        paths.append(p)
    short = tmp_path / "short.raw"
    short.write_bytes(frames[0, :frame_bytes // 3].tobytes())
    long = tmp_path / "long.raw"
    long.write_bytes(frames[1].tobytes() + frames[2, :frame_bytes // 2].tobytes())
    paths[1:1] = [tmp_path / "missing.raw", short, long]
    return frames, paths


def _read_mt(paths, frame_bytes, n_threads):
    """The C batch read on n_threads threads (read_raw_batch passes 0: one
    per core)."""
    out = np.zeros((len(paths), frame_bytes), np.uint8)
    ok = np.zeros(len(paths), np.uint8)
    native.library().mqio_read_raw_batch_mt(native._paths_array(paths), len(paths),
                                            frame_bytes, out.ctypes.data, ok.ctypes.data,
                                            n_threads)
    return out, ok.astype(bool)


def _write_png_batch_mt(paths, imgs, n_threads):
    """The C batch PNG writer on n_threads threads (write_png_batch passes 0)."""
    ok = np.zeros(len(paths), np.uint8)
    native.library().mqio_write_png_batch_bgr(
        native._paths_array(paths), imgs.ctypes.data, len(paths), imgs.shape[2],
        imgs.shape[1], 1 if imgs.ndim == 3 else 3, 3, ok.ctypes.data, n_threads)
    return ok.astype(bool)


@pytest.mark.parametrize("n_threads", [0, 1, 3])
def test_read_raw_batch_matches_jax_and_plain(jax_lib, tmp_path, n_threads):
    frame_bytes = 8 * 6 * 4
    frames, paths = _raw_files(tmp_path, np.random.default_rng(0), frame_bytes)
    want_buf, want_ok = jax_native.read_raw_batch(paths, frame_bytes)
    buf, ok = native.read_raw_batch(paths, frame_bytes)
    mt_buf, mt_ok = _read_mt(paths, frame_bytes, n_threads)
    plain_buf, plain_ok = native.read_raw_batch_plain(paths, frame_bytes)
    np.testing.assert_array_equal(mt_ok, ok)
    np.testing.assert_array_equal(mt_buf, buf)
    # present, missing, short, long (its first frame), present x3
    assert ok.tolist() == [True, False, False, True, True, True, True]
    assert ok.dtype == bool and buf.dtype == np.uint8 and buf.shape == (7, frame_bytes)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(buf, want_buf)
    np.testing.assert_array_equal(plain_ok, ok)
    np.testing.assert_array_equal(plain_buf, buf)
    np.testing.assert_array_equal(buf[3], frames[1])
    assert (buf[1] == 0).all()
    np.testing.assert_array_equal(buf[2, :frame_bytes // 3], frames[0, :frame_bytes // 3])
    assert (buf[2, frame_bytes // 3:] == 0).all()


def test_the_other_c_entry_points(tmp_path):
    """The entry points the Python functions do not call: the one-thread
    batch read and the file read give what read_raw_batch gives, and the
    RGB-input PNG writers what the BGR-input ones write."""
    lib = native.library()
    frame_bytes = 8 * 6 * 4
    frames, paths = _raw_files(tmp_path, np.random.default_rng(1), frame_bytes)
    want_buf, want_ok = native.read_raw_batch(paths, frame_bytes)
    buf = np.zeros_like(want_buf)
    ok = np.zeros(len(paths), np.uint8)
    arr = native._paths_array(paths)
    assert lib.mqio_read_raw_batch(arr, len(paths), frame_bytes, buf.ctypes.data,
                                   ok.ctypes.data) == int(want_ok.sum())
    np.testing.assert_array_equal(buf, want_buf)
    np.testing.assert_array_equal(ok.astype(bool), want_ok)
    one = np.zeros(frame_bytes * 2, np.uint8)
    assert lib.mqio_read_file(str(paths[3]).encode(), one.ctypes.data, one.size) \
        == frame_bytes * 3 // 2
    assert lib.mqio_read_file(str(paths[1]).encode(), one.ctypes.data, one.size) == -1

    bgr = _image((3, 6, 5, 3), 2)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    assert lib.mqio_write_png(str(tmp_path / "rgb.png").encode(), rgb[0].ctypes.data,
                              5, 6, 3, 3) == 0
    assert native.write_png(tmp_path / "bgr.png", bgr[0])
    assert (tmp_path / "rgb.png").read_bytes() == (tmp_path / "bgr.png").read_bytes()
    names = [tmp_path / f"rgb{i}.png" for i in range(3)]
    ok = np.zeros(3, np.uint8)
    assert lib.mqio_write_png_batch(native._paths_array(names), rgb.ctypes.data, 3, 5, 6, 3,
                                    3, ok.ctypes.data, 2) == 3
    native.write_png_batch([tmp_path / f"bgr{i}.png" for i in range(3)], bgr)
    for i in range(3):
        assert names[i].read_bytes() == (tmp_path / f"bgr{i}.png").read_bytes()


def test_read_raw_batch_empty():
    buf, ok = native.read_raw_batch([], 16)
    assert buf.shape == (0, 16) and ok.shape == (0,)


def test_batches_on_more_threads_than_cores(tmp_path):
    """64 files on 4x the cores' threads, each thread taking the next file:
    every frame lands in its own row and every PNG in its own file."""
    threads = 4 * (os.cpu_count() or 1)
    frame_bytes = 3 * 5 * 3
    frames = np.random.default_rng(5).integers(0, 256, (64, frame_bytes), np.uint8)
    paths = [tmp_path / f"{i}.raw" for i in range(64)]
    for p, fr in zip(paths, frames):
        p.write_bytes(fr.tobytes())
    buf, ok = _read_mt(paths, frame_bytes, threads)
    assert ok.all()
    np.testing.assert_array_equal(buf, frames)
    pngs = [tmp_path / f"{i}.png" for i in range(64)]
    imgs = frames.reshape(64, 3, 5, 3)
    assert _write_png_batch_mt(pngs, imgs, threads).all()
    for p, img in zip(pngs, imgs):
        np.testing.assert_array_equal(imread_bgr(p), img)


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        native.read_raw_batch([], -1)
    with pytest.raises(ValueError):
        native.destride_plane(bytes(16), -1, 2, 2, 4, 1)


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


PNG_SHAPES = [(1, 1), (3, 5), (64, 80), (1, 1, 3), (3, 5, 3), (64, 80, 3)]


@pytest.mark.parametrize("shape", PNG_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_write_png_bytes_match_jax(jax_lib, tmp_path, shape):
    img = _image(shape, sum(shape))
    assert native.write_png(tmp_path / "port.png", img)
    assert jax_native.write_png(tmp_path / "jax.png", img)
    got = (tmp_path / "port.png").read_bytes()
    assert got == (tmp_path / "jax.png").read_bytes()
    if native.runtime_info()["zlib_runtime"] == zlib.ZLIB_RUNTIME_VERSION:
        assert got == encode_png(img)
    back = imread_bgr(tmp_path / "port.png")
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=-1)
    np.testing.assert_array_equal(back, want)


@pytest.mark.parametrize("shape", [(3, 1, 1), (4, 3, 5), (5, 64, 80), (3, 1, 1, 3),
                                   (4, 3, 5, 3), (5, 64, 80, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_write_png_batch_bytes_match_jax(jax_lib, tmp_path, shape):
    imgs = _image(shape, len(shape))
    n = shape[0]
    port = [tmp_path / f"port_{i}.png" for i in range(n)]
    jax = [tmp_path / f"jax_{i}.png" for i in range(n)]
    plain = [tmp_path / f"plain_{i}.png" for i in range(n)]
    assert native.write_png_batch(port, imgs).all()
    assert jax_native.write_png_batch(jax, imgs).all()
    assert write_png_batch_plain(plain, imgs).all()
    two = [tmp_path / f"two_{i}.png" for i in range(n)]
    assert _write_png_batch_mt(two, np.ascontiguousarray(imgs), 2).all()
    same_zlib = native.runtime_info()["zlib_runtime"] == zlib.ZLIB_RUNTIME_VERSION
    for i in range(n):
        got = port[i].read_bytes()
        assert got == jax[i].read_bytes() == two[i].read_bytes()
        if same_zlib:
            assert got == plain[i].read_bytes()
        back = imread_bgr(port[i])
        np.testing.assert_array_equal(back, imread_bgr(plain[i]))
        want = imgs[i] if imgs.ndim == 4 else np.repeat(imgs[i][..., None], 3, axis=-1)
        np.testing.assert_array_equal(back, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_imwrite_matches_jax(jax_lib, tmp_path, dtype):
    """Both packages' imwrite go through their runtime's write_png; float
    input rounds and clips the same way."""
    rng = np.random.default_rng(3)
    for name, img in (("gray", rng.uniform(-20, 280, (12, 10))),
                      ("bgr", rng.uniform(-20, 280, (12, 10, 3)))):
        img = img.astype(dtype) if dtype is np.float32 else np.clip(img, 0, 255).astype(dtype)
        imwrite(tmp_path / f"port_{name}.png", img)
        jax_imwrite(tmp_path / f"jax_{name}.png", img)
        assert ((tmp_path / f"port_{name}.png").read_bytes()
                == (tmp_path / f"jax_{name}.png").read_bytes())


def test_write_failures_raise(tmp_path):
    img = _image((4, 5, 3), 0)
    target = tmp_path / "dir.png"
    target.mkdir()  # a directory cannot be opened as a file
    assert not native.write_png(target, img)
    with pytest.raises(OSError, match="failed to write"):
        imwrite(target, img)
    with pytest.raises(ValueError):
        native.write_png(tmp_path / "a.png", img.astype(np.float32))
    with pytest.raises(ValueError):
        native.write_png_batch([tmp_path / "a.png"], img[None, ..., :2])
    ok = native.write_png_batch([tmp_path / "ok.png", target], np.stack([img, img]))
    assert ok.tolist() == [True, False]


# Buffers like the Android image planes: a Y plane with row padding, and the
# interleaved chroma of NV12 (pixel stride 2) whose last row is short.
DESTRIDE_CASES = [
    (0, 16, 12, 20, 1, 20 * 12),
    (3, 16, 12, 20, 1, 20 * 12 + 3),
    (0, 8, 6, 16, 2, 16 * 5 + 15),
    (1, 8, 6, 16, 2, 16 * 5 + 15),
    (5, 7, 9, 100, 2, 500),  # rows past the buffer's end read 0
]


@pytest.mark.parametrize("case", DESTRIDE_CASES)
def test_destride_plane_matches_jax(case):
    offset, width, height, row_stride, pixel_stride, size = case
    data = np.random.default_rng(size).integers(0, 256, size, np.uint8).tobytes()
    want = jax_destride_plane(data, offset, width, height, row_stride, pixel_stride)
    got = native.destride_plane(data, offset, width, height, row_stride, pixel_stride)
    assert got.shape == (height, width) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        destride_plane(data, offset, width, height, row_stride, pixel_stride), want)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_native_session")
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=6))
    return d


def test_load_depth_stack_matches_jax(jax_lib, session):
    """Both packages' stack loaders on one capture, after one raw file is
    made longer than a frame (both read its first frame, valid) and one
    shorter (both mark it invalid)."""
    jds = JaxDataIO(session).depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    io = DataIO(session)
    ds = io.depth.load_depth_dataset(Side.LEFT, use_cache=False)
    pc = io.depth.depth_path_config
    long = pc.get_depth_map_path(Side.LEFT, int(ds.timestamps[1]))
    short = pc.get_depth_map_path(Side.LEFT, int(ds.timestamps[4]))
    long_bytes, short_bytes = long.read_bytes(), short.read_bytes()
    try:
        long.write_bytes(long_bytes + long_bytes[:100])
        short.write_bytes(short_bytes[:-4])
        want, want_valid = JaxDataIO(session).depth.load_depth_stack(JaxSide.LEFT, jds)
        got, valid = DataIO(session).depth.load_depth_stack(Side.LEFT, ds)
    finally:
        long.write_bytes(long_bytes)
        short.write_bytes(short_bytes)
    assert valid.tolist() == [True, True, True, True, False, True]
    np.testing.assert_array_equal(valid, want_valid)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    fresh, _ = DataIO(session).depth.load_depth_stack(Side.LEFT, ds, np.array([1]))
    np.testing.assert_array_equal(fresh[0], got[1])


def test_save_bgr_batch_matches_jax(jax_lib, session, tmp_path):
    bgrs = _image((5, 72, 96, 3), 7)
    timestamps = [1000 + 33 * i for i in range(5)]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    for d in (port_dir, jax_dir):
        d.mkdir()
    assert DataIO(port_dir).color.save_bgr_batch(bgrs, Side.RIGHT, timestamps) == 5
    JaxDataIO(jax_dir).color.save_bgr_batch(bgrs, JaxSide.RIGHT, timestamps)
    port = sorted(p.relative_to(port_dir) for p in port_dir.rglob("*.png"))
    assert port == sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*.png"))
    assert len(port) == 5
    for rel in port:
        assert (port_dir / rel).read_bytes() == (jax_dir / rel).read_bytes()
    assert DataIO(port_dir).color.save_bgr_batch(bgrs[:0], Side.RIGHT, []) == 0


def test_save_bgr_batch_raises_on_a_failed_write(tmp_path):
    io = DataIO(tmp_path)
    blocker = io.color.image_path_config.get_rgb_file_path(Side.LEFT, 5)
    blocker.mkdir(parents=True)  # a directory where a PNG should go
    with pytest.raises(OSError, match="5.png"):
        io.color.save_bgr_batch(_image((2, 4, 4, 3), 1), Side.LEFT, [4, 5])


def test_runtime_info():
    info = native.runtime_info()
    assert info["threads"] >= 1
    assert info["zlib_compiled"] and info["zlib_runtime"] and info["gxx"]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "mqio.cpp"
    bad.write_text("int mqio_read_file( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Builds that start together (xdist workers, process-group ranks)
    each compile to a name of their own and move it into place."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    errors = []

    def run():
        try:
            native.build(force=True)
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    built = list((tmp_path / "build").iterdir())
    assert [p.name for p in built] == [native._lib_path().name]
    lib = native.load(built[0])
    assert lib.mqio_default_threads() >= 1
