"""mq3d_tpu_torch kernels K1 (patch lookup) and K2 (I420 -> BGR).

On the CPU each wrapper runs its kernel's plain PyTorch version; those are
held here against the JAX package's Pallas kernels in interpret mode and
its XLA reference.  Tolerance: exact (K1 is a pure gather, K2 integer
arithmetic on uint8).  The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from mq3d_tpu.ops.tsdf_pallas import patch_lookup as jax_patch_lookup
from mq3d_tpu.ops.yuv import yuv420_to_8uc3 as jax_yuv420_to_8uc3
from mq3d_tpu.ops.yuv_pallas import yuv420_to_bgr_pallas
from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup, patch_lookup_plain
from mq3d_tpu_torch.ops.yuv import yuv420_to_8uc3, yuv420_to_bgr

torch.set_num_threads(1)


def _patch_inputs(rng, TP, PS, V):
    patch = rng.random((TP, PS, PS), dtype=np.float32)
    vi = rng.integers(-5, PS + 5, (TP, V), dtype=np.int32)  # out-of-patch too
    ui = rng.integers(-5, PS + 5, (TP, V), dtype=np.int32)
    return patch, vi, ui


def _jax_lookup_padded(patch, vi, ui):
    """The Pallas kernel needs TP % 8 == 0 and V % 128 == 0: pad with
    out-of-patch rows/columns (which read 0.0) and crop."""
    TP, PS, _ = patch.shape
    V = vi.shape[1]
    TPp, Vp = -(-TP // 8) * 8, -(-V // 128) * 128
    pp = np.zeros((TPp, PS, PS), np.float32)
    pp[:TP] = patch
    vp = np.full((TPp, Vp), -1, np.int32)
    up = np.full((TPp, Vp), -1, np.int32)
    vp[:TP, :V] = vi
    up[:TP, :V] = ui
    return np.asarray(jax_patch_lookup(pp, vp, up, interpret=True))[:TP, :V]


@pytest.mark.parametrize("TP,PS,V", [(16, 8, 256), (13, 8, 200), (8, 16, 128), (5, 4, 77)])
def test_k1_plain_matches_pallas_interpret(rng, TP, PS, V):
    """Exact, including TP and V that are not multiples of 8 or 128."""
    patch, vi, ui = _patch_inputs(rng, TP, PS, V)
    want = _jax_lookup_padded(patch, vi, ui)
    got = patch_lookup(*map(torch.from_numpy, (patch, vi, ui)))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = patch_lookup_plain(*map(torch.from_numpy, (patch, vi, ui)))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_k1_out_of_patch_reads_zero(rng):
    patch, vi, ui = _patch_inputs(rng, 4, 8, 64)
    out = patch_lookup(*map(torch.from_numpy, (patch, vi, ui))).numpy()
    outside = (vi < 0) | (vi >= 8) | (ui < 0) | (ui >= 8)
    assert outside.any() and (~outside).any()
    assert (out[outside] == 0.0).all()
    p = np.arange(4)[:, None].repeat(64, 1)
    np.testing.assert_array_equal(out[~outside], patch[p[~outside], vi[~outside], ui[~outside]])


@pytest.mark.parametrize("h,w", [(64, 256), (48, 96)])
def test_k2_plain_matches_pallas_and_xla(rng, h, w):
    """uint8-exact against yuv420_to_bgr_pallas (interpret) and the XLA
    yuv420_to_8uc3, including shapes that are not tile-aligned."""
    y = rng.integers(0, 256, (2, h, w), np.uint8)
    u = rng.integers(0, 256, (2, h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (2, h // 2, w // 2), np.uint8)
    got = yuv420_to_bgr(*map(torch.from_numpy, (y, u, v))).numpy()
    np.testing.assert_array_equal(got, yuv420_to_bgr_pallas(y, u, v, interpret=True))
    np.testing.assert_array_equal(got, np.asarray(jax_yuv420_to_8uc3(y, u, v)))
    rgb = yuv420_to_8uc3(*map(torch.from_numpy, (y, u, v)), order="rgb").numpy()
    np.testing.assert_array_equal(rgb, np.asarray(jax_yuv420_to_8uc3(y, u, v, order="rgb")))


def test_k2_matches_opencv(rng):
    cv2 = pytest.importorskip("cv2")
    h, w = 36, 50
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    i420 = np.concatenate([y.ravel(), u.ravel(), v.ravel()]).reshape(h * 3 // 2, w)
    want = cv2.cvtColor(i420, cv2.COLOR_YUV2BGR_I420)
    got = yuv420_to_bgr(*(torch.from_numpy(p[None]) for p in (y, u, v)))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    f = torch.zeros((2, 4, 4))
    i = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        patch_lookup(f, i.long(), i)
    with pytest.raises(ValueError):
        patch_lookup(torch.zeros((2, 4, 5)), i, i)
    with pytest.raises(ValueError):
        patch_lookup(f.to("meta"), i.to("meta"), i.to("meta"))
    y = torch.zeros((1, 6, 8), dtype=torch.uint8)
    c = torch.zeros((1, 3, 4), dtype=torch.uint8)
    with pytest.raises(TypeError):
        yuv420_to_bgr(y.float(), c, c)
    with pytest.raises(ValueError):
        yuv420_to_bgr(torch.zeros((1, 5, 8), dtype=torch.uint8), c, c)
    with pytest.raises(ValueError):
        yuv420_to_bgr(y.to("meta"), c.to("meta"), c.to("meta"))


def test_cpu_calls_count_no_launch(rng):
    """The CPU path is the plain version: no kernel launch is counted."""
    _build.reset_launch_counts()
    patch, vi, ui = _patch_inputs(rng, 2, 4, 16)
    patch_lookup(*map(torch.from_numpy, (patch, vi, ui)))
    y = torch.zeros((1, 4, 4), dtype=torch.uint8)
    c = torch.zeros((1, 2, 2), dtype=torch.uint8)
    yuv420_to_bgr(y, c, c)
    assert _build.launch_counts() == {"patch_lookup": 0, "i420_to_bgr": 0}


def test_build_sources_and_flags():
    """One nvcc call over every csrc/*.cu for sm_90a; no source includes
    PyTorch's headers; the build hash follows the sources."""
    srcs = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert srcs == ["i420.cu", "patch_lookup.cu"]
    for p in _build.CSRC_DIR.glob("*.cu"):
        text = p.read_text()
        assert "torch/extension.h" not in text and "ATen" not in text
        assert "cudaGetLastError" in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build._source_hash()) == 16
