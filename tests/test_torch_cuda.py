"""mq3d_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU.  This file imports neither
jax nor mq3d_tpu, so it also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: exact (K1 is a gather, K2 integer arithmetic).
"""

import numpy as np
import pytest
import torch

from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup, patch_lookup_plain
from mq3d_tpu_torch.ops.yuv import yuv420_to_8uc3, yuv420_to_bgr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("TP,PS,V", [(512, 64, 4096), (13, 8, 200), (1, 128, 77)])
def test_k1_kernel_matches_plain(cuda_device, TP, PS, V):
    rng = np.random.default_rng(0)
    patch = torch.from_numpy(rng.random((TP, PS, PS), dtype=np.float32)).to(cuda_device)
    vi = torch.from_numpy(rng.integers(-5, PS + 5, (TP, V), dtype=np.int32)).to(cuda_device)
    ui = torch.from_numpy(rng.integers(-5, PS + 5, (TP, V), dtype=np.int32)).to(cuda_device)
    before = _build.launch_counts()["patch_lookup"]
    got = patch_lookup(patch, vi, ui)
    assert _build.launch_counts()["patch_lookup"] == before + 1
    assert torch.equal(got, patch_lookup_plain(patch, vi, ui))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w", [(2, 960, 1280), (3, 50, 98), (1, 2, 2)])
def test_k2_kernel_matches_plain(cuda_device, n, h, w):
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.integers(0, 256, (n, h, w), np.uint8)).to(cuda_device)
    u = torch.from_numpy(rng.integers(0, 256, (n, h // 2, w // 2), np.uint8)).to(cuda_device)
    v = torch.from_numpy(rng.integers(0, 256, (n, h // 2, w // 2), np.uint8)).to(cuda_device)
    before = _build.launch_counts()["i420_to_bgr"]
    got = yuv420_to_bgr(y, u, v)
    assert _build.launch_counts()["i420_to_bgr"] == before + 1
    assert torch.equal(got, yuv420_to_8uc3(y, u, v))


@pytest.mark.cuda
def test_empty_inputs_launch_nothing(cuda_device):
    """An empty batch returns an empty result and counts no launch."""
    _build.reset_launch_counts()
    patch = torch.zeros((0, 8, 8), dtype=torch.float32, device=cuda_device)
    idx = torch.zeros((0, 16), dtype=torch.int32, device=cuda_device)
    assert patch_lookup(patch, idx, idx).shape == (0, 16)
    y = torch.zeros((0, 4, 4), dtype=torch.uint8, device=cuda_device)
    uv = torch.zeros((0, 2, 2), dtype=torch.uint8, device=cuda_device)
    assert yuv420_to_bgr(y, uv, uv).shape == (0, 4, 4, 3)
    assert _build.launch_counts() == {"patch_lookup": 0, "i420_to_bgr": 0}
