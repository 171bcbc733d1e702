"""mq3d_tpu_torch's mesh evaluation on the card against the same code on
the CPU.

Marked `cuda`: they skip without an NVIDIA GPU.  This file imports neither
jax nor mq3d_tpu, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_eval.py

Tolerance: identical.  nearest_distances forms every term with correctly
rounded float32 operations (its fused multiply-adds through ops/tsdf.py's
`_fma`, the square root in float64), so the card and the CPU give the same
bits, as the CPU gives the JAX package's (tests/test_torch_eval.py).
"""

import numpy as np
import pytest
import torch

from mq3d_tpu_torch.eval import metrics


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,center", [(5000, 3000, 0.0), (300, 9000, 5.0),
                                        (4096, 17, 20.0), (20000, 20000, 1.0)])
@pytest.mark.parametrize("tiles", [(None, None), (700, 1000)], ids=["default", "small"])
def test_nearest_distances_card_equals_cpu(cuda_device, n, m, center, tiles):
    rng = np.random.default_rng(n + m)
    src = (rng.normal(size=(n, 3)) + center).astype(np.float32)
    tgt = (rng.normal(size=(m, 3)) + center).astype(np.float32)
    card = metrics.nearest_distances(src, tgt, *tiles, device=cuda_device)
    cpu = metrics.nearest_distances(src, tgt, *tiles, device="cpu")
    np.testing.assert_array_equal(card, cpu)


@pytest.mark.cuda
def test_nearest_distances_ignore_tf32(cuda_device):
    """The caller's TF32 matmul setting does not reach the distances."""
    rng = np.random.default_rng(1)
    src = (rng.normal(size=(3000, 3)) + 3.0).astype(np.float32)
    tgt = (rng.normal(size=(2000, 3)) + 3.0).astype(np.float32)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        on = metrics.nearest_distances(src, tgt, device=cuda_device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    np.testing.assert_array_equal(on, metrics.nearest_distances(src, tgt, device="cpu"))


@pytest.mark.cuda
def test_compare_point_clouds_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(2)
    gt = rng.uniform(-2, 2, size=(6000, 3))
    pred = gt[rng.permutation(6000)[:4000]] + rng.normal(scale=0.05, size=(4000, 3))
    assert (metrics.compare_point_clouds(pred, gt, device=cuda_device)
            == metrics.compare_point_clouds(pred, gt, device="cpu"))
