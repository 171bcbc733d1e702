"""mq3d_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without an NVIDIA GPU.  This file imports neither
jax nor mq3d_tpu, so it also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every in-kernel path is held bit-equal to the plain version: K1's bulk
copy and vector indices, its scalar staging (odd PS or an unaligned patch),
its scalar indices (V % 4 != 0 or unaligned rows) and its one-buffer ring
(PS > 170); K2's 16-pixel vector strips staged in shared memory (past
48 KB of it at W=8208) and its scalar strips (W % 16 != 0, rows too wide
to stage at W=38752, or unaligned planes); K3 at tables that fit shared
memory, the L2 or neither, in both out-of-range modes, with vector and
scalar indices.

Tolerance: exact (K1 and K3 are gathers, K2 integer arithmetic).
"""

import numpy as np
import pytest
import torch

from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops.gather import gather, gather_plain
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup, patch_lookup_plain
from mq3d_tpu_torch.ops.yuv import yuv420_to_8uc3, yuv420_to_bgr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _offset_view(t: torch.Tensor, elems: int) -> torch.Tensor:
    """t's values at a data pointer `elems` elements into a fresh buffer."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = buf[elems:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("TP,PS,V", [
    (512, 64, 4096), (13, 8, 200), (1, 128, 77), (7, 63, 4096), (5, 64, 4095),
    (1, 238, 512), (2, 170, 64), (3, 172, 64), (1, 1, 1), (3000, 16, 256)])
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
@pytest.mark.parametrize("offsets", [(1, 0, 0, 0), (0, 1, 2, 3), (4, 4, 4, 4)])
def test_k1_kernel_matches_plain_on_offset_views(cuda_device, offsets):
    """Patch, vi, ui at `offsets` elements past an aligned allocation: an
    odd offset takes the scalar paths, 4 keeps 16-byte alignment."""
    TP, PS, V = 9, 64, 1024
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.random((TP, PS, PS), dtype=np.float32)),
            torch.from_numpy(rng.integers(-5, PS + 5, (TP, V), dtype=np.int32)),
            torch.from_numpy(rng.integers(-5, PS + 5, (TP, V), dtype=np.int32))]
    args = [_offset_view(a.to(cuda_device), k) for a, k in zip(args, offsets)]
    assert torch.equal(patch_lookup(*args), patch_lookup_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w", [(2, 960, 1280), (3, 50, 98), (1, 2, 2),
                                   (2, 64, 1272), (1, 6, 16), (1, 4, 48),
                                   (3, 34, 1280), (1, 4, 8208), (1, 2, 38752)])
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
@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 3, 5), (16, 8, 8)])
def test_k2_kernel_matches_plain_on_offset_views(cuda_device, offsets):
    """Planes at `offsets` bytes into fresh buffers: unaligned luma or
    chroma takes the scalar strips; (16, 8, 8) keeps the vector path."""
    n, h, w = 2, 32, 64
    rng = np.random.default_rng(4)
    planes = [rng.integers(0, 256, s, np.uint8)
              for s in ((n, h, w), (n, h // 2, w // 2), (n, h // 2, w // 2))]
    y, u, v = (_offset_view(torch.from_numpy(p).to(cuda_device), k)
               for p, k in zip(planes, offsets))
    assert torch.equal(yuv420_to_bgr(y, u, v), yuv420_to_8uc3(y, u, v))


@pytest.mark.cuda
@pytest.mark.parametrize("table_mb,m,offset", [
    (16, 1 << 19, 0), (128, 1 << 19, 0), (1, 4099, 0), (1, 4096, 1), (0.1, 1, 0)])
def test_k3_kernel_matches_torch_take(cuda_device, table_mb, m, offset):
    from mq3d_tpu_torch.tools.probe_gather import make_inputs

    table, idx = make_inputs(int(table_mb * 2 ** 20) // 4, m, seed=5, device=cuda_device)
    if offset:
        idx = _offset_view(idx, offset)
    before = _build.launch_counts()["gather"]
    got = gather(table, idx)
    assert _build.launch_counts()["gather"] == before + 1
    assert torch.equal(got, gather_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,want", [
    ("fill", [0, 7, float("nan"), 7, 0, float("nan"), float("nan"), float("nan")]),
    ("clip", [0, 7, 7, 7, 0, 0, 0, 7])])
def test_k3_out_of_range_reads_nan(cuda_device, mode, want):
    """The TPU kernels' values (tools/probe_pallas_gather.py): -1 wraps to
    table[n-1] in both modes; past [-n, n) fill mode reads NaN (jnp.take)
    and clip mode clamps (x.reshape(-1)[i])."""
    table = torch.arange(8, dtype=torch.float32, device=cuda_device)
    idx = torch.tensor([0, -1, 8, 7, -8, -9, -2 ** 31, 2 ** 31 - 1], dtype=torch.int32,
                       device=cuda_device)
    got = gather(table, idx, mode).cpu()
    np.testing.assert_array_equal(got.numpy(), np.array(want, dtype=np.float32))
    assert torch.equal(got.view(torch.int32), gather_plain(table.cpu(), idx.cpu(), mode)
                       .view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("table_mb", [0.125, 16, 128])  # fits shared memory, L2, HBM
@pytest.mark.parametrize("mode", ["fill", "clip"])
@pytest.mark.parametrize("m,idx_offset,table_offset", [
    (1 << 19, 0, 0), (4099, 1, 0), (4097, 0, 3), (3, 2, 1), (1 << 19, 4, 4)])
def test_k3_matches_plain_at_every_level(cuda_device, table_mb, mode, m, idx_offset,
                                         table_offset):
    """K3 against the plain version bit for bit at a table that fits shared
    memory, one that fits the L2 and one that does not, in both modes, on
    in-range and edge indices, with vector and scalar index loads (aligned
    and offset pointers) and m not a multiple of 4."""
    from mq3d_tpu_torch.tools.probe_gather import edges as edge_values
    from mq3d_tpu_torch.tools.probe_gather import make_inputs

    table, idx = make_inputs(int(table_mb * 2 ** 20) // 4, m, seed=7, device=cuda_device)
    edges = torch.tensor(edge_values(table.numel()), dtype=torch.int32, device=cuda_device)
    pos = torch.arange(0, m, max(1, m // 64), device=cuda_device)
    idx[pos] = edges.repeat(len(pos) // 8 + 1)[:len(pos)]
    if table_offset:
        table = _offset_view(table, table_offset)
    if idx_offset:
        idx = _offset_view(idx, idx_offset)
    got = gather(table, idx, mode)
    want = gather_plain(table, idx, mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
    table = torch.zeros(16, dtype=torch.float32, device=cuda_device)
    assert gather(table, torch.zeros(0, dtype=torch.int32, device=cuda_device)).shape == (0,)
    assert _build.launch_counts() == {"patch_lookup": 0, "i420_to_bgr": 0, "gather": 0}
