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
scalar indices; K4 on its vector path (contiguous or scalar operands,
16-byte aligned) and its strided path with 32-bit indices and with 64-bit
ones (an output past 2^31 elements, an operand reaching past 2^31), on
ties, near-ties and special values, and step 1 with `fma` on the card
against the same call with `fma` pointed at its plain version; K5's
volume against the tile loop's, on the card ("pallas") and on the CPU,
over several chunks, several capacity windows, invalid and depthless
frames, one-frame chunks, voxels outside their pair's patch, the uint16
stream and an NCCL world of one, with one launch a window and no host sync
inside a window's call.

Tolerance: exact (K1 and K3 are gathers, K2 integer arithmetic, K4 one
correctly rounded operation, compared as bits, NaN as NaN; K5's volumes
compared as bytes).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops import fma as fma_ops
from mq3d_tpu_torch.ops import tsdf
from mq3d_tpu_torch.ops.gather import gather, gather_plain
from mq3d_tpu_torch.ops.ray_march import march_base
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup, patch_lookup_plain
from mq3d_tpu_torch.ops.tsdf_window import (
    integrate_window, reset_window_pair_count, window_pair_count)
from mq3d_tpu_torch.ops.yuv import yuv420_to_8uc3, yuv420_to_bgr
from mq3d_tpu_torch.recon import confidence
from mq3d_tpu_torch.testing.fma_cases import compare_bits, special_triples, tie_triples


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
    empty = torch.zeros((3, 0), dtype=torch.float32, device=cuda_device)
    assert fma_ops.fma(empty, table[:1], table[0]).shape == (3, 0)
    window = {k: v.to(cuda_device) for k, v in _k5_operands().items()}
    window["wkeys"] = window["slots"] = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    integrate_window(tsdf.TSDFConfig(block_resolution=4), **window)
    cfg = tsdf.TSDFConfig(block_resolution=16, grid_dim=8)
    scene = (torch.zeros(8 ** 3, dtype=torch.int32, device=cuda_device),
             torch.zeros(17 ** 3 + 1, dtype=torch.int32, device=cuda_device),
             torch.zeros((2, 3), device=cuda_device), 1)
    no_views = torch.zeros((0, 3, 3), device=cuda_device)
    assert march_base(cfg, scene, no_views, no_views, torch.zeros((0, 3), device=cuda_device),
                      0.05, 6.0, 8, 4, 6, 24, 3, 1).shape == (0, 4, 6)
    assert _build.launch_counts() == {"patch_lookup": 0, "i420_to_bgr": 0, "gather": 0,
                                      "fma": 0, "tsdf_window": 0, "ray_march": 0}


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    """Equal as bits where `want` is not NaN (so -0.0 is not +0.0), NaN where
    it is."""
    equal, err = compare_bits(got.cpu(), want.cpu())
    assert equal, f"differs from the plain version, by up to {err}"


def _plain(a, b, c):
    """The plain version on materialised operands of the broadcast shape."""
    return fma_ops.fma_plain(*(t.expand(torch.broadcast_shapes(a.shape, b.shape, c.shape))
                             .contiguous() for t in (a, b, c)))


def _fma_kernel(a, b, c):
    """fma on the card, checked to launch K4 once."""
    before = _build.launch_counts()["fma"]
    out = fma_ops.fma(a, b, c)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fma"] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("ties", 4099), ("specials", (1 << 18) + 3),
                                    ("random", 1 << 20)])
def test_k4_kernel_matches_plain_on_hard_values(cuda_device, kind, n):
    """Ties, near-ties, subnormal, huge, infinite, NaN and signed-zero
    operands; n % 4 != 0 sends the last elements through the vector path's
    tail."""
    if kind == "ties":
        arrays = tie_triples(n)
    elif kind == "specials":
        arrays = special_triples(n)
    else:
        rng = np.random.default_rng(3)
        arrays = [(rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)).astype(np.float32)
                  for _ in range(3)]
    a, b, c = (torch.from_numpy(x).to(cuda_device) for x in arrays)
    got = _fma_kernel(a, b, c)
    _same_bits(got, fma_ops.fma_plain(a, b, c))
    _same_bits(got, fma_ops.fma_plain(a.cpu(), b.cpu(), c.cpu()))
    if kind == "specials":  # both strided paths too, on the same values
        _same_bits(_fma_kernel(a[1:], b[1:], c[1:]), fma_ops.fma_plain(a[1:], b[1:], c[1:]))
        ev = slice(None, None, 2)
        _same_bits(_fma_kernel(a[ev], b[ev], c[ev]), fma_ops.fma_plain(a[ev], b[ev], c[ev]))


def _views(case: str, dev):
    """Operands of each layout the call sites hand fma (a, b, c)."""
    g = torch.Generator(device="cpu").manual_seed(4)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    if case == "zero_dim":  # every operand 0-d, and 0-d b and c beside a full a
        return [(r(()), r(()), r(())), (r(33, 7), r(()), r(()))]
    if case == "pose_scalar":  # apply_pose in step 1: component views, pose scalars
        p = r(4, 1, 29, 31, 3)
        T = r(4, 5, 1, 1, 4, 4)
        return [(p[..., 1], T[..., 0, 1], r(4, 5, 29, 31)),
                (p[..., 2], T[..., 2, 2], (p[..., 0] * T[..., 2, 0]))]
    if case == "expanded":  # the raycast's refine: .expand()ed rows and columns
        lo, hi, w = r(37), r(37), r(16)
        dirs, org = r(37, 3), r(37, 3)
        ts = (hi - lo)[:, None].expand(-1, 16)
        return [(ts, w[None, :].expand(37, -1), lo[:, None].expand(-1, 16)),
                (dirs[:, None, :].expand(-1, 16, -1), r(37, 16)[..., None].expand(-1, -1, 3),
                 org[:, None, :].expand(-1, 16, -1))]
    if case == "non_contiguous":
        x = r(39, 24, 3)
        return [(x[..., 0], x[..., 1], x[..., 2]), (x.transpose(0, 1), r(24, 39, 3), r(3)),
                (x[::3, 1::2], x[1::3, ::2], x[2::3, 1::2])]
    if case == "unaligned":  # one element past a 16-byte boundary: no vector loads
        x = r(4097)
        return [(x[1:], x[:-1], x[1:]), (x[1:], r(()), r(4096))]
    if case == "many_dims":  # six dimensions left after merging
        x = r(2, 3, 2, 3, 2, 3)
        return [(x, x.permute(5, 4, 3, 2, 1, 0).contiguous().permute(5, 4, 3, 2, 1, 0), r(3))]
    raise KeyError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero_dim", "pose_scalar", "expanded", "non_contiguous",
                                  "unaligned", "many_dims"])
def test_k4_kernel_matches_plain_on_views(cuda_device, case):
    for a, b, c in _views(case, cuda_device):
        _same_bits(_fma_kernel(a, b, c), _plain(a, b, c))


@pytest.mark.cuda
def test_k4_rejects_seven_dimensions(cuda_device):
    x = torch.randn(2, 3, 2, 3, 2, 3, 2, device=cuda_device)
    with pytest.raises(ValueError):
        fma_ops.fma(x, x.permute(6, 5, 4, 3, 2, 1, 0).contiguous().permute(6, 5, 4, 3, 2, 1, 0),
                  x)


@pytest.mark.cuda
def test_k4_64_bit_indices(cuda_device):
    """An operand that reaches past 2^31 elements, and outputs of more than
    2^31 elements on the strided and the vector path (8.6 GB each)."""
    big = torch.empty((1 << 31) + 4096, dtype=torch.float32, device=cuda_device)
    big[:4096].normal_()
    big[-4096:].normal_()
    a = big.as_strided((2, 4096), (1 << 31, 1))  # rows 2^31 elements apart
    b, c = torch.randn(4096, device=cuda_device), torch.randn(2, 1, device=cuda_device)
    _same_bits(_fma_kernel(a, b, c), _plain(a.contiguous(), b, c))
    del big, a

    rows = (1 << 21) + 3  # rows x 1024 > 2^31
    a, b = torch.randn(1024, device=cuda_device), torch.randn((), device=cuda_device)
    c = torch.randn(rows, 1, device=cuda_device)
    out = _fma_kernel(a, b, c)
    check = torch.tensor([0, 1, rows // 2, rows - 2, rows - 1], device=cuda_device)
    _same_bits(out[check], _plain(a, b, c[check]))
    del out

    n = (1 << 31) + 5
    x, y, z = (torch.randn((), device=cuda_device) for _ in range(3))
    out = _fma_kernel(x.expand(n), y, z)
    want = fma_ops.fma_plain(x[None], y, z)
    _same_bits(out[-7:], want.expand(7))
    assert bool((out.view(torch.int32) == want.view(torch.int32)).all())


@pytest.mark.cuda
def test_k4_kernels_are_charged_to_the_fma_span(cuda_device):
    """Under a host-and-device profiler, benchmark.spans charges each K4
    launch to the "fma" span of its `fma` call (the launch's operator
    record links it), and nothing to no span."""
    from benchmark import spans

    a = torch.randn(8, 1000, device=cuda_device)
    b = torch.randn(8, 1, device=cuda_device)
    fma_ops.fma(a, b, a)  # the library built and loaded outside the trace
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fma_ops.fma(a, b, a)
        torch.cuda.synchronize()
    st = spans.attribute(spans.collect_linked(prof))
    assert st["fma"]["opened"] == 3 and st["fma"]["events"] == 3
    assert st["fma"]["self_s"] > 0
    assert spans.UNATTRIBUTED not in st


@pytest.mark.cuda
def test_k4_in_step_1_equals_the_plain_version(cuda_device, monkeypatch, tmp_path):
    """confidence_for_refs on Quest-scale depth (320x288) of the synthetic
    box room with fma on the card, against the same call with every fma
    pointed at the plain version: identical maps, and every fma of the
    call launched K4."""
    from mq3d_tpu_torch.dataio.data_io import DataIO
    from mq3d_tpu_torch.models.side import Side
    from mq3d_tpu_torch.models.transforms import CoordinateSystem
    from mq3d_tpu_torch.testing.synthetic import quest_scene, write_synthetic_project

    write_synthetic_project(tmp_path, quest_scene(n_frames=12), workers=4)
    io = DataIO(tmp_path)
    ds = io.depth.load_depth_dataset(Side.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(CoordinateSystem.OPEN3D,
                                                            is_camera=True)
    depth, valid = io.depth.load_depth_stack(Side.LEFT, ds)
    K = ds.get_render_intrinsic_matrices().astype(np.float32)
    T_cw = ds.transforms.extrinsics_cw.astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
            for x in (depth, K, T_cw, np.linalg.inv(T_cw), valid)]
    args.append(torch.arange(len(depth), device=cuda_device))
    calls = []
    fma = fma_ops.fma
    counted = lambda *t: calls.append(1) or fma(*t)  # noqa: E731
    monkeypatch.setattr(fma_ops, "fma", counted)
    monkeypatch.setattr(confidence, "fma", counted)
    _build.reset_launch_counts()
    kernel = confidence.confidence_for_refs(*args, 4.0, 0.08, 10)
    torch.cuda.synchronize()
    assert calls and _build.launch_counts()["fma"] == len(calls)
    monkeypatch.setattr(fma_ops, "fma", fma_ops.fma_plain)
    monkeypatch.setattr(confidence, "fma", fma_ops.fma_plain)
    plain = confidence.confidence_for_refs(*args, 4.0, 0.08, 10)
    assert (plain[1] > 0).float().mean() > 0.5
    for k, p in zip(kernel, plain):
        assert torch.equal(k, p)


# The sharded integration on the card (parallel/sharded.py), through K5.
# Frames of 128x96 px, so pairs have a 64 px patch.  Two gloo
# ranks share cuda:0 (NCCL refuses two ranks on one GPU); tolerances as on
# the CPU (tests/test_torch_parallel.py): weights exact, tsdf within 1e-5.

def _sharded_jobs(frames_per_rank_chunk):
    from mq3d_tpu_torch.ops.tsdf import TSDFConfig
    from mq3d_tpu_torch.parallel.dryrun import tiny_frames

    cfg = TSDFConfig(voxel_size=0.05, block_resolution=16, block_count=1024, grid_dim=16,
                     depth_max=4.0, trunc_voxel_multiplier=4.0, chunk_active_capacity=1024,
                     integrate_tile=128)
    depth, K, T, valid = tiny_frames(16, h=96, w=128)
    return cfg, (depth, K, T, valid), [("integrate", {
        "cfg": cfg, "depth": depth, "K": K, "T": T, "valid": valid,
        "frames_per_rank_chunk": frames_per_rank_chunk})]


def _volume(arrays):
    k = np.lexsort(arrays["block_coords"].T)
    return arrays["block_coords"][k], arrays["tsdf"][k], arrays["weight"][k]


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_the_cpu_world(cuda_device):
    from mq3d_tpu_torch.parallel.dist import spawn_ranks

    _build.library()  # built once, before the ranks load it
    _, _, jobs = _sharded_jobs(4)
    run = "mq3d_tpu_torch.parallel.dryrun:rank_run"
    card = spawn_ranks(run, 2, "gloo", "cuda", jobs, timeout_s=600)
    cpu = spawn_ranks(run, 2, "gloo", "cpu", jobs, timeout_s=600)
    assert len({r[0]["digest_tables"] for r in card}) == 1
    assert all(r[0]["partitioned_equal"] and r[0]["pad_rows_zero"] for r in card)
    for r in card:
        assert r[0]["modes"]["replicated"]["launches"]["tsdf_window"] > 0
    (cc, ct, cw), (pc, pt, pw) = _volume(card[0][0]["arrays"]), _volume(cpu[0][0]["arrays"])
    np.testing.assert_array_equal(cc, pc)
    np.testing.assert_array_equal(cw, pw)
    np.testing.assert_allclose(ct, pt, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_nccl_world_of_one_equals_tsdf_volume_integrate(cuda_device):
    from mq3d_tpu_torch.ops.tsdf import TSDFVolume
    from mq3d_tpu_torch.parallel.dist import spawn_ranks

    _build.library()
    cfg, (depth, K, T, valid), jobs = _sharded_jobs(8)
    (res,), = spawn_ranks("mq3d_tpu_torch.parallel.dryrun:rank_run", 1, "nccl", "cuda", jobs,
                          timeout_s=600)
    vol = TSDFVolume(cfg, device=cuda_device)
    for s in (0, 8):
        vol.integrate(depth[s:s + 8], K[s:s + 8], T[s:s + 8], valid[s:s + 8])
    n = vol.n_active
    a = res["arrays"]
    assert res["n_active"] == n and res["modes"]["replicated"]["launches"]["tsdf_window"] > 0
    assert np.array_equal(a["slot_table"], vol.state.slot_table.cpu().numpy())
    for k in ("block_coords", "tsdf", "weight"):
        assert np.array_equal(a[k], getattr(vol.state, k)[:n].cpu().numpy()), k


# The uint16 depth stream (ops/tsdf.py integrate_chunks_u16) on the card:
# bench.py's capture style (orbit depth of the box room, 320x288) at the
# production settings' 1 cm voxels, where K5 integrates, cut to 2
# groups of 3 chunks of 10 frames.  Tolerance: exact.

@pytest.mark.cuda
def test_u16_stream_on_the_card_matches_the_cpu_and_float32_paths(cuda_device):
    from mq3d_tpu_torch.config.configs import PRODUCTION_INTEGRATION
    from mq3d_tpu_torch.ops import tsdf
    from mq3d_tpu_torch.testing.synthetic import (
        SyntheticSceneConfig, intrinsics_from_cfg, orbit_poses_o3d, render_box_depth)

    n, h, w = 60, 288, 320
    scene = SyntheticSceneConfig(n_frames=n, depth_width=w, depth_height=h)
    fx, fy, cx, cy = intrinsics_from_cfg(scene, w, h)
    poses_cw = orbit_poses_o3d(scene).extrinsics_cw.astype(np.float64)
    depth = np.stack([render_box_depth(p, fx, fy, w - cx, cy, w, h, scene.box_min,
                                       scene.box_max) for p in poses_cw]).astype(np.float32)
    K = np.tile(np.array([[fx, 0, w - cx], [0, fy, cy], [0, 0, 1]], np.float32), (n, 1, 1))
    T = np.linalg.inv(poses_cw).astype(np.float32)
    valid = np.ones(n, bool)
    kw = {k: v for k, v in PRODUCTION_INTEGRATION.items() if k != "frames_per_batch"}
    cfg = tsdf.TSDFConfig(**dict(kw, block_count=8192))
    dq, scale = tsdf.quantize_depth_u16(depth, cfg.depth_max)
    dep_f = dq.astype(np.float32) * np.float32(1.0 / np.float32(scale))

    def run(device, d, u16):
        state = tsdf.create_state(cfg, device)
        for s0 in (0, 30):
            args = [torch.from_numpy(a[s0:s0 + 30].reshape(3, 10, *a.shape[1:])).to(device)
                    for a in (d, K, T, valid)]
            if u16:
                tsdf.integrate_chunks_u16(cfg, state, args[0], scale, *args[1:])
            else:
                tsdf.integrate_chunks(cfg, state, *args)
        return tsdf.state_to_numpy(state)

    _build.reset_launch_counts()
    card = run(cuda_device, dq, True)
    assert _build.launch_counts()["tsdf_window"] > 0
    assert int(card["n_active"]) > 0
    for other in (run("cpu", dq, True), run(cuda_device, dep_f, False)):
        for k in card:
            np.testing.assert_array_equal(other[k], card[k], err_msg=k)


# K5 (csrc/tsdf_window.cu): Phase B of a capacity window in one launch, the
# form "auto" takes on the card.  Each case integrates the same chunks
# three ways: "auto" on the card (K5), "pallas" on the card (the tile loop
# with K1's patch fetch) and "auto" on the CPU (the tile loop with the flat
# gather); the volumes must be equal bit for bit, counters included.  Every
# K5 call runs with synchronizing operations raising, and K5 launches once a
# window that holds blocks and never otherwise.  Frames: the box room's
# orbit depth at 320x288 (bench.py's capture style), production TSDF
# settings unless a case says otherwise.  Tolerance: exact.

def _k5_operands() -> dict:
    """K5 operands on the CPU for a 2-frame chunk of 8x10 depth and a
    window of 3 blocks of 4^3 voxels."""
    C, H, W, R, N = 2, 8, 10, 4, 5
    return dict(tsdf=torch.zeros((N, R ** 3)), weight=torch.zeros((N, R ** 3)),
                block_coords=torch.zeros((N, 3), dtype=torch.int32),
                depth=torch.ones((C, H, W)), intrinsics=torch.eye(3).expand(C, 3, 3),
                extrinsics_wc=torch.eye(4).expand(C, 4, 4),
                frame_touched=torch.zeros((C, 65), dtype=torch.bool),
                wkeys=torch.arange(3), slots=torch.arange(3))


def _box_room(n: int, h: int = 288, w: int = 320):
    from mq3d_tpu_torch.testing.synthetic import (
        SyntheticSceneConfig, intrinsics_from_cfg, orbit_poses_o3d, render_box_depth)

    scene = SyntheticSceneConfig(n_frames=n, depth_width=w, depth_height=h)
    fx, fy, cx, cy = intrinsics_from_cfg(scene, w, h)
    poses_cw = orbit_poses_o3d(scene).extrinsics_cw.astype(np.float64)
    depth = np.stack([render_box_depth(p, fx, fy, w - cx, cy, w, h, scene.box_min,
                                       scene.box_max) for p in poses_cw]).astype(np.float32)
    K = np.tile(np.array([[fx, 0, w - cx], [0, fy, cy], [0, 0, 1]], np.float32), (n, 1, 1))
    T = np.linalg.inv(poses_cw).astype(np.float32)
    return depth, K, T, np.ones(n, bool)


def _invalid_frames(n: int):
    """Chunk 0: frame 2 marked invalid, frame 5 without depth; chunk 1 all
    marked invalid; chunk 2 valid frames without any depth."""
    depth, K, T, valid = _box_room(n)
    valid[2] = False
    depth[5] = 0.0
    valid[8:12] = False
    depth[12:16] = 0.0
    return depth, K, T, valid


# case: (TSDFConfig overrides, chunks, frames, uint16 stream)
_K5_CASES = {
    "production_1cm_chunks": ({}, [(0, 10), (10, 20), (20, 30)], lambda: _box_room(30), False),
    "several_windows": ({"chunk_active_capacity": 1000}, [(0, 10), (10, 20)],
                        lambda: _box_room(20), False),
    "invalid_frames": ({}, [(0, 8), (8, 12), (12, 16)], lambda: _invalid_frames(16), False),
    "one_frame_chunks": ({}, [(0, 1), (1, 2), (2, 3)], lambda: _box_room(3), False),
    "voxels_outside_their_patch": ({"voxel_size": 0.05, "grid_dim": 64, "block_count": 4096},
                                   [(0, 10), (10, 20)], lambda: _box_room(20), False),
    "u16_stream": ({}, [(0, 10), (10, 20)], lambda: _box_room(20), True),
}


def _k5_cfg(**overrides):
    from mq3d_tpu_torch.config.configs import PRODUCTION_INTEGRATION

    kw = {k: v for k, v in PRODUCTION_INTEGRATION.items() if k != "frames_per_batch"}
    kw["block_count"] = 16384
    kw.update(overrides)
    return tsdf.TSDFConfig(**kw)


def _integrate_case(cfg, frames, chunks, device, u16: bool) -> dict:
    depth, K, T, valid = frames
    vol = tsdf.TSDFVolume(cfg, device=device)
    if u16:
        dq, scale = tsdf.quantize_depth_u16(depth, cfg.depth_max)
        stack = [torch.from_numpy(np.stack([a[c0:c1] for c0, c1 in chunks])).to(device)
                 for a in (dq, K, T, valid)]
        tsdf.integrate_chunks_u16(cfg, vol.state, stack[0], scale, *stack[1:])
    else:
        for c0, c1 in chunks:
            vol.integrate(depth[c0:c1], K[c0:c1], T[c0:c1], valid[c0:c1])
    return tsdf.state_to_numpy(vol.state)


def _same_state(got: dict, want: dict) -> None:
    for k in want:
        a, b = np.atleast_1d(got[k]), np.atleast_1d(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def _watch_k5(monkeypatch) -> list:
    """Run integrate_chunk's K5 calls with synchronizing operations raising
    (torch.cuda.set_sync_debug_mode); returns the list of their window
    sizes, filled as they run."""
    sizes = []

    def watched(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            integrate_window(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sizes.append(args[8].numel())

    monkeypatch.setattr(tsdf, "integrate_window", watched)
    return sizes


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_K5_CASES))
def test_k5_volume_equals_the_tile_path(cuda_device, monkeypatch, case):
    overrides, chunks, make_frames, u16 = _K5_CASES[case]
    cfg = _k5_cfg(**overrides)
    frames = make_frames()
    sizes = _watch_k5(monkeypatch)
    _build.reset_launch_counts()
    reset_window_pair_count()
    got = _integrate_case(cfg, frames, chunks, cuda_device, u16)
    launches, pairs = _build.launch_counts(), window_pair_count()
    monkeypatch.undo()
    assert int(got["n_active"]) > 0 and pairs > 0
    assert launches["tsdf_window"] == sum(n > 0 for n in sizes) > 0
    assert launches["patch_lookup"] == 0
    if case == "several_windows":
        assert len(sizes) > len(chunks)
    if case == "invalid_frames":
        assert 0 in sizes  # the chunk with no valid frame launched nothing
    tsdf.reset_lookup_tile_counts()
    tiles = _integrate_case(dataclasses.replace(cfg, depth_lookup="pallas"), frames, chunks,
                            cuda_device, u16)
    if case == "voxels_outside_their_patch":  # tiles the tile path gathered flat
        assert tsdf.lookup_tile_counts()["over"] > 0
    _same_state(got, tiles)
    _same_state(got, _integrate_case(cfg, frames, chunks, "cpu", u16))


@pytest.mark.cuda
def test_k5_in_an_nccl_world_of_one_equals_the_tile_path(cuda_device):
    from mq3d_tpu_torch.parallel.dist import spawn_ranks

    _build.library()
    cfg, (depth, K, T, valid), jobs = _sharded_jobs(8)
    (res,), = spawn_ranks("mq3d_tpu_torch.parallel.dryrun:rank_run", 1, "nccl", "cuda", jobs,
                          timeout_s=600)
    launches = res["modes"]["replicated"]["launches"]
    assert launches["tsdf_window"] > 0 and launches["patch_lookup"] == 0
    vol = tsdf.TSDFVolume(dataclasses.replace(cfg, depth_lookup="pallas"), device=cuda_device)
    for s in (0, 8):
        vol.integrate(depth[s:s + 8], K[s:s + 8], T[s:s + 8], valid[s:s + 8])
    n = vol.n_active
    a = res["arrays"]
    assert res["n_active"] == n > 0
    assert np.array_equal(a["slot_table"], vol.state.slot_table.cpu().numpy())
    for k in ("block_coords", "tsdf", "weight"):
        want = getattr(vol.state, k)[:n].cpu().numpy()
        assert np.array_equal(a[k].view(np.uint8), want.view(np.uint8)), k
