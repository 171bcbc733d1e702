"""K6 (csrc/ray_march.cu, `ops.ray_march`): step 6's march and refine, one
launch a pyramid level.

On the card (marked `cuda`: they skip without an NVIDIA GPU), K6's depth
maps and edge overflow against the plain march and refine run on the card
(`raycast._plain_path`), bit for bit: test_torch_raycast.py's capture and
settings at its three pyramid shapes (80x64: levels 8, 4, 2, 1; 84x60: 4,
2, 1; 81x63: 1 only), its five-view edge-overflow batch, the thin slab, the
wall near depth_max and the grazing plane, and `raycast_in_color_view`
with and without the uint16 read-back.  Each render makes one K6 launch a
level and no host sync; K6's counters count every lane (the base level's
pixels and each fine level's cap_p * f^2 lanes), and no more hits than
lanes.

On the CPU: the wrapper refuses wrong dtypes, shapes, layouts and devices
before it builds or launches anything, and its arguments are the C entry
point's; chip_smoke's count of K6's compulsory bytes leaves the render
alone.

This file imports neither jax nor mq3d_tpu, so it runs on a machine with
the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_ray_march.py
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops import ray_march
from mq3d_tpu_torch.ops import raycast as rc
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume, state_from_numpy, state_to_numpy
from mq3d_tpu_torch.testing import raycast_scenes as scenes
from mq3d_tpu_torch.testing.synthetic import SyntheticSceneConfig, write_synthetic_project

SMALL = dict(voxel_size=0.04, block_resolution=16, block_count=2048, grid_dim=16,
             depth_max=4.0, trunc_voxel_multiplier=4.0, chunk_active_capacity=2048,
             integrate_tile=256)
OVERFLOW_VIEWS = [3, 4, 5, 6, 7]
OVERFLOW_SIZE = (160, 128)
OVERFLOW_CAP = 1024


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """test_torch_raycast.py's capture: (K, T_wc, width, height, volume of
    all 8 frames, volume of the first 3), the volumes integrated by the
    port on the CPU and moved to the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    d = tmp_path_factory.mktemp("ray_march_proj")
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=8, sweep=1.0))
    io = DataIO(d)
    ds = io.depth.load_depth_dataset(Side.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(CoordinateSystem.OPEN3D,
                                                            is_camera=True)
    depth, valid = io.depth.load_depth_stack(Side.LEFT, ds)
    K = ds.get_render_intrinsic_matrices().astype(np.float32)
    T_wc = np.linalg.inv(ds.transforms.extrinsics_cw.astype(np.float32))
    cfg = TSDFConfig(**SMALL)
    vols = []
    for n in (8, 3):
        cpu = TSDFVolume(cfg, device="cpu")
        cpu.integrate(depth[:n], K[:n], T_wc[:n], valid[:n])
        vols.append(TSDFVolume(cfg, state_from_numpy(cfg, state_to_numpy(cpu.state), "cuda")))
    return K, T_wc, int(ds.widths[0]), int(ds.heights[0]), *vols


def _scaled(K, w, h, w0, h0):
    K = K.copy()
    K[:, 0] *= np.float32(w / w0)
    K[:, 1] *= np.float32(h / h0)
    return K


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _lanes(F: int, width: int, height: int, edge_cap: int) -> dict:
    """K6's lanes per level kind as `_render_frames` sizes them: every
    pixel of the base level, and cap_p * f^2 at each fine level."""
    scales = rc._pyramid_scales(width, height)
    lanes = {"base": F * (height // scales[0]) * (width // scales[0]), "fine": 0}
    fine = scales[1:]
    for s_prev, s in zip(scales, fine):
        h_l, w_l, f = height // s, width // s, s_prev // s
        per = math.isqrt(h_l * w_l)
        mult = (rc._EDGE_MULT_FULL if s == 1 else
                rc._EDGE_MULT_MID + rc._EDGE_MULT_MID // 4 if s == fine[0] else
                rc._EDGE_MULT_MID)
        cap_l = min(max(F * mult * per, 4096), F * h_l * w_l, edge_cap)
        lanes["fine"] += max(cap_l // (f * f), 1) * f * f
    return lanes


def _render_both(vol, K, T_wc, width, height, edge_cap=None):
    """(K6's (z, overflow), the plain path's, K6's launches and counters)
    of one `_render_frames_device` call on the card; K6's call runs with
    host syncs refused."""
    rc._render_frames_device(vol, K, T_wc, width, height, edge_cap)  # prep the scene
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    ray_march.reset_ray_march_counts()
    with _no_host_sync():
        z, over = rc._render_frames_device(vol, K, T_wc, width, height, edge_cap)
    launches = _build.launch_counts()
    counts = ray_march.ray_march_counts()
    with rc._plain_path():
        z_p, over_p = rc._render_frames_device(vol, K, T_wc, width, height, edge_cap)
    return ((z.cpu().numpy(), int(over)), (z_p.cpu().numpy(), int(over_p)), launches,
            counts)


@contextlib.contextmanager
def _no_host_sync():
    """Raise on any synchronizing CUDA call inside, past the call's host
    inputs, which the wrapper copies to the card first."""
    real = rc._render_frames

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    rc._render_frames = guarded
    try:
        yield
    finally:
        rc._render_frames = real


def _assert_k6_run(launches, counts, F, width, height, edge_cap=None):
    if edge_cap is None:  # `_render_frames_device`'s default
        edge_cap = max(F * width * height // 16, 4096)
    levels = len(rc._pyramid_scales(width, height))
    assert launches["ray_march"] == levels
    assert launches["fma"] == 2 * (levels - 1)  # the edge tests only
    want = _lanes(F, width, height, edge_cap)
    for kind in ("base", "fine"):
        c = counts[kind]
        assert c["lanes"] == want[kind], (kind, c, want)
        assert 0 <= c["hits"] <= c["lanes"]
    assert counts["base"]["hits"] > 0 and counts["base"]["steps"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(80, 64), (84, 60), (81, 63)], ids=["8421", "421", "1"])
def test_k6_equals_the_plain_path_at_each_pyramid(capture, size):
    K, T_wc, w0, h0, vol, _ = capture
    w, h = size
    K = _scaled(K[:3], w, h, w0, h0)
    (z, over), (z_p, over_p), launches, counts = _render_both(vol, K, T_wc[:3], w, h)
    assert np.isfinite(z).mean() > 0.5
    assert _same_bits(z, z_p) and over == over_p
    _assert_k6_run(launches, counts, 3, w, h)


@pytest.mark.cuda
def test_k6_equals_the_plain_path_on_the_edge_overflow_batch(capture):
    """Five views of walls the 3-frame volume never saw, at 160x128 with an
    edge budget of 1024: the budget overflows and both paths count the
    same overflow and leave the same pixels upsampled."""
    K, T_wc, w0, h0, _, partial = capture
    w, h = OVERFLOW_SIZE
    K = _scaled(K[OVERFLOW_VIEWS], w, h, w0, h0)
    (z, over), (z_p, over_p), launches, counts = _render_both(
        partial, K, T_wc[OVERFLOW_VIEWS], w, h, OVERFLOW_CAP)
    assert over == over_p > 0
    assert _same_bits(z, z_p)
    _assert_k6_run(launches, counts, len(OVERFLOW_VIEWS), w, h, OVERFLOW_CAP)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(scenes.SCENES))
def test_k6_equals_the_plain_path_on_analytic_scenes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    planes, poses, T = scenes.SCENES[name]()
    vol = scenes.integrate_planes(planes, poses, device="cuda")
    K = scenes.K_ADV[None]
    (z, over), (z_p, over_p), launches, counts = _render_both(
        vol, K, T[None], scenes.W, scenes.H)
    assert np.isfinite(z).mean() > 0.3
    assert _same_bits(z, z_p) and over == over_p
    _assert_k6_run(launches, counts, 1, scenes.W, scenes.H)


@pytest.mark.cuda
@pytest.mark.parametrize("transfer_u16", [False, True], ids=["float32", "u16"])
def test_k6_equals_the_plain_path_in_color_view(transfer_u16):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    planes, poses, views = scenes.wall_views()
    vol = scenes.integrate_planes(planes, poses, device="cuda")
    ds = scenes.camera_dataset(views)
    _build.reset_launch_counts()
    got = list(rc.raycast_in_color_view(vol, ds, frames_per_batch=2,
                                        transfer_u16=transfer_u16))
    # Two calls (2 + 1 views) of 4 levels each.
    assert _build.launch_counts()["ray_march"] == 2 * len(rc._pyramid_scales(scenes.W,
                                                                              scenes.H))
    with rc._plain_path():
        want = list(rc.raycast_in_color_view(vol, ds, frames_per_batch=2,
                                             transfer_u16=transfer_u16))
    assert len(got) == len(want) == len(views)
    for a, b in zip(got, want):
        assert np.isfinite(a).mean() > 0.5 and _same_bits(a, b)


# -- the wrapper on the CPU ---------------------------------------------------

def _base_operands(device="cpu", F=2):
    cfg = TSDFConfig(**SMALL)
    n_bucket = 4
    scene = (torch.zeros(cfg.grid_dim ** 3, dtype=torch.int32, device=device),
             torch.zeros(n_bucket * 17 ** 3 + 1, dtype=torch.int32, device=device),
             torch.zeros((2, 3), device=device), n_bucket)
    K = torch.eye(3, device=device).repeat(F, 1, 1)
    return cfg, scene, K, K.clone(), torch.zeros((F, 3), device=device)


def _fine_operands(device="cpu", F=2, cap_p=5):
    cfg, scene, K, Rcw, origin = _base_operands(device, F)
    return (cfg, scene, K, Rcw, origin, torch.zeros(cap_p, dtype=torch.int64, device=device),
            torch.zeros(cap_p, device=device), torch.zeros(cap_p, device=device),
            torch.zeros((F, 8, 12), device=device))


def _call_base(ops):
    cfg, scene, K, Rcw, origin = ops
    return ray_march.march_base(cfg, scene, K, Rcw, origin, 0.05, 6.0, 8, 4, 6, 24, 3, 1)


def _call_fine(ops, f=2, n_samples=2):
    cfg, scene, K, Rcw, origin, ids, t0, thi, depth = ops
    return ray_march.march_fine(cfg, scene, K, Rcw, origin, 0.05, 6.0, 4, f, ids, t0, thi,
                                depth, 8, n_samples, 1)


def _swap(ops, i, value):
    ops = list(ops)
    ops[i] = value
    return ops


def _swap_scene(ops, i, value):
    scene = list(ops[1])
    scene[i] = value
    return _swap(ops, 1, tuple(scene))


@pytest.mark.parametrize("make,exc,match", [
    # a float32 z-pair table (it holds packed f16 pairs as int32)
    (lambda: _call_base(_swap_scene(_base_operands(), 1, torch.zeros(4 * 17 ** 3 + 1))),
     TypeError, "ext must be torch.int32"),
    (lambda: _call_base(_swap(_base_operands(), 2, torch.eye(3, dtype=torch.float64)
                              .repeat(2, 1, 1))), TypeError, "K must be torch.float32"),
    (lambda: _call_fine(_swap(_fine_operands(), 5, torch.zeros(5, dtype=torch.int32))),
     TypeError, "ids_p must be torch.int64"),
    (lambda: _call_fine(_swap(_fine_operands(), 8, torch.zeros((2, 8, 12),
                                                              dtype=torch.float64))),
     TypeError, "depth must be torch.float32"),
    (lambda: _call_base(_swap(_base_operands(), 3, torch.eye(3).repeat(2, 1, 1)
                              .transpose(1, 2))), ValueError, "Rcw must be contiguous"),
    (lambda: _call_fine(_swap(_fine_operands(), 8, torch.zeros((2, 12, 8)).transpose(1, 2))),
     ValueError, "depth must be contiguous"),
    (lambda: _call_base(_base_operands()), ValueError, "CUDA tensors on one card"),
    (lambda: _call_base(_swap(_base_operands(), 4, torch.zeros((2, 3), device="meta"))),
     ValueError, "CUDA tensors on one card"),
    (lambda: _call_base(_swap(_base_operands(), 4, torch.zeros((3, 3)))), ValueError,
     "origin must be"),
    (lambda: _call_base(_swap_scene(_base_operands(), 1,
                                    torch.zeros(5 * 17 ** 3 + 1, dtype=torch.int32))),
     ValueError, "ext must be"),  # a table of another bucket
    (lambda: _call_fine(_swap(_fine_operands(), 6, torch.zeros(4))), ValueError,
     "t0_p must be"),
    (lambda: _call_fine(_fine_operands(device="meta"), f=3), ValueError,
     "factor 3 does not divide"),
    (lambda: _call_fine(_fine_operands(device="meta"), n_samples=4), ValueError,
     "4 refine samples"),
])
def test_wrapper_refuses_before_building(monkeypatch, make, exc, match):
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the library was built"))
    _build.reset_launch_counts()
    with pytest.raises(exc, match=match):
        make()
    assert _build.launch_counts()["ray_march"] == 0


def test_wrapper_refuses_another_block_resolution(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the library was built"))
    cfg, *rest = _base_operands(device="meta")
    cfg = TSDFConfig(**dict(SMALL, block_resolution=8))
    with pytest.raises(ValueError, match="block_resolution"):
        _call_base([cfg, *rest])


@pytest.mark.parametrize("level", ["base", "fine"])
def test_launch_arguments_are_the_c_entry_points(monkeypatch, level):
    """What the wrapper hands `_build.launch`: one argument for each of
    mq3d_ray_march's but the stream, the lane count of the level, the
    parent map's shape, and the Python scalars rounded to float32 as
    PyTorch rounds them in the plain path."""
    calls = []
    monkeypatch.setattr(ray_march, "_check", lambda *a: None)  # meta tensors pass
    monkeypatch.setattr(ray_march, "_counts", {})
    monkeypatch.setattr(_build, "launch", lambda name, dev, *args: calls.append((name, args)))
    if level == "base":
        _call_base(_base_operands(device="meta"))
        lanes, cap_p, hw_p, s, f, iters, samples = 2 * 4 * 6, 0, (0, 0), 8, 0, 24, 3
    else:
        _call_fine(_fine_operands(device="meta"))
        lanes, cap_p, hw_p, s, f, iters, samples = 5 * 4, 5, (4, 6), 4, 2, 8, 2
    (name, args), = calls
    assert name == "ray_march"
    assert len(args) == len(_build._SIGNATURES["mq3d_ray_march"][1]) - 1
    assert (args[9] is not None and args[10] is not None
            and (args[6] is None) == (level == "base"))
    hw = (4, 6) if level == "base" else (8, 12)
    assert args[11:26] == (lanes, cap_p, 4, 2, *hw, *hw_p, s, f, 16, 16, iters, samples, 1)
    assert list(args[26])[:samples] == list(np.linspace(0, 1, samples, dtype=np.float32))
    cfg = TSDFConfig(**SMALL)
    f32 = np.float32
    assert args[27:] == tuple(map(float, (
        f32(cfg.voxel_size), f32(rc._inv(cfg.voxel_size)), f32(cfg.block_size),
        f32(cfg.trunc), f32(cfg.voxel_size * 0.75), f32(0.05), f32(6.0))))


def test_plain_path_is_scoped():
    assert not rc._plain_on_card
    with rc._plain_path():
        assert rc._plain_on_card
        with rc._plain_path():
            assert rc._plain_on_card
        assert rc._plain_on_card
    assert not rc._plain_on_card


def test_compulsory_bytes_leave_the_render_alone():
    """chip_smoke bounds K6 by the distinct sectors that the plain march and
    refine gather, recorded by wrapping their functions: one positive figure
    a level, within the tables' sectors plus 4 bytes a lane, and the
    scene's tables, the rendered map and the module's functions as before."""
    import chip_smoke

    planes, poses, view = scenes.thin_slab()
    vol = scenes.integrate_planes(planes, poses)
    K, T = scenes.K_ADV[None], np.asarray(view, np.float32)[None]

    def call():
        return rc._render_frames_device(vol, K, T, scenes.W, scenes.H)

    want = call()[0]
    slot_dist, ext = (t.clone() for t in rc._prep_cache.get(vol)[:2])
    functions = (rc._at, rc._sample_ids, rc._march, rc._refine)
    per_level = chip_smoke.k6_compulsory_bytes(call)
    scales = rc._pyramid_scales(scenes.W, scenes.H)
    assert len(per_level) == len(scales)
    table_bytes = (slot_dist.numel() + ext.numel()) * 4
    for s, nbytes in zip(scales, per_level):
        assert 0 < nbytes <= table_bytes + 4 * (scenes.W // s) * (scenes.H // s)
    assert (rc._at, rc._sample_ids, rc._march, rc._refine) == functions
    assert all(torch.equal(a, b) for a, b in zip(rc._prep_cache.get(vol)[:2], (slot_dist, ext)))
    assert torch.equal(call()[0], want)
