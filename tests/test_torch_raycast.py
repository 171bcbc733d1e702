"""mq3d_tpu_torch raycast (color-aligned depth rendering) against the JAX
package and against analytic truth, on the CPU.

Parity: both packages render from the *same* volume (the JAX package
integrates the voxel-0.04 scene of tests/test_confidence_raycast.py:161-172
and its state moves into the port through `state_from_numpy`).  Tolerances:
hit/miss equal on >= 99.9 % of pixels, and |dz| <= 1e-4 m on >= 99.9 % of
the pixels both hit.  The scene-prep tables (slot distance field, packed
f16 z-pair table, AABB) are equal bit for bit.

Analytic: the port alone, with the thresholds of the JAX package's own tests
(tests/test_confidence_raycast.py TestRaycast and
tests/test_raycast_adversarial.py's thin slab, far wall and grazing plane),
on volumes the port integrates itself.  The uint16 readback equals the
float32 maps within half a quantization step, and `_upsample_bilinear`
equals jax.image.resize within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.models.transforms import CoordinateSystem as JaxCS
from mq3d_tpu.ops import raycast as jax_rc
from mq3d_tpu.ops.tsdf import TSDFConfig as JaxConfig
from mq3d_tpu.ops.tsdf import TSDFVolume as JaxVolume
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.geometry.coordinates import CoordinateSystem
from mq3d_tpu_torch.models.datasets import CameraDataset
from mq3d_tpu_torch.models.transforms import Transforms
from mq3d_tpu_torch.ops import raycast as rc
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume, state_from_numpy

torch.set_num_threads(1)

SMALL = dict(voxel_size=0.04, block_resolution=16, block_count=2048, grid_dim=16,
             depth_max=4.0, trunc_voxel_multiplier=4.0, chunk_active_capacity=2048,
             integrate_tile=256)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rc_proj")
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=8, sweep=1.0))
    io = JaxDataIO(d)
    ds = io.depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    depth, valid = io.depth.load_depth_stack(JaxSide.LEFT, ds)
    K = ds.get_render_intrinsic_matrices().astype(np.float32)
    T_wc = np.linalg.inv(ds.transforms.extrinsics_cw.astype(np.float32))
    return ds, depth, valid, K, T_wc


@pytest.fixture(scope="module")
def volumes(loaded):
    _, depth, valid, K, T_wc = loaded
    jv = JaxVolume(JaxConfig(**SMALL))
    jv.integrate(depth, K, T_wc, valid)
    state = {k: np.array(v) for k, v in jv.state._asdict().items()}
    cfg = TSDFConfig(**SMALL)
    return jv, TSDFVolume(cfg, state_from_numpy(cfg, state, "cpu"))


def assert_depth_close(want, got):
    fw, fg = np.isfinite(want), np.isfinite(got)
    assert fw.mean() > 0.5
    assert (fw == fg).mean() >= 0.999
    both = fw & fg
    assert (np.abs(got[both] - want[both]) <= 1e-4).mean() >= 0.999


def test_prepare_scene_matches_jax(volumes):
    jv, tv = volumes
    n_bucket = 256
    want = jax_rc.prepare_scene(jv.cfg, jv.state, n_bucket)
    got = rc.prepare_scene(tv.cfg, tv.state, n_bucket)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (got[0] < 0).any() and (got[0] >= 0).any()


# Render sizes that give each pyramid the default scale choice builds: the
# capture's 80x64 (levels 8, 4, 2, 1), 84x60 (4, 2, 1) and 81x63 (1 only),
# with the intrinsics scaled to the size.
@pytest.mark.parametrize("size", [(80, 64), (84, 60), (81, 63)], ids=["8421", "421", "1"])
def test_depth_matches_jax(loaded, volumes, size):
    ds, *_, K, T_wc = loaded
    jv, tv = volumes
    w, h = size
    K = K[:3].copy()
    K[:, 0] *= np.float32(w / int(ds.widths[0]))
    K[:, 1] *= np.float32(h / int(ds.heights[0]))
    assert rc._pyramid_scales(w, h) == {"80": [8, 4, 2, 1], "84": [4, 2, 1],
                                        "81": [1]}[str(w)]
    want = jax_rc.raycast_depth_batch(jv, K, T_wc[:3], w, h)
    got = rc.raycast_depth_batch(tv, K, T_wc[:3], w, h)
    assert got.shape == want.shape == (3, h, w) and got.dtype == np.float32
    assert_depth_close(want, got)


def test_depth_matches_analytic(loaded, volumes):
    ds, depth, _, K, T_wc = loaded
    _, tv = volumes
    rendered = rc.raycast_depth(tv, K[0], T_wc[0], int(ds.widths[0]), int(ds.heights[0]))
    analytic = depth[0]
    hit = np.isfinite(rendered) & (analytic > 0) & (analytic < 3.9)
    assert hit.mean() > 0.7
    err = np.abs(rendered[hit] - analytic[hit])
    assert np.median(err) < 0.04  # within one voxel
    assert np.quantile(err, 0.9) < 0.1


def test_scene_cache_follows_the_volume(loaded):
    """The prep cache keys on the volume's revision: integrating more
    frames changes the rendered depth, as a fresh volume's render shows."""
    ds, depth, valid, K, T_wc = loaded
    w, h = int(ds.widths[0]), int(ds.heights[0])
    tv = TSDFVolume(TSDFConfig(**SMALL), device="cpu")
    tv.integrate(depth[:2], K[:2], T_wc[:2], valid[:2])
    first = rc.raycast_depth(tv, K[5], T_wc[5], w, h)
    tv.integrate(depth[2:], K[2:], T_wc[2:], valid[2:])
    again = rc.raycast_depth(tv, K[5], T_wc[5], w, h)
    fresh = TSDFVolume(TSDFConfig(**SMALL), device="cpu")
    fresh.integrate(depth[:2], K[:2], T_wc[:2], valid[:2])
    fresh.integrate(depth[2:], K[2:], T_wc[2:], valid[2:])
    np.testing.assert_array_equal(again, rc.raycast_depth(fresh, K[5], T_wc[5], w, h))
    assert not np.array_equal(first, again, equal_nan=True)


@pytest.mark.parametrize("f", [2, 4, 8])
def test_upsample_matches_jax_image_resize(f):
    x = np.random.default_rng(0).standard_normal((3, 24, 16)).astype(np.float32)
    t = torch.from_numpy(x)
    got = rc._upsample_bilinear(rc._upsample_bilinear(t, f, axis=1), f, axis=2)
    want = jax.image.resize(jnp.asarray(x), (3, 24 * f, 16 * f), method="linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_pools_and_shift_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 7, 9)).astype(np.float32)
    x[0, 3, 4] = np.inf
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(rc._min_pool3(t).numpy(), np.asarray(jax_rc._min_pool3(x)))
    np.testing.assert_array_equal(rc._max_pool3(t).numpy(), np.asarray(jax_rc._max_pool3(x)))
    for d, axis in ((1, 1), (-1, 2), (2, 2)):
        np.testing.assert_array_equal(rc._shift_clamped(t, d, axis).numpy(),
                                      np.asarray(jax_rc._shift_clamped(x, d, axis)))


# -- the edge budget's overflow against the JAX package ----------------------
#
# A volume of the first 3 frames only: views 3-7 look at walls it never
# saw, and every miss is an edge pixel at every level, so at 160x128 their
# edge sets outgrow the budget (a forced edge_cap of 1024, below the 4096
# floor of the per-level caps).  Both packages must count the same
# overflow per view and per batch, and the pixels left out of the re-march
# keep the same upsampled depth.  Tolerances as assert_depth_close.

OVERFLOW_VIEWS = [3, 4, 5, 6, 7]
OVERFLOW_SIZE = (160, 128)
OVERFLOW_CAP = 1024


@pytest.fixture(scope="module")
def partial_volumes(loaded):
    ds, depth, valid, K, T_wc = loaded
    jv = JaxVolume(JaxConfig(**SMALL))
    jv.integrate(depth[:3], K[:3], T_wc[:3], valid[:3])
    state = {k: np.array(v) for k, v in jv.state._asdict().items()}
    cfg = TSDFConfig(**SMALL)
    w, h = OVERFLOW_SIZE
    K = K.copy()
    K[:, 0] *= np.float32(w / int(ds.widths[0]))
    K[:, 1] *= np.float32(h / int(ds.heights[0]))
    return jv, TSDFVolume(cfg, state_from_numpy(cfg, state, "cpu")), K, T_wc


def _jax_render(jv, K, T_wc, edge_cap):
    """JAX `_render_frames` as its `_render_frames_device` calls it, with
    an explicit edge_cap."""
    slot_dist, ext, aabb, n_bucket = jax_rc._prep_cache.get(jv)
    T_cw = np.linalg.inv(np.asarray(T_wc, np.float64)).astype(np.float32)
    z, overflow = jax_rc._render_frames(
        jv.cfg, slot_dist, ext, aabb, n_bucket, jnp.asarray(K, jnp.float32),
        jnp.asarray(T_cw[:, :3, :3]), jnp.asarray(np.ascontiguousarray(T_cw[:, :3, 3])),
        jnp.float32(0.05), jnp.float32(jv.cfg.depth_max * 1.5), *OVERFLOW_SIZE,
        edge_cap, jnp.float32(1e-3))
    return np.asarray(z), int(overflow)


def _port_render(tv, K, T_wc, edge_cap):
    z, overflow = rc._render_frames_device(tv, K, T_wc, *OVERFLOW_SIZE, edge_cap=edge_cap)
    return z.numpy(), int(overflow)


def _assert_overflow_matches(jv, tv, K, T_wc):
    want, want_over = _jax_render(jv, K, T_wc, OVERFLOW_CAP)
    got, over = _port_render(tv, K, T_wc, OVERFLOW_CAP)
    assert over == want_over > 0
    assert_depth_close(want, got)
    # The pixels the budget left out: where the capped render differs from
    # one whose budget covers every edge pixel.
    full, full_over = _port_render(tv, K, T_wc, 1 << 30)
    assert full_over < over
    left_out = ~((full == got) | (np.isinf(full) & np.isinf(got)))
    assert left_out.sum() > 100
    w, g = want[left_out], got[left_out]
    fw, fg = np.isfinite(w), np.isfinite(g)
    assert fw.mean() > 0.5
    assert (fw == fg).mean() >= 0.999
    both = fw & fg
    assert (np.abs(g[both] - w[both]) <= 1e-4).mean() >= 0.999
    return over


@pytest.mark.parametrize("view", OVERFLOW_VIEWS)
def test_edge_overflow_per_view_matches_jax(partial_volumes, view):
    jv, tv, K, T_wc = partial_volumes
    _assert_overflow_matches(jv, tv, K[[view]], T_wc[[view]])


def test_edge_overflow_of_a_batch_matches_jax(partial_volumes):
    """One call for the five views: the budget is the batch's, filled by
    flat index, so its count is not the sum of the views'."""
    jv, tv, K, T_wc = partial_volumes
    over = _assert_overflow_matches(jv, tv, K[OVERFLOW_VIEWS], T_wc[OVERFLOW_VIEWS])
    per_view = sum(_port_render(tv, K[[v]], T_wc[[v]], OVERFLOW_CAP)[1]
                   for v in OVERFLOW_VIEWS)
    assert over != per_view


# -- analytic scenes of tests/test_raycast_adversarial.py, on the port --------

W, H = 320, 240
FX = FY = 260.0
K_ADV = np.array([[FX, 0, W / 2], [0, FY, H / 2], [0, 0, 1]], np.float32)
CFG_ADV = TSDFConfig(voxel_size=0.01, block_resolution=16, block_count=16384, grid_dim=64,
                     depth_max=4.0, trunc_voxel_multiplier=10.0,
                     chunk_active_capacity=8192, integrate_tile=256)


def _rays():
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    return np.stack([(u - K_ADV[0, 2]) / FX, (v - K_ADV[1, 2]) / FY, np.ones_like(u)], -1)


def _lookat_T_wc(eye, target, up=(0, -1, 0)):
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T_cw = np.eye(4)
    T_cw[:3, 0], T_cw[:3, 1], T_cw[:3, 2], T_cw[:3, 3] = x, y, z, eye
    return np.linalg.inv(T_cw)


def _plane_depth(T_wc, p0, n, bounds=None):
    T_cw = np.linalg.inv(T_wc)
    dirs_w = _rays() @ T_cw[:3, :3].T
    n = np.asarray(n, np.float64)
    denom = dirs_w @ n
    num = n @ (np.asarray(p0, np.float64) - T_cw[:3, 3])
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = num / denom
    hit = (denom != 0) & (tt > 0)
    if bounds is not None:
        b = np.asarray(bounds, np.float64)
        pw = T_cw[:3, 3] + tt[..., None] * dirs_w
        hit &= np.all((pw >= b[:, 0] - 1e-9) & (pw <= b[:, 1] + 1e-9), -1)
    return np.where(hit, tt, np.inf)


def _scene_depth(T_wc, planes):
    return np.min(np.stack([_plane_depth(T_wc, *p) for p in planes]), axis=0)


def _integrate(planes, poses):
    depth = np.stack([_scene_depth(T, planes) for T in poses]).astype(np.float32)
    depth[~np.isfinite(depth)] = 0.0
    vol = TSDFVolume(CFG_ADV, device="cpu")
    vol.integrate(depth, np.tile(K_ADV[None], (len(poses), 1, 1)),
                  np.stack(poses).astype(np.float32), np.ones(len(poses), bool))
    return vol


def _central(gt, far=np.inf):
    c = np.zeros((H, W), bool)
    c[H // 6: -H // 6, W // 6: -W // 6] = True
    return c & np.isfinite(gt) & (gt < far)


def test_thin_slab():
    from scipy.ndimage import binary_erosion

    slab = ([0, 0, 1.5], [0, 0, -1.0], [[-0.15, 0.15], [-0.20, 0.20], [1.49, 1.51]])
    planes = [slab, ([0, 0, 2.5], [0, 0, -1.0], None)]
    vol = _integrate(planes, [_lookat_T_wc((x, y, 0.0), (0, 0, 1.5))
                              for x in (-0.15, 0.0, 0.15) for y in (-0.1, 0.1)])
    T = _lookat_T_wc((0.02, 0.01, 0.0), (0, 0, 1.5))
    gt = _scene_depth(T, planes)
    z = rc.raycast_depth(vol, K_ADV, T, W, H)
    on_slab = gt < 2.0
    behind = (gt > 2.0) & np.isfinite(gt)
    assert (np.isfinite(z) & on_slab).sum() / on_slab.sum() > 0.97
    assert (np.isfinite(z) & behind).sum() / behind.sum() > 0.97
    assert (behind & np.isfinite(z) & (z < 2.0)).sum() / behind.sum() < 0.005
    interior = binary_erosion(on_slab, iterations=3)
    mi = interior & np.isfinite(z)
    ei = np.abs(z[mi] - gt[mi])
    assert np.median(ei) < 1.5e-4
    assert np.quantile(ei, 0.95) < 4e-4
    band = on_slab & ~interior & np.isfinite(z)
    assert np.median(np.abs(z[band] - gt[band])) < 0.003


def test_depth_max_wall():
    wall = ([0, 0, 3.9], [0, 0, -1.0], None)
    vol = _integrate([wall], [_lookat_T_wc((x, y, 0.0), (0, 0, 3.9))
                              for x in (-0.2, 0.0, 0.2) for y in (-0.15, 0.15)])
    T = _lookat_T_wc((0.03, -0.02, 0.0), (0, 0, 3.9))
    gt = _plane_depth(T, *wall)
    z = rc.raycast_depth(vol, K_ADV, T, W, H)
    m = _central(gt)
    assert (np.isfinite(z) & m).sum() / m.sum() > 0.97
    hit = m & np.isfinite(z)
    err = np.abs(z[hit] - gt[hit])
    assert np.median(err) < 2e-4
    assert np.quantile(err, 0.95) < 5e-4


def test_grazing_plane():
    n = np.array([np.sin(np.deg2rad(78.0)), 0, -np.cos(np.deg2rad(78.0))])
    plane = ([0, 0, 2.0], n, [[-2.0, 2.0], [-2.0, 2.0], [0.6, 3.4]])
    vol = _integrate([plane], [_lookat_T_wc((x, y, 0.0), (0, 0, 2.0))
                               for x in (-0.1, 0.0, 0.1) for y in (-0.1, 0.1)])
    T = _lookat_T_wc((0.02, 0.03, 0.0), (0, 0, 2.0))
    gt = _plane_depth(T, *plane)
    z = rc.raycast_depth(vol, K_ADV, T, W, H)
    m = _central(gt, far=3.4)
    assert (np.isfinite(z) & m).sum() / m.sum() > 0.85
    hit = m & np.isfinite(z)
    err = np.abs(z[hit] - gt[hit])
    assert np.median(err) < 1.5e-3
    assert np.quantile(err, 0.95) < 0.12


def test_u16_stream_matches_f32():
    wall = ([0, 0, 3.0], [0, 0, -1.0], None)
    vol = _integrate([wall], [_lookat_T_wc((x, y, 0.0), (0, 0, 3.0))
                              for x in (-0.2, 0.0, 0.2) for y in (-0.15, 0.15)])
    views = [_lookat_T_wc((x, 0.01, 0.0), (0, 0, 3.0)) for x in (-0.05, 0.0, 0.05)]
    T_cw = np.linalg.inv(np.stack(views))
    n = len(views)
    ones = np.ones(n)
    ds = CameraDataset(
        directory_relative_path="t",
        image_file_names=np.array([f"{i}.png" for i in range(n)]),
        timestamps=np.arange(n, dtype=np.int64),
        fx=FX * ones, fy=FY * ones, cx=K_ADV[0, 2] * ones, cy=K_ADV[1, 2] * ones,
        transforms=Transforms(coordinate_system=CoordinateSystem.OPEN3D,
                              positions=T_cw[:, :3, 3].astype(np.float32),
                              rotations=quat.from_matrix(T_cw[:, :3, :3])),
        widths=np.full(n, W, np.int64), heights=np.full(n, H, np.int64))
    f32 = list(rc.raycast_in_color_view(vol, ds, frames_per_batch=2))
    u16 = list(rc.raycast_in_color_view(vol, ds, frames_per_batch=2, transfer_u16=True))
    assert len(f32) == len(u16) == n
    # The generator renders what raycast_depth_batch renders.
    batch = rc.raycast_depth_batch(vol, ds.get_render_intrinsic_matrices()[:2],
                                   ds.transforms.extrinsics_wc[:2], W, H)
    np.testing.assert_array_equal(f32[0], batch[0])
    np.testing.assert_array_equal(f32[1], batch[1])
    step = vol.cfg.depth_max * 1.5 / 65534.0
    for a, b in zip(f32, u16):
        assert b.dtype == np.float32 and np.isfinite(a).mean() > 0.5
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        m = np.isfinite(a)
        assert np.abs(a[m] - b[m]).max() <= step * 0.5 + 1e-6
