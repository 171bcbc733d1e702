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
from mq3d_tpu_torch.ops import raycast as rc
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume, state_from_numpy
from mq3d_tpu_torch.testing import raycast_scenes as scenes

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
# (built by mq3d_tpu_torch/testing/raycast_scenes.py, which the card's tests
# share)


def test_thin_slab():
    from scipy.ndimage import binary_erosion

    planes, poses, T = scenes.thin_slab()
    vol = scenes.integrate_planes(planes, poses)
    gt = scenes.scene_depth(T, planes)
    z = rc.raycast_depth(vol, scenes.K_ADV, T, scenes.W, scenes.H)
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
    planes, poses, T = scenes.depth_max_wall()
    vol = scenes.integrate_planes(planes, poses)
    gt = scenes.plane_depth(T, *planes[0])
    z = rc.raycast_depth(vol, scenes.K_ADV, T, scenes.W, scenes.H)
    m = scenes.central(gt)
    assert (np.isfinite(z) & m).sum() / m.sum() > 0.97
    hit = m & np.isfinite(z)
    err = np.abs(z[hit] - gt[hit])
    assert np.median(err) < 2e-4
    assert np.quantile(err, 0.95) < 5e-4


def test_grazing_plane():
    planes, poses, T = scenes.grazing_plane()
    vol = scenes.integrate_planes(planes, poses)
    gt = scenes.plane_depth(T, *planes[0])
    z = rc.raycast_depth(vol, scenes.K_ADV, T, scenes.W, scenes.H)
    m = scenes.central(gt, far=3.4)
    assert (np.isfinite(z) & m).sum() / m.sum() > 0.85
    hit = m & np.isfinite(z)
    err = np.abs(z[hit] - gt[hit])
    assert np.median(err) < 1.5e-3
    assert np.quantile(err, 0.95) < 0.12


def test_u16_stream_matches_f32():
    planes, poses, views = scenes.wall_views()
    vol = scenes.integrate_planes(planes, poses)
    n = len(views)
    ds = scenes.camera_dataset(views)
    f32 = list(rc.raycast_in_color_view(vol, ds, frames_per_batch=2))
    u16 = list(rc.raycast_in_color_view(vol, ds, frames_per_batch=2, transfer_u16=True))
    assert len(f32) == len(u16) == n
    # The generator renders what raycast_depth_batch renders.
    batch = rc.raycast_depth_batch(vol, ds.get_render_intrinsic_matrices()[:2],
                                   ds.transforms.extrinsics_wc[:2], scenes.W, scenes.H)
    np.testing.assert_array_equal(f32[0], batch[0])
    np.testing.assert_array_equal(f32[1], batch[1])
    step = vol.cfg.depth_max * 1.5 / 65534.0
    for a, b in zip(f32, u16):
        assert b.dtype == np.float32 and np.isfinite(a).mean() > 0.5
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        m = np.isfinite(a)
        assert np.abs(a[m] - b[m]).max() <= step * 0.5 + 1e-6


# -- K6's route: a CPU volume takes the plain march and refine ---------------

def test_cpu_render_launches_no_k6_and_matches_jax(monkeypatch, loaded, volumes):
    """A CPU render never calls K6's wrappers, launches nothing, and still
    equals the JAX package within the tolerances above."""
    from mq3d_tpu_torch.kernels import _build

    ds, *_, K, T_wc = loaded
    jv, tv = volumes
    for name in ("march_base", "march_fine"):
        monkeypatch.setattr(rc, name, lambda *a, name=name: pytest.fail(f"{name} called"))
    _build.reset_launch_counts()
    w, h = int(ds.widths[0]), int(ds.heights[0])
    got = rc.raycast_depth_batch(tv, K[:4], T_wc[:4], w, h)
    assert _build.launch_counts()["ray_march"] == 0
    assert_depth_close(jax_rc.raycast_depth_batch(jv, K[:4], T_wc[:4], w, h), got)
    with rc._plain_path():
        np.testing.assert_array_equal(rc.raycast_depth_batch(tv, K[:4], T_wc[:4], w, h), got)
