"""mq3d_tpu_torch TSDF integration and extraction against the JAX package.

Both packages integrate the same depth (the JAX package's synthetic box
room, 80x64 depth) at the small config of tests/test_tsdf.py.  Tolerances:
n_active, block_coords, slot_table, weight, overflow and dropped_active are
compared exactly; tsdf within 1e-6, the tolerance tests/test_tsdf.py uses
between loop forms; points and normals exactly after a canonical sort.

The port reproduces the reference's float32 arithmetic on the CPU (XLA's
fused multiply-adds in the projection and merge, and its LU inverse of the
extrinsics; see mq3d_tpu_torch/ops/tsdf.py), so no projected pixel moves:
were one to move, the exact weight comparison below would fail.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.models.transforms import CoordinateSystem as JaxCS
from mq3d_tpu.ops.tsdf import TSDFConfig as JaxConfig
from mq3d_tpu.ops.tsdf import TSDFVolume as JaxVolume
from mq3d_tpu.recon.integrate import integrate as jax_integrate
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops import tsdf as ttsdf
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume, state_from_numpy, state_to_numpy
from mq3d_tpu_torch.recon.integrate import integrate, tsdf_config_from_integration

torch.set_num_threads(1)

BASE = dict(voxel_size=0.05, block_resolution=16, block_count=2048, grid_dim=16,
            depth_max=4.0, trunc_voxel_multiplier=4.0, alloc_pixel_stride=2,
            chunk_active_capacity=2048, integrate_tile=256)
# Finer voxels: block footprints fit the depth patch, so the patch lookup
# (K1's plain version on the CPU) really runs instead of the flat gather.
FINE = dict(BASE, voxel_size=0.02, block_count=4096, chunk_active_capacity=4096,
            onehot_patch=32)


@pytest.fixture(scope="module")
def depth_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tsdf_proj")
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=12))
    io = JaxDataIO(d)
    ds = io.depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    depth, valid = io.depth.load_depth_stack(JaxSide.LEFT, ds)
    K = ds.get_render_intrinsic_matrices()
    T = ds.transforms.extrinsics_wc
    return d, depth, K, T, valid


def _jax_state(vol):
    # Copies: JAX donates (reuses) its state buffers on the next integrate.
    return {k: np.array(v) for k, v in vol.state._asdict().items()}


def assert_same_volume(jax_vol, port_vol):
    a, b = _jax_state(jax_vol), state_to_numpy(port_vol.state)
    for k in ("n_active", "overflow", "dropped_active", "slot_table", "block_coords", "weight"):
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b["tsdf"], a["tsdf"], rtol=0, atol=1e-6)


def _canonical(pcd):
    order = np.lexsort(np.concatenate([pcd.points, pcd.normals], 1).T[::-1])
    return pcd.points[order], pcd.normals[order]


def assert_same_points(jax_pcd, port_pcd):
    assert len(port_pcd.points) == len(jax_pcd.points)
    for a, b in zip(_canonical(jax_pcd), _canonical(port_pcd)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("base", [BASE, FINE], ids=["voxel5cm", "voxel2cm"])
@pytest.mark.parametrize("lookup", ["flat", "onehot", "pallas"])
def test_integration_matches_jax(depth_data, monkeypatch, lookup, base):
    _, depth, K, T, valid = depth_data
    patch_calls = []
    real = ttsdf.patch_lookup
    monkeypatch.setattr(ttsdf, "patch_lookup",
                        lambda *a: patch_calls.append(1) or real(*a))
    jv = JaxVolume(JaxConfig(depth_lookup=lookup, **base))
    tv = TSDFVolume(TSDFConfig(depth_lookup=lookup, **base), device="cpu")
    half = len(depth) // 2  # two chunks: chunked allocation and merging
    ttsdf.reset_lookup_tile_counts()
    for sl in (slice(0, half), slice(half, None)):
        jv.integrate(depth[sl], K[sl], T[sl], valid[sl])
        tv.integrate(depth[sl], K[sl], T[sl], valid[sl])
    assert tv.n_active > 0
    assert_same_volume(jv, tv)
    tiles = ttsdf.lookup_tile_counts()
    if lookup == "flat":
        assert tiles == {"patch": 0, "over": 0}
    else:
        assert tiles["patch"] + tiles["over"] > 0
    if lookup == "pallas":
        assert tiles["patch"] == len(patch_calls)
    if lookup == "pallas" and base is FINE:
        assert patch_calls, "the patch lookup never ran"
    for wt in (0.5, 3.0):
        assert_same_points(jv.extract_point_cloud(wt), tv.extract_point_cloud(wt))


def test_host_and_device_extraction_match_jax(depth_data):
    _, depth, K, T, valid = depth_data
    jv = JaxVolume(JaxConfig(**BASE))
    tv = TSDFVolume(TSDFConfig(**BASE), device="cpu")
    jv.integrate(depth, K, T, valid)
    tv.integrate(depth, K, T, valid)
    host = tv.extract_point_cloud(0.5, device=False)
    assert len(host.points) > 0
    assert_same_points(jv.extract_point_cloud(0.5, device=False), host)
    # Device-path output order is the reference's too.
    a, b = jv.extract_point_cloud(0.5), tv.extract_point_cloud(0.5)
    np.testing.assert_array_equal(b.points, a.points)
    np.testing.assert_array_equal(b.normals, a.normals)


def test_state_carried_across_packages(depth_data):
    """A JAX state continues in the port (state_from_numpy) and vice versa."""
    _, depth, K, T, valid = depth_data
    half = len(depth) // 2
    jcfg, tcfg = JaxConfig(**BASE), TSDFConfig(**BASE)
    jv = JaxVolume(jcfg)
    jv.integrate(depth[:half], K[:half], T[:half], valid[:half])
    tv = TSDFVolume(tcfg, state_from_numpy(tcfg, _jax_state(jv), device="cpu"))
    tv.integrate(depth[half:], K[half:], T[half:], valid[half:])
    jv.integrate(depth[half:], K[half:], T[half:], valid[half:])
    assert_same_volume(jv, tv)

    import jax.numpy as jnp
    from mq3d_tpu.ops.tsdf import TSDFState

    back = JaxVolume(jcfg, TSDFState(**{k: jnp.asarray(v) for k, v in
                                        state_to_numpy(tv.state).items()}))
    assert_same_volume(back, tv)


def test_volume_files_load_in_both_packages(depth_data, tmp_path):
    _, depth, K, T, valid = depth_data
    jv = JaxVolume(JaxConfig(**BASE))
    tv = TSDFVolume(TSDFConfig(**BASE), device="cpu")
    jv.integrate(depth, K, T, valid)
    tv.integrate(depth, K, T, valid)
    jv.save(tmp_path / "j.npz")
    tv.save(tmp_path / "t.npz")
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert_same_volume(JaxVolume.load(tmp_path / "t.npz"),
                       TSDFVolume.load(tmp_path / "j.npz", device="cpu"))
    # Open3D VoxelBlockGrid schema, both directions.
    jv.save_open3d_npz(tmp_path / "jo.npz")
    tv.save_open3d_npz(tmp_path / "to.npz")
    assert_same_volume(JaxVolume.load(tmp_path / "to.npz"),
                       TSDFVolume.load(tmp_path / "jo.npz", device="cpu"))


def _overflow_inputs():
    # One frame seeing a wall 1 m away fills far more than 4 blocks.
    depth = np.full((1, 64, 64), 1.0, np.float32)
    K = np.array([[[60.0, 0, 32.0], [0, 60.0, 32.0], [0, 0, 1]]], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
    return depth, K, T


def _overflow_kw(**kw):
    base = dict(voxel_size=0.05, block_resolution=16, block_count=2048, grid_dim=16,
                chunk_active_capacity=4, integrate_tile=4)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [
    dict(),                                            # several capacity windows
    dict(chunk_active_capacity=6, integrate_tile=2),  # ragged tiles
    dict(block_count=6),                               # pool AND window overflow
])
def test_autosplit_matches_jax(kw):
    depth, K, T = _overflow_inputs()
    jv = JaxVolume(JaxConfig(**_overflow_kw(**kw)))
    tv = TSDFVolume(TSDFConfig(**_overflow_kw(**kw)), device="cpu")
    for _ in range(2):  # second chunk: the volume already holds blocks
        jv.integrate(depth, K, T)
        tv.integrate(depth, K, T)
    assert tv.state.dropped_active == 0
    assert_same_volume(jv, tv)
    big = TSDFVolume(TSDFConfig(**_overflow_kw(**dict(kw, chunk_active_capacity=2048))),
                     device="cpu")
    big.integrate(depth, K, T)
    big.integrate(depth, K, T)
    assert big.state.overflow == tv.state.overflow  # counted once
    n = tv.n_active
    assert n > 4
    assert torch.equal(tv.state.weight[:n], big.state.weight[:n])
    assert torch.equal(tv.state.tsdf[:n], big.state.tsdf[:n])


def test_dropped_active_without_autosplit_matches_jax():
    depth, K, T = _overflow_inputs()
    jv = JaxVolume(JaxConfig(**_overflow_kw()))
    tv = TSDFVolume(TSDFConfig(**_overflow_kw()), device="cpu")
    jv.integrate(depth, K, T, auto_split=False)
    tv.integrate(depth, K, T, auto_split=False)
    assert tv.state.dropped_active > 0
    assert_same_volume(jv, tv)


def _icfg(block_count, **kw):
    c = dict(BASE, block_count=block_count, use_confidence_filtered_depth=False,
             confidence_threshold=0.0, valid_count_threshold=0, frames_per_batch=5)
    c.update(kw)
    return SimpleNamespace(**c)


def test_pool_growth_matches_jax(depth_data):
    """Exhausting block_count grows the pool and replays: same final state
    in both packages, nothing dropped."""
    proj, *_ = depth_data
    jio, tio = JaxDataIO(proj), DataIO(proj)
    jds = jio.depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    jds.transforms = jds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    tds = tio.depth.load_depth_dataset(Side.LEFT, use_cache=False)
    tds.transforms = tds.transforms.convert_coordinate_system(
        CoordinateSystem.OPEN3D, is_camera=True)
    needed = integrate(tds, tio.depth, Side.LEFT, _icfg(2048), device="cpu").n_active
    small = needed // 2 + 1
    jv = jax_integrate(dataset=jds, depth_data_io=jio.depth, side=JaxSide.LEFT,
                       config=_icfg(small))
    tv = integrate(tds, tio.depth, Side.LEFT, _icfg(small), device="cpu")
    assert tv.cfg.block_count == jv.cfg.block_count == 2 * small
    assert tv.state.overflow == 0 and tv.n_active == needed
    assert_same_volume(jv, tv)


def test_preloaded_volume_is_not_replayed(depth_data):
    proj, *_ = depth_data
    tio = DataIO(proj)
    tds = tio.depth.load_depth_dataset(Side.LEFT, use_cache=False)
    tds.transforms = tds.transforms.convert_coordinate_system(
        CoordinateSystem.OPEN3D, is_camera=True)
    cfg = _icfg(4)
    pre = TSDFVolume(tsdf_config_from_integration(cfg), device="cpu")
    depth, K, T = _overflow_inputs()
    pre.integrate(depth, K, T)
    out = integrate(tds, tio.depth, Side.LEFT, cfg, vbg_opt=pre, device="cpu")
    assert out is pre and out.cfg.block_count == 4
    assert out.state.overflow > 0  # warned, not hidden


def test_reset_and_mesh_not_ported():
    depth, K, T = _overflow_inputs()
    tv = TSDFVolume(TSDFConfig(**_overflow_kw(chunk_active_capacity=2048)), device="cpu")
    tv.integrate(depth, K, T)
    assert tv.n_active > 0
    tv.reset()
    assert tv.n_active == 0 and not tv.state.weight.any() and (tv.state.slot_table == -1).all()
    # Marching cubes is ported: empty after the reset, and after a frame is
    # integrated again, the JAX package's mesh of that frame bit for bit.  The
    # wall moves off the voxel lattice (1 m is a voxel plane, where the
    # tsdf is exactly 0 and neither device path finds a sign change).
    assert len(tv.extract_triangle_mesh(0.5).triangles) == 0
    depth = depth + np.float32(0.013)
    tv.integrate(depth, K, T)
    jv = JaxVolume(JaxConfig(**_overflow_kw(chunk_active_capacity=2048)))
    jv.integrate(depth, K, T)
    jm, tm = jv.extract_triangle_mesh(0.5), tv.extract_triangle_mesh(0.5)
    assert len(tm.triangles) > 100
    for k in ("vertices", "triangles", "vertex_normals"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k), err_msg=k)


def test_integrate_chunks_matches_jax(depth_data):
    """S chunks in one call (the JAX build's scan form) == S chunk calls."""
    import jax.numpy as jnp
    from mq3d_tpu.ops.tsdf import create_state as jax_create_state
    from mq3d_tpu.ops.tsdf import integrate_chunks as jax_integrate_chunks

    _, depth, K, T, valid = depth_data
    S, C = 2, len(depth) // 2
    args = (depth[:S * C].reshape(S, C, *depth.shape[1:]), K[:S * C].reshape(S, C, 3, 3),
            T[:S * C].reshape(S, C, 4, 4).astype(np.float32), valid[:S * C].reshape(S, C))
    jcfg, tcfg = JaxConfig(**BASE), TSDFConfig(**BASE)
    jstate = jax_integrate_chunks(jcfg, jax_create_state(jcfg),
                                  *(jnp.asarray(a) for a in args))
    tstate = ttsdf.integrate_chunks(
        tcfg, ttsdf.create_state(tcfg, "cpu"),
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    assert_same_volume(JaxVolume(jcfg, jstate), TSDFVolume(tcfg, tstate))
