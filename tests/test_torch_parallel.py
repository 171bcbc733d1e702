"""mq3d_tpu_torch's sharded paths (parallel/sharded.py, the group paths of
ops/icp.py and recon/color_opt.py) on 2 and 4 gloo ranks of the CPU,
against the JAX package's shard_map versions on a mesh of the same size
(the conftest's virtual CPU devices) and against the port's single-process
paths.

One world per rank count runs every job once (`parallel.dryrun.rank_run`
in processes started by `spawn_ranks`, one thread each, with a deadline);
the tests compare its results.  Inputs are those of tests/test_parallel.py,
made from the same seeds.  Tolerances, as the JAX package holds its
sharded paths against its single-chip ones:

- integration: n_active and the sorted block coordinates exact, weights
  exact, tsdf within 1e-5 (the window sums add across ranks in the
  backend's order, not in frame order); partitioned == replicated bit for
  bit; every rank holds the same slot table;
- raycast: no edge overflow, within 1e-6 of the port's single-process
  render and of the JAX package's sharded render;
- confidence: counts exact, confidence within 1e-7;
- pair ICP (11 pairs, so the world pads): n_correspondences exact,
  transforms within 1e-5 of the JAX package (tests/test_torch_icp.py's
  bound), sharded == unsharded within 1e-12;
- Gauss-Newton terms: rtol 1e-6, atol 1e-8 against the port's unsharded
  terms (the JAX package's bound for its own), and within 1e-5 of the
  largest entry of the JAX package's `_sharded_gn` (the bound of
  tests/test_torch_color_opt.py: the two packages accumulate in other
  orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.models.transforms import CoordinateSystem as JaxCS
from mq3d_tpu.ops import icp as jax_icp
from mq3d_tpu.ops.tsdf import TSDFConfig as JaxConfig
from mq3d_tpu.ops.tsdf import TSDFVolume as JaxVolume
from mq3d_tpu.parallel import sharded as jax_sharded
from mq3d_tpu.recon import color_opt as jax_co
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.ops import icp
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume, create_state
from mq3d_tpu_torch.parallel import sharded
from mq3d_tpu_torch.parallel.dist import spawn_ranks
from mq3d_tpu_torch.parallel.dryrun import tiny_frames
from mq3d_tpu_torch.recon import color_opt

torch.set_num_threads(1)

_CFG = dict(voxel_size=0.05, block_resolution=16, block_count=1024, grid_dim=16,
            depth_max=4.0, trunc_voxel_multiplier=4.0, chunk_active_capacity=1024,
            integrate_tile=128)
CFG, JCFG = TSDFConfig(**_CFG), JaxConfig(**_CFG)
RAY_W, RAY_H = 64, 48
DEADLINE_S = 300


def plane_frames():
    depth, K, T, valid = tiny_frames(16)
    depth[:] = 2.0
    return depth, K, T, valid


def ray_cameras():
    Kc = np.tile(np.eye(3, dtype=np.float32), (8, 1, 1))
    Kc[:, 0, 0] = Kc[:, 1, 1] = 45.0
    Kc[:, 0, 2], Kc[:, 1, 2] = RAY_W / 2.0, RAY_H / 2.0
    Tc = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    Tc[:, 0, 3] = np.linspace(-0.2, 0.2, 8)
    return Kc, Tc


def icp_pairs(n_pairs=11, seed=0):
    """tests/test_parallel.py's pairs: known small rigid offsets."""
    rng = np.random.default_rng(seed)
    sources, targets = [], []
    for _ in range(n_pairs):
        n = int(rng.integers(400, 900))
        tgt = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        ang = rng.uniform(-0.05, 0.05)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        t = rng.uniform(-0.02, 0.02, 3)
        sources.append(((tgt - t) @ R).astype(np.float32))
        targets.append(tgt)
    return sources, targets


def gn_inputs():
    """tests/test_parallel.py's Gauss-Newton inputs."""
    rng = np.random.default_rng(2)
    n_verts, B, h, w = 500, 8, 24, 32
    verts = rng.uniform(-1, 1, (n_verts, 3)).astype(np.float32)
    K = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 20.0
    K[:, 0, 2], K[:, 1, 2] = w / 2, h / 2
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, 2, 3] = np.linspace(2.0, 3.0, B)
    return {"verts": verts, "K": K, "T": T,
            "gray": rng.random((B, h, w)).astype(np.float32),
            "gx": rng.random((B, h, w)).astype(np.float32),
            "gy": rng.random((B, h, w)).astype(np.float32),
            "target": rng.random(n_verts).astype(np.float32),
            "vis": rng.random((B, n_verts)) > 0.3}


@pytest.fixture(scope="module")
def confidence_inputs(tmp_path_factory):
    """tests/test_parallel.py's confidence inputs: 8 frames of a synthetic
    capture through the JAX package's loaders."""
    proj, _, _ = write_synthetic_project(tmp_path_factory.mktemp("conf") / "p",
                                         SyntheticSceneConfig(n_frames=8, sweep=1.0))
    io = JaxDataIO(proj)
    ds = io.depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    depth, valid = io.depth.load_depth_stack(JaxSide.LEFT, ds)
    T_cw = ds.transforms.extrinsics_cw.astype(np.float32)
    return {"depth": np.asarray(depth, np.float32),
            "K": ds.get_render_intrinsic_matrices().astype(np.float32),
            "T_cw": T_cw, "T_wc": np.linalg.inv(T_cw).astype(np.float32),
            "valid": np.asarray(valid), "refs": np.arange(8, dtype=np.int32),
            "depth_max": 4.0, "error_threshold": 0.05, "window": 2}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, confidence_inputs):
    """(n, the JAX mesh of n devices, the results of one n-rank run of
    every job)."""
    n = request.param
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    depth, K, T, valid = tiny_frames(16)
    pd, pK, pT, pv = plane_frames()
    Kc, Tc = ray_cameras()
    sources, targets = icp_pairs()
    jobs = [
        ("integrate", {"cfg": CFG, "depth": depth, "K": K, "T": T, "valid": valid,
                       "frames_per_rank_chunk": 8 // n}),
        ("raycast", {"frames": {"cfg": CFG, "depth": pd, "K": pK, "T": pT, "valid": pv,
                                "frames_per_rank_chunk": 16 // n},
                     "K": Kc, "T": Tc, "width": RAY_W, "height": RAY_H}),
        ("confidence", confidence_inputs),
        ("icp", {"sources": sources, "targets": targets, "max_corrs": [0.1] * 11,
                 "max_iteration": 20}),
        ("gn", {"inputs": gn_inputs()}),
        ("gn", {"inputs": {k: (v[:7] if k in ("K", "T", "gray", "gx", "gy", "vis") else v)
                           for k, v in gn_inputs().items()}}),
    ]
    names = ["integrate", "raycast", "confidence", "icp", "gn", "gn_ragged"]
    out = spawn_ranks("mq3d_tpu_torch.parallel.dryrun:rank_run", n, "gloo", "cpu", jobs,
                      timeout_s=DEADLINE_S)
    mesh = Mesh(np.asarray(jax.devices()[:n]), axis_names=("data",))
    return n, mesh, dict(zip(names, zip(*out)))


def _sorted_volume(coords, tsdf, weight):
    k = np.lexsort(np.asarray(coords).T)
    return np.asarray(coords)[k], np.asarray(tsdf)[k], np.asarray(weight)[k]


def assert_same_volume(got, want):
    """(coords, tsdf, weight) of the active blocks, in any slot order."""
    assert len(got[0]) == len(want[0]) > 0
    gc, gt, gw = _sorted_volume(*got)
    wc, wt, ww = _sorted_volume(*want)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gw, ww)
    np.testing.assert_allclose(gt, wt, rtol=0, atol=1e-5)


def test_integrate_matches_single_process_and_jax(world):
    n, mesh, res = world
    got = res["integrate"][0]["arrays"]
    got = (got["block_coords"], got["tsdf"], got["weight"])
    depth, K, T, valid = tiny_frames(16)
    vol = TSDFVolume(CFG, device="cpu")
    vol.integrate(depth[:8], K[:8], T[:8], valid[:8])
    vol.integrate(depth[8:], K[8:], T[8:], valid[8:])
    m = vol.n_active
    assert_same_volume(got, (vol.state.block_coords[:m].numpy(), vol.state.tsdf[:m].numpy(),
                             vol.state.weight[:m].numpy()))
    js = jax_sharded.integrate_dataset_sharded(JCFG, mesh, depth, K, T, valid,
                                               frames_per_device_chunk=8 // n)
    m = int(js.n_active)
    assert res["integrate"][0]["n_active"] == m
    assert_same_volume(got, (np.asarray(js.block_coords[:m]), np.asarray(js.tsdf[:m]),
                             np.asarray(js.weight[:m])))


def test_partitioned_equals_replicated(world):
    _, _, res = world
    for r in res["integrate"]:
        assert r["partitioned_equal"] and r["pad_rows_zero"]


def test_every_rank_holds_the_same_slot_table(world):
    n, _, res = world
    ranks = res["integrate"]
    assert len(ranks) == n
    assert len({r["digest_tables"] for r in ranks}) == 1
    assert len({(r["n_active"], r["overflow"], r["dropped_active"]) for r in ranks}) == 1
    assert len({r["digest_volume"] for r in ranks}) == 1


def test_raycast_matches_single_process_and_jax(world):
    n, mesh, res = world
    r0 = res["raycast"][0]
    assert {r["overflow"] for r in res["raycast"]} == {0} and r0["overflow_single"] == 0
    assert len({r["digest"] for r in res["raycast"]}) == 1
    assert r0["z"].shape == (8, RAY_H, RAY_W)
    np.testing.assert_allclose(r0["z"], r0["z_single"], rtol=0, atol=1e-6)
    assert np.isfinite(r0["z"]).mean() > 0.3
    pd, pK, pT, pv = plane_frames()
    jvol = JaxVolume(JCFG, jax_sharded.integrate_dataset_sharded(
        JCFG, mesh, pd, pK, pT, pv, frames_per_device_chunk=16 // n))
    Kc, Tc = ray_cameras()
    want, overflow = jax_sharded.sharded_raycast_batch(jvol, mesh, Kc, Tc, RAY_W, RAY_H)
    assert overflow == 0
    np.testing.assert_array_equal(np.isfinite(r0["z"]), np.isfinite(want))
    np.testing.assert_allclose(r0["z"], want, rtol=0, atol=1e-6)


def test_raycast_rejects_ragged_frames(monkeypatch):
    monkeypatch.setattr(sharded, "world_of", lambda group: 4)
    vol = TSDFVolume(CFG, create_state(CFG, "cpu"))
    K = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    with pytest.raises(ValueError):
        sharded.sharded_raycast_batch(vol, object(), K, T, 32, 32)


def test_confidence_matches_jax(world, confidence_inputs):
    n, mesh, res = world
    ci = confidence_inputs
    args = [jnp.asarray(ci[k]) for k in ("depth", "K", "T_cw", "T_wc", "valid", "refs")]
    want_conf, want_cnt = jax_sharded.sharded_confidence_step(mesh)(
        ci["depth_max"], ci["error_threshold"], ci["window"])(*args)
    r0 = res["confidence"][0]
    assert len({r["digest"] for r in res["confidence"]}) == 1
    np.testing.assert_array_equal(r0["count"], np.asarray(want_cnt))
    np.testing.assert_allclose(r0["confidence"], np.asarray(want_conf), rtol=0, atol=1e-7)


def test_pair_icp_matches_jax_plain_and_sharded(world):
    n, mesh, res = world
    r0 = res["icp"][0]
    assert len({r["digest"] for r in res["icp"]}) == 1
    sources, targets = icp_pairs()
    grids = [jax_icp.build_grid_nn(t, 0.1) for t in targets]
    crit = [jax_icp.ICPConvergenceCriteria(20) for _ in sources]
    for got, mesh_arg in ((r0["plain"], None), (r0["sharded"], mesh)):
        want = jax_icp.registration_icp_batch(sources, grids, [0.1] * 11, None, crit,
                                              mesh=mesh_arg, axis="data")
        np.testing.assert_array_equal(got["n"], [w.n_correspondences for w in want])
        np.testing.assert_allclose(got["T"], np.stack([w.transformation for w in want]),
                                   rtol=0, atol=1e-5)
        assert (got["fitness"] > 0.95).all()
    np.testing.assert_allclose(r0["sharded"]["T"], r0["plain"]["T"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(r0["sharded"]["n"], r0["plain"]["n"])


def test_pair_icp_unsharded_matches_per_pair():
    """registration_icp_batch (one grid per pair) == registration_icp pair by
    pair, within the float32 moments' summation order."""
    sources, targets = icp_pairs(6)
    grids = [icp.build_grid_nn(t, 0.1) for t in targets]
    crit = [icp.ICPConvergenceCriteria(20)] * 6
    batch = icp.registration_icp_batch(sources, grids, [0.1] * 6, None, crit, device="cpu")
    for i, (s, t) in enumerate(zip(sources, targets)):
        one = icp.registration_icp(s, t, 0.1, criteria=crit[i], grid=grids[i], device="cpu")
        np.testing.assert_allclose(batch[i].transformation, one.transformation, rtol=0,
                                   atol=1e-6)
        assert batch[i].n_correspondences == one.n_correspondences
        assert batch[i].fitness > 0.95


def test_gn_terms_match_unsharded_and_jax(world):
    n, mesh, res = world
    r0 = res["gn"][0]
    assert len({r["digest"] for r in res["gn"]}) == 1
    g = gn_inputs()
    names = ("verts", "K", "T", "gray", "gx", "gy", "target", "vis")
    plain = color_opt._gn_terms(*[torch.from_numpy(np.asarray(g[k])) for k in names])
    want = jax_co._sharded_gn(mesh)(*[jnp.asarray(g[k]) for k in names])
    for got, in_rank, p, w in zip(r0["sharded"], r0["plain"], plain, want):
        np.testing.assert_allclose(got, p.numpy(), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got, in_rank, rtol=1e-6, atol=1e-8)
        # The port's terms against the JAX package's, at the bound of
        # tests/test_torch_color_opt.py (1e-5 of the largest entry).
        w = np.asarray(w)
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max()


def test_gn_terms_pad_ragged_frames(world):
    """7 frames pad to the world's multiple by repeating the last (the JAX
    package's pad_ids); the padded terms are dropped."""
    _, _, res = world
    r0 = res["gn_ragged"][0]
    assert r0["frames"] == 7
    assert len({r["digest"] for r in res["gn_ragged"]}) == 1
    for got, in_rank in zip(r0["sharded"], r0["plain"]):
        assert got.shape[0] == 7
        np.testing.assert_allclose(got, in_rank, rtol=1e-6, atol=1e-8)
