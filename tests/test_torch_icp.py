"""Registration (ops/icp.py) of mq3d_tpu_torch against the JAX package, on
the CPU.

Tolerances: the down-samplers, the CSR grid build and the Voronoi field's
ids are exact; the nearest-neighbour ids are equal and the distances
within 1e-6 (float32 sums of squares rounded in another order); ICP
transforms and fitness within 1e-5 of both of the JAX package's batched
variants (the bound it holds its flat path against its tiled one,
tests/test_registration.py), each source stopping at the same iteration;
information matrices within 1e-4 relative (the JAX package sums them in
float32, the port in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mq3d_tpu.ops.icp as J
from mq3d_tpu_torch.geometry import se3
from mq3d_tpu_torch.ops import icp

torch.set_num_threads(1)


def make_surface(rng, n=4000):
    """tests/test_registration.py's wavy surface patch."""
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.2 * np.sin(3 * xy[:, 0]) * np.cos(2 * xy[:, 1])
    return np.stack([xy[:, 0], xy[:, 1], z], -1)


def _clouds(kind, rng):
    if kind == "surface":
        return make_surface(rng, 3000)
    return rng.uniform(0, 1, (1500, 3))


@pytest.mark.parametrize("voxel", [0.25, 0.05, 0.0125])
def test_down_samplers_exact(voxel):
    pts = make_surface(np.random.default_rng(0), 5000)
    np.testing.assert_array_equal(icp.voxel_down_sample(pts, voxel),
                                  J.voxel_down_sample(pts, voxel))
    np.testing.assert_array_equal(icp.uniform_down_sample(pts, 7), J.uniform_down_sample(pts, 7))


@pytest.mark.parametrize("kind,radius,capacity", [
    ("surface", 0.1, 32), ("cube", 0.2, 64), ("cube", 0.05, 4), ("empty", 0.1, 32)])
def test_build_grid_nn_exact(kind, radius, capacity):
    tgt = np.zeros((0, 3)) if kind == "empty" else _clouds(kind, np.random.default_rng(1))
    a, b = J.build_grid_nn(tgt, radius, capacity), icp.build_grid_nn(tgt, radius, capacity)
    for k in ("target", "order", "starts", "gmin", "dims"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(y, x, err_msg=k)
    assert (a.cell, a.capacity, a.max_occ, a.n_target) == (b.cell, b.capacity, b.max_occ, b.n_target)


@pytest.mark.parametrize("kind,radius", [("surface", 0.1), ("surface", 0.03), ("cube", 0.07)])
def test_voronoi_field_ids_exact(kind, radius):
    tgt = _clouds(kind, np.random.default_rng(2))
    a, b = J.build_voronoi_nn(tgt, radius), icp.build_voronoi_nn(tgt, radius, device="cpu")
    assert isinstance(a, J.VoroNN) and isinstance(b, icp.VoroNN)
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    assert (np.asarray(a.ids) >= 0).mean() > 0.05
    for k in ("target", "gmin", "dims"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)


def test_voronoi_falls_back_to_grid(monkeypatch):
    """Past _VORO_MAX_CELLS the builder returns the CSR grid (JAX's case at
    this cap, which its own test runs only in the slow tier at 64M cells)."""
    tgt = np.random.default_rng(3).uniform(0, 5.0, (100, 3))
    monkeypatch.setattr(icp, "_VORO_MAX_CELLS", 4096)
    monkeypatch.setattr(J, "_VORO_MAX_CELLS", 4096)
    a, b = J.build_voronoi_nn(tgt, 0.1), icp.build_voronoi_nn(tgt, 0.1, device="cpu")
    assert isinstance(a, J.GridNN) and isinstance(b, icp.GridNN)
    np.testing.assert_array_equal(b.order, a.order)


def _queries(rng):
    tgt = make_surface(rng, 3000).astype(np.float32)
    src = (make_surface(rng, 500) + rng.normal(0, 0.01, (500, 3))).astype(np.float32)
    T = se3.se3_exp(np.array([0.01, -0.02, 0.015, 0.01, -0.02, 0.005]))
    return tgt, src, T


@pytest.mark.parametrize("kind", ["grid", "voro"])
def test_nn_queries_match_jax(kind):
    tgt, src, T = _queries(np.random.default_rng(4))
    sp, n = J._pad_src(src)
    if kind == "grid":  # capacity 64: no cell is cut, so the grid is exact
        g = J.build_grid_nn(tgt, 0.1, capacity=64)
        idx_j, d_j = J._nn_query(jnp.asarray(sp), jnp.asarray(T), jnp.asarray(g.target),
                                 jnp.asarray(g.order), jnp.asarray(g.starts), jnp.asarray(g.gmin),
                                 jnp.asarray(g.dims), jnp.float32(g.cell), g.max_occ)
        grid = icp.build_grid_nn(tgt, 0.1, capacity=64).to("cpu")
    else:
        g = J.build_voronoi_nn(tgt, 0.1)
        idx_j, d_j = J._nn_query_voro(jnp.asarray(sp), jnp.asarray(T), jnp.asarray(g.target),
                                      jnp.asarray(g.ids), jnp.asarray(g.gmin),
                                      jnp.asarray(g.dims), jnp.float32(g.cell))
        grid = icp.build_voronoi_nn(tgt, 0.1, device="cpu").to("cpu")
    p = icp.apply_pose(torch.from_numpy(src), torch.from_numpy(T).float())
    idx_t, d_t = icp._query(p, grid)
    idx_j, d_j = np.asarray(idx_j)[:n], np.asarray(d_j)[:n]
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    found = np.isfinite(d_j)
    assert found.mean() > 0.9 and (np.isfinite(d_t.numpy()) == found).all()
    np.testing.assert_allclose(d_t.numpy()[found], d_j[found], rtol=0, atol=1e-6)
    if kind == "grid":  # exact nearest within the radius
        bf = np.linalg.norm(p.numpy()[:, None] - tgt[None], axis=-1).min(1)
        within = bf <= 0.1
        np.testing.assert_allclose(d_t.numpy()[within], bf[within], atol=1e-5)


def _sources(rng, target, n_src=3):
    out = []
    for k in range(n_src):
        T = se3.se3_exp(rng.normal(size=6) * 0.01)
        src = target @ T[:3, :3].T + T[:3, 3]
        out.append(src[rng.permutation(len(src))[:1500 + 100 * k]])
    return out


def _jax_batch(monkeypatch, sources, grid, max_corr, inits, max_iteration, tiled):
    with monkeypatch.context() as m:
        if tiled:
            m.setattr(J, "_VMAP_SRC_PAD_LIMIT", 512)
        return J.registration_icp_batch_shared(
            sources, grid, [max_corr] * len(sources), inits=inits,
            criteria=[J.ICPConvergenceCriteria(max_iteration)] * len(sources))


@pytest.mark.parametrize("kind", ["grid", "voro"])
def test_batched_icp_matches_both_jax_variants(monkeypatch, kind):
    rng = np.random.default_rng(5)
    target = make_surface(rng, 2000)
    sources = _sources(rng, target)
    inits = [None, se3.se3_exp(np.array([0.0, 0.01, 0.0, 0.01, 0.0, 0.0])), None]
    if kind == "grid":
        gj, gt = J.build_grid_nn(target, 0.1), icp.build_grid_nn(target, 0.1)
    else:
        gj, gt = J.build_voronoi_nn(target, 0.1), icp.build_voronoi_nn(target, 0.1, device="cpu")
    got = icp.registration_icp_batch_shared(
        sources, gt, [0.1] * 3, inits=inits,
        criteria=[icp.ICPConvergenceCriteria(30)] * 3, device="cpu")
    for tiled in (False, True):
        want = _jax_batch(monkeypatch, sources, gj, 0.1, inits, 30, tiled)
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.transformation, a.transformation, rtol=0, atol=1e-5)
            assert abs(b.fitness - a.fitness) < 1e-5 and a.fitness > 0.9
            assert abs(b.inlier_rmse - a.inlier_rmse) < 1e-5
            assert b.n_correspondences == a.n_correspondences


def test_sources_stop_at_jax_iterations(monkeypatch):
    """Every source stops at the iteration its JAX loop stops at, although
    the float32 moments are summed in another order.  A source's loop has
    stopped after k iterations when its pose equals that of a run capped
    at 8; the port's stops are found by a sweep, and the JAX package's
    poses are checked just before and at each of them (0 of 3 sources
    differ here)."""
    rng = np.random.default_rng(6)
    target = make_surface(rng, 1200)
    sources = _sources(rng, target)
    field_j = J.build_voronoi_nn(target, 0.1)
    field_t = icp.build_voronoi_nn(target, 0.1, device="cpu")

    def port(k):
        return [r.transformation for r in icp.registration_icp_batch_shared(
            sources, field_t, [0.1] * 3, device="cpu",
            criteria=[icp.ICPConvergenceCriteria(k, 1e-3, 1e-4)] * 3)]

    def jax(k):
        return [r.transformation for r in J.registration_icp_batch_shared(
            sources, field_j, [0.1] * 3,
            criteria=[J.ICPConvergenceCriteria(k, 1e-3, 1e-4)] * 3)]

    runs = {k: port(k) for k in range(9)}
    stops = [min(k for k in range(9) if np.array_equal(runs[k][i], runs[8][i]))
             for i in range(3)]
    assert all(2 <= k < 8 for k in stops), stops
    final_j = jax(8)
    for k in sorted({k for s in stops for k in (s - 1, s)}):
        poses = jax(k)
        for i, s in enumerate(stops):
            if k in (s - 1, s):
                assert np.array_equal(poses[i], final_j[i]) == (k == s), (i, k, stops)


def test_stacks_cut_by_max_stack_bytes_give_the_same_poses():
    rng = np.random.default_rng(7)
    target = make_surface(rng, 1500)
    sources = _sources(rng, target, 4)
    field = icp.build_voronoi_nn(target, 0.1, device="cpu")
    crit = [icp.ICPConvergenceCriteria(10)] * 4
    whole = icp.registration_icp_batch_shared(sources, field, [0.1] * 4, criteria=crit)
    one_by_one = icp.registration_icp_batch_shared(sources, field, [0.1] * 4, criteria=crit,
                                                   max_stack_bytes=1)
    for a, b in zip(whole, one_by_one):
        np.testing.assert_array_equal(b.transformation, a.transformation)


def test_single_pair_entries_match_jax():
    rng = np.random.default_rng(8)
    src = make_surface(rng)
    T_true = se3.se3_exp(np.array([0.03, -0.02, 0.05, 0.04, -0.03, 0.02]))
    tgt = src @ T_true[:3, :3].T + T_true[:3, 3]
    crit = [(30, 1e-6, 1e-6), (20, 1e-6, 1e-6)]
    a = J.multi_scale_icp(src, tgt, [0.1, 0.05], [J.ICPConvergenceCriteria(*c) for c in crit],
                          [0.3, 0.1])
    b = icp.multi_scale_icp(src, tgt, [0.1, 0.05], [icp.ICPConvergenceCriteria(*c) for c in crit],
                            [0.3, 0.1], device="cpu")
    np.testing.assert_allclose(b.transformation, a.transformation, rtol=0, atol=1e-5)
    assert np.linalg.norm(se3.se3_log(np.linalg.inv(T_true) @ b.transformation)) < 0.02
    assert b.fitness > 0.9

    e_j = J.evaluate_registration(src[::3], tgt, 0.05, b.transformation)
    e_t = icp.evaluate_registration(src[::3], tgt, 0.05, b.transformation, device="cpu")
    assert e_t.n_correspondences == e_j.n_correspondences > 0
    assert abs(e_t.fitness - e_j.fitness) < 1e-12
    assert abs(e_t.inlier_rmse - e_j.inlier_rmse) < 1e-6
    same = icp.evaluate_registration(src, src, 0.05, device="cpu")
    assert same.fitness == 1.0 and same.inlier_rmse < 1e-5


@pytest.mark.parametrize("kind", ["grid", "voro"])
def test_information_matrices_match_jax(kind):
    rng = np.random.default_rng(9)
    target = make_surface(rng, 3000)
    build_j = J.build_grid_nn if kind == "grid" else J.build_voronoi_nn
    gj = build_j(target, 0.05)
    gt = (icp.build_grid_nn(target, 0.05) if kind == "grid"
          else icp.build_voronoi_nn(target, 0.05, device="cpu"))
    sources = [target[rng.choice(len(target), 300 + 100 * k, replace=False)] for k in range(3)]
    sources.append(target + 100.0)  # no correspondence: the identity
    Ts = [se3.se3_exp(rng.normal(size=6) * 0.01) for _ in sources]
    want = J.get_information_matrix_batch(sources, gj, 0.05, Ts)
    got = icp.get_information_matrix_batch(sources, gt, 0.05, Ts, device="cpu")
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * np.abs(a).max())
    np.testing.assert_array_equal(got[3], np.eye(6))
    single = icp.get_information_matrix(sources[0], target, 0.05, Ts[0], grid=gt, device="cpu")
    np.testing.assert_array_equal(single, got[0])
    if kind == "grid":  # against the JAX package's float64 host sum
        ref = J.get_information_matrix(sources[0], target, 0.05, Ts[0], grid=gj)
        np.testing.assert_allclose(single, ref, rtol=0, atol=1e-9 * np.abs(ref).max())
