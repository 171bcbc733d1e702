"""Pose-graph LM and odometry information matrices of mq3d_tpu_torch
against the JAX package, on the CPU.

Tolerances: _edge_terms (float64 residuals and jacrev Jacobians) within
1e-12; LM poses within 1e-9 with the same pruned edges, on the ring cases
of tests/test_registration.py; odometry information matrices within 1e-5
relative (the JAX package sums them in float32, the port in float64) with
equal correspondence counts and so equal loop-gate decisions.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.models.transforms import CoordinateSystem as JaxCS
from mq3d_tpu.ops import odometry as jax_odo
from mq3d_tpu.ops import posegraph as jax_pg
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.geometry import se3
from mq3d_tpu_torch.ops import odometry, posegraph

torch.set_num_threads(1)


def _poses(rng, n, scale):
    return se3.se3_exp(rng.normal(size=(n, 6)) * scale)


@pytest.mark.parametrize("seed,scale", [(0, 0.3), (1, 1.0), (2, 2.5)])
def test_edge_terms_match_jax(seed, scale):
    rng = np.random.default_rng(seed)
    E = 9
    Xs, Xt, Ti = _poses(rng, E, scale), _poses(rng, E, scale), _poses(rng, E, 0.3)
    Ti[0] = np.linalg.inv(np.linalg.inv(Xt[0]) @ Xs[0])  # a consistent edge: r = 0
    Ti[1] = np.linalg.inv(np.linalg.inv(Xt[1]) @ Xs[1]) @ se3.se3_exp(
        np.array([0.0, 0.0, 3.1, 0.1, 0.0, 0.0]))  # residual rotation near pi
    want = [np.asarray(x) for x in jax_pg._edge_terms(
        jnp.asarray(Xs), jnp.asarray(Xt), jnp.asarray(Ti))]
    got = [x.numpy() for x in posegraph._edge_terms(
        *[torch.from_numpy(x) for x in (Xs, Xt, Ti)])]
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def _ring(rng, n=12, noise=0.02):
    """tests/test_registration.py's ring: ground truth, noisy odometry
    edges and one exact uncertain loop closure."""
    gt = np.stack([se3.se3_exp(np.array([0, a, 0, np.cos(a), 0.0, np.sin(a)]))
                   for a in 2 * np.pi * np.arange(n) / n])
    edges = []
    for i in range(n - 1):
        T = np.linalg.inv(gt[i + 1]) @ gt[i]
        edges.append((i, i + 1, se3.se3_exp(rng.normal(scale=noise, size=6)) @ T, False))
    edges.append((n - 1, 0, np.linalg.inv(gt[0]) @ gt[n - 1], True))
    return gt, edges


def _graphs(gt, edges):
    init = [gt[0]]
    for i in range(len(gt) - 1):
        init.append(init[-1] @ np.linalg.inv(edges[i][2]))

    def make(mod):
        return mod.PoseGraph(nodes=[p.copy() for p in init], edges=[
            mod.PoseGraphEdge(s, t, T.copy(), np.eye(6) * 100, unc) for s, t, T, unc in edges])

    return make(jax_pg), make(posegraph)


@pytest.mark.parametrize("case", ["noisy_ring", "outlier_loop"])
def test_global_optimization_matches_jax(case):
    rng = np.random.default_rng(0)
    gt, edges = _ring(rng, noise=0.02 if case == "noisy_ring" else 0.005)
    if case == "outlier_loop":
        bad = np.eye(4)
        bad[:3, 3] = [5.0, 5.0, 5.0]
        edges.append((3, 8, bad, True))
    pj, pt = _graphs(gt, edges)
    jax_pg.global_optimization(pj, jax_pg.GlobalOptimizationOption(reference_node=0))
    posegraph.global_optimization(pt, posegraph.GlobalOptimizationOption(reference_node=0),
                                  device="cpu")
    assert [(e.source_node_id, e.target_node_id) for e in pt.edges] == \
        [(e.source_node_id, e.target_node_id) for e in pj.edges]
    assert len(pt.edges) == len(edges) - (case == "outlier_loop")
    np.testing.assert_allclose(np.stack(pt.nodes), np.stack(pj.nodes), rtol=0, atol=1e-9)
    err = [np.linalg.norm(se3.se3_log(np.linalg.inv(g) @ x)) for g, x in zip(gt, pt.nodes)]
    assert np.mean(err) < 0.05


def test_graph_without_edges_is_returned_unchanged():
    X = se3.se3_exp(np.array([0.1, 0.2, 0.3, 1.0, 2.0, 3.0]))
    pg = posegraph.PoseGraph(nodes=[X.copy()])
    assert posegraph.global_optimization(pg, device="cpu") is pg
    np.testing.assert_array_equal(pg.nodes[0], X)


@pytest.fixture(scope="module")
def depth_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_odo")
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=8, sweep=1.0))
    io = JaxDataIO(d)
    ds = io.depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    depth, _ = io.depth.load_depth_stack(JaxSide.LEFT, ds)
    K = ds.get_render_intrinsic_matrices().astype(np.float32)[0]
    yield depth, K, ds.transforms.extrinsics_cw.astype(np.float64), ds
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("dist_threshold", [0.07, 0.01])
def test_odometry_information_matches_jax(depth_scene, dist_threshold):
    depth, K, T_cw, ds = depth_scene
    pairs = np.array([(i, i + 1) for i in range(7)] + [(0, 3), (0, 6), (3, 6), (5, 2)], np.int32)
    rel = (np.linalg.inv(T_cw[pairs[:, 1]]) @ T_cw[pairs[:, 0]]).astype(np.float32)
    want, n_want = (np.asarray(x) for x in jax_odo.odometry_information_matrix_batch(
        jnp.asarray(depth), jnp.asarray(K), jnp.asarray(pairs), jnp.asarray(rel),
        dist_threshold=dist_threshold, depth_max=4.0))
    got, n_got = odometry.odometry_information_matrix_batch(
        torch.from_numpy(depth), torch.from_numpy(K), pairs, torch.from_numpy(rel),
        dist_threshold, 4.0)
    np.testing.assert_array_equal(n_got, n_want)
    assert (n_want > 300).all()
    scale = np.abs(want).max(axis=(1, 2))[:, None, None]
    assert (np.abs(got - want) <= 1e-5 * scale).all()
    area = int(ds.widths[0]) * int(ds.heights[0])
    np.testing.assert_array_equal(got[:, 5, 5] / area > 0.3, want[:, 5, 5] / area > 0.3)


def test_odometry_information_analytic():
    """tests/test_registration.py's identity and far-apart pairs."""
    rng = np.random.default_rng(0)
    h, w = 24, 32
    depth = (1.0 + 0.3 * rng.random((h, w))).astype(np.float32)
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1]], np.float32)
    d, k = torch.from_numpy(depth), torch.from_numpy(K)
    info, n = odometry.odometry_information_matrix(d, d, k, torch.eye(4), 0.07, 4.0)
    assert n == h * w
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    q = np.stack([(u - 16.0) * depth / 40.0, (v - 12.0) * depth / 40.0, depth],
                 -1).reshape(-1, 3).astype(np.float64)
    G = np.zeros((len(q), 3, 6))
    G[:, 0, 1], G[:, 0, 2], G[:, 0, 3] = q[:, 2], -q[:, 1], 1
    G[:, 1, 0], G[:, 1, 2], G[:, 1, 4] = -q[:, 2], q[:, 0], 1
    G[:, 2, 0], G[:, 2, 1], G[:, 2, 5] = q[:, 1], -q[:, 0], 1
    np.testing.assert_allclose(info, np.einsum("nri,nrj->ij", G, G), rtol=1e-6)
    T = torch.eye(4)
    T[2, 3] = 1.0
    far = torch.full((h, w), 2.0)
    assert odometry.odometry_information_matrix(far, far, k, T, 0.07, 4.0)[1] == 0
