"""mq3d_tpu_torch's decimation and evaluation (ops/decimate, eval/metrics,
eval/quality, eval/reporting) against the JAX package, on the CPU.

The same meshes and point sets, made from a seed with numpy, go through
both packages.  Tolerances:

- decimation, mesh metrics, quality scores, CSV files and paired
  statistics: equal (host numpy in both packages);
- nearest_distances and compare_point_clouds: equal.  Both packages compute
  |s|^2 + |t|^2 - 2 s.t in float32, where the cancellation alone would
  allow |d_port^2 - d_jax^2| up to a few eps32 (|s|^2 + |t|^2); the port
  reproduces XLA's fused multiply-add chains with a correctly rounded
  fma, so no such difference is left, and the tests hold it to equality
  (on random clouds far from and near the origin, in several tilings, and
  on a grid whose distances are known exactly).
"""

import csv
from dataclasses import asdict

import numpy as np
import pytest
import torch

from mq3d_tpu.dataio.ply import TriangleMesh as JaxMesh
from mq3d_tpu.eval import metrics as jax_metrics
from mq3d_tpu.eval import quality as jax_quality
from mq3d_tpu.eval import reporting as jax_reporting
from mq3d_tpu.ops import decimate as jax_decimate
from mq3d_tpu_torch.dataio.ply import TriangleMesh
from mq3d_tpu_torch.eval import metrics, quality, reporting
from mq3d_tpu_torch.ops import decimate

torch.set_num_threads(1)


def sphere(n_theta=24, n_phi=48, radius=1.0):
    """Closed UV sphere: 2 n_phi (n_theta - 1) triangles."""
    verts = [(0, 0, radius)]
    for i in range(1, n_theta):
        th = np.pi * i / n_theta
        for j in range(n_phi):
            ph = 2 * np.pi * j / n_phi
            verts.append((radius * np.sin(th) * np.cos(ph),
                          radius * np.sin(th) * np.sin(ph), radius * np.cos(th)))
    verts.append((0, 0, -radius))
    south = len(verts) - 1

    def ring(i, j):
        return 1 + (i - 1) * n_phi + (j % n_phi)

    tris = []
    for j in range(n_phi):
        tris += [(0, ring(1, j), ring(1, j + 1)),
                 (south, ring(n_theta - 1, j + 1), ring(n_theta - 1, j))]
    for i in range(1, n_theta - 1):
        for j in range(n_phi):
            a, b, c, d = ring(i, j), ring(i, j + 1), ring(i + 1, j), ring(i + 1, j + 1)
            tris += [(a, c, b), (b, c, d)]
    return np.asarray(verts, float), np.asarray(tris, np.int64)


def grid(g=40, hole=False, noise=0.0, rng=None):
    """g x g height field with a boundary (and an interior hole)."""
    xs, ys = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    z = noise * rng.standard_normal((g, g)) if noise else np.zeros((g, g))
    verts = np.stack([xs.ravel(), ys.ravel(), z.ravel()], -1)
    tris = []
    for i in range(g - 1):
        for j in range(g - 1):
            if hole and g // 3 <= i <= g // 2 and g // 3 <= j <= g // 2:
                continue
            a = i * g + j
            tris += [(a, a + 1, a + g), (a + 1, a + g + 1, a + g)]
    return verts, np.asarray(tris, np.int64)


def messy(rng):
    """Two grids, one duplicated triangle, a degenerate one, a sliver and a
    non-manifold fin: every branch of the topology metrics."""
    v1, t1 = grid(12, noise=0.02, rng=rng)
    v2, t2 = grid(8, hole=False)
    v2 = v2 + [2.0, 0.0, 0.5]
    verts = np.concatenate([v1, v2, [[0.5, 0.5, 1.0]]])
    fin = len(verts) - 1
    tris = np.concatenate([t1, t2 + len(v1), [[0, 1, 1], t1[5], [1, 13, fin]],
                           [[t1[7][0], t1[7][1], fin]]])
    return verts, tris


def meshes(rng, colors=True):
    """name -> (verts, tris, colors or None)."""
    out = {
        "sphere": sphere(),
        "noisy grid": grid(40, noise=0.01, rng=rng),
        "grid with a hole": grid(30, hole=True),
        "messy": messy(rng),
    }
    return {k: (v, t, rng.random((len(v), 3)) if colors else None) for k, (v, t) in out.items()}


def pair(verts, tris, cols):
    def mesh(cls):
        return cls(verts.copy(), tris.copy(),
                   vertex_colors=None if cols is None else cols.copy())
    return mesh(JaxMesh), mesh(TriangleMesh)


MESH_NAMES = ["sphere", "noisy grid", "grid with a hole", "messy"]


def _assert_mesh_bits(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    assert (a.vertex_colors is None) == (b.vertex_colors is None)
    if a.vertex_colors is not None:
        np.testing.assert_array_equal(a.vertex_colors, b.vertex_colors)


@pytest.mark.parametrize("name", MESH_NAMES)
@pytest.mark.parametrize("ratio", [0.5, 0.25, 0.05])
def test_simplify_to_ratio_bit_equal(name, ratio):
    jm, pm = pair(*meshes(np.random.default_rng(1))[name])
    a = jax_decimate.simplify_to_ratio(jm, ratio)
    b = decimate.simplify_to_ratio(pm, ratio)
    assert len(a.triangles) < len(jm.triangles)
    _assert_mesh_bits(a, b)


@pytest.mark.parametrize("colors", [False, True], ids=["plain", "colors"])
@pytest.mark.parametrize("target,rounds", [(600, 64), (100, 3), (1, 64)])
def test_simplify_quadric_decimation_bit_equal(colors, target, rounds):
    jm, pm = pair(*meshes(np.random.default_rng(2), colors)["sphere"])
    a = jax_decimate.simplify_quadric_decimation(jm, target, max_rounds=rounds)
    b = decimate.simplify_quadric_decimation(pm, target, max_rounds=rounds)
    _assert_mesh_bits(a, b)


@pytest.mark.parametrize("n,m,center", [(5000, 3000, 0.0), (300, 9000, 5.0),
                                        (4096, 17, 20.0), (1, 1, 1.0)])
@pytest.mark.parametrize("tiles", [(None, None), (4096, 8192), (700, 1000)],
                         ids=["default", "large", "small"])
def test_nearest_distances_equal(n, m, center, tiles):
    rng = np.random.default_rng(n + m)
    src = (rng.normal(size=(n, 3)) + center).astype(np.float32)
    tgt = (rng.normal(size=(m, 3)) + center).astype(np.float32)
    want = jax_metrics.nearest_distances(src, tgt)
    got = metrics.nearest_distances(src, tgt, tile=tiles[0], target_tile=tiles[1],
                                    device="cpu")
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


def test_nearest_distances_exact_on_a_grid():
    """Integer targets and sources at dyadic offsets under half a cell:
    every term is exact in float32, so both packages give the correctly
    rounded distance to the known nearest target."""
    g = np.stack(np.meshgrid(*[np.arange(-4, 5)] * 3, indexing="ij"), -1).reshape(-1, 3)
    tgt = g.astype(np.float32)
    rng = np.random.default_rng(3)
    offsets = rng.integers(-3, 4, size=(len(g), 3)) / 8.0  # |offset| <= 0.375
    src = (g + offsets).astype(np.float32)
    exact = np.sqrt((offsets ** 2).sum(1).astype(np.float32))
    got = metrics.nearest_distances(src, tgt, tile=100, target_tile=250, device="cpu")
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(jax_metrics.nearest_distances(src, tgt), exact)


def test_nearest_distances_empty():
    a = np.zeros((0, 3), np.float32)
    b = np.ones((4, 3), np.float32)
    assert metrics.nearest_distances(a, b, device="cpu").shape == (0,)
    np.testing.assert_array_equal(metrics.nearest_distances(b, a, device="cpu"),
                                  jax_metrics.nearest_distances(b, a))


@pytest.mark.parametrize("tau", [None, 0.05, 0.1])
def test_compare_point_clouds(tau):
    rng = np.random.default_rng(4)
    gt = rng.uniform(-2, 2, size=(3000, 3))
    pred = gt[rng.permutation(3000)[:2000]] + rng.normal(scale=0.05, size=(2000, 3))
    want = asdict(jax_metrics.compare_point_clouds(pred, gt, fscore_threshold=tau))
    got = asdict(metrics.compare_point_clouds(pred, gt, fscore_threshold=tau, device="cpu"))
    assert got == want
    assert 0 < want["precision"] < 1 and 0 < want["recall"] < 1


@pytest.mark.parametrize("voxel", [0.05, 0.2, 1.0])
def test_voxel_iou_and_normalize_scale_equal(voxel):
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (2000, 3))
    b = a * 0.7 + rng.normal(scale=0.02, size=a.shape) + 3.0
    assert metrics.voxel_iou(a, b, voxel) == jax_metrics.voxel_iou(a, b, voxel)
    assert metrics.voxel_iou(a, a, voxel) == 1.0
    sa, fa = metrics.normalize_scale(b, a)
    sj, fj = jax_metrics.normalize_scale(b, a)
    assert fa == fj
    np.testing.assert_array_equal(sa, sj)


@pytest.mark.parametrize("name", MESH_NAMES)
def test_mesh_metrics_equal(name):
    verts, tris, _ = meshes(np.random.default_rng(6))[name]
    assert metrics.mesh_surface_area(verts, tris) == jax_metrics.mesh_surface_area(verts, tris)
    assert metrics.count_boundary_edges(tris) == jax_metrics.count_boundary_edges(tris)
    for ratio in (0.0, 0.01, 0.5):
        assert metrics.count_holes(verts, tris, ratio) == jax_metrics.count_holes(
            verts, tris, ratio)
    if name == "grid with a hole":
        assert metrics.count_holes(verts, tris) == 2


@pytest.mark.parametrize("name", MESH_NAMES)
@pytest.mark.parametrize("colors", [False, True], ids=["plain", "colors"])
def test_compute_raw_metrics_equal(name, colors):
    jm, pm = pair(*meshes(np.random.default_rng(7), colors)[name])
    want = asdict(jax_quality.compute_raw_metrics(jm, name=name, path="x.ply"))
    got = asdict(quality.compute_raw_metrics(pm, name=name, path="x.ply"))
    assert got == want
    assert want["num_triangles"] == len(jm.triangles)


def _raw_batches():
    rng = np.random.default_rng(8)
    ms = meshes(rng)
    both = []
    for k, (v, t, c) in ms.items():
        jm, pm = pair(v, t, c if k != "messy" else None)
        both.append((jax_quality.compute_raw_metrics(jm, name=k, path=f"{k}.ply"),
                     quality.compute_raw_metrics(pm, name=k, path=f"{k}.ply")))
    return [a for a, _ in both], [b for _, b in both]


def test_quality_scores_and_csv_equal(tmp_path):
    jraw, praw = _raw_batches()
    want = jax_quality.compute_quality_scores(jraw)
    got = quality.compute_quality_scores(praw)
    for a, b in zip(want, got):
        assert {k: v for k, v in asdict(b).items() if k != "raw"} == {
            k: v for k, v in asdict(a).items() if k != "raw"}
    jax_quality.write_scores_csv(want, tmp_path / "jax.csv")
    quality.write_scores_csv(got, tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert [vars(x) for x in quality.score_batch(praw)] == [
        vars(x) for x in jax_quality.score_batch(jraw)]
    assert quality.compute_quality_scores([]) == []
    np.testing.assert_array_equal(quality.min_max_normalize([1.0, 1.0]),
                                  jax_quality.min_max_normalize([1.0, 1.0]))


@pytest.mark.parametrize("case", ["separated", "identical", "small"])
def test_paired_statistics_equal(case):
    rng = np.random.default_rng(9)
    fog = rng.normal(0.8, 0.1, 10)
    nofog = {"separated": fog - 0.15 + rng.normal(0, 0.02, 10), "identical": fog.copy(),
             "small": fog + rng.normal(0, 0.1, 10)}[case]
    want = jax_reporting.paired_statistics("m", fog, nofog)
    got = reporting.paired_statistics("m", fog, nofog)
    np.testing.assert_equal(asdict(got), asdict(want))  # NaN == NaN here


def _master_csv(path):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["participant", "pair_id",
                                          "fog_evaluate_quality_score_placeholder",
                                          "nofog_evaluate_quality_score_placeholder"])
        w.writeheader()
        w.writerows([{"participant": "P1", "pair_id": "A__B"},
                     {"participant": "P2", "pair_id": "C__D"}])


def test_reports_equal(tmp_path):
    names = ["P1_A__B_fog", "P1_A__B_nofog", "P2_C__D_fog"]
    meta = [{"participant": "P1", "pair_id": "A__B", "fog_name": names[0],
             "nofog_name": names[1]},
            {"participant": "P2", "pair_id": "C__D", "fog_name": names[2],
             "nofog_name": "P2_C__D_nofog"}]
    rng = np.random.default_rng(10)
    vals = rng.random((3, 9))
    fog, nofog = rng.normal(0.8, 0.1, (2, 8))
    for pkg, tag in ((jax_reporting, "jax"), (reporting, "port")):
        scores = [pkg.PairQualityScores(n, *v) for n, v in zip(names, vals)]
        _master_csv(tmp_path / f"{tag}_master.csv")
        pkg.update_master_fog_report(tmp_path / f"{tag}_master.csv", scores, meta)
        pkg.write_pairwise_summary(tmp_path / f"{tag}_pairs.csv", scores, meta)
        results = [pkg.paired_statistics("m1", fog, nofog),
                   pkg.paired_statistics("m2", nofog, fog)]
        pkg.write_statistical_report(results, tmp_path / f"{tag}.txt",
                                     tmp_path / f"{tag}.csv", tmp_path / f"{tag}.html")
    for suffix in ("_master.csv", "_pairs.csv", ".txt", ".csv", ".html"):
        want = (tmp_path / f"jax{suffix}").read_bytes()
        assert len(want) > 50
        assert (tmp_path / f"port{suffix}").read_bytes() == want, suffix
