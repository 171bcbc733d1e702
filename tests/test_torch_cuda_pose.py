"""Reconstruction steps 1-2 of mq3d_tpu_torch on the card against the same
code on the CPU.

Marked `cuda`: they skip without an NVIDIA GPU.  This file imports neither
jax nor mq3d_tpu, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_pose.py

Tolerances: confidence counts and maps, the Voronoi field's ids and the
odometry correspondence counts identical (integer and elementwise IEEE
float32 work, with float64 where XLA fuses); nearest-neighbour ids equal
on >= 99.9 % of the points; ICP poses within 1e-5 (float32 sums in
another order) and the inlier counts equal; the odometry information
within 1e-9 relative (float64 sums in another order); the pose-graph
terms within 1e-10 (the card's float64 sin, cos and arccos differ from
the CPU's by an ulp or two, which the Jacobians near a zero rotation
magnify).
"""

import numpy as np
import pytest
import torch

from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.geometry import se3
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops import icp, odometry, posegraph
from mq3d_tpu_torch.recon import confidence
from mq3d_tpu_torch.testing.synthetic import quest_scene, write_synthetic_project


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Quest-scale depth (320x288) of the port's synthetic box room."""
    _card()
    d = tmp_path_factory.mktemp("cuda_pose")
    write_synthetic_project(d, quest_scene(n_frames=12), workers=4)
    io = DataIO(d)
    ds = io.depth.load_depth_dataset(Side.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(CoordinateSystem.OPEN3D,
                                                            is_camera=True)
    depth, valid = io.depth.load_depth_stack(Side.LEFT, ds)
    K = ds.get_render_intrinsic_matrices().astype(np.float32)
    T_cw = ds.transforms.extrinsics_cw.astype(np.float32)
    return depth, K, T_cw, np.linalg.inv(T_cw), valid


def _on(arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.cuda
def test_confidence_card_equals_cpu(frames):
    refs = torch.arange(12)
    out = {dev: [x.cpu() for x in confidence.confidence_for_refs(
        *_on(frames, dev), refs.to(dev), 4.0, 0.08, 10)] for dev in ("cpu", "cuda")}
    (c_cpu, n_cpu), (c_gpu, n_gpu) = out["cpu"], out["cuda"]
    assert (n_cpu > 0).float().mean() > 0.5
    assert torch.equal(n_gpu, n_cpu) and torch.equal(c_gpu, c_cpu)


@pytest.mark.cuda
def test_odometry_card_equals_cpu(frames):
    depth, K, T_cw = frames[0], frames[1][0], frames[2].astype(np.float64)
    pairs = np.array([(i, i + 1) for i in range(11)] + [(0, 10), (2, 7)])
    rel = (np.linalg.inv(T_cw[pairs[:, 1]]) @ T_cw[pairs[:, 0]]).astype(np.float32)
    out = {dev: odometry.odometry_information_matrix_batch(
        *_on((depth, K), dev), pairs, torch.from_numpy(rel).to(dev), 0.07, 4.0)
        for dev in ("cpu", "cuda")}
    (i_cpu, n_cpu), (i_gpu, n_gpu) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(n_gpu, n_cpu)
    assert np.abs(i_gpu - i_cpu).max() <= 1e-9 * np.abs(i_cpu).max()


def _surface(rng, n):
    xy = rng.uniform(-1, 1, (n, 2))
    return np.stack([xy[:, 0], xy[:, 1], 0.2 * np.sin(3 * xy[:, 0]) * np.cos(2 * xy[:, 1])], -1)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [0.1, 0.025])
def test_voronoi_field_and_queries_card_equal_cpu(radius):
    _card()
    rng = np.random.default_rng(0)
    tgt = _surface(rng, 200_000)
    a = icp.build_voronoi_nn(tgt, radius, device="cpu")
    b = icp.build_voronoi_nn(tgt, radius, device="cuda")
    assert torch.equal(b.ids.cpu(), a.ids)
    src = torch.from_numpy((_surface(rng, 50_000) + rng.normal(0, 0.005, (50_000, 3)))
                           .astype(np.float32))
    ia, da = icp._query(src, a.to("cpu"))
    ib, db = icp._query(src.cuda(), b.to("cuda"))
    assert (ib.cpu() == ia).float().mean() >= 0.999
    same = ib.cpu() == ia
    assert torch.equal(db.cpu()[same], da[same])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid", "voro"])
def test_batched_icp_card_matches_cpu(kind):
    _card()
    rng = np.random.default_rng(1)
    target = _surface(rng, 20_000)
    sources = []
    for k in range(5):
        T = se3.se3_exp(rng.normal(size=6) * 0.01)
        sources.append((target @ T[:3, :3].T + T[:3, 3])[rng.permutation(20_000)[:8000 + 500 * k]])
    crit = [icp.ICPConvergenceCriteria(30)] * 5
    out = {}
    for dev in ("cpu", "cuda"):
        grid = (icp.build_grid_nn(target, 0.05).to(dev) if kind == "grid"
                else icp.build_voronoi_nn(target, 0.05, device=dev))
        out[dev] = icp.registration_icp_batch_shared(sources, grid, [0.05] * 5, criteria=crit,
                                                     device=dev)
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose(b.transformation, a.transformation, rtol=0, atol=1e-5)
        assert b.n_correspondences == a.n_correspondences and a.fitness > 0.9


@pytest.mark.cuda
def test_edge_terms_card_match_cpu():
    _card()
    rng = np.random.default_rng(2)
    X = [torch.from_numpy(se3.se3_exp(rng.normal(size=(20, 6)) * s)) for s in (1.0, 1.0, 0.3)]
    a = posegraph._edge_terms(*X)
    b = posegraph._edge_terms(*[x.cuda() for x in X])
    for x, y in zip(a, b):
        d = float((y.cpu() - x).abs().max())
        assert d <= 1e-10, d
