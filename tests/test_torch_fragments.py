"""Fragment generation and scene refinement (recon/fragments.py,
recon/refine.py) of mq3d_tpu_torch against the JAX package, on the CPU.

The capture and settings are tests/test_end_to_end.py's (80x64 depth, 12
frames, 6-frame fragments, voxel 0.05 m), with the depth unfiltered here
(tests/test_torch_pose_pipeline.py runs the confidence filter).
Tolerances: the frustum gate and the fragment edge sets and loop gates
equal; edge transforms equal and information within 1e-5 relative;
fragment poses within 1e-9; fragment point clouds identical; scene edges
from the batched and the serial path equal in set, transforms within 1e-5
and information within 1e-4 relative (as tests/test_registration.py holds
the JAX package's two paths); against the JAX package the same edge set
and information bound, and transforms within 5e-5.  That last bound is
wider than the 1e-5 of tests/test_torch_icp.py: the JAX package's
moments are float32 sums taken one point after another (its p^T q is a
sequential fused multiply-add chain), the port's are float32 sums in
another order, and these fragment pairs converge slowly along the walls,
where that rounding moves the pose most: the JAX package's own flat and
tiled ICP differ by more than 1e-5 on these pairs (asserted below), and
the port is held within 5e-5 of both.
"""

import copy
import shutil

import numpy as np
import pytest
import torch
import yaml

from mq3d_tpu.config.configs import PipelineConfigs as JaxConfigs
from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
import mq3d_tpu.ops.icp as J
from mq3d_tpu.dataio.ply import read_pcd as jax_read_pcd
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.recon import fragments as jax_frag
from mq3d_tpu.recon import refine as jax_refine
from mq3d_tpu.recon.integrate import load_filtered_depth_stack as jax_load_stack
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.config.configs import PipelineConfigs
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.recon import fragments, refine
from mq3d_tpu_torch.recon.integrate import load_filtered_depth_stack
from tests.test_end_to_end import TEST_CONFIG

torch.set_num_threads(1)


def _settings(tmp_path):
    cfg = yaml.safe_load(TEST_CONFIG)
    rc = cfg["reconstruction"]
    rc["fragment_generation"]["use_confidence_filtered_depth"] = False
    rc["fragment_pose_refinement"]["use_confidence_filtered_depth"] = False
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return (JaxConfigs.parse_config_yml(path).reconstruction,
            PipelineConfigs.parse_config_yml(path).reconstruction)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_frag")
    write_synthetic_project(d / "capture", SyntheticSceneConfig(n_frames=12, sweep=1.2))
    jc, tc = _settings(d)
    jmap = jax_frag.make_fragment_datasets(JaxDataIO(d / "capture").depth,
                                           jc.fragment_generation)
    yield d, jc, tc, jmap
    shutil.rmtree(d, ignore_errors=True)


def test_frustum_overlap_filter_matches_jax():
    rng = np.random.default_rng(0)
    from mq3d_tpu_torch.geometry import se3
    K = np.array([[60.0, 0, 40.0], [0, 60.0, 32.0], [0, 0, 1]])
    got, want = [], []
    for _ in range(60):
        a, b = se3.se3_exp(rng.normal(size=(2, 6)) * [0.6, 0.6, 0.6, 1.0, 1.0, 1.0])
        args = (a, b, K, K, (80, 64), (80, 64))
        kw = dict(z_near=0.1, z_far=4.0, overlap_ratio_threshold=0.1)
        got.append(fragments.frustum_overlap_filter(*args, **kw))
        want.append(jax_frag.frustum_overlap_filter(*args, **kw))
    assert got == want and 5 < sum(got) < 55


def _fragment_inputs(capture, side_j, side_t, index):
    d, jc, tc, _ = capture
    fc = tc.fragment_generation
    jio, io = JaxDataIO(d / "capture"), DataIO(d / "capture")
    jds = jio.depth.load_depth_dataset(side_j)
    ds = io.depth.load_depth_dataset(side_t)
    from mq3d_tpu.models.transforms import CoordinateSystem as JaxCS
    from mq3d_tpu_torch.models.transforms import CoordinateSystem
    jds.transforms = jds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    ds.transforms = ds.transforms.convert_coordinate_system(CoordinateSystem.OPEN3D,
                                                            is_camera=True)
    idx = np.arange(index * fc.fragment_size, (index + 1) * fc.fragment_size)
    jstack = jax_load_stack(jio.depth, side_j, jds, idx, False, 0.0, 0)
    stack = load_filtered_depth_stack(io.depth, side_t, ds, idx, False, 0.0, 0)
    np.testing.assert_array_equal(stack[0], jstack[0])
    return jds.split(fc.fragment_size)[index], ds.split(fc.fragment_size)[index], stack


@pytest.mark.parametrize("side,index,interval", [("LEFT", 0, 3), ("RIGHT", 1, 3), ("LEFT", 1, 1)])
def test_fragment_pose_graph_matches_jax(capture, side, index, interval):
    _, jc, tc, _ = capture
    jfrag, frag, (stack, valid) = _fragment_inputs(capture, JaxSide[side], Side[side], index)
    jcfg, cfg = copy.copy(jc.fragment_generation), copy.copy(tc.fragment_generation)
    jcfg.odometry_loop_interval = cfg.odometry_loop_interval = interval
    want = jax_frag.build_pose_graph_for_fragment(jfrag, stack, valid, jcfg)
    got = fragments.build_pose_graph_for_fragment(frag, stack, valid, cfg, device="cpu")
    key = [(e.source_node_id, e.target_node_id, e.uncertain) for e in got.edges]
    assert key == [(e.source_node_id, e.target_node_id, e.uncertain) for e in want.edges]
    assert sum(e.uncertain for e in got.edges) > 0
    for a, b in zip(want.edges, got.edges):
        np.testing.assert_array_equal(b.transformation, a.transformation)
        a_info = np.asarray(a.information, np.float64)
        assert np.abs(b.information - a_info).max() <= 1e-5 * np.abs(a_info).max()


def test_fragment_poses_match_jax(capture, tmp_path):
    d, jc, tc, jmap = capture
    shutil.copytree(d / "capture", tmp_path / "port")
    tmap = fragments.make_fragment_datasets(DataIO(tmp_path / "port").depth,
                                            tc.fragment_generation, device="cpu")
    for side in Side:
        assert len(tmap[side]) == len(jmap[JaxSide[side.name]]) == 2
        for a, b in zip(jmap[JaxSide[side.name]], tmap[side]):
            np.testing.assert_array_equal(b.timestamps, a.timestamps)
            np.testing.assert_allclose(b.transforms.positions, a.transforms.positions,
                                       rtol=0, atol=1e-9)
            np.testing.assert_allclose(b.transforms.rotations, a.transforms.rotations,
                                       rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def fragment_clouds(capture, tmp_path_factory):
    """Both packages' fragment point clouds of the JAX package's fragments."""
    d, jc, tc, jmap = capture
    root = tmp_path_factory.mktemp("torch_frag_pcd")
    for p in ("jax", "port"):
        shutil.copytree(d / "capture", root / p)
    jcounts = jax_refine.integrate_and_save_fragment_point_clouds(
        JaxDataIO(root / "jax").depth, JaxDataIO(root / "jax").reconstruction, jmap,
        jc.fragment_pose_refinement)
    # The port reads the JAX package's fragment datasets.
    for side, frags in jmap.items():
        for i, frag in enumerate(frags):
            JaxDataIO(root / "jax").reconstruction.save_fragment_dataset(frag, side, i)
    shutil.copytree(root / "jax/cache/dataset", root / "port/cache/dataset")
    io = DataIO(root / "port")
    tmap = io.reconstruction.load_fragment_datasets()
    tcounts = refine.integrate_and_save_fragment_point_clouds(
        io.depth, io.reconstruction, tmap, tc.fragment_pose_refinement, device="cpu")
    return root, jcounts, tcounts, tmap


def test_fragment_point_clouds_equal_jax(fragment_clouds):
    root, jcounts, tcounts, _ = fragment_clouds
    assert {s.name: c for s, c in tcounts.items()} == {s.name: c for s, c in jcounts.items()}
    for side in ("LEFT", "RIGHT"):
        for i in range(2):
            a = jax_read_pcd(root / f"jax/cache/pcd/{side}_fragment_{i}.pcd")
            b = jax_read_pcd(root / f"port/cache/pcd/{side}_fragment_{i}.pcd")
            assert len(a.points) > 1000
            np.testing.assert_array_equal(b.points, a.points)


def test_fragment_failures_propagate(capture, monkeypatch):
    """Only an empty cloud gives None; any other error propagates instead of
    dropping the fragment (the JAX package prints and drops it)."""
    d, _, tc, jmap = capture
    io = DataIO(d / "capture")
    frag = io.depth.load_depth_dataset(Side.LEFT)[:6]

    def broken(**kwargs):
        raise RuntimeError("device fault")

    monkeypatch.setattr(refine, "integrate", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        refine.integrate_fragment_point_cloud(io.depth, frag, Side.LEFT,
                                              tc.fragment_pose_refinement, device="cpu")
    monkeypatch.undo()
    far = copy.copy(tc.fragment_pose_refinement)
    far.depth_max = 0.2  # no depth within range: an empty cloud
    assert refine.integrate_fragment_point_cloud(io.depth, frag, Side.LEFT, far,
                                                 device="cpu") is None


def _edges_key(edges):
    return [(e.source_node_id, e.target_node_id, e.uncertain) for e in edges]


def _assert_edges_close(got, want, atol, rtol_info=1e-4):
    assert _edges_key(got) == _edges_key(want) and len(got) > 0
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.transformation, a.transformation, rtol=0, atol=atol)
        info = np.asarray(a.information, np.float64)
        assert np.abs(b.information - info).max() <= rtol_info * np.abs(info).max()


@pytest.mark.parametrize("pre_filter", [False, True])
def test_scene_edges_batched_serial_and_jax(fragment_clouds, pre_filter):
    root, _, tcounts, _ = fragment_clouds
    jc, tc = _settings(root)
    jcfg, cfg = copy.copy(jc.fragment_pose_refinement), copy.copy(tc.fragment_pose_refinement)
    for c in (jcfg, cfg):
        c.use_pre_filtering = pre_filter
        c.pre_filter_every_k_points = 5
    nodes = [(Side.LEFT, 0), (Side.LEFT, 1), (Side.RIGHT, 0), (Side.RIGHT, 1)]
    jnodes = [(JaxSide[s.name], i) for s, i in nodes]
    pairs = [(0, 1, False), (2, 3, False)] + [(i, j, True) for i in range(4)
                                              for j in range(i + 1, 4)]
    io = DataIO(root / "port").reconstruction
    batched = refine.compute_pcd_pair_edges_batched(
        refine._FragmentCache(io, cfg, device="cpu"), nodes, pairs, cfg)
    cache = refine._FragmentCache(io, cfg, device="cpu")
    serial = [e for s, t, u in pairs
              if (e := refine.compute_pcd_pair_edge(cache, nodes, s, t, cfg, u)) is not None]
    _assert_edges_close(batched, serial, atol=1e-5)
    variants = []
    for limit in (None, 256):  # the JAX package's flat and tiled ICP
        with pytest.MonkeyPatch.context() as m:
            if limit:
                m.setattr(J, "_VMAP_SRC_PAD_LIMIT", limit)
            variants.append(jax_refine.compute_pcd_pair_edges_batched(
                jax_refine._FragmentCache(JaxDataIO(root / "port").reconstruction, jcfg),
                jnodes, pairs, jcfg))
    for want in variants:
        _assert_edges_close(batched, want, atol=5e-5)
    spread = max(np.abs(a.transformation - b.transformation).max()
                 for a, b in zip(*variants))
    assert spread > 1e-5
