"""mq3d_tpu_torch colour-map optimisation (step 4) against the JAX package,
on the CPU.

One synthetic capture goes through the JAX package's colorless pipeline
(PNGs, frame tables, colorless_vbg.npz).  The colour frame tables are then
offset by a few millimetres and a small rotation, so the Gauss-Newton
steps have something to correct, and both packages optimise from the same
tables and the same volume.  Tolerances:

- `_gn_terms` H and b: relative error <= 1e-5 (of the largest entry);
  residual relative error <= 1e-5; valid-vertex counts equal;
- visibility masks equal on >= 99.9 % of the vertices, sampled
  intensities and colours within 1e-6;
- `optimize_color_pose`: the mesh identical, final poses within 1e-5
  (positions in metres, quaternion components), vertex colours within
  1e-4.
"""

import shutil

import numpy as np
import pytest
import torch
import yaml

from mq3d_tpu.config.configs import ColorOptimizationConfig as JaxColorConfig
from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.ops.raycast import raycast_depth as jax_raycast_depth
from mq3d_tpu.ops.tsdf import TSDFVolume as JaxVolume
from mq3d_tpu.pipeline.processor import PipelineProcessor as JaxProcessor
from mq3d_tpu.recon import color_opt as jax_co
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.config.configs import ColorOptimizationConfig
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops.mesh_filter import filter_mesh_components
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.recon import color_opt

torch.set_num_threads(1)

COLOR = dict(weight_threshold=1.5, interval=4, max_iteration=12, min_triangle_count=100,
             use_dataset_cache=True)


def colorless_config(tmp, repo):
    cfg = yaml.safe_load((repo / "config/pipeline_config_batch.yml").read_text())
    rc = cfg["reconstruction"]
    for k in ("estimate_depth_confidences", "optimize_depth_pose", "optimize_color_pose",
              "render_color_aligned_depth"):
        rc[k] = False
    rc["use_dataset_cache"] = False
    rc["use_colorless_vbg_cache"] = False
    rc["depth_integration"].update(
        voxel_size=0.05, block_count=2048, grid_dim=16, depth_max=4.0,
        trunc_voxel_multiplier=4.0, chunk_active_capacity=2048, integrate_tile=256,
        frames_per_batch=8, use_confidence_filtered_depth=False)
    path = tmp / "colorless.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def project(tmp_path_factory, request):
    repo = request.config.rootpath
    tmp = tmp_path_factory.mktemp("torch_color_opt")
    session = tmp / "capture"
    write_synthetic_project(session, SyntheticSceneConfig(n_frames=12))
    p = JaxProcessor(session, colorless_config(tmp, repo))
    p.convert_yuv_to_rgb()
    p.convert_depth_to_linear()
    p.reconstruct_scene()
    # Offset every colour frame's pose: 4 mm along a per-frame direction
    # and a 0.2 degree turn about z.
    rng = np.random.default_rng(0)
    for side in ("left", "right"):
        path = session / "dataset" / f"{side}_camera_dataset.npz"
        data = dict(np.load(path))
        n = len(data["positions"])
        d = rng.standard_normal((n, 3))
        data["positions"] = (data["positions"]
                             + 0.004 * d / np.linalg.norm(d, axis=1, keepdims=True)
                             ).astype(data["positions"].dtype)
        a = np.deg2rad(0.2) / 2
        q = data["rotations"].astype(np.float64)  # xyzw
        r = np.array([0.0, 0.0, np.sin(a), np.cos(a)])
        x1, y1, z1, w1 = q.T
        x2, y2, z2, w2 = r
        data["rotations"] = np.stack([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1).astype(data["rotations"].dtype)
        np.savez(path, **data)
    yield session
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def volumes(project):
    path = project / "reconstruction/colorless_vbg.npz"
    return JaxVolume.load(path), TSDFVolume.load(path, device="cpu")


@pytest.fixture(scope="module")
def keyframe(project, volumes):
    """The inputs of one keyframe's terms, as the optimiser builds them."""
    jv, tv = volumes
    mesh = filter_mesh_components(tv.extract_triangle_mesh(1.5), 100, device="cpu")
    io = DataIO(project)
    ds = io.color.load_color_dataset(Side.LEFT)[::4]
    ds.transforms = ds.transforms.convert_coordinate_system(CoordinateSystem.OPEN3D,
                                                            is_camera=True)
    i = 1
    K = ds.get_render_intrinsic_matrices().astype(np.float32)[i]
    T = ds.transforms.extrinsics_wc.astype(np.float64)[i]
    rgb = io.color.load_rgb(Side.LEFT, int(ds.timestamps[i])).astype(np.float32) / 255.0
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    gy, gx = np.gradient(gray)
    depth = jax_raycast_depth(jv, K, T, int(ds.widths[i]), int(ds.heights[i]))
    verts = mesh.vertices.astype(np.float32)
    target = np.random.default_rng(3).uniform(0.2, 0.8, len(verts)).astype(np.float32)
    return dict(verts=verts, K=K, T=T.astype(np.float32), rgb=rgb, gray=gray,
                gx=gx.astype(np.float32), gy=gy.astype(np.float32), depth=depth,
                target=target)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_visibility_and_sampling_match_jax(keyframe):
    k = keyframe
    args = (k["verts"], k["K"], k["T"])
    targs = (_t(k["verts"]), _t(k["K"])[None], _t(k["T"])[None])
    want_vis = np.asarray(jax_co._visibility(*args, k["depth"]))
    vis = color_opt._visibility(*targs, _t(k["depth"])[None])[0].numpy()
    assert want_vis.sum() > 1000
    assert (vis == want_vis).mean() >= 0.999
    wv = _t(want_vis)[None]
    val, ok = color_opt._sample_intensity(*targs, _t(k["gray"])[None], wv)
    jval, jok = jax_co._sample_intensity(*args, k["gray"], want_vis)
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(jok))
    np.testing.assert_allclose(val[0].numpy(), np.asarray(jval), rtol=0, atol=1e-6)
    val, ok = color_opt._sample_rgb(*targs, _t(k["rgb"])[None], wv)
    jval, jok = jax_co._sample_rgb(*args, k["rgb"], want_vis)
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(jok))
    np.testing.assert_allclose(val[0].numpy(), np.asarray(jval), rtol=0, atol=1e-6)


def test_gn_terms_match_jax(keyframe):
    k = keyframe
    vis = np.asarray(jax_co._visibility(k["verts"], k["K"], k["T"], k["depth"]))
    H, b, res, n_ok = jax_co._gn_terms(k["verts"], k["K"], k["T"], k["gray"], k["gx"],
                                       k["gy"], k["target"], vis)
    tH, tb, tres, tn = (x[0].numpy() for x in color_opt._gn_terms(
        _t(k["verts"]), _t(k["K"])[None], _t(k["T"])[None], _t(k["gray"])[None],
        _t(k["gx"])[None], _t(k["gy"])[None], _t(k["target"]), _t(vis)[None]))
    H, b = np.asarray(H), np.asarray(b)
    assert tH.dtype == tb.dtype == np.float64
    assert int(tn) == int(n_ok) > 100
    assert np.abs(tH - H).max() <= 1e-5 * np.abs(H).max()
    assert np.abs(tb - b).max() <= 1e-5 * np.abs(b).max()
    assert abs(float(tres) - float(res)) <= 1e-5 * float(res)


def test_optimize_color_pose_matches_jax(project, volumes):
    jv, tv = volumes
    jmesh, jds = jax_co.optimize_color_pose(jv, JaxDataIO(project), JaxColorConfig(**COLOR))
    cfg = ColorOptimizationConfig(**COLOR)
    start_mesh = filter_mesh_components(tv.extract_triangle_mesh(cfg.weight_threshold),
                                        cfg.min_triangle_count, device="cpu")
    mesh, ds = color_opt.optimize_color_pose(tv, DataIO(project), cfg, start_mesh)
    assert start_mesh.vertex_colors is None  # the input mesh is left as it was
    for key in ("vertices", "triangles", "vertex_normals"):
        np.testing.assert_array_equal(getattr(mesh, key), getattr(jmesh, key), err_msg=key)
    assert mesh.vertex_colors.shape == jmesh.vertex_colors.shape
    np.testing.assert_allclose(mesh.vertex_colors, jmesh.vertex_colors, rtol=0, atol=1e-4)
    start = DataIO(project).color.load_color_dataset(Side.LEFT)[::4]
    start.transforms = start.transforms.convert_coordinate_system(CoordinateSystem.OPEN3D,
                                                                  is_camera=True)
    moved = 0.0
    for side in Side:
        want = next(v for s, v in jds.items() if s.name == side.name).transforms
        got = ds[side].transforms
        assert len(got.positions) == 3
        np.testing.assert_allclose(got.positions, want.positions, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.rotations, want.rotations, rtol=0, atol=1e-5)
        if side is Side.LEFT:
            moved = np.abs(got.positions - start.transforms.positions).max()
    assert moved > 1e-4  # the steps really ran
