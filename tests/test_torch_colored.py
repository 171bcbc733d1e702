"""The colored recipe end to end: mq3d_tpu_torch's run_full_pipeline
against the JAX package's pipeline, on the CPU.

One tiny synthetic capture goes through each package with reconstruction
steps 0 and 3-6 on (1-2 off; tests/test_torch_pose_pipeline.py runs them)
and small colour settings.  Tolerances:

- colorless_mesh_raw/clean.ply and the colored mesh's vertices, triangles
  and normals: identical;
- colored mesh and colored point cloud colours: PLY stores uint8, and the
  vertex colours agree within 1e-4 (tests/test_torch_color_opt.py), so
  within one unit; the sampled points and normals identical;
- the optimised colour frame tables: equal, poses within 1e-5;
- the colour-aligned depth maps: the same files, hit/miss equal on
  >= 99.9 % of the pixels and |dz| <= 1e-4 m on >= 99.9 % of the common
  hits.

Each package reads the other's meshes and depth maps.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.dataio.ply import read_ply as jax_read_ply
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.pipeline.processor import PipelineProcessor as JaxProcessor
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.config.configs import (
    SHIPPED_COLOR_OPTIMIZATION,
    PipelineConfigs,
    colored_recipe,
)
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.dataio.ply import read_ply
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.pipeline.processor import run_full_pipeline
from mq3d_tpu_torch.recon import reconstruct
from mq3d_tpu_torch.testing.synthetic import SyntheticSceneConfig as PortSceneConfig
from mq3d_tpu_torch.testing.synthetic import write_synthetic_project as write_port_project

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
MESHES = ("colorless_mesh_raw.ply", "colorless_mesh_clean.ply", "color_mesh.ply")


def colored_config(tmp: Path) -> Path:
    cfg = yaml.safe_load((REPO / "config/pipeline_config_batch.yml").read_text())
    rc = cfg["reconstruction"]
    rc.update(estimate_depth_confidences=False, optimize_depth_pose=False,
              optimize_color_pose=True, render_color_aligned_depth=True,
              sample_point_cloud_from_colored_mesh=True, points_per_vertex_ratio=2.0,
              use_dataset_cache=False, use_colorless_vbg_cache=False)
    rc["depth_integration"].update(
        voxel_size=0.05, block_count=2048, grid_dim=16, depth_max=4.0,
        trunc_voxel_multiplier=4.0, chunk_active_capacity=2048, integrate_tile=256,
        frames_per_batch=8, use_confidence_filtered_depth=False)
    rc["color_optimization"].update(weight_threshold=1.5, interval=4, max_iteration=12,
                                    min_triangle_count=100, use_dataset_cache=False)
    # Render every colour frame: the optimised keyframes and the rest.
    rc["color_aligned_depth_rendering"].update(only_use_optimized_dataset=False,
                                               frames_per_batch=4)
    path = tmp / "colored.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_colored")
    write_synthetic_project(tmp / "jax", SyntheticSceneConfig(n_frames=12))
    shutil.copytree(tmp / "jax", tmp / "port")
    cfg = colored_config(tmp)
    p = JaxProcessor(tmp / "jax", cfg)
    p.convert_yuv_to_rgb()
    p.convert_depth_to_linear()
    p.reconstruct_scene()
    run = run_full_pipeline(tmp / "port", cfg, device="cpu")
    yield tmp / "jax", tmp / "port", run
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("name", MESHES)
def test_meshes_equal(runs, name):
    j, t, _ = runs
    a = jax_read_ply(j / "reconstruction" / name)
    b = jax_read_ply(t / "reconstruction" / name)
    assert len(a.triangles) > 1000
    for k in ("vertices", "triangles", "vertex_normals"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
    if name == "color_mesh.ply":
        d = np.abs(a.vertex_colors - b.vertex_colors)  # read back as u8 / 255
        assert d.max() <= 1 / 255 + 1e-12 and a.vertex_colors.std() > 0.05


def test_colored_point_cloud_equal(runs):
    j, t, _ = runs
    a = jax_read_ply(j / "reconstruction/color.ply")
    b = jax_read_ply(t / "reconstruction/color.ply")
    mesh = jax_read_ply(t / "reconstruction/color_mesh.ply")
    assert len(b.points) == 2 * len(mesh.vertices)  # points_per_vertex_ratio 2
    np.testing.assert_array_equal(b.points, a.points)
    np.testing.assert_array_equal(b.normals, a.normals)
    assert np.abs(a.colors - b.colors).max() <= 1 / 255 + 1e-12


def test_optimized_datasets_equal(runs):
    j, t, _ = runs
    for side in ("left", "right"):
        name = f"{side}_camera_dataset_optimized.npz"
        a, b = np.load(j / "dataset" / name), np.load(t / "dataset" / name)
        assert a.files == b.files
        for k in a.files:
            if k in ("positions", "rotations"):
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert len(a["timestamps"]) == 3  # 12 frames, interval 4


def test_color_aligned_depth_close(runs):
    j, t, run = runs
    for side in ("left", "right"):
        fj = sorted((j / f"{side}_color_aligned_depth").glob("*.npy"))
        ft = sorted((t / f"{side}_color_aligned_depth").glob("*.npy"))
        assert [f.name for f in fj] == [f.name for f in ft] and len(fj) == 12
        a = np.stack([np.load(f) for f in fj])
        b = np.stack([np.load(f) for f in ft])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        fa, fb = np.isfinite(a), np.isfinite(b)
        assert fa.mean() > 0.5 and (fa == fb).mean() >= 0.999
        both = fa & fb
        assert (np.abs(a[both] - b[both]) <= 1e-4).mean() >= 0.999
    assert run.volume is not None and run.volume.n_active > 0


def test_each_package_reads_the_others_artifacts(runs):
    j, t, _ = runs
    for name in MESHES + ("color.ply",):
        a, b = read_ply(j / "reconstruction" / name), jax_read_ply(t / "reconstruction" / name)
        key = "points" if name == "color.ply" else "vertices"
        assert len(getattr(a, key)) == len(getattr(b, key)) > 0
    ts = int(DataIO(t).color.load_optimized_color_dataset(Side.LEFT).timestamps[0])
    np.testing.assert_array_equal(
        DataIO(j).rgbd.load_color_aligned_depth(Side.LEFT, ts).shape,
        JaxDataIO(t).rgbd.load_color_aligned_depth(JaxSide.LEFT, ts).shape)
    assert JaxDataIO(t).color.load_optimized_color_dataset(JaxSide.RIGHT) is not None


@pytest.mark.parametrize("flag,entry", [
    ("estimate_depth_confidences", "estimate_depth_confidences"),
    ("optimize_depth_pose", "DepthPoseOptimizer")])
def test_steps_1_2_still_raise(tmp_path, monkeypatch, flag, entry):
    """Switched on in the colored recipe, each of steps 1 and 2 is run by
    reconstruct_scene (it raised NotImplementedError before they were
    ported): its entry is reached, here replaced by one that raises."""
    class Reached(Exception):
        pass

    def reached(*args, **kwargs):
        raise Reached(entry)

    monkeypatch.setattr(reconstruct, entry, reached)
    write_port_project(tmp_path, PortSceneConfig(n_frames=4))
    cfg = colored_recipe()
    setattr(cfg.reconstruction, flag, True)
    with pytest.raises(Reached, match=entry):
        run_full_pipeline(tmp_path, cfg, device="cpu")


def test_colored_recipe():
    cfg = colored_recipe(color_optimization={"interval": 10}, voxel_size=0.02)
    rc = cfg.reconstruction
    assert rc.optimize_color_pose and rc.render_color_aligned_depth
    assert rc.sample_point_cloud_from_colored_mesh
    assert not rc.estimate_depth_confidences and not rc.optimize_depth_pose
    assert rc.color_optimization.interval == 10
    assert rc.depth_integration.voxel_size == 0.02
    shipped = PipelineConfigs.parse_config_yml(REPO / "config/pipeline_config.yml")
    for k, v in SHIPPED_COLOR_OPTIMIZATION.items():
        assert getattr(shipped.reconstruction.color_optimization, k) == v, k
        if k != "interval":
            assert getattr(rc.color_optimization, k) == v, k
    assert rc.points_per_vertex_ratio == shipped.reconstruction.points_per_vertex_ratio
    assert rc.color_aligned_depth_rendering.only_use_optimized_dataset
