"""Reconstruction steps 0-3 with steps 1-2 on: mq3d_tpu_torch's
run_full_pipeline against the JAX package's pipeline, on the CPU.

tests/test_end_to_end.py's capture and settings (12 frames, 6-frame
fragments, voxel 0.05 m, confidence-filtered depth), with the colour steps
off.  Tolerances: confidence maps and packs identical; fragment poses
within 1e-9; optimized poses within 5e-5 (1e-5 was the aim: the scene
ICP edges agree with the JAX package's only to 5e-5, as its own flat and
tiled ICP differ by more than 1e-5 on such fragment pairs,
tests/test_torch_fragments.py, and the scene pose graph carries that
into the poses); the same blocks in the colorless volume.  Each package reads the other's frame tables.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.pipeline.processor import PipelineProcessor as JaxProcessor
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.config.configs import PipelineConfigs
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.pipeline.processor import PipelineProcessor, run_full_pipeline
from tests.test_end_to_end import TEST_CONFIG

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pose_pipeline")
    write_synthetic_project(tmp / "jax", SyntheticSceneConfig(n_frames=12, sweep=1.2))
    shutil.copytree(tmp / "jax", tmp / "port")
    cfg = yaml.safe_load(TEST_CONFIG)
    cfg["reconstruction"].update(optimize_color_pose=False, render_color_aligned_depth=False)
    path = tmp / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    JaxProcessor(project_dir=tmp / "jax", config_yml_path=path).run_full_pipeline()
    run = run_full_pipeline(tmp / "port", path, device="cpu")
    yield tmp / "jax", tmp / "port", run
    shutil.rmtree(tmp, ignore_errors=True)


def test_confidence_outputs_equal(runs):
    j, t, _ = runs
    for side in ("left", "right"):
        fj = sorted((j / f"{side}_depth_confidence").glob("*.npz"))
        ft = sorted((t / f"{side}_depth_confidence").glob("*.npz"))
        assert [f.name for f in ft] == [f.name for f in fj] and len(fj) == 12
        for a, b in zip(fj, ft):
            A, B = np.load(a), np.load(b)
            for k in A.files:
                assert A[k].dtype == B[k].dtype
                np.testing.assert_array_equal(B[k], A[k])
        for member in ("timestamps", "confidence", "valid_count"):
            np.testing.assert_array_equal(
                np.load(t / f"cache/confidence/{side}_{member}.npy"),
                np.load(j / f"cache/confidence/{side}_{member}.npy"))


def _tables(root: Path, pattern: str):
    return {p.name: np.load(p) for p in sorted(root.glob(pattern))}


@pytest.mark.parametrize("pattern,atol", [
    ("cache/dataset/*_fragment_*_dataset.npz", 1e-9),
    ("dataset/*_depth_dataset_optimized.npz", 5e-5)])
def test_poses_match(runs, pattern, atol):
    j, t, _ = runs
    a, b = _tables(j, pattern), _tables(t, pattern)
    assert sorted(a) == sorted(b) and len(a) in (2, 4)
    for name in a:
        assert a[name].files == b[name].files
        for k in a[name].files:
            if k in ("positions", "rotations"):
                np.testing.assert_allclose(b[name][k], a[name][k], rtol=0, atol=atol,
                                           err_msg=f"{name} {k}")
            else:
                np.testing.assert_array_equal(b[name][k], a[name][k], err_msg=f"{name} {k}")


def test_volume_blocks_equal(runs):
    j, t, run = runs
    a = np.load(j / "reconstruction/colorless_vbg.npz")
    b = np.load(t / "reconstruction/colorless_vbg.npz")
    np.testing.assert_array_equal(b["block_coords"], a["block_coords"])
    assert len(a["block_coords"]) > 30 and run.volume.n_active == len(a["block_coords"])


def test_each_package_reads_the_others_frame_tables(runs):
    j, t, _ = runs
    a = JaxDataIO(t).depth.load_optimized_depth_dataset(JaxSide.LEFT)
    b = DataIO(j).depth.load_optimized_depth_dataset(Side.LEFT)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert len(JaxDataIO(t).reconstruction.load_fragment_datasets()[JaxSide.RIGHT]) == 2
    assert len(DataIO(j).reconstruction.load_fragment_datasets()[Side.RIGHT]) == 2


@pytest.mark.parametrize("name", ["pipeline_config.yml", "pipeline_config_batch.yml",
                                  "pipeline_config_sharp_textures.yml"])
def test_shipped_configs_load(name):
    """Every config the repo ships turns steps 1-2 on, and the port takes
    each as it is."""
    path = REPO / "config" / name
    rc = PipelineConfigs.parse_config_yml(path).reconstruction
    assert rc.estimate_depth_confidences and rc.optimize_depth_pose
    assert PipelineProcessor(REPO, path, device="cpu").pipeline_configs.reconstruction \
        .fragment_generation.fragment_size == rc.fragment_generation.fragment_size
