"""The mq3d_tpu_torch slice end to end against the JAX package, on the CPU.

One synthetic capture (the JAX package's writer) goes through each
package's full pipeline: YUV -> BGR PNGs, NDC depth -> linear PNGs, then
reconstruction steps 0 and 3.  Tolerances: decoded PNG pixels, frame-table
npz files and the colorless_vbg.npz arrays are compared exactly (tsdf
within 1e-6 would be allowed by tests/test_tsdf.py's tolerance, but the
port reproduces the reference's float32 arithmetic, so it is exact); the
point cloud exactly after a canonical sort.  Each package's TSDFVolume.load
reads the other's colorless_vbg.npz.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mq3d_tpu.dataio.ply import read_ply as jax_read_ply
from mq3d_tpu.ops.tsdf import TSDFVolume as JaxVolume
from mq3d_tpu.pipeline.processor import PipelineProcessor as JaxProcessor
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.config.configs import PipelineConfigs
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.pipeline.processor import run_full_pipeline
from mq3d_tpu_torch.utils.png import imread_bgr

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _config(tmp: Path, frames_per_batch: int) -> Path:
    cfg = yaml.safe_load((REPO / "config/pipeline_config_batch.yml").read_text())
    rc = cfg["reconstruction"]
    for k in ("estimate_depth_confidences", "optimize_depth_pose",
              "optimize_color_pose", "render_color_aligned_depth"):
        rc[k] = False
    rc["use_dataset_cache"] = False
    rc["use_colorless_vbg_cache"] = False
    rc["depth_integration"].update(
        voxel_size=0.05, block_count=2048, grid_dim=16, depth_max=4.0,
        trunc_voxel_multiplier=4.0, chunk_active_capacity=2048, integrate_tile=256,
        frames_per_batch=frames_per_batch, use_confidence_filtered_depth=False)
    path = tmp / f"cfg_{frames_per_batch}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module", params=[8, 32], ids=["chunked", "one-chunk"])
def runs(request, tmp_path_factory):
    """(jax session, port session, port run).  frames_per_batch 8 takes
    integrate_multi (24 frames in 3 chunks); 32 takes the single-chunk
    integrate_extract_small path."""
    tmp = tmp_path_factory.mktemp(f"torch_pipeline_{request.param}")
    write_synthetic_project(tmp / "jax", SyntheticSceneConfig(n_frames=12))
    shutil.copytree(tmp / "jax", tmp / "port")
    cfg = _config(tmp, request.param)
    p = JaxProcessor(tmp / "jax", cfg)
    p.convert_yuv_to_rgb()
    p.convert_depth_to_linear()
    p.reconstruct_scene()
    run = run_full_pipeline(tmp / "port", cfg, device="cpu")
    return tmp / "jax", tmp / "port", run


@pytest.mark.parametrize("kind", ["camera_rgb", "depth_linear"])
def test_pngs_equal(runs, kind):
    cv2 = pytest.importorskip("cv2")
    j, t, _ = runs
    for side in ("left", "right"):
        fj = sorted((j / f"{side}_{kind}").glob("*.png"))
        ft = sorted((t / f"{side}_{kind}").glob("*.png"))
        assert [f.name for f in fj] == [f.name for f in ft] and len(fj) == 12
        for a, b in zip(fj, ft):
            want = cv2.imread(str(a), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(cv2.imread(str(b), cv2.IMREAD_UNCHANGED), want)
        if kind == "camera_rgb":  # the port's own reader decodes the JAX PNGs
            np.testing.assert_array_equal(imread_bgr(fj[0]), cv2.imread(str(fj[0])))
    assert not (t / "left_camera_raw").exists()  # raw YUV cleaned up as in JAX


def test_frame_tables_equal(runs):
    j, t, _ = runs
    names = sorted(p.name for p in (j / "dataset").glob("*.npz"))
    assert names == sorted(p.name for p in (t / "dataset").glob("*.npz"))
    assert "left_camera_dataset.npz" in names and "right_depth_dataset.npz" in names
    for n in names:
        a, b = np.load(j / "dataset" / n), np.load(t / "dataset" / n)
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, (n, k)
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{n}:{k}")


def test_volume_and_point_cloud_equal(runs):
    j, t, run = runs
    a = np.load(j / "reconstruction/colorless_vbg.npz")
    b = np.load(t / "reconstruction/colorless_vbg.npz")
    assert a.files == b.files and a["block_coords"].shape[0] > 0
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    pj = jax_read_ply(j / "reconstruction/colorless.ply")
    pt = jax_read_ply(t / "reconstruction/colorless.ply")
    assert len(pt.points) == len(pj.points) > 0

    def canon(p):
        o = np.lexsort(np.concatenate([p.points, p.normals], 1).T[::-1])
        return p.points[o], p.normals[o]

    for x, y in zip(canon(pj), canon(pt)):
        np.testing.assert_array_equal(y, x)
    assert run.volume.n_active == a["block_coords"].shape[0]
    assert set(run.stage_seconds) == {
        "convert_yuv_to_rgb", "convert_depth_to_linear", "reconstruct_scene"}


def test_each_package_loads_the_others_volume(runs):
    j, t, _ = runs
    jv = JaxVolume.load(t / "reconstruction/colorless_vbg.npz")
    tv = TSDFVolume.load(j / "reconstruction/colorless_vbg.npz", device="cpu")
    n = tv.n_active
    assert int(jv.n_active) == n > 0
    np.testing.assert_array_equal(tv.state.block_coords[:n].numpy(),
                                  np.asarray(jv.state.block_coords[:n]))
    np.testing.assert_array_equal(tv.state.weight[:n].numpy(), np.asarray(jv.state.weight[:n]))
    np.testing.assert_array_equal(tv.state.slot_table.numpy(), np.asarray(jv.state.slot_table))
    np.testing.assert_array_equal(tv.state.tsdf[:n].numpy(), np.asarray(jv.state.tsdf[:n]))


def test_unported_steps_raise(tmp_path):
    cfg = PipelineConfigs.parse({"reconstruction": {"optimize_depth_pose": True}})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_full_pipeline(tmp_path, cfg, device="cpu")


def test_cli_runs_on_cpu(tmp_path):
    """python -m mq3d_tpu_torch.scripts.run_full_pipeline --device cpu."""
    session = tmp_path / "session"
    write_synthetic_project(session, SyntheticSceneConfig(n_frames=4))
    cfg = _config(tmp_path, 8)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-m", "mq3d_tpu_torch.scripts.run_full_pipeline",
         "--session_dir", str(session), "--config", str(cfg), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (session / "reconstruction/colorless.ply").is_file()
    assert "seconds_per_capture" in (session / "pipeline_runtime.txt").read_text()
