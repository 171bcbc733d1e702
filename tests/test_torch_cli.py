"""mq3d_tpu_torch's command-line tools against the JAX package's scripts,
on the CPU (--device cpu), in-process.

A tiny synthetic capture goes through the port's run_full_pipeline CLI with
the colour steps on, --export-fbx and --profile; the other tools then run
on its outputs, each beside the JAX script of the same name (whose main()
reads sys.argv, patched here).  A second capture goes through the three
step CLIs of each package.  Tolerances: none.  FBX, COLMAP, PLY and CSV
outputs are equal byte for byte, the comparison JSON equal (the
nearest-neighbour distances are bit-equal, tests/test_torch_eval.py), PNG
pixels and volume arrays equal.  The JAX evaluate_mesh_quality script fails
on FBX input (it imports a reader its package lacks); the port's reads it.
"""

import importlib
import json
import shutil
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mq3d_tpu.export.fbx import convert_ply_to_fbx as jax_convert_ply_to_fbx
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig as JaxSceneConfig
from mq3d_tpu.testing.synthetic import write_synthetic_project as write_jax_project
from mq3d_tpu_torch.dataio.ply import TriangleMesh, read_ply, write_ply_mesh
from mq3d_tpu_torch.export.colmap import read_model
from mq3d_tpu_torch.scripts import (
    build_colmap_project,
    compare_mesh_to_ground_truth,
    convert_depth_to_linear_map,
    convert_obj_to_fbx,
    convert_yuv_to_rgb,
    downsample_fbx_mesh,
    evaluate_fbx_quality,
    evaluate_mesh_quality,
    reconstruct_scene,
    run_full_pipeline,
)
from mq3d_tpu_torch.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.utils.png import imread_bgr, imwrite

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def jax_script(name: str, argv, monkeypatch):
    """Run scripts/<name>.py's main() with sys.argv set to argv."""
    module = importlib.import_module(f"scripts.{name}")
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + [str(a) for a in argv])
    return module.main()


def _config(tmp: Path, colored: bool) -> Path:
    cfg = yaml.safe_load((REPO / "config/pipeline_config_batch.yml").read_text())
    rc = cfg["reconstruction"]
    rc.update(estimate_depth_confidences=False, optimize_depth_pose=False,
              optimize_color_pose=colored, render_color_aligned_depth=False,
              sample_point_cloud_from_colored_mesh=colored, points_per_vertex_ratio=0.5,
              use_dataset_cache=False, use_colorless_vbg_cache=False)
    rc["depth_integration"].update(
        voxel_size=0.05, block_count=2048, grid_dim=16, depth_max=4.0,
        trunc_voxel_multiplier=4.0, chunk_active_capacity=2048, integrate_tile=256,
        frames_per_batch=8, use_confidence_filtered_depth=False)
    rc["color_optimization"].update(weight_threshold=1.5, interval=4, max_iteration=6,
                                    min_triangle_count=100, use_dataset_cache=False)
    path = tmp / f"{'colored' if colored else 'colorless'}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def colored(tmp_path_factory):
    """(work dir, session) after the port's run_full_pipeline CLI with the
    colour steps, --export-fbx and --profile."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    session = tmp / "session"
    write_synthetic_project(session, SyntheticSceneConfig(n_frames=12))
    run_full_pipeline.main(["--session_dir", str(session), "--config",
                            str(_config(tmp, colored=True)), "--device", "cpu",
                            "--export-fbx", "--profile", str(tmp / "trace")])
    yield tmp, session
    shutil.rmtree(tmp, ignore_errors=True)


def test_export_fbx_equals_the_jax_conversion(colored):
    tmp, session = colored
    recon = session / "reconstruction"
    assert len(read_ply(recon / "color_mesh.ply").triangles) > 1000
    jax_convert_ply_to_fbx(recon / "color_mesh.ply", tmp / "jax_color_mesh.fbx")
    assert (recon / "color_mesh.fbx").read_bytes() == (tmp / "jax_color_mesh.fbx").read_bytes()
    runtime = (session / "pipeline_runtime.txt").read_text()
    assert "  export_fbx: " in runtime and "  reconstruct_scene: " in runtime


def test_profile_trace_names_the_stages(colored):
    tmp, _ = colored
    trace = json.loads((tmp / "trace" / run_full_pipeline.TRACE_NAME).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    for stage in ("convert_yuv_to_rgb", "convert_depth_to_linear", "reconstruct_scene",
                  "export_fbx"):
        assert stage in names, stage


def test_build_colmap_project_equal(colored, monkeypatch):
    tmp, session = colored
    build_colmap_project.main(["--project_dir", str(session), "--output_dir",
                               str(tmp / "port_colmap"), "--include_points", "--device", "cpu"])
    jax_script("build_colmap_project", ["--project_dir", session, "--output_dir",
                                        tmp / "jax_colmap", "--include_points"], monkeypatch)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        want = (tmp / "jax_colmap/distorted/sparse/0" / name).read_bytes()
        assert (tmp / "port_colmap/distorted/sparse/0" / name).read_bytes() == want, name
    # One image per keyframe of the optimized colour datasets (interval 4).
    want = sorted((tmp / "jax_colmap/input").iterdir())
    got = sorted((tmp / "port_colmap/input").iterdir())
    assert [p.name for p in got] == [p.name for p in want] and len(want) == 6
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(got, want))
    cameras, images, points = read_model(tmp / "jax_colmap/distorted/sparse/0")
    assert len(cameras) == 2 and len(images) == 6
    assert len(points) == len(read_ply(session / "reconstruction/color.ply").points) > 0


def box_mesh(lo, hi) -> TriangleMesh:
    """An axis-aligned box as 8 corners and 12 triangles."""
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])], float)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 5, 7, 3)]
    tris = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
    return TriangleMesh(corners, np.asarray(tris, np.int64))


@pytest.mark.parametrize("align", ["none", "center"])
def test_compare_mesh_to_ground_truth_equal(colored, monkeypatch, capsys, align):
    tmp, session = colored
    scene = SyntheticSceneConfig()
    gt = tmp / "gt_room.ply"
    write_ply_mesh(gt, box_mesh(scene.box_min, scene.box_max))
    pred = session / "reconstruction/color_mesh.ply"
    args = ["--pred", pred, "--gt", gt, "--samples", "3000", "--align", align]
    capsys.readouterr()
    jax_script("compare_mesh_to_ground_truth", args + ["--heatmap", tmp / f"jax_{align}.ply"],
               monkeypatch)
    want = json.loads(capsys.readouterr().out.split("[Info]")[0])
    got = compare_mesh_to_ground_truth.main(
        [str(a) for a in args] + ["--heatmap", str(tmp / f"port_{align}.ply"),
                                  "--html", str(tmp / f"port_{align}.html"), "--device", "cpu"])
    assert got == want
    assert 0 < want["mean_to_gt"] < 0.1 and want["pred_surface_area"] > 0  # 2 voxels
    assert (tmp / f"port_{align}.ply").read_bytes() == (tmp / f"jax_{align}.ply").read_bytes()
    assert "mean_to_gt" in (tmp / f"port_{align}.html").read_text()


def test_evaluate_mesh_quality_csv_equal(colored, monkeypatch):
    tmp, session = colored
    recon = session / "reconstruction"
    meshes = [recon / "color_mesh.ply", recon / "colorless_mesh_clean.ply",
              recon / "colorless_mesh_raw.ply"]
    evaluate_mesh_quality.main([str(m) for m in meshes] + ["--csv", str(tmp / "port_q.csv")])
    jax_script("evaluate_mesh_quality", meshes + ["--csv", tmp / "jax_q.csv"], monkeypatch)
    assert (tmp / "port_q.csv").read_bytes() == (tmp / "jax_q.csv").read_bytes()


def test_evaluate_mesh_quality_pairs_equal(colored, monkeypatch):
    tmp, session = colored
    recon = session / "reconstruction"
    pairs = ["--pair", recon / "color_mesh.ply", recon / "colorless_mesh_clean.ply",
             "--pair", recon / "colorless_mesh_raw.ply", recon / "color_mesh.ply"]
    evaluate_mesh_quality.main([str(a) for a in pairs] + ["--report-dir", str(tmp / "port_r")])
    jax_script("evaluate_mesh_quality", pairs + ["--report-dir", tmp / "jax_r"], monkeypatch)
    want = (tmp / "jax_r/pairwise_summary.csv").read_bytes()
    assert (tmp / "port_r/pairwise_summary.csv").read_bytes() == want
    assert "base64" in (tmp / "port_r/pairwise_quality_report.html").read_text()


def test_evaluate_mesh_quality_reads_fbx(colored, monkeypatch):
    """The port scores the exported FBX as the PLY it came from; the JAX
    script raises ImportError on any FBX input (ROADMAP C7)."""
    tmp, session = colored
    recon = session / "reconstruction"
    [ply] = evaluate_mesh_quality.main([str(recon / "color_mesh.ply")])
    [fbx] = evaluate_fbx_quality.main([str(recon / "color_mesh.fbx")])
    raw_ply, raw_fbx = asdict(ply.raw), asdict(fbx.raw)
    for k in ("name", "path"):
        raw_ply.pop(k), raw_fbx.pop(k)
    assert raw_fbx == raw_ply and raw_ply["has_color"]
    with pytest.raises(ImportError):
        jax_script("evaluate_mesh_quality", [recon / "color_mesh.fbx"], monkeypatch)


@pytest.mark.parametrize("method", ["quadric", "cluster"])
@pytest.mark.parametrize("suffixes", [(".ply", ".ply"), (".fbx", ".fbx")],
                         ids=["ply", "fbx"])
def test_downsample_fbx_mesh_equal(colored, monkeypatch, method, suffixes):
    tmp, session = colored
    src = session / f"reconstruction/color_mesh{suffixes[0]}"
    port_out = tmp / f"port_down_{method}{suffixes[1]}"
    jax_out = tmp / f"jax_down_{method}{suffixes[1]}"
    out = downsample_fbx_mesh.main(["--input", str(src), "--output", str(port_out),
                                    "--ratio", "0.25", "--method", method])
    jax_script("downsample_fbx_mesh", ["--input", src, "--output", jax_out, "--ratio", "0.25",
                                       "--method", method], monkeypatch)
    assert port_out.read_bytes() == jax_out.read_bytes()
    n = len(read_ply(session / "reconstruction/color_mesh.ply").triangles)
    assert 0.1 * n < len(out.triangles) < 0.4 * n


def test_convert_obj_to_fbx_equal(tmp_path, monkeypatch):
    tex = np.zeros((16, 16, 3), np.uint8)
    tex[:, :8] = (0, 0, 255)
    tex[:, 8:] = (255, 0, 0)
    imwrite(tmp_path / "tex.png", tex)
    (tmp_path / "mesh.mtl").write_text("newmtl mat0\nKd 0.5 0.5 0.5\nmap_Kd tex.png\n")
    (tmp_path / "mesh.obj").write_text(
        "mtllib mesh.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0.1 0.5\nvt 0.9 0.5\nvt 0.9 0.5\nvt 0.1 0.5\nusemtl mat0\nf 1/1 2/2 3/3 4/4\n")
    convert_obj_to_fbx.main(["--input", str(tmp_path / "mesh.obj"), "--output",
                             str(tmp_path / "port.fbx"), "--keep-ply"])
    jax_script("convert_obj_to_fbx", ["--input", tmp_path / "mesh.obj", "--output",
                                      tmp_path / "jax.fbx"], monkeypatch)
    assert (tmp_path / "port.fbx").read_bytes() == (tmp_path / "jax.fbx").read_bytes()
    assert (tmp_path / "port.ply").exists() and not (tmp_path / "jax.ply").exists()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(jax session, port session): one capture (the JAX package's writer)
    through each package's three step CLIs, colorless settings."""
    tmp = tmp_path_factory.mktemp("torch_cli_steps")
    write_jax_project(tmp / "jax", JaxSceneConfig(n_frames=12))
    shutil.copytree(tmp / "jax", tmp / "port")
    cfg = _config(tmp, colored=False)
    mp = pytest.MonkeyPatch()
    for name in ("convert_yuv_to_rgb", "convert_depth_to_linear_map", "reconstruct_scene"):
        jax_script(name, ["--project_dir", tmp / "jax", "--config", cfg], mp)
    mp.undo()
    args = ["--project_dir", str(tmp / "port"), "--config", str(cfg), "--device", "cpu"]
    convert_yuv_to_rgb.main(args)
    convert_depth_to_linear_map.main(args)
    reconstruct_scene.main(args)
    yield tmp / "jax", tmp / "port"
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("kind", ["camera_rgb", "depth_linear"])
def test_step_cli_pngs_equal(steps, kind):
    j, t = steps
    for side in ("left", "right"):
        fj = sorted((j / f"{side}_{kind}").glob("*.png"))
        ft = sorted((t / f"{side}_{kind}").glob("*.png"))
        assert [f.name for f in fj] == [f.name for f in ft] and len(fj) == 12
        for a, b in zip(fj, ft):
            np.testing.assert_array_equal(imread_bgr(b), imread_bgr(a))


def test_step_cli_volumes_equal(steps):
    j, t = steps
    a = np.load(j / "reconstruction/colorless_vbg.npz")
    b = np.load(t / "reconstruction/colorless_vbg.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    pa = read_ply(j / "reconstruction/colorless.ply").points
    pb = read_ply(t / "reconstruction/colorless.ply").points
    assert len(pa) > 1000
    np.testing.assert_array_equal(pb[np.lexsort(pb.T)], pa[np.lexsort(pa.T)])
