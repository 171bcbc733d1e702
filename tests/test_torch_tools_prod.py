"""The port's production-scale end-to-end run
(mq3d_tpu_torch/tools/run_prod_e2e.py) and raycast micro-benchmark
(mq3d_tpu_torch/tools/bench_raycast.py) against the JAX package, on the
CPU at a small size.

run_prod_e2e: with its size constants patched (6 frames per side, 80x64
depth, 160x120 colour; the shipped sizes are checked apart), its capture
equals the JAX package's write_synthetic_project for the same scene byte
for byte, file by file; and with the verify skill's fast config (the
bench's edits of config/pipeline_config_batch.yml: 5 cm voxels, 4096
blocks, no confidence filtering, the slow steps off) patched in, it runs
`--device cpu` to pipeline_runtime.txt.

The synthetic writer's renderer (testing/synthetic.py::render_box_depth,
which tests one ray component at a time) gives the bytes of the version
it replaced and, without clutter, of the JAX package's; the furnished
room's capture is the same bytes on one worker thread and on several.

bench_raycast: on a volume of 20 frames of 80x64 at 5 cm voxels
(tests/test_torch_bench.py's settings), its renders at 128x96 equal
`raycast_depth` bit for bit and stay within tests/test_torch_raycast.py's
tolerance of the JAX package's raycast_depth on the same volume (hit/miss
equal on >= 99.9 % of pixels, |dz| <= 1e-4 m on >= 99.9 % of the pixels
both hit); its median error against the analytic depth is under a
quarter voxel, the smoke's gate at 1 cm.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mq3d_tpu.ops import raycast as jax_rc
from mq3d_tpu.ops import tsdf as jtsdf
from mq3d_tpu.testing import synthetic as jsyn
from mq3d_tpu_torch import bench as pbench
from mq3d_tpu_torch.ops import raycast as prc
from mq3d_tpu_torch.ops import tsdf as ttsdf
from mq3d_tpu_torch.testing import synthetic as psyn
from mq3d_tpu_torch.tools import bench_raycast as br
from mq3d_tpu_torch.tools import bench_reference_raycast as ref_rc
from mq3d_tpu_torch.tools import run_prod_e2e as pe

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FRAMES, DEPTH_W, DEPTH_H, COLOR_W, COLOR_H = 6, 80, 64, 160, 120
SMALL = dict(voxel_size=0.05, block_resolution=16, block_count=2048, grid_dim=16,
             depth_max=4.0, trunc_voxel_multiplier=4.0, alloc_pixel_stride=2,
             chunk_active_capacity=2048, integrate_tile=256)
W_C, H_C = 128, 96


@pytest.fixture
def small(monkeypatch):
    """run_prod_e2e at this file's size."""
    for name, value in dict(DEPTH_W=DEPTH_W, DEPTH_H=DEPTH_H, COLOR_W=COLOR_W,
                            COLOR_H=COLOR_H).items():
        monkeypatch.setattr(pe, name, value)
    monkeypatch.setenv("MQ3D_SUBSTEP_TIMING", "0")  # restored after the test
    return pe


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_shipped_sizes():
    """The tool's own sizes are the JAX tool's: 500 frames per side,
    320x288 depth, 640x480 colour, a whole orbit, the shipped config."""
    assert (pe.FRAMES, pe.DEPTH_W, pe.DEPTH_H, pe.COLOR_W, pe.COLOR_H) == (
        500, 320, 288, 640, 480)
    assert pe.SWEEP == 2 * np.pi
    assert pe.CONFIG == REPO / "config/pipeline_config.yml"
    src = (REPO / "tools/run_prod_e2e.py").read_text()
    for text in ("default=500", "depth_width=320, depth_height=288",
                 "color_width=640, color_height=480", "sweep=2 * 3.141592653589793",
                 '"config/pipeline_config.yml"'):
        assert text in src, text
    cfg = pe.scene_config()
    assert (cfg.n_frames, cfg.depth_width, cfg.color_width) == (500, 320, 640)


def test_capture_matches_jax(small, tmp_path):
    """write_capture == the JAX write_synthetic_project on the same
    scene: the same files with the same bytes."""
    secs = small.write_capture(tmp_path / "port", FRAMES)
    assert secs > 0
    jsyn.write_synthetic_project(tmp_path / "jax", jsyn.SyntheticSceneConfig(
        n_frames=FRAMES, depth_width=DEPTH_W, depth_height=DEPTH_H, color_width=COLOR_W,
        color_height=COLOR_H, sweep=2 * np.pi))
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(want) > 4 * FRAMES and sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def _render_plain(pose_cw, fx, fy, cx_flipped, cy, w, h, box_min, box_max, clutter):
    """The renderer as it was written first, on (h, w, 3) rays: face
    points from the whole ray, slab tests reduced with nanmax / nanmin."""
    d_world = psyn._camera_rays(fx, fy, cx_flipped, cy, w, h) @ pose_cw[:3, :3].T
    c = pose_cw[:3, 3]
    t_exit = np.full((h, w), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis in range(3):
            for bound in (box_min[axis], box_max[axis]):
                t = (bound - c[axis]) / d_world[..., axis]
                t = np.where(np.isfinite(t) & (t > 1e-9), t, np.inf)
                p = c + np.where(np.isfinite(t), t, 0.0)[..., None] * d_world
                on_face = np.ones((h, w), dtype=bool)
                for a in (a for a in range(3) if a != axis):
                    on_face &= (p[..., a] >= box_min[a] - 1e-9) & (p[..., a] <= box_max[a] + 1e-9)
                t_exit = np.minimum(t_exit, np.where(on_face, t, np.inf))
        for lo, hi in clutter:
            t0 = (np.asarray(lo) - c) / d_world
            t1 = (np.asarray(hi) - c) / d_world
            t_in = np.nanmax(np.minimum(t0, t1), axis=-1)
            t_out = np.nanmin(np.maximum(t0, t1), axis=-1)
            hit = (t_in <= t_out) & (t_in > 1e-9)
            t_exit = np.minimum(t_exit, np.where(hit, t_in, np.inf))
    return t_exit


@pytest.mark.parametrize("clutter", [(), psyn.ROOM_CLUTTER], ids=["box", "furnished"])
def test_render_box_depth_bytes(clutter):
    """render_box_depth, one ray component at a time, gives the bytes of
    the (h, w, 3) version it replaced, with and without the furnished
    room's clutter, over a whole orbit and from poses whose rays run
    parallel to a wall (a zero ray component, and a 0 / 0 slab); without clutter
    also the bytes of the JAX package's render_box_depth."""
    from mq3d_tpu.testing.synthetic import render_box_depth as jax_render

    scene = psyn.quest_scene(24, clutter)
    poses = list(psyn.orbit_poses_o3d(dataclasses.replace(scene, sweep=2 * np.pi))
                 .extrinsics_cw.astype(np.float64))
    # The optical axis along +z from x = 1.5, the plane of the first
    # clutter box's -x face, in front of that box: the centre column's
    # rays have x == 0 and graze the face, so that box's x slab is 0 / 0
    # there and the entry point comes from the other two slabs.
    level = np.eye(4)
    level[:3, 3] = (1.5, -0.5, -1.3)
    poses.append(level)
    w, h = 96, 72
    fx, fy, cx, cy = psyn.intrinsics_from_cfg(scene, w, h)
    cx = w / 2 + 0.0  # a principal point on a pixel, so a ray has a zero x
    cy = h / 2 + 0.0
    for pose in poses:
        args = (pose, fx, fy, w - cx, cy, w, h, scene.box_min, scene.box_max)
        got = psyn.render_box_depth(*args, clutter)
        assert got.tobytes() == _render_plain(*args, clutter).tobytes()
        assert np.isfinite(got).all()
        if not clutter:
            assert got.tobytes() == jax_render(*args).tobytes()


def test_furnished_capture_workers(tmp_path):
    """The furnished room's capture is the same bytes on one worker thread
    and on three (depth and colour frames render on the pool)."""
    scene = dataclasses.replace(psyn.quest_scene(6, psyn.ROOM_CLUTTER), depth_width=DEPTH_W,
                                depth_height=DEPTH_H, color_width=COLOR_W,
                                color_height=COLOR_H)
    psyn.write_synthetic_project(tmp_path / "one", scene, workers=1)
    psyn.write_synthetic_project(tmp_path / "many", scene, workers=3)
    want, got = _files(tmp_path / "one"), _files(tmp_path / "many")
    assert sorted(got) == sorted(want) and len(want) > 4 * 6
    for name in want:
        assert got[name] == want[name], name


def test_bgr_to_i420_is_cv2s_over_every_triple():
    """The port's writer converts BGR to I420 as cv2.cvtColor does, byte
    for byte, over all 2^24 BGR triples: each triple fills one 2x2 quad
    (chroma comes from the quad's top-left pixel), and a second image
    shifts the odd rows so that each quad's other pixels differ."""
    import cv2

    rg = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    for b in range(256):
        img = np.empty((256, 256, 3), np.uint8)
        img[..., 0], img[..., 1], img[..., 2] = b, rg[..., 1], rg[..., 0]
        quads = np.repeat(np.repeat(img, 2, 0), 2, 1)
        mixed = quads.copy()
        mixed[1::2] = np.roll(quads[1::2], 1, axis=1)
        for im in (quads, mixed):
            np.testing.assert_array_equal(psyn.bgr_to_i420(im),
                                          cv2.cvtColor(im, cv2.COLOR_BGR2YUV_I420))


def _fast_config(path: Path) -> Path:
    """The verify skill's fast config, written as JSON (which YAML reads)."""
    cfg = yaml.safe_load(pbench.E2E_CONFIG.read_text())
    rec = cfg["reconstruction"]
    for k in ("fragment_pose_refinement", "depth_integration"):
        rec[k].update(pbench.E2E_VOLUME)
    for k in pbench.E2E_OFF:
        rec[k] = False
    path.write_text(json.dumps(cfg))
    return path


def test_cpu_run_writes_pipeline_runtime(small, tmp_path, monkeypatch, capsys):
    """--device cpu at 6 frames per side: the capture's seconds apart, the
    pipeline's wall clock, [Substep] lines, pipeline_runtime.txt with
    every stage, and the launch counts on stderr; --keep reuses the
    capture."""
    monkeypatch.setattr(pe, "CONFIG", _fast_config(tmp_path / "fast.json"))
    proj = tmp_path / "proj"
    res = small.main(["--project", str(proj), "--frames", str(FRAMES), "--device", "cpu"])
    captured = capsys.readouterr()
    rt = (proj / "pipeline_runtime.txt").read_text()
    for stage in ("convert_yuv_to_rgb", "convert_depth_to_linear", "reconstruct_scene"):
        assert f"  {stage}: " in rt, stage
    assert "device: cpu" in rt
    for a in ("reconstruction/colorless.ply", "reconstruction/colorless_vbg.npz"):
        assert (proj / a).stat().st_size > 0, a
    assert "[prod-e2e] capture generated in" in captured.out
    assert "[prod-e2e] pipeline wall-clock:" in captured.out and "[Substep]" in captured.out
    assert rt in captured.out
    assert "[prod-e2e] kernel launches {" in captured.err
    assert res["capture_s"] > 0 and res["pipeline_s"] > 0
    assert res["launches"]["patch_lookup"] == 0  # no kernel on the CPU
    stamp = (proj / "reconstruction/colorless.ply").stat().st_mtime_ns
    capture_file = next(p for p in sorted(proj.rglob("*.csv")))
    before = capture_file.stat().st_mtime_ns
    res = small.main(["--project", str(proj), "--keep", "--device", "cpu"])
    assert res["capture_s"] is None and capture_file.stat().st_mtime_ns == before
    assert (proj / "reconstruction/colorless.ply").stat().st_mtime_ns >= stamp


@pytest.fixture(scope="module")
def volume():
    return ref_rc.build_volume("cpu", ttsdf.TSDFConfig(**SMALL), n_integrate=20, w=DEPTH_W,
                               h=DEPTH_H)


def test_raycast_render_matches_port_and_jax(volume):
    vol, gt, cfg_s = volume
    warm, ms, d = br.render_views(vol, gt, cfg_s, 2, W_C, H_C)
    assert warm > 0 and len(ms) == 2 and all(t > 0 for t in ms)
    K = ref_rc.view_intrinsics(cfg_s, W_C, H_C)
    T_wc = np.linalg.inv(gt.extrinsics_cw[1])
    np.testing.assert_array_equal(d, prc.raycast_depth(vol, K, T_wc, W_C, H_C))
    state = {k: np.asarray(v) for k, v in ttsdf.state_to_numpy(vol.state).items()}
    jstate = jtsdf.TSDFState(**{k: state[k] for k in jtsdf.TSDFState._fields})
    jvol = jtsdf.TSDFVolume(jtsdf.TSDFConfig(**SMALL), jstate)
    want = np.asarray(jax_rc.raycast_depth(jvol, K, T_wc, W_C, H_C))
    fw, fg = np.isfinite(want), np.isfinite(d)
    assert fw.mean() > 0.5
    assert (fw == fg).mean() >= 0.999
    both = fw & fg
    assert (np.abs(d[both] - want[both]) <= 1e-4).mean() >= 0.999
    acc = ref_rc.accuracy(d, ref_rc.analytic_depth(gt, cfg_s, 1, W_C, H_C))
    assert acc["coverage"] > 0.7 and acc["median_mm"] < 0.25 * SMALL["voxel_size"] * 1e3, acc


def test_bench_raycast_main_on_the_cpu(volume, monkeypatch, capsys):
    """main --device cpu (its volume and render size patched to this
    file's) prints the JAX tool's lines and one JSON line."""
    monkeypatch.setattr(br, "build_volume", lambda dev, cfg: volume)
    monkeypatch.setattr(br, "W_C", W_C)
    monkeypatch.setattr(br, "H_C", H_C)
    line = br.main(["2", "--device", "cpu"])
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(line))
    for s in ("volume: ", "warmup: ", "per-frame: median", "accuracy: median"):
        assert any(x.startswith(s) for x in lines), s
    assert "[bench-raycast] volume build: kernel launches" in out.err
    assert line["ms_per_frame"] > 0 and len(line["ms"]) == 2
    assert line["accuracy"]["median_mm"] < 0.25 * SMALL["voxel_size"] * 1e3



@pytest.mark.parametrize("tool", [pe, br])
def test_no_hidden_fallback(tool, monkeypatch, capsys, tmp_path):
    """Without CUDA each tool raises unless --device cpu, before writing
    or measuring anything; invalid sizes are refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--project", str(tmp_path / "p")] if tool is pe else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(args)
    bad = ["--frames", "0"] if tool is pe else ["0"]
    with pytest.raises(SystemExit):
        tool.main(args + bad + ["--device", "cpu"])
    assert not (tmp_path / "p").exists()
    assert capsys.readouterr().out == ""
