"""Benchmark of the port on one card: the JAX package's bench.py, measured here.

    python -m mq3d_tpu_torch.bench [--device cuda] [--frames 1000] [--reps 3]

Prints bench.py's one JSON line on standard output, with the same
`metric`, `unit` and `extra` keys, plus `extra.device` (nvidia-smi's name
and power limit of the card, the host's CPU model and thread count).
Primary metric: TSDF integration frames/s of the device-resident
scan-fused path at the reference's production settings (voxel 1 cm,
16^3 blocks, 50 000 blocks, depth_max 4 m, 320x288 Quest depth) over
bench.py's synthetic 1000-frame capture.  `extra` carries the streamed
rates (per chunk, scan-fused float32, scan-fused uint16), the staging
rate, the 1280x960 raycast (device and streamed ms per frame), the
partitioned sharded step on a group of one rank and the end-to-end
`run_full_pipeline` seconds of a 16-frame capture.

Every rate is the median of `--reps` repetitions, each from a fresh
volume; every repetition is printed on standard error.  bench.py reports
the best of its repetitions and fetches a scalar to close each timed
window, because its TPU's remote transport throttled for minutes after a
cold connect and its `block_until_ready` did not block.  Here each timed
window opens and closes with `torch.cuda.synchronize()`, and the median
is the number that a repeated run reproduces.  As in bench.py, the first
group of each integration is an untimed warm-up.

There is no fallback: without CUDA the bench raises unless `--device cpu`
is given, and then `extra.device.platform` says "cpu" and its rates are
CPU numbers, not the card's.  A failed measurement raises before the JSON
line is printed.  `--frames` and `--reps` exist to run a small size in
the tests; their defaults are bench.py's workload.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.kernels._build import launch_counts, reset_launch_counts
from mq3d_tpu_torch.models.datasets import CameraDataset
from mq3d_tpu_torch.ops.raycast import _render_frames_device, raycast_in_color_view
from mq3d_tpu_torch.ops.tsdf import (
    TSDFConfig,
    TSDFVolume,
    create_state,
    integrate_chunk,
    integrate_chunks,
    integrate_chunks_u16,
    quantize_depth_u16,
)
from mq3d_tpu_torch.parallel.dist import destroy_group, init_group
from mq3d_tpu_torch.parallel.sharded import create_state_partitioned, sharded_integrate_step
from mq3d_tpu_torch.testing.synthetic import (
    SyntheticSceneConfig,
    intrinsics_from_cfg,
    orbit_poses_o3d,
    render_box_depth,
    write_synthetic_project,
)
from mq3d_tpu_torch.tools._reference import host_cpu

# The CPU reference baselines: all-threads medians of the two reference
# tools on the card's host (PERF.md section 6, the entry on this bench).
# mq3d_tpu_torch/tools/bench_reference_cpu.py, 200 frames of this capture,
# median of 3: 104.51 frames/s on the card host's 8 threads (an Intel CPU,
# family 6 model 207, whose model name the virtual machine hides; 24.72 on
# one thread), beside an NVIDIA H100 80GB HBM3 at 700.00 W.
BASELINE_FRAMES_PER_SEC = 104.51
# mq3d_tpu_torch/tools/bench_reference_raycast.py, 8 views of 1280x960 of
# the port's 1.71 M-triangle marching-cubes mesh, median per frame: 83.11
# ms on the same host's 8 threads (606.10 on one thread).
BASELINE_RAYCAST_MS = 83.11
# bench.py's earlier raycast budget, kept for its raycast_vs_legacy_budget.
LEGACY_RAYCAST_BUDGET_MS = 200.0

N_FRAMES = 1000
H, W = 288, 320
H_C, W_C = 960, 1280
CHUNK = 20
SCAN = 5  # chunks per scan-fused launch
RAYCAST_BATCH = 8
UNIQUE = 50  # distinct renders the capture cycles through
REPS = 3
E2E_FRAMES = 16

# bench.py's TSDFConfig (its main): the production integration settings.
TSDF_SETTINGS = dict(
    voxel_size=0.01,
    block_resolution=16,
    block_count=50_000,
    grid_dim=160,
    depth_max=4.0,
    trunc_voxel_multiplier=10.0,
    alloc_pixel_stride=2,
    chunk_active_capacity=12_288,
    integrate_tile=512,
)

# bench_e2e's edits of config/pipeline_config_batch.yml (bench.py's).
E2E_CONFIG = Path(__file__).resolve().parent.parent / "config/pipeline_config_batch.yml"
E2E_VOLUME = dict(voxel_size=0.05, block_count=4096, use_confidence_filtered_depth=False)
E2E_OFF = ("estimate_depth_confidences", "optimize_depth_pose", "optimize_color_pose",
           "render_color_aligned_depth")
E2E_ARTIFACTS = ("reconstruction/colorless.ply", "reconstruction/colorless_vbg.npz",
                 "pipeline_runtime.txt")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def bench_config() -> TSDFConfig:
    return TSDFConfig(**TSDF_SETTINGS)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def make_capture(n_frames: int = N_FRAMES, h: int = H, w: int = W):
    """bench.py's synthetic room orbit at Quest depth-camera scale: n_frames
    frames cycling through 50 renders.  Returns depth (n, h, w) float32,
    K (n, 3, 3) float32, T_wc (n, 4, 4) float32, valid (n,), the
    ground-truth poses and the scene config, host numpy."""
    cfg = SyntheticSceneConfig(
        n_frames=n_frames, depth_width=w, depth_height=h, sweep=2 * np.pi
    )
    fx, fy, cx, cy = intrinsics_from_cfg(cfg, w, h)
    cxf = w - cx
    gt = orbit_poses_o3d(cfg)
    poses_cw = gt.extrinsics_cw.astype(np.float64)

    depths = np.empty((UNIQUE, h, w), np.float32)
    for i in range(UNIQUE):
        depths[i] = render_box_depth(
            poses_cw[i * (n_frames // UNIQUE)], fx, fy, cxf, cy, w, h,
            cfg.box_min, cfg.box_max,
        )
    depth = depths[np.arange(n_frames) % UNIQUE]

    K = np.zeros((n_frames, 3, 3), np.float32)
    K[:, 0, 0] = fx
    K[:, 1, 1] = fy
    K[:, 0, 2] = cxf
    K[:, 1, 2] = cy
    K[:, 2, 2] = 1
    order = (np.arange(n_frames) % UNIQUE) * (n_frames // UNIQUE)
    T_wc = np.linalg.inv(poses_cw[order]).astype(np.float32)
    valid = np.ones(n_frames, bool)
    return depth, K, T_wc, valid, gt, cfg


def _group_starts(n: int) -> list:
    """First frames of bench.py's scan-fused groups (SCAN chunks each)
    that n frames fill."""
    per = SCAN * CHUNK
    return list(range(0, (n // per) * per, per))


def _group(a, s0: int) -> np.ndarray:
    """The group of frames from s0 as (SCAN, CHUNK, ...)."""
    return a[s0:s0 + SCAN * CHUNK].reshape(SCAN, CHUNK, *a.shape[1:])


def bench_integrate(cfg, depth, K, T_wc, valid, device="cuda", reps: int = REPS):
    """Per-chunk streamed integrate: one integrate_chunk per 20 frames, the
    chunk copied to the device per call.  Returns (frames/s of each rep,
    the last rep's state)."""
    dev = resolve_device(device)
    n = depth.shape[0]

    def chunk(s):
        return [_tensor(a[s:s + CHUNK], dev) for a in (depth, K, T_wc, valid)]

    rates, state = [], None
    for _ in range(reps):
        state = None  # free the previous rep's volume first
        state = create_state(cfg, dev)
        integrate_chunk(cfg, state, *chunk(0))
        _sync(dev)
        t0 = time.perf_counter()
        for s in range(CHUNK, n, CHUNK):
            integrate_chunk(cfg, state, *chunk(s))
        _sync(dev)
        rates.append((n - CHUNK) / (time.perf_counter() - t0))
    return rates, state


def _fused(cfg, n, put, launch, device, reps):
    """The scan-fused loop of bench.py: group 0 untimed, then the other
    whole groups, each group's inputs from put(s0)."""
    starts = _group_starts(n)
    if len(starts) < 2:
        raise ValueError(f"{n} frames hold fewer than two groups of {SCAN * CHUNK}")
    rates, state = [], None
    for _ in range(reps):
        state = None
        state = create_state(cfg, device)
        launch(state, *put(starts[0]))
        _sync(device)
        t0 = time.perf_counter()
        for s0 in starts[1:]:
            launch(state, *put(s0))
        _sync(device)
        rates.append((len(starts) - 1) * SCAN * CHUNK / (time.perf_counter() - t0))
    return rates, state


def bench_integrate_fused(cfg, depth, K, T_wc, valid, device="cuda", reps: int = REPS):
    """Scan-fused streamed integrate: one integrate_chunks call per group of
    5 chunks of 20 frames, the group's float32 inputs copied per call.
    Returns (frames/s of each rep, the last rep's state)."""
    dev = resolve_device(device)

    def put(s0):
        return [_tensor(_group(a, s0), dev) for a in (depth, K, T_wc, valid)]

    return _fused(cfg, depth.shape[0], put,
                  lambda state, *args: integrate_chunks(cfg, state, *args), dev, reps)


def bench_integrate_fused_u16(cfg, depth, K, T_wc, valid, device="cuda",
                              reps: int = REPS):
    """bench_integrate_fused with uint16 fixed-point depth
    (quantize_depth_u16 on the host, outside the clock; dequantized on the
    device by integrate_chunks_u16): half the depth bytes per call.
    Returns (frames/s of each rep, the last rep's state)."""
    dev = resolve_device(device)
    dq, scale = quantize_depth_u16(depth, cfg.depth_max)

    def put(s0):
        return [_tensor(_group(a, s0), dev) for a in (dq, K, T_wc, valid)]

    def launch(state, d, k, t, v):
        integrate_chunks_u16(cfg, state, d, scale, k, t, v)

    return _fused(cfg, depth.shape[0], put, launch, dev, reps)


def bench_integrate_devres(cfg, depth, K, T_wc, valid, device="cuda", reps: int = REPS):
    """Device-resident scan-fused integrate: every whole group staged on
    the device first, one (5, 20, H, W) tensor per group as the streamed
    path sees it (timed: the staging rate), then integrated with no copy
    per call.  Each rep stages anew.  Returns (frames/s of each rep,
    staging MB/s of each rep, the last rep's state)."""
    dev = resolve_device(device)
    n = depth.shape[0]
    starts = _group_starts(n)
    staged_mb = depth[:len(starts) * SCAN * CHUNK].nbytes / 1e6
    rates, stage_rates, state = [], [], None
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        groups = [[_tensor(_group(a, s0), dev) for a in (depth, K, T_wc, valid)]
                  for s0 in starts]
        _sync(dev)
        stage_rates.append(staged_mb / (time.perf_counter() - t0))
        it = iter(groups)
        r, state = _fused(cfg, n, lambda s0: next(it),
                          lambda st, *args: integrate_chunks(cfg, st, *args), dev, 1)
        rates += r
        del groups, it
    return rates, stage_rates, state


def bench_raycast(cfg, state, gt, scene_cfg, device="cuda", reps: int = REPS):
    """z-depth renders at the colour camera's resolution (W_C x H_C) of the
    volume just integrated, the color-aligned depth workload.  Device:
    ms per frame of 3 back-to-back `_render_frames_device` launches of
    2 x RAYCAST_BATCH frames, synchronized at both ends.  Streamed: ms per
    frame of 4 x RAYCAST_BATCH frames through the production generator
    `raycast_in_color_view` (device compute overlapped with each batch's
    readback), with float32 and with uint16 readback.  Returns (device,
    streamed float32 and streamed uint16 ms per frame of each rep, the
    last device render (F, H_C, W_C) on the host)."""
    dev = resolve_device(device)
    vol = TSDFVolume(cfg, state)
    fx, fy, cx, cy = intrinsics_from_cfg(scene_cfg, W_C, H_C)

    def make_ds(n):
        ones = np.ones(n)
        return CameraDataset(
            directory_relative_path="bench",
            image_file_names=np.array([f"{i}.png" for i in range(n)]),
            timestamps=np.arange(n, dtype=np.int64),
            fx=fx * ones, fy=fy * ones, cx=cx * ones, cy=cy * ones,
            transforms=type(gt)(
                coordinate_system=gt.coordinate_system,
                positions=gt.positions[:n],
                rotations=gt.rotations[:n],
            ),
            widths=np.full(n, W_C, np.int64),
            heights=np.full(n, H_C, np.int64),
        )

    # Warm-up (scene preparation).
    d = next(raycast_in_color_view(vol, make_ds(RAYCAST_BATCH)))
    if not np.isfinite(d).mean() > 0.5:
        raise RuntimeError(f"raycast: mostly misses ({np.isfinite(d).mean():.3f} hit)")

    ds = make_ds(2 * RAYCAST_BATCH)
    Kb = np.asarray(ds.get_render_intrinsic_matrices(), np.float32)
    Tb = np.asarray(ds.transforms.extrinsics_wc, np.float64)
    z, _ = _render_frames_device(vol, Kb, Tb, W_C, H_C)
    _sync(dev)
    n_stream = 4 * RAYCAST_BATCH
    device_ms, stream_ms, stream_u16_ms = [], [], []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        for _launch in range(3):
            z, _ = _render_frames_device(vol, Kb, Tb, W_C, H_C)
        _sync(dev)
        device_ms.append((time.perf_counter() - t0) / (3 * Kb.shape[0]) * 1e3)
        for out, u16 in ((stream_ms, False), (stream_u16_ms, True)):
            _sync(dev)
            t0 = time.perf_counter()
            for d in raycast_in_color_view(vol, make_ds(n_stream), transfer_u16=u16):
                d.ravel()[0]  # touch on the host, as a writer would
            out.append((time.perf_counter() - t0) / n_stream * 1e3)
    return device_ms, stream_ms, stream_u16_ms, z.cpu().numpy()


def bench_sharded_prod(cfg, depth, K, T_wc, valid, device="cuda", reps: int = REPS,
                       n_steps: int = 10):
    """The partitioned-state sharded step (`sharded_integrate_step`,
    partition_state=True) at the production shape on a process group of
    one rank (NCCL on the card, gloo on the CPU), opened and closed here:
    one untimed step, then n_steps timed 20-frame steps from a fresh state
    per rep.  Returns (frames/s of each rep, the last rep's state)."""
    dev = resolve_device(device)
    n_steps = min(n_steps, depth.shape[0] // CHUNK - 1)
    if n_steps < 1:
        raise ValueError(f"{depth.shape[0]} frames hold fewer than two chunks")

    def args(s):
        return depth[s:s + CHUNK], K[s:s + CHUNK], T_wc[s:s + CHUNK], valid[s:s + CHUNK]

    store = tempfile.mkdtemp(prefix="mq3d_bench_group_")
    rates, state = [], None
    try:
        group = init_group("nccl" if dev.type == "cuda" else "gloo", 0, 1,
                           f"file://{store}/store", timeout_s=600)
        step = sharded_integrate_step(cfg, group, partition_state=True)
        for _ in range(reps):
            state = None
            state = create_state_partitioned(cfg, group, dev)
            step(state, *args(0))
            _sync(dev)
            t0 = time.perf_counter()
            for i in range(1, 1 + n_steps):
                step(state, *args(i * CHUNK))
            _sync(dev)
            rates.append(n_steps * CHUNK / (time.perf_counter() - t0))
    finally:
        destroy_group()
        shutil.rmtree(store, ignore_errors=True)
    return rates, state


@contextlib.contextmanager
def _env(name: str, value: str):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def bench_e2e(device="cuda", reps: int = REPS):
    """`run_full_pipeline` (the port's CLI, in-process) on a fresh
    E2E_FRAMES-frame synthetic capture per rep, with bench.py's edits of
    config/pipeline_config_batch.yml (5 cm voxels, 4096 blocks, no
    confidence filtering; confidence, both pose optimisations and the
    color-aligned depth off), written as JSON, which YAML reads, with
    [Substep] timings in the CLI's output (MQ3D_SUBSTEP_TIMING=1).  Raises
    when a run leaves out one of E2E_ARTIFACTS.  Returns the seconds of
    each rep."""
    import yaml  # the config reader; never imported at module level

    from mq3d_tpu_torch.scripts import run_full_pipeline as rfp

    dev = resolve_device(device)
    cfg = yaml.safe_load(E2E_CONFIG.read_text())
    rec = cfg["reconstruction"]
    for k in ("fragment_pose_refinement", "depth_integration"):
        rec[k].update(E2E_VOLUME)
    for k in E2E_OFF:
        rec[k] = False
    secs = []
    for _ in range(reps):
        proj = Path(tempfile.mkdtemp(prefix="mq3d_bench_e2e_"))
        try:
            write_synthetic_project(proj, SyntheticSceneConfig(n_frames=E2E_FRAMES))
            cfg_path = proj / "bench_cfg.json"
            cfg_path.write_text(json.dumps(cfg))
            with _env("MQ3D_SUBSTEP_TIMING", "1"):
                _sync(dev)
                t0 = time.perf_counter()
                rfp.main(["--session_dir", str(proj), "--config", str(cfg_path),
                          "--device", str(dev)])
                _sync(dev)
                secs.append(time.perf_counter() - t0)
            missing = [a for a in E2E_ARTIFACTS if not (proj / a).is_file()
                       or (proj / a).stat().st_size == 0]
            if missing:
                raise RuntimeError(f"e2e: run_full_pipeline wrote no {missing}")
        finally:
            shutil.rmtree(proj, ignore_errors=True)
    return secs


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def describe_device(device: torch.device) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else "cpu"}
    if device.type == "cuda":
        info["kind"] = torch.cuda.get_device_name(device)
        info["nvidia_smi"] = nvidia_smi()
    else:
        info["note"] = "CPU run: its rates are not the card's"
    host = host_cpu()
    info["host_cpu"], info["host_threads"] = host["cpu"], host["threads"]
    return info


def _launched(part: str) -> None:
    """Print the hand-written kernels' launches since the last call (over
    every rep of `part`; none on the CPU), then set the counts to 0."""
    log(f"{part}: kernel launches {launch_counts()}")
    reset_launch_counts()


def _median(name: str, values, unit: str) -> float:
    """Print every rep of a measurement on stderr; return the median."""
    med = statistics.median(values)
    log(f"{name}: median {med!r} {unit} of {len(values)} reps "
        f"{[float(v) for v in values]}")
    if not np.isfinite(med) or med <= 0:
        raise RuntimeError(f"{name}: no valid measurement ({values})")
    return med


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("--frames", type=int, default=N_FRAMES,
                        help=f"capture frames (default {N_FRAMES}); a multiple of "
                             f"{SCAN * CHUNK}, at least {2 * SCAN * CHUNK}")
    parser.add_argument("--reps", type=int, default=REPS,
                        help=f"repetitions of each measurement (default {REPS})")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)  # raises without CUDA
    per = SCAN * CHUNK
    if args.frames < 2 * per or args.frames % per:
        parser.error(f"--frames {args.frames}: a multiple of {per}, at least {2 * per}")
    if args.reps < 1:
        parser.error("--reps must be at least 1")
    # What the library prints (the raycast's edge-budget warnings, the
    # e2e run's log) goes to stderr: stdout holds the JSON line alone.
    with contextlib.redirect_stdout(sys.stderr):
        line = _measure(dev, args.frames, args.reps)
    print(json.dumps(line), flush=True)
    return line


def _measure(dev: torch.device, frames: int, reps: int) -> dict:
    """Every measurement of main, in bench.py's order; returns the line."""
    device_info = describe_device(dev)
    log(f"device {device_info}")

    cfg = bench_config()
    depth, K, T_wc, valid, gt, scene_cfg = make_capture(frames, H, W)
    log(f"capture ready: {frames} frames of {depth.shape[2]}x{depth.shape[1]}")
    reset_launch_counts()
    rates, state = bench_integrate(cfg, depth, K, T_wc, valid, dev, reps)
    fps_chunk = _median("integrate (per-chunk streamed)", rates, "frames/s")
    _launched("integrate (per-chunk streamed)")
    rates, _ = bench_integrate_fused(cfg, depth, K, T_wc, valid, dev, reps)
    fps_stream = _median("integrate (scan-fused streamed)", rates, "frames/s")
    _launched("integrate (scan-fused streamed)")
    rates, _ = bench_integrate_fused_u16(cfg, depth, K, T_wc, valid, dev, reps)
    fps_stream_u16 = _median("integrate (scan-fused streamed u16)", rates, "frames/s")
    _launched("integrate (scan-fused streamed u16)")
    rates, stage_rates, _ = bench_integrate_devres(cfg, depth, K, T_wc, valid, dev, reps)
    fps_dev = _median("integrate (device-resident)", rates, "frames/s")
    stage_mb_s = _median("staging", stage_rates, "MB/s")
    _launched("integrate (device-resident)")
    device_ms, stream_ms, stream_u16_ms, _ = bench_raycast(cfg, state, gt, scene_cfg, dev,
                                                           reps)
    raycast_ms = _median("raycast (device)", device_ms, "ms/frame")
    stream_ms = _median("raycast (streamed float32)", stream_ms, "ms/frame")
    stream_u16_ms = _median("raycast (streamed uint16)", stream_u16_ms, "ms/frame")
    _launched("raycast")
    del state  # free the single volume before the sharded state, as bench.py does
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rates, _ = bench_sharded_prod(cfg, depth, K, T_wc, valid, dev, reps)
    sharded_fps = _median("sharded prod integrate", rates, "frames/s")
    _launched("sharded prod integrate")
    e2e_s = _median("e2e", bench_e2e(dev, reps), "s")
    _launched("e2e")

    return {
        "metric": "tsdf_frames_per_sec",
        "value": round(fps_dev, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps_dev / BASELINE_FRAMES_PER_SEC, 2),
        "extra": {
            "tsdf_streamed_frames_per_sec": round(fps_stream, 2),
            "tsdf_streamed_u16_frames_per_sec": round(fps_stream_u16, 2),
            "tsdf_streamed_per_chunk_frames_per_sec": round(fps_chunk, 2),
            "tsdf_staging_mb_per_sec": round(stage_mb_s, 1),
            "raycast_ms_per_frame": round(raycast_ms, 1),
            "raycast_vs_embree_cpu": round(BASELINE_RAYCAST_MS / raycast_ms, 2),
            "raycast_vs_legacy_budget": round(LEGACY_RAYCAST_BUDGET_MS / raycast_ms, 2),
            "raycast_stream_ms_per_frame": round(stream_ms, 1),
            "raycast_stream_u16_ms_per_frame": round(stream_u16_ms, 1),
            "sharded_prod_frames_per_sec": round(sharded_fps, 1),
            "e2e_pipeline_seconds": round(e2e_s, 1),
            "device": device_info,
        },
    }


if __name__ == "__main__":
    main()
