"""Smoke run of the PyTorch/CUDA port (mq3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (flushed, so a cut run shows where it stopped):
  0. environment: the card's name and power limit; no CUDA -> exit non-zero
  1. build: one nvcc call compiles mq3d_tpu_torch/csrc/*.cu
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with times and byte bounds
  3. the main path: a synthetic capture at Quest scale through
     run_full_pipeline with the production TSDF settings (launch counts
     reset just before, read just after)
  4. the same depth integrated again with the plain lookup: the volume must
     be identical to the kernel path's
  5. a small capture through run_full_pipeline on the CPU and on the card:
     the artifacts must be identical (the CPU run is plain PyTorch)
Then one JSON line with the kernels, the nvidia-smi line, and the final
JSON line.  Nothing is caught: a failed phase ends the run non-zero.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mq3d_tpu_torch.config.configs import (
    PRODUCTION_INTEGRATION,
    PipelineConfigs,
    colorless_recipe,
)
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.dataio.ply import read_ply
from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.ops import tsdf as tsdf_ops
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup, patch_lookup_plain
from mq3d_tpu_torch.ops.yuv import yuv420_to_8uc3, yuv420_to_bgr
from mq3d_tpu_torch.pipeline.processor import run_full_pipeline
from mq3d_tpu_torch.pipeline.stages import YUV_BATCH
from mq3d_tpu_torch.recon.integrate import integrate_multi, tsdf_config_from_integration
from mq3d_tpu_torch.recon.reconstruct import load_depth_datasets
from mq3d_tpu_torch.testing.synthetic import (
    SyntheticSceneConfig,
    quest_scene,
    write_synthetic_project,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# Integer and compare ops run on the SM's ALUs; the data sheet's 67 TFLOP/s
# float32 (non-tensor) rate is the table's closest line.
ALU_OPS_PER_S = 67e12
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms (CUDA events), with the 50 MB L2
    flushed before each timed launch."""
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    return float(np.median(times))


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(rng) -> dict:
    """K1 at the integration tile's shapes: TP=512 pairs, PS=64, V=16^3."""
    TP, PS, V = 512, 64, 4096
    patch = torch.from_numpy(rng.random((TP, PS, PS), dtype=np.float32)).cuda()
    # Indices span past both edges so out-of-patch voxels read 0.0.
    vi = torch.from_numpy(rng.integers(-8, PS + 8, (TP, V), dtype=np.int32)).cuda()
    ui = torch.from_numpy(rng.integers(-8, PS + 8, (TP, V), dtype=np.int32)).cuda()
    got = patch_lookup(patch, vi, ui)
    ref = patch_lookup_plain(patch, vi, ui)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("K1 patch_lookup differs from its plain version")
    ms = time_ms(lambda: patch_lookup(patch, vi, ui))
    plain_ms = time_ms(lambda: patch_lookup_plain(patch, vi, ui))
    nbytes = patch.numel() * 4 + vi.numel() * 4 * 2 + TP * V * 4
    b_ms, b_by = bound(nbytes, 6 * TP * V)  # 4 range compares, index, select
    log(f"[phase 2] K1 patch_lookup TP={TP} PS={PS} V={V}: equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.1f} MB)")
    return {"name": "patch_lookup", "route": "cuda",
            "source": "mq3d_tpu_torch/csrc/patch_lookup.cu",
            "replaces": "mq3d_tpu/ops/tsdf_pallas.py:38",
            "max_abs_err": float((got - ref).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def check_k2(rng) -> dict:
    """K2 at the Quest colour shape (960x1280) for N=8 and for the main
    path's batch of YUV_BATCH=16 frames (timed), and at a shape that is not
    32-aligned."""
    def planes(n, h, w):
        y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
        u = rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)
        v = rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)
        return [torch.from_numpy(p).cuda() for p in (y, u, v)]

    err = 0
    for n, h, w in [(8, 960, 1280), (YUV_BATCH, 960, 1280), (3, 50, 98)]:
        y, u, v = planes(n, h, w)
        got = yuv420_to_bgr(y, u, v)
        ref = yuv420_to_8uc3(y, u, v)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"K2 i420_to_bgr differs from its plain version at {(n, h, w)}")
        err = max(err, int((got.int() - ref.int()).abs().max()))
    y, u, v = planes(YUV_BATCH, 960, 1280)
    ms = time_ms(lambda: yuv420_to_bgr(y, u, v))
    plain_ms = time_ms(lambda: yuv420_to_8uc3(y, u, v))
    px = y.numel()
    nbytes = 4.5 * px
    b_ms, b_by = bound(nbytes, 20 * px)  # ~20 integer ops per pixel
    log(f"[phase 2] K2 i420_to_bgr N={YUV_BATCH} 960x1280 (+N=8, 3x50x98): equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.1f} MB)")
    return {"name": "i420_to_bgr", "route": "cuda",
            "source": "mq3d_tpu_torch/csrc/i420.cu",
            "replaces": "mq3d_tpu/ops/yuv_pallas.py:32",
            "max_abs_err": float(err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def wall_distance(points, box_min, box_max):
    return np.minimum(points - box_min, box_max - points).min(axis=-1)


def main_path(work: Path, scene: SyntheticSceneConfig):
    """Phase 3: the port's run_full_pipeline at Quest scale on the card,
    with the production TSDF settings (bench.py's)."""
    session = work / "capture"
    t0 = time.perf_counter()
    write_synthetic_project(session, scene, workers=8)
    log(f"[phase 3] synthetic capture: 2 sides x {scene.n_frames} frames, depth "
        f"{scene.depth_width}x{scene.depth_height}, colour "
        f"{scene.color_width}x{scene.color_height} "
        f"({time.perf_counter() - t0:.1f} s)")
    configs = colorless_recipe(**PRODUCTION_INTEGRATION)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    os.environ["MQ3D_SUBSTEP_TIMING"] = "1"  # reconstruction substep seconds
    _build.reset_launch_counts()
    tsdf_ops.reset_lookup_tile_counts()
    t0 = time.perf_counter()
    run = run_full_pipeline(session, configs, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _build.launch_counts()
    tiles = tsdf_ops.lookup_tile_counts()
    del os.environ["MQ3D_SUBSTEP_TIMING"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    vol = run.volume
    recon = session / "reconstruction"
    pcd = read_ply(recon / "colorless.ply")
    frames = 2 * scene.n_frames
    dist = wall_distance(pcd.points, scene.box_min, scene.box_max)
    log(f"[phase 3] stage seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in run.stage_seconds.items())
        + f"; total {total:.2f} s, {frames / total:.2f} frames/s "
        f"({frames} depth + {frames} colour frames), peak device memory "
        f"{peak_gb:.2f} GB")
    log(f"[phase 3] n_active {vol.n_active}, overflow {vol.state.overflow}, "
        f"dropped_active {vol.state.dropped_active}, points {len(pcd.points)}, "
        f"wall distance median {np.median(dist):.5f} m p99 "
        f"{np.quantile(dist, 0.99):.5f} m; launches {launches}")
    n_tiles = tiles["patch"] + tiles["over"]
    log(f"[phase 3] integration tiles: {tiles['patch']} through K1 (patch), "
        f"{tiles['over']} through the flat gather (a voxel outside its patch); "
        f"K1 share {tiles['patch'] / max(n_tiles, 1):.4f}")
    checks = {
        "colorless_vbg.npz exists": (recon / "colorless_vbg.npz").is_file(),
        "colorless.ply exists": (recon / "colorless.ply").is_file(),
        "n_active > 0": vol.n_active > 0,
        "points > 0": len(pcd.points) > 0,
        "points finite": bool(np.isfinite(pcd.points).all()),
        "points on the walls (p99 < 2 voxels)":
            float(np.quantile(dist, 0.99)) < 2 * PRODUCTION_INTEGRATION["voxel_size"],
        "overflow == 0": vol.state.overflow == 0,
        "dropped_active == 0": vol.state.dropped_active == 0,
        "K1 launched": launches["patch_lookup"] > 0,
        "one K1 launch per patch tile": launches["patch_lookup"] == tiles["patch"],
        "K2 launched": launches["i420_to_bgr"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    return session, configs, vol, launches


def plain_path(session: Path, configs: PipelineConfigs, vol: TSDFVolume) -> None:
    """Phase 4: the same depth integrated with the flat gather."""
    ic = configs.reconstruction.depth_integration
    data_io = DataIO(session)
    datasets = load_depth_datasets(data_io, configs.reconstruction)
    cfg = dataclasses.replace(tsdf_config_from_integration(ic), depth_lookup="flat")
    t0 = time.perf_counter()
    plain = integrate_multi(datasets, data_io.depth, ic,
                            vbg_opt=TSDFVolume(cfg, device="cuda"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    a, b = vol.state, plain.state
    n = a.n_active
    same = {
        "n_active": a.n_active == b.n_active,
        "slot_table": torch.equal(a.slot_table, b.slot_table),
        "block_coords": torch.equal(a.block_coords[:n], b.block_coords[:n]),
        "weight": torch.equal(a.weight[:n], b.weight[:n]),
        "tsdf": torch.equal(a.tsdf[:n], b.tsdf[:n]),
    }
    log(f"[phase 4] flat-lookup integration {secs:.2f} s; identical to the "
        f"kernel path: {same}")
    if not all(same.values()):
        raise AssertionError(f"kernel path and plain path volumes differ: {same}")


def small_cpu_vs_card(work: Path) -> None:
    """Phase 5: a small capture on the CPU (plain PyTorch) and on the card."""
    scene = SyntheticSceneConfig(n_frames=12)
    configs = dict(voxel_size=0.02, block_resolution=16, block_count=4096,
                   grid_dim=16, depth_max=4.0, trunc_voxel_multiplier=4.0,
                   chunk_active_capacity=4096, integrate_tile=256,
                   frames_per_batch=8)
    sessions = {}
    for device in ("cpu", "cuda"):
        session = work / f"small_{device}"
        write_synthetic_project(session, scene)
        run_full_pipeline(session, colorless_recipe(**configs), device=device)
        sessions[device] = session / "reconstruction"
    a = np.load(sessions["cpu"] / "colorless_vbg.npz")
    b = np.load(sessions["cuda"] / "colorless_vbg.npz")
    pa = read_ply(sessions["cpu"] / "colorless.ply")
    pb = read_ply(sessions["cuda"] / "colorless.ply")
    same = {k: bool(np.array_equal(a[k], b[k])) for k in a.files}
    same["points"] = bool(np.array_equal(pa.points, pb.points))
    same["normals"] = bool(np.array_equal(pa.normals, pb.normals))
    log(f"[phase 5] small capture, CPU vs card: {a['block_coords'].shape[0]} "
        f"blocks, {len(pa.points)} points; identical: {all(same.values())}")
    if not all(same.values()):
        raise AssertionError(f"CPU and card runs differ: {same}")


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power()
    log(f"[phase 0] device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _build.build(force=True)
    _build.library()
    log(f"[phase 1] built {lib.name} from {len(list(_build.CSRC_DIR.glob('*.cu')))} "
        f"sources with one nvcc call: nvcc {_build.last_build_seconds():.1f} s, "
        f"phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    kernels = [check_k1(rng), check_k2(rng)]
    log(f"[phase 2] done in {time.perf_counter() - t0:.1f} s")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        scene = quest_scene(n_frames=60)
        t0 = time.perf_counter()
        session, configs, vol, launches = main_path(work, scene)
        log(f"[phase 3] done in {time.perf_counter() - t0:.1f} s")
        for k in kernels:
            k["launches"] = launches[k["name"]]

        t0 = time.perf_counter()
        plain_path(session, configs, vol)
        del vol
        log(f"[phase 4] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        small_cpu_vs_card(work)
        log(f"[phase 5] done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
