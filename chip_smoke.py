"""Smoke run of the PyTorch/CUDA port (mq3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (flushed, so a cut run shows where it stopped):
  0. environment: the card's name and power limit; no CUDA -> exit non-zero
  1. build: mq3d_tpu_torch/csrc/*.cu, one nvcc per source in parallel and
     one link, with ptxas's registers, shared memory and spills; and the
     native IO runtime (csrc/mqio.cpp, g++ -lz), which the main path's
     depth-stack reads and PNG writes go through from phase 3 on
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (and at shapes that take the kernels'
     scalar paths), with times and byte bounds; K3 in both out-of-range
     modes at every table size of the gather probe and at 0.125 MB, on
     in-range and out-of-range indices; the timer's floor (an empty
     launch); bgr_to_gray on the card against the CPU over all 2^24 BGR
     triples; the gather probe's seven calls
     (mq3d_tpu_torch.tools.probe_gather, K3's own path, counts reset just
     before and read just after)
  3. the main path: a synthetic capture at Quest scale through
     run_full_pipeline with the production TSDF settings (launch counts
     reset just before, read just after); K1 timed again on one of its
     integration tiles, saved during the run
  4. the same depth integrated again with the plain lookup: the volume must
     be identical to the kernel path's
  5. a small capture through run_full_pipeline on the CPU and on the card
     (the CPU run is plain PyTorch): first the colored recipe (steps 0 and
     3-6), whose volume, points, meshes and sampled points must be
     identical and whose rendered depth and refined poses must agree
     within the CPU tests' tolerances; then tests/test_end_to_end.py's
     settings with every step on (1-2 included), whose confidence maps
     must be identical, fragment and optimized poses, scene edges and
     volume blocks agree within tests/test_torch_pose_pipeline.py's
     tolerances, and colored outputs agree as the poses allow (see
     compare_pose_runs)
  6. the colored recipe at full width on the card: phase 3's capture and
     volume (volume cache on) through marching cubes, the mesh filter,
     colour-map optimisation (every 10th frame), point sampling and the
     color-aligned depth raycast (launch counts reset just before, read
     just after: steps 4-6 have no hand kernel yet), with substep seconds,
     mesh size, Gauss-Newton residuals, raycast ms per frame and peak
     memory; the mesh must lie on the box walls and the rendered depth
     must match the analytic box depth
  7. the shipped configuration at full width on the card: Quest-scale
     captures of 200 frames per side through run_full_pipeline with
     config/pipeline_config.yml unchanged (every step, steps 1-2
     included; launch counts reset just before, read just after, and K1's
     launches of the fragment integrations counted apart), with substep
     seconds, edge counts, the pair ICP's last fitness and rmse, and peak
     memory.  First the bare box room: its bare parallel walls let the
     half-room fragments slide against each other in the scene ICP (the
     JAX package's algorithm too), so its run is checked and its accuracy
     only printed.  Then the room furnished with ROOM_CLUTTER: confidence
     maps, poses against the ground truth, the colorless cloud and the
     colored outputs must pass their gates.  Last, the device programs of
     steps 1-2 timed alone at these shapes
  8. the user's tools after reconstruction, on the card: on phase 7's
     furnished-room session, the FBX export of --export-fbx read back
     against color_mesh.ply, build_colmap_project --include_points
     (cameras, images, poses in the COLMAP frame, one Point3D per point of
     step 5's sampling at the shipped ratio), compare_mesh_to_ground_truth
     against the scene's boxes (mean_to_gt under 2 voxels; nearest_distances
     timed, card == CPU on a 20 000-point subsample), evaluate_mesh_quality
     on the PLY and its FBX (equal raw metrics) and downsample_fbx_mesh
     --ratio 0.25; then the step CLIs on phase 5's small capture (K2 and
     K1 launched, outputs equal to phase 5's card run) and
     run_full_pipeline --profile --export-fbx (a trace with the stages and
     CUDA kernel events, K1 and K2 among them)
  9. the multi-device and batch-of-sessions paths (mq3d_tpu_torch.parallel):
     phase 3's capture through integrate_dataset_sharded on an NCCL group
     of one rank, replicated and partitioned, bit-equal to
     TSDFVolume.integrate chunked the same way (K1 counted); the same
     frames on two gloo ranks sharing cuda:0 (weights and blocks equal to
     the single-process volume, tsdf within 1e-5, partitioned == replicated
     bit for bit, K1 launched on each rank), with the sharded raycast at
     1280x960 of the first 4 of phase 6's keyframe views that render alone
     within the edge budget (within 1e-6 of the single-process render, no
     edge overflow), pair ICP on phase 7's fragment pairs and the
     Gauss-Newton terms of phase 6's first call, each against the unsharded
     port; batch_run_full_pipeline as two hosts over three copies of phase
     5's capture, one without its left depth (both print [1, 0, 1] and exit
     1; K1 and K2 launched in the sessions); dryrun_multichip on two gloo
     ranks, tiny and production shapes.  Two ranks share one card, so
     these times say nothing about scaling over cards
  10. the native IO runtime and the host tools on phase 7's furnished room:
     phase 1's build of the runtime on this host (g++ and zlib versions,
     thread count, build seconds); read_raw_batch against the per-file read
     on the side's raw depth files plus a missing, a short and a long file;
     write_png_batch on the side's 200 colour frames against encode_png
     (equal pixels, and equal bytes where both link one zlib) and against
     step 0's own files; destride_plane against the numpy one at Quest
     scale; median times of the PNG batch (native, encode_png on one
     thread, and encode_png on the 8-thread pool step 0 used before the
     runtime), the raw read and the de-striding; then visualize_camera_trajectories,
     find_optimal_timestamp_offset, rename_timestamps on a copy and
     analyze_fog_no_fog_mapping with their outputs checked, and the tools
     that read CSVs with pandas when this machine has pandas
Then one JSON line with the kernels, the nvidia-smi line, and the final
JSON line.  Nothing is caught: a failed phase ends the run non-zero.
"""

import contextlib
import csv
import dataclasses
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mq3d_tpu_torch.config.configs import (
    PRODUCTION_INTEGRATION,
    PipelineConfigs,
    colored_recipe,
    colorless_recipe,
)
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.dataio.ply import TriangleMesh, read_ply, write_ply_mesh
from mq3d_tpu_torch.eval.metrics import nearest_distances
from mq3d_tpu_torch.export.colmap import qvec2rotmat, read_cameras_binary, read_images_binary
from mq3d_tpu_torch.export.fbx import read_fbx_mesh
from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops import icp, odometry, posegraph, raycast
from mq3d_tpu_torch.ops import tsdf as tsdf_ops
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.ops.gather import MODES as gather_modes
from mq3d_tpu_torch.ops.gather import gather, gather_plain
from mq3d_tpu_torch.ops.sampling import sample_points_uniformly
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup, patch_lookup_plain
from mq3d_tpu_torch.ops.yuv import bgr_to_gray, yuv420_to_8uc3, yuv420_to_bgr
from mq3d_tpu_torch.pipeline.processor import run_full_pipeline
from mq3d_tpu_torch.pipeline.stages import YUV_BATCH
from mq3d_tpu_torch.parallel import dist as pdist
from mq3d_tpu_torch.parallel.dryrun import dryrun_multichip
from mq3d_tpu_torch.parallel.sharded import integrate_dataset_sharded
from mq3d_tpu_torch.recon import color_opt, confidence, refine
from mq3d_tpu_torch.recon.integrate import (
    integrate_multi,
    load_filtered_depth_stack,
    tsdf_config_from_integration,
)
from mq3d_tpu_torch.recon.reconstruct import load_depth_datasets
from mq3d_tpu_torch.scripts import (
    analyze_fog_no_fog_mapping,
    analyze_recording_lengths,
    build_colmap_project,
    compare_mesh_to_ground_truth,
    compute_hmd_motion_stats,
    convert_depth_to_linear_map,
    convert_yuv_to_rgb,
    downsample_fbx_mesh,
    evaluate_mesh_quality,
    find_optimal_timestamp_offset,
    reconstruct_scene,
    rename_timestamps,
    trim_recordings,
    visualize_camera_trajectories,
)
from mq3d_tpu_torch.scripts import run_full_pipeline as pipeline_cli
from mq3d_tpu_torch.testing.synthetic import (
    ROOM_CLUTTER,
    SyntheticSceneConfig,
    quest_scene,
    render_box_depth,
    write_synthetic_project,
)
from mq3d_tpu_torch.tools import probe_gather
from mq3d_tpu_torch.ops.yuv import destride_plane
from mq3d_tpu_torch.utils import native
from mq3d_tpu_torch.utils.devtime import bound_ms as bound
from mq3d_tpu_torch.utils.devtime import floor_ms, time_ms
from mq3d_tpu_torch.utils.png import encode_png, imread_bgr, write_png_batch_plain

SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


class _Tee(io.StringIO):
    """Standard output that is also kept, for the lines a run prints."""

    def write(self, text: str) -> int:
        sys.__stdout__.write(text)
        return super().write(text)

    def flush(self) -> None:
        sys.__stdout__.flush()


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _offset_view(t: torch.Tensor, elems: int = 1) -> torch.Tensor:
    """The same values at a data pointer `elems` elements past an aligned
    allocation (not 16-byte aligned for elems % 4 != 0)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = buf[elems:].view(t.shape)
    view.copy_(t)
    return view


def check_k1(rng) -> dict:
    """K1 at the integration tile's shapes (TP=512 pairs, PS=64, V=16^3),
    timed, and at shapes that take its scalar paths: odd PS, V % 4 != 0,
    PS=238 (one patch buffer), offset views."""
    def inputs(TP, PS, V):
        patch = torch.from_numpy(rng.random((TP, PS, PS), dtype=np.float32)).cuda()
        # Indices span past both edges so out-of-patch voxels read 0.0.
        vi = torch.from_numpy(rng.integers(-8, PS + 8, (TP, V), dtype=np.int32)).cuda()
        ui = torch.from_numpy(rng.integers(-8, PS + 8, (TP, V), dtype=np.int32)).cuda()
        return patch, vi, ui

    shapes = [(512, 64, 4096), (13, 63, 201), (1, 238, 4096), (600, 32, 130)]
    timed = None
    for TP, PS, V in shapes:
        for offset in (False, True):
            args = inputs(TP, PS, V)
            if offset:
                args = tuple(_offset_view(t) for t in args)
            got = patch_lookup(*args)
            ref = patch_lookup_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"K1 patch_lookup differs from its plain version at "
                    f"{(TP, PS, V)}, offset {offset}")
            timed = timed or (args, got, ref)
    (patch, vi, ui), got, ref = timed
    TP, PS, V = shapes[0]
    ms = time_ms(lambda: patch_lookup(patch, vi, ui))
    plain_ms = time_ms(lambda: patch_lookup_plain(patch, vi, ui))
    nbytes = patch.numel() * 4 + vi.numel() * 4 * 2 + TP * V * 4
    b_ms, b_by = bound(nbytes, 6 * TP * V)  # 4 range compares, index, select
    log(f"[phase 2] K1 patch_lookup TP={TP} PS={PS} V={V} (+{shapes[1:]}, "
        f"each also at offset views): equal; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
    return {"name": "patch_lookup", "route": "cuda",
            "source": "mq3d_tpu_torch/csrc/patch_lookup.cu",
            "replaces": "mq3d_tpu/ops/tsdf_pallas.py:38",
            "max_abs_err": float((got - ref).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def check_k2(rng) -> dict:
    """K2 at the Quest colour shape (960x1280) for N=8 and for the main
    path's batch of YUV_BATCH=16 frames (timed), at a row whose staging
    needs more than 48 KB of shared memory (W=8208), and at shapes that
    take its scalar path: W % 16 != 0, a row too wide to stage (W=38752)
    and offset plane views."""
    def planes(n, h, w):
        y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
        u = rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)
        v = rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)
        return [torch.from_numpy(p).cuda() for p in (y, u, v)]

    err = 0
    cases = [((8, 960, 1280), False), ((YUV_BATCH, 960, 1280), False),
             ((3, 50, 98), False), ((1, 2, 2), False), ((2, 960, 1272), False),
             ((1, 4, 8208), False), ((1, 2, 38752), False), ((2, 960, 1280), True)]
    for (n, h, w), offset in cases:
        y, u, v = planes(n, h, w)
        if offset:
            y, u, v = (_offset_view(p, 3) for p in (y, u, v))
        got = yuv420_to_bgr(y, u, v)
        ref = yuv420_to_8uc3(y, u, v)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(
                f"K2 i420_to_bgr differs from its plain version at {(n, h, w)}, "
                f"offset {offset}")
        err = max(err, int((got.int() - ref.int()).abs().max()))
        if (n, h, w, offset) == (YUV_BATCH, 960, 1280, False):
            timed = (y, u, v)
    y, u, v = timed
    ms = time_ms(lambda: yuv420_to_bgr(y, u, v))
    plain_ms = time_ms(lambda: yuv420_to_8uc3(y, u, v))
    px = y.numel()
    nbytes = 4.5 * px
    b_ms, b_by = bound(nbytes, 20 * px)  # ~20 integer ops per pixel
    log(f"[phase 2] K2 i420_to_bgr N={YUV_BATCH} 960x1280 (+{[c for c, _ in cases]}, "
        f"the last at offset views): equal; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
    return {"name": "i420_to_bgr", "route": "cuda",
            "source": "mq3d_tpu_torch/csrc/i420.cu",
            "replaces": "mq3d_tpu/ops/yuv_pallas.py:32",
            "max_abs_err": float(err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def _with_edges(idx: torch.Tensor, n: int):
    """idx with every 997th index replaced by probe_gather.edges(n) in turn."""
    out = idx.clone()
    k = out[::997].numel()
    edges = torch.tensor(probe_gather.edges(n), dtype=torch.int32, device=idx.device)
    out[::997] = edges.repeat(k // 8 + 1)[:k]
    return out, k


def check_k3() -> dict:
    """K3 against its plain version bit for bit, in both modes, at the
    gather probe's five tables (2^19 indices) and at its CPU test's 0.125
    MB table (the shared-memory size), on uniform in-range indices and on
    the same indices with out-of-range ones mixed in.  The 128 MB table
    (HBM) is timed and is the kernel's row; torch.take is its library
    call."""
    err, row = 0.0, None
    for mb in (0.125,) + probe_gather.TABLE_MB:
        table, idx = probe_gather.make_inputs(int(mb * 2 ** 20) // 4, device="cuda")
        edges, n_edges = _with_edges(idx, table.numel())
        for mode in gather_modes:
            for ix in (idx, edges):
                got = gather(table, ix, mode)
                ref = gather_plain(table, ix, mode)
                torch.cuda.synchronize()
                if not probe_gather.equal_bits(got, ref):
                    raise AssertionError(
                        f"K3 gather ({mode}) differs from its plain version at {mb} MB")
                ok = ~torch.isnan(ref)
                err = max(err, float((got[ok] - ref[ok]).abs().max()))
        log(f"[phase 2] K3 gather {mb:g} MB table, {idx.numel()} indices: fill and "
            f"clip equal to the plain version bit for bit, in range and with "
            f"{n_edges} edge indices")
        if mb == 128:
            idx64 = idx.long()
            ms = time_ms(lambda: gather(table, idx))
            plain_ms = time_ms(lambda: gather_plain(table, idx))
            library_ms = time_ms(lambda: torch.take(table, idx64))
            t = probe_gather.traffic(table, idx)
            b_ms, b_by = bound(t["bytes"], idx.numel())  # one resolve per index
            s_ms, _ = bound(t["sector_bytes"], idx.numel())
            log(f"[phase 2] K3 gather {mb} MB table, {idx.numel()} indices "
                f"({t['distinct']} distinct): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, torch.take {library_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}, {t['bytes'] / 1e6:.2f} MB), sector bound "
                f"{s_ms:.4f} ms ({t['sector_bytes'] / 1e6:.2f} MB)")
            row = {"name": "gather", "route": "cuda",
                    "source": "mq3d_tpu_torch/csrc/gather.cu",
                    "replaces": "tools/probe_pallas_gather.py:49",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": library_ms}
    row["max_abs_err"] = err
    log(f"[phase 2] timer floor: an empty launch under time_ms takes "
        f"{floor_ms():.4f} ms")
    return row


def time_fma(rng) -> None:
    """`ops.tsdf._fma` (correctly rounded) at an integration tile's shape
    (512 pairs x 16^3 voxels), against the float64-then-float32 form it
    replaced, which rounds twice, for its cost only."""
    a, b, c = (torch.from_numpy(rng.standard_normal((512, 4096), dtype=np.float32)).cuda()
               for _ in range(3))
    got = tsdf_ops._fma(a, b, c)
    if not torch.equal(got.cpu(), tsdf_ops._fma(a.cpu(), b.cpu(), c.cpu())):
        raise AssertionError("_fma differs between the card and the CPU")
    ms = time_ms(lambda: tsdf_ops._fma(a, b, c))
    old_ms = time_ms(lambda: (a.double() * b.double() + c.double()).float())
    log(f"[phase 2] _fma at 512x4096: card == CPU; {ms:.4f} ms, the double-rounded "
        f"form {old_ms:.4f} ms")


def probe_path() -> int:
    """K3's own path: the gather probe's seven calls as its users run them,
    with the launch counts reset just before and read just after."""
    _build.reset_launch_counts()
    rows = probe_gather.run(probe_gather.CALLS, "cuda")
    launches = _build.launch_counts()["gather"]
    if not all(r["equal"] for r in rows) or launches == 0:
        raise AssertionError(f"gather probe failed: {rows}, {launches} launches")
    log(f"[phase 2] gather probe, the TPU probe's {len(rows)} calls: all equal to "
        f"the plain version; {launches} K3 launches")
    return launches


def check_gray() -> None:
    """bgr_to_gray on the card equals the CPU on all 2^24 BGR triples."""
    idx = torch.arange(1 << 24, dtype=torch.int64)
    bgr = torch.stack([idx & 255, (idx >> 8) & 255, idx >> 16], -1).to(torch.uint8)
    want = bgr_to_gray(bgr)
    got = bgr_to_gray(bgr.cuda()).cpu()
    bad = int((got != want).sum())
    log(f"[phase 2] bgr_to_gray, card vs CPU over all 2^24 BGR triples: "
        f"{bad} mismatches")
    if bad:
        raise AssertionError(f"bgr_to_gray differs between card and CPU on {bad} triples")


def wall_distance(points, scene: SyntheticSceneConfig):
    """Distance to the nearest wall of the points on the room's walls: those
    more than 0.15 m (a production truncation distance and a margin) from
    every clutter box, where TSDF fusion leaves fringes at the boxes' depth
    edges whatever the poses."""
    keep = np.ones(len(points), bool)
    for lo, hi in scene.clutter:
        keep &= ~((points >= np.asarray(lo) - 0.15) & (points <= np.asarray(hi) + 0.15)).all(-1)
    p = points[keep]
    return np.minimum(p - scene.box_min, scene.box_max - p).min(axis=-1)


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

    # Keep the inputs of the first full integration tile that K1 fetches
    # (its patch and patch-relative indices) for timing K1 on real data.
    saved = []

    def keep_first_tile(patch, vi, ui):
        if not saved and patch.shape[0] == configs.reconstruction.depth_integration.integrate_tile:
            saved.append((patch.clone(), vi.clone(), ui.clone()))
        return patch_lookup(patch, vi, ui)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    os.environ["MQ3D_SUBSTEP_TIMING"] = "1"  # reconstruction substep seconds
    tsdf_ops.patch_lookup = keep_first_tile
    _build.reset_launch_counts()
    tsdf_ops.reset_lookup_tile_counts()
    t0 = time.perf_counter()
    run = run_full_pipeline(session, configs, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _build.launch_counts()
    tiles = tsdf_ops.lookup_tile_counts()
    tsdf_ops.patch_lookup = patch_lookup
    del os.environ["MQ3D_SUBSTEP_TIMING"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    vol = run.volume
    recon = session / "reconstruction"
    pcd = read_ply(recon / "colorless.ply")
    frames = 2 * scene.n_frames
    dist = wall_distance(pcd.points, scene)
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
    time_k1_on_tile(*saved[0])
    return session, configs, vol, launches


def time_k1_on_tile(patch, vi, ui) -> None:
    """K1 on one integration tile of the main path (its patch-relative
    indices are those of real voxels, not random ones)."""
    got = patch_lookup(patch, vi, ui)
    if not torch.equal(got, patch_lookup_plain(patch, vi, ui)):
        raise AssertionError("K1 differs from its plain version on a main-path tile")
    TP, PS, _ = patch.shape
    V = vi.shape[1]
    ms = time_ms(lambda: patch_lookup(patch, vi, ui))
    nbytes = patch.numel() * 4 + vi.numel() * 4 * 2 + TP * V * 4
    b_ms, b_by = bound(nbytes, 6 * TP * V)
    inside = float(((vi >= 0) & (vi < PS) & (ui >= 0) & (ui < PS)).float().mean())
    log(f"[phase 3] K1 on a main-path tile TP={TP} PS={PS} V={V} ({inside:.3f} of "
        f"the voxels inside their patch): equal; kernel {ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")


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


MESHES = ("colorless_mesh_raw.ply", "colorless_mesh_clean.ply", "color_mesh.ply")


def compare_colored(a: Path, b: Path):
    """Artifacts of two colored-recipe runs of one capture: ({name: True
    where they agree within the CPU tests' tolerances}, {name: largest
    difference}).  Tolerances (tests/test_torch_colored.py): volume,
    points, meshes and sampled points identical; colours within one uint8
    unit; poses within 1e-5; depth hit/miss equal on >= 99.9 % of the
    pixels and |dz| <= 1e-4 m on >= 99.9 % of the common hits."""
    diff = {}
    ra, rb = a / "reconstruction", b / "reconstruction"
    va, vb = np.load(ra / "colorless_vbg.npz"), np.load(rb / "colorless_vbg.npz")
    same = {f"vbg.{k}": bool(np.array_equal(va[k], vb[k])) for k in va.files}
    pa, pb = read_ply(ra / "colorless.ply"), read_ply(rb / "colorless.ply")
    same["colorless.ply"] = bool(np.array_equal(pa.points, pb.points)
                                 and np.array_equal(pa.normals, pb.normals))
    for name in MESHES:
        ma, mb = read_ply(ra / name), read_ply(rb / name)
        same[name] = all(np.array_equal(getattr(ma, k), getattr(mb, k))
                         for k in ("vertices", "triangles", "vertex_normals"))
    ca, cb = read_ply(ra / "color_mesh.ply"), read_ply(rb / "color_mesh.ply")
    same["color_mesh colours"] = bool(np.abs(ca.vertex_colors - cb.vertex_colors).max()
                                      <= 1 / 255 + 1e-12)
    sa, sb = read_ply(ra / "color.ply"), read_ply(rb / "color.ply")
    same["color.ply points"] = bool(np.array_equal(sa.points, sb.points)
                                    and np.array_equal(sa.normals, sb.normals))
    same["color.ply colours"] = bool(np.abs(sa.colors - sb.colors).max() <= 1 / 255 + 1e-12)
    for side in ("left", "right"):
        name = f"{side}_camera_dataset_optimized.npz"
        da, db = np.load(a / "dataset" / name), np.load(b / "dataset" / name)
        same[f"{side} poses"] = all(
            np.allclose(da[k], db[k], rtol=0, atol=1e-5) if k in ("positions", "rotations")
            else np.array_equal(da[k], db[k]) for k in da.files)
        diff[f"{side} poses"] = max(float(np.abs(da[k] - db[k]).max())
                                    for k in ("positions", "rotations"))
        fa = sorted((a / f"{side}_color_aligned_depth").glob("*.npy"))
        fb = sorted((b / f"{side}_color_aligned_depth").glob("*.npy"))
        za = np.stack([np.load(f) for f in fa])
        zb = np.stack([np.load(f) for f in fb])
        ha, hb = np.isfinite(za), np.isfinite(zb)
        both = ha & hb
        same[f"{side} depth"] = bool(
            [f.name for f in fa] == [f.name for f in fb] and (ha == hb).mean() >= 0.999
            and (np.abs(za[both] - zb[both]) <= 1e-4).mean() >= 0.999)
        diff[f"{side} depth"] = float(np.abs(za[both] - zb[both]).max())
        diff[f"{side} hit/miss"] = int((ha != hb).sum())
    return same, diff


# Phase 5's small capture and its colored-recipe settings (phase 8 runs
# the step CLIs on the same capture).
SMALL_SCENE = SyntheticSceneConfig(n_frames=12)


def small_configs() -> PipelineConfigs:
    return colored_recipe(dict(interval=4, max_iteration=12, min_triangle_count=100),
                          voxel_size=0.02, block_resolution=16, block_count=4096,
                          grid_dim=16, depth_max=4.0, trunc_voxel_multiplier=4.0,
                          chunk_active_capacity=4096, integrate_tile=256,
                          frames_per_batch=8)


def small_cpu_vs_card(work: Path) -> None:
    """Phase 5: a small capture through the colored recipe on the CPU (plain
    PyTorch) and on the card."""
    sessions = {}
    for device in ("cpu", "cuda"):
        session = work / f"small_{device}"
        write_synthetic_project(session, SMALL_SCENE)
        run_full_pipeline(session, small_configs(), device=device)
        sessions[device] = session
    same, diff = compare_colored(sessions["cpu"], sessions["cuda"])
    recon = sessions["cpu"] / "reconstruction"
    mesh = read_ply(recon / "color_mesh.ply")
    log(f"[phase 5] small capture, colored recipe, CPU vs card: "
        f"{np.load(recon / 'colorless_vbg.npz')['block_coords'].shape[0]} blocks, "
        f"{len(read_ply(recon / 'colorless.ply').points)} points, colored mesh "
        f"{len(mesh.vertices)} vertices / {len(mesh.triangles)} triangles; agree: {same}; "
        f"largest differences: {diff}")
    if not all(same.values()):
        raise AssertionError(f"CPU and card runs differ: {same}")


# tests/test_end_to_end.py's reconstruction settings: every step on, tiny
# fragments (6 frames) and a coarse volume (5 cm voxels).
E2E_RECONSTRUCTION = {
    "use_dataset_cache": False, "estimate_depth_confidences": True,
    "optimize_depth_pose": True, "use_fragment_dataset_cache": False,
    "use_optimized_dataset_cache": False, "use_colorless_vbg_cache": False,
    "optimize_color_pose": True, "sample_point_cloud_from_colored_mesh": True,
    "points_per_vertex_ratio": 0.5, "render_color_aligned_depth": True,
    "confidence_estimation": {"target_frame_range": 3, "depth_max": 4.0,
                              "error_threshold": 0.08, "skip_if_output_dir_exists": False,
                              "frames_per_batch": 4},
    "fragment_generation": {"fragment_size": 6, "use_confidence_filtered_depth": True,
                            "confidence_threshold": 0.02, "valid_count_threshold": 2,
                            "depth_max": 4.0, "odometry_loop_interval": 3,
                            "overlap_ratio_threshold": 0.1,
                            "loop_yaw_info_density_threshold": 0.3, "dist_threshold": 0.07,
                            "edge_prune_threshold": 0.25},
    "fragment_pose_refinement": {"use_confidence_filtered_depth": True,
                                 "confidence_threshold": 0.02, "valid_count_threshold": 2,
                                 "voxel_size": 0.05, "block_resolution": 16,
                                 "block_count": 2048, "depth_max": 4.0,
                                 "trunc_voxel_multiplier": 4.0, "use_pre_filtering": False,
                                 "icp_voxel_sizes": [0.1, 0.05], "max_corr_dists": [0.2, 0.1],
                                 "max_iterations": [20, 10],
                                 "relative_fitnesses": [1e-6, 1e-6],
                                 "relative_rmses": [1e-6, 1e-6], "icp_fitness_threshold": 0.2,
                                 "icp_inlier_rmse_threshold": 0.05, "dist_threshold": 0.07,
                                 "edge_prune_threshold": 0.25, "grid_dim": 16,
                                 "chunk_active_capacity": 2048, "integrate_tile": 256},
    "depth_integration": {"use_confidence_filtered_depth": True, "confidence_threshold": 0.02,
                          "valid_count_threshold": 2, "voxel_size": 0.05,
                          "block_resolution": 16, "block_count": 2048, "depth_max": 4.0,
                          "trunc_voxel_multiplier": 4.0, "frames_per_batch": 6,
                          "grid_dim": 16, "chunk_active_capacity": 2048,
                          "integrate_tile": 256},
    "color_optimization": {"weight_threshold": 1.5, "estimated_vertex_number": -1,
                           "interval": 4, "max_iteration": 6, "use_dataset_cache": False,
                           "min_triangle_count": 100},
    "color_aligned_depth_rendering": {"only_use_optimized_dataset": True},
}

_PAIR_RE = re.compile(r"\[Info\] Pair \((\d+), (\d+)\): fitness (\S+), inlier rmse "
                      r"([0-9.]+)( \(not converged, dropped\))?")
_SCENE_RE = re.compile(r"\[Info\] Scene pose graph: (\d+) nodes, (\d+) edges, (\d+) pruned")


def run_teed(session: Path, configs, device: str) -> str:
    """run_full_pipeline with its standard output shown and kept."""
    out = _Tee()
    with contextlib.redirect_stdout(out):
        run_full_pipeline(session, configs, device=device)
    return out.getvalue()


def compare_pose_runs(a: Path, b: Path, out_a: str, out_b: str):
    """Two runs of one capture with steps 1-2 on: ({name: True where they
    agree}, {name: largest difference}).  Tolerances of
    tests/test_torch_pose_pipeline.py: confidence maps and packs
    identical, fragment poses within 1e-9, optimized poses within 5e-5,
    the scene pose graph's edges (pairs, convergence, pruning) equal, and
    the volume's blocks equal.  The colored outputs come from volumes of
    poses up to 5e-5 apart, so they are held only as far as that allows:
    mesh triangle counts within 1 %, optimized colour poses within 1e-3,
    the same depth files with hit/miss equal on >= 99 % of the pixels and
    |dz| <= 1 mm on >= 99 % of the common hits."""
    same, diff = {}, {}
    for side in ("left", "right"):
        fa = sorted((a / f"{side}_depth_confidence").glob("*.npz"))
        fb = sorted((b / f"{side}_depth_confidence").glob("*.npz"))
        same[f"{side} confidence maps"] = bool(
            [f.name for f in fa] == [f.name for f in fb] and len(fa) > 0 and all(
                np.array_equal(np.load(x)[k], np.load(y)[k])
                for x, y in zip(fa, fb) for k in ("confidence_map", "valid_count")))
        same[f"{side} confidence pack"] = all(
            np.array_equal(np.load(a / f"cache/confidence/{side}_{m}.npy"),
                           np.load(b / f"cache/confidence/{side}_{m}.npy"))
            for m in ("timestamps", "confidence", "valid_count"))
    for pattern, tol in (("cache/dataset/*_fragment_*_dataset.npz", 1e-9),
                         ("dataset/*_depth_dataset_optimized.npz", 5e-5),
                         ("dataset/*_camera_dataset_optimized.npz", 1e-3)):
        for fa in sorted(a.glob(pattern)):
            da, db = np.load(fa), np.load(b / fa.relative_to(a))
            d = max(float(np.abs(da[k] - db[k]).max()) for k in ("positions", "rotations"))
            diff[fa.name] = d
            same[fa.name] = d <= tol and all(np.array_equal(da[k], db[k]) for k in da.files
                                             if k not in ("positions", "rotations"))
    edges_a = [(m[0], m[1], bool(m[4])) for m in _PAIR_RE.findall(out_a)]
    edges_b = [(m[0], m[1], bool(m[4])) for m in _PAIR_RE.findall(out_b)]
    same["scene edges"] = edges_a == edges_b and len(edges_a) > 0
    same["scene graph"] = _SCENE_RE.findall(out_a) == _SCENE_RE.findall(out_b)
    va = np.load(a / "reconstruction/colorless_vbg.npz")
    vb = np.load(b / "reconstruction/colorless_vbg.npz")
    same["volume blocks"] = bool(np.array_equal(va["block_coords"], vb["block_coords"]))
    for name in MESHES:
        ta = len(read_ply(a / "reconstruction" / name).triangles)
        tb = len(read_ply(b / "reconstruction" / name).triangles)
        same[f"{name} triangles"] = abs(ta - tb) <= 0.01 * max(ta, tb) and ta > 0
        diff[f"{name} triangles"] = (ta, tb)
    for side in ("left", "right"):
        fa = sorted((a / f"{side}_color_aligned_depth").glob("*.npy"))
        fb = sorted((b / f"{side}_color_aligned_depth").glob("*.npy"))
        za = np.stack([np.load(f) for f in fa])
        zb = np.stack([np.load(f) for f in fb])
        ha, hb = np.isfinite(za), np.isfinite(zb)
        both = ha & hb
        same[f"{side} depth"] = bool(
            [f.name for f in fa] == [f.name for f in fb] and (ha == hb).mean() >= 0.99
            and (np.abs(za[both] - zb[both]) <= 1e-3).mean() >= 0.99)
        diff[f"{side} depth"] = float(np.abs(za[both] - zb[both]).max())
    return same, diff


def small_pose_cpu_vs_card(work: Path) -> None:
    """Phase 5, second part: tests/test_end_to_end.py's capture and settings
    (every step on) on the CPU and on the card."""
    configs = PipelineConfigs.parse({"depth_to_linear": {"use_cache": True},
                                     "reconstruction": E2E_RECONSTRUCTION})
    sessions, printed = {}, {}
    for device in ("cpu", "cuda"):
        session = work / f"small_pose_{device}"
        write_synthetic_project(session, SyntheticSceneConfig(n_frames=12, sweep=1.2))
        printed[device] = run_teed(session, configs, device)
        sessions[device] = session
    same, diff = compare_pose_runs(sessions["cpu"], sessions["cuda"],
                                   printed["cpu"], printed["cuda"])
    log(f"[phase 5] small capture, every step on, CPU vs card: scene graph "
        f"{_SCENE_RE.findall(printed['cuda'])}; agree: {same}; largest differences: {diff}")
    if not all(same.values()):
        raise AssertionError(f"CPU and card runs with steps 1-2 differ: {same}")


def colored_path(session: Path, scene: SyntheticSceneConfig, gn_path: Path):
    """Phase 6: the colored recipe at full width on the card, on phase 3's
    capture and volume.  Saves the inputs of its first Gauss-Newton call
    to `gn_path` and returns its keyframes' views (K, T_wc, width, height)
    for phase 9."""
    configs = colored_recipe({"interval": 10}, **PRODUCTION_INTEGRATION)
    configs.reconstruction.use_colorless_vbg_cache = True
    co = configs.reconstruction.color_optimization
    log(f"[phase 6] colored recipe: interval {co.interval}, max_iteration "
        f"{co.max_iteration}, min_triangle_count {co.min_triangle_count}, weight_threshold "
        f"{co.weight_threshold}; volume from phase 3 (colorless_vbg.npz)")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    os.environ["MQ3D_SUBSTEP_TIMING"] = "1"  # [Substep] lines: the substep seconds
    out = _Tee()
    gn_terms = color_opt._gn_terms

    def keep_first_gn(*args):
        if not gn_path.exists():
            names = ("verts", "K", "T", "gray", "gx", "gy", "target", "vis")
            torch.save({k: a.cpu() for k, a in zip(names, args)}, gn_path)
        return gn_terms(*args)

    color_opt._gn_terms = keep_first_gn
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run = run_full_pipeline(session, configs, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _build.launch_counts()
    color_opt._gn_terms = gn_terms
    del os.environ["MQ3D_SUBSTEP_TIMING"]
    printed = out.getvalue()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[phase 6] stage seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in run.stage_seconds.items())
        + f"; total {total:.2f} s; peak device memory {peak_gb:.2f} GB; launches "
        f"{launches} (steps 4-6 run plain PyTorch; K1/K2 of steps 0/3 ran in phase 3)")

    checks, datasets = check_colored_outputs("phase 6", session, scene, printed,
                                             PRODUCTION_INTEGRATION["voxel_size"], sampled=True)
    # The device parts of the run, as the entries' own substeps timed them
    # (each ends in a readback, so the host clock holds the device work).
    mc_s = [float(x) for x in re.findall(
        r"\[Substep\] extract_triangle_mesh\.device: (\S+)s", printed)]
    label_s = [float(x) for x in re.findall(
        r"\[Substep\] filter_mesh_components\.labels: (\S+)s", printed)]

    # The raycast through its entries, on the same volume: a new volume
    # object over the same state misses the scene-prep cache once, so its
    # first render preps the scene and its second does not.
    n_frames = sum(len(ds) for ds in datasets.values())
    ds0 = datasets[Side.LEFT]
    view = (ds0.get_render_intrinsic_matrices()[0], ds0.transforms.extrinsics_wc[0],
            int(ds0.widths[0]), int(ds0.heights[0]))
    first_s, again_s = [], []
    for _ in range(5):
        vol = TSDFVolume(run.volume.cfg, run.volume.state)
        for times in (first_s, again_s):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raycast.raycast_depth(vol, *view)
            times.append(time.perf_counter() - t0)
    prep_s = float(np.median(first_s) - np.median(again_s))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ds in datasets.values():
        list(raycast.raycast_in_color_view(vol, ds, frames_per_batch=16))
    torch.cuda.synchronize()
    ray_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    log(f"[phase 6] device parts: marching cubes {mc_s} s, component labels {label_s} s "
        f"(step 4's filter, then the one after baking), scene prep {prep_s:.4f} s "
        f"(median first render of a new volume object {np.median(first_s):.4f} s less the "
        f"median second {np.median(again_s):.4f} s), raycast {ray_ms:.2f} ms "
        f"per frame ({n_frames} frames {scene.color_width}x{scene.color_height}, "
        f"readback included)")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"colored path checks failed: {failed}")
    return (np.concatenate([ds.get_render_intrinsic_matrices() for ds in datasets.values()])
            .astype(np.float32),
            np.concatenate([ds.transforms.extrinsics_wc for ds in datasets.values()])
            .astype(np.float32),
            int(ds0.widths[0]), int(ds0.heights[0]))


def host_ms(fn, reps: int = 5) -> float:
    """Median wall time of fn() in ms after one warm call, synchronized:
    for the device programs of steps 1-2, which launch many small kernels
    and read results back, so host gaps are part of their cost, and for
    the host IO of phase 10."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_pose_programs(session: Path, rc) -> None:
    """The device programs of steps 1-2 alone, at phase 7's shapes: B9 one
    confidence pass (frames_per_batch references x 2 x target_frame_range
    neighbours of 320x288), B11 one odometry pass of EDGES_PER_PASS edges,
    B14 _edge_terms over a fragment's edges, B10 a Voronoi field of a
    fragment cloud at the last ICP radius and one ICP level-3 batch."""
    ce, fg, fr = rc.confidence_estimation, rc.fragment_generation, rc.fragment_pose_refinement
    data_io = DataIO(session)
    ds = data_io.depth.load_depth_dataset(Side.LEFT)
    ds.transforms = ds.transforms.convert_coordinate_system(CoordinateSystem.OPEN3D,
                                                            is_camera=True)
    depth, valid = data_io.depth.load_depth_stack(Side.LEFT, ds)
    T_cw = ds.transforms.extrinsics_cw.astype(np.float32)
    K = ds.get_render_intrinsic_matrices().astype(np.float32)
    dev = [torch.from_numpy(a).cuda() for a in (depth, K, T_cw, np.linalg.inv(T_cw), valid)]
    refs = torch.arange(ce.frames_per_batch, device="cuda") + ce.target_frame_range
    b9 = host_ms(lambda: confidence.confidence_for_refs(
        *dev, refs, ce.depth_max, ce.error_threshold, ce.target_frame_range))
    n = odometry.EDGES_PER_PASS
    pairs = np.stack([np.arange(n), np.arange(n) + 1], -1)
    T64 = T_cw.astype(np.float64)
    rel = torch.from_numpy((np.linalg.inv(T64[pairs[:, 1]]) @ T64[pairs[:, 0]])
                           .astype(np.float32)).cuda()
    b11 = host_ms(lambda: odometry.odometry_information_matrix_batch(
        dev[0], dev[1][0], pairs, rel, fg.dist_threshold, fg.depth_max))
    E = fg.fragment_size + 45
    X = [torch.from_numpy(T64[np.arange(E) % len(T64)]).cuda() for _ in range(3)]
    b14 = host_ms(lambda: posegraph._edge_terms(*X))
    io = data_io.reconstruction
    src, tgt = io.load_fragment_pcd(Side.LEFT, 1).points, io.load_fragment_pcd(Side.LEFT, 0).points
    voro_ms = host_ms(lambda: icp.build_voronoi_nn(tgt, fr.max_corr_dists[-1], device="cuda"))
    field = icp.build_voronoi_nn(tgt, fr.max_corr_dists[-1], device="cuda").to("cuda")
    fine = icp.voxel_down_sample(src, fr.icp_voxel_sizes[-1])
    crit = icp.ICPConvergenceCriteria(fr.max_iterations[-1], fr.relative_fitnesses[-1],
                                      fr.relative_rmses[-1])
    icp_ms = host_ms(lambda: icp.registration_icp_batch_shared(
        [fine] * 3, field, [fr.max_corr_dists[-1]] * 3, criteria=[crit] * 3), reps=3)
    log(f"[phase 7] device programs alone (median wall ms, synchronized): B9 confidence "
        f"pass of {ce.frames_per_batch} x {2 * ce.target_frame_range} pairs {b9:.2f}; B11 "
        f"odometry pass of {n} edges {b11:.2f}; B14 _edge_terms of {E} edges {b14:.2f}; "
        f"B10 Voronoi field of {len(tgt)} points at {fr.max_corr_dists[-1]} m {voro_ms:.2f}, "
        f"ICP of 3 x {len(fine)} points at level 3 ({fr.max_iterations[-1]} iterations at "
        f"most) {icp_ms:.2f}")


SHIPPED_CONFIG = Path(__file__).resolve().parent / "config/pipeline_config.yml"


def shipped_config_path(work: Path, scene: SyntheticSceneConfig, room: str):
    """Phase 7: the shipped configuration, unchanged, on a Quest-scale
    capture of `room` on the card.  Returns (K1's launches on the fragment
    integrations, {check: passed} of the run, {check: passed} of its
    accuracy against the scene's ground truth)."""
    session = work / f"shipped_{room.replace(' ', '_')}"
    t0 = time.perf_counter()
    _, _, gt = write_synthetic_project(session, scene, workers=8)
    log(f"[phase 7] {room}: synthetic capture of 2 sides x {scene.n_frames} frames, depth "
        f"{scene.depth_width}x{scene.depth_height}, colour "
        f"{scene.color_width}x{scene.color_height}, {len(scene.clutter)} clutter boxes "
        f"({time.perf_counter() - t0:.1f} s); config {SHIPPED_CONFIG.name} as shipped")
    configs = PipelineConfigs.parse_config_yml(SHIPPED_CONFIG)
    rc = configs.reconstruction

    # K1's launches and tiles of the fragment integrations, apart from
    # step 3's: counted around that call of the run.
    frag = {}
    integrate_fragments = refine.integrate_and_save_fragment_point_clouds

    def counted(*args, **kwargs):
        k1, tiles = _build.launch_counts()["patch_lookup"], tsdf_ops.lookup_tile_counts()
        result = integrate_fragments(*args, **kwargs)
        frag["k1"] = _build.launch_counts()["patch_lookup"] - k1
        frag["tiles"] = {k: v - tiles[k] for k, v in tsdf_ops.lookup_tile_counts().items()}
        return result

    refine.integrate_and_save_fragment_point_clouds = counted
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    os.environ["MQ3D_SUBSTEP_TIMING"] = "1"
    _build.reset_launch_counts()
    tsdf_ops.reset_lookup_tile_counts()
    out = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run = run_full_pipeline(session, SHIPPED_CONFIG, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _build.launch_counts()
    del os.environ["MQ3D_SUBSTEP_TIMING"]
    refine.integrate_and_save_fragment_point_clouds = integrate_fragments
    printed = out.getvalue()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    substeps: dict = {}
    for name, secs in re.findall(r"\[Substep\] (\S+): (\S+)s", printed):
        substeps[name] = substeps.get(name, 0.0) + float(secs)
    log(f"[phase 7] stage seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in run.stage_seconds.items())
        + f"; total {total:.2f} s; peak device memory {peak_gb:.2f} GB")
    log("[phase 7] substep seconds (summed over repeats): "
        + ", ".join(f"{k} {v:.3f}" for k, v in substeps.items()))
    frag_graphs = [tuple(map(int, m)) for m in re.findall(
        r"Fragment pose graph: (\d+) odometry edges, (\d+) loop candidates, (\d+) loops kept",
        printed)]
    prefilter = re.findall(r"Pre-filter kept (\d+) / (\d+) uncertain pairs", printed)
    scene_graph = _SCENE_RE.findall(printed)
    pairs = _PAIR_RE.findall(printed)
    log(f"[phase 7] fragments {len(frag_graphs)}: odometry edges "
        f"{sum(g[0] for g in frag_graphs)}, loop candidates {sum(g[1] for g in frag_graphs)}, "
        f"loops kept {sum(g[2] for g in frag_graphs)}; pre-filter kept {prefilter}; scene "
        f"graph (nodes, edges, pruned) {scene_graph}")
    log("[phase 7] pair ICP at the last level: " + "; ".join(
        f"({s}, {t}) fitness {f} rmse {r}{' dropped' if d else ''}" for s, t, f, r, d in pairs))
    log(f"[phase 7] launches {launches}; K1 on the fragment integrations {frag['k1']} "
        f"(tiles {frag['tiles']}), on step 3 {launches['patch_lookup'] - frag['k1']}")

    data_io = DataIO(session)
    conf_ok, conf_means, pose_err = {}, [], []
    for side in Side:
        ds = data_io.depth.load_depth_dataset(side)
        n_maps = len(list(data_io.depth.depth_path_config
                          .get_depth_confidence_map_dir_path(side).glob("*.npz")))
        conf, cnt, have = data_io.depth.load_confidence_stack(side, ds.timestamps)
        pack_ts = np.load(data_io.depth.depth_path_config.get_confidence_pack_path(
            side, "timestamps"))
        conf_ok[side.name] = (n_maps == len(ds) and bool(have.all())
                              and np.array_equal(pack_ts, np.sort(ds.timestamps)))
        conf_means.append(float(conf[cnt >= 2].mean()))
        opt = data_io.depth.load_optimized_depth_dataset(side)
        cw, gt_cw = opt.transforms.extrinsics_cw, gt.extrinsics_cw
        dpos = np.linalg.norm(cw[:, :3, 3] - gt_cw[:, :3, 3], axis=-1)
        cos = (np.einsum("nij,nij->n", cw[:, :3, :3], gt_cw[:, :3, :3]) - 1) / 2
        pose_err.append((float(dpos.max()), float(np.degrees(np.arccos(np.clip(cos, -1, 1))).max()),
                         len(opt) == len(gt_cw)))
    pcd = read_ply(session / "reconstruction/colorless.ply")
    dist = wall_distance(pcd.points, scene)
    vs = rc.depth_integration.voxel_size
    log(f"[phase 7] {room}: confidence maps and packs complete {conf_ok}; mean confidence "
        f"where valid_count >= 2 {conf_means}; optimized poses vs ground truth (max position "
        f"error m, max angle deg, all frames) {pose_err}; colorless points {len(pcd.points)}, "
        f"wall distance median {np.median(dist):.5f} m p99 {np.quantile(dist, 0.99):.5f} m")
    colored, _ = check_colored_outputs("phase 7", session, scene, printed, vs,
                                       sampled=rc.sample_point_cloud_from_colored_mesh)
    run_checks = {
        "steps 1 and 2 on": rc.estimate_depth_confidences and rc.optimize_depth_pose,
        "a confidence map for every frame, the pack complete and loading": all(conf_ok.values()),
        "mean confidence > 0.95 where valid_count >= 2": min(conf_means) > 0.95,
        "K1 launched on the fragment integrations": frag["k1"] > 0,
        "K1 launched on step 3": launches["patch_lookup"] > frag["k1"],
        "two fragments per side": len(frag_graphs) == 4,
        "colored outputs written": all(v for k, v in colored.items()
                                       if "exist" in k or "one depth map" in k),
    }
    accuracy = dict(colored, **{
        "optimized poses within 2 cm and 1 deg of the ground truth": all(
            p < 0.02 and a < 1.0 and n for p, a, n in pose_err),
        "colorless points on the walls (p99 < 2 voxels)":
            float(np.quantile(dist, 0.99)) < 2 * vs,
    })
    log(f"[phase 7] {room}: run checks {run_checks}; accuracy checks {accuracy}")
    return frag["k1"], run_checks, accuracy, session, rc


def check_colored_outputs(phase: str, session: Path, scene: SyntheticSceneConfig,
                          printed: str, voxel_size: float, sampled: bool):
    """The colored outputs of a run of steps 4-6 (phases 6 and 7): meshes,
    optimised colour datasets, one depth map per optimised frame, the mesh
    on the box walls, the colored point cloud when sampling is on, the
    rendered depth against the analytic box depth at the refined poses,
    and the Gauss-Newton residuals read from the run's output.  Returns
    ({check: passed}, the optimised colour datasets)."""
    recon = session / "reconstruction"
    raw = read_ply(recon / "colorless_mesh_raw.ply")
    mesh = read_ply(recon / "color_mesh.ply")
    gn = re.search(r"\[ColorOpt\] (\d+) iterations, residual first (\S+) last (\S+)",
                   printed)
    n_iter, res_first, res_last = int(gn[1]), float(gn[2]), float(gn[3])
    dist = wall_distance(mesh.vertices, scene)
    n_points = len(read_ply(recon / "color.ply").points) if sampled else 0
    log(f"[{phase}] raw mesh {len(raw.vertices)} vertices / {len(raw.triangles)} triangles; "
        f"colored mesh {len(mesh.vertices)} / {len(mesh.triangles)}; colored points "
        f"{n_points if sampled else 'off'}; wall distance median {np.median(dist):.5f} m p99 "
        f"{np.quantile(dist, 0.99):.5f} m")
    log(f"[{phase}] Gauss-Newton: {n_iter} iterations, residual first {res_first:.6f} "
        f"last {res_last:.6f}")

    # Rendered depth against the analytic box depth at the refined poses.
    data_io = DataIO(session)
    datasets = {side: data_io.color.load_optimized_color_dataset(side) for side in Side}
    n_frames = sum(len(ds) for ds in datasets.values())
    hits, errs, n_px = 0, [], 0
    for side, ds in datasets.items():
        K = ds.get_render_intrinsic_matrices()
        T_cw = ds.transforms.extrinsics_cw.astype(np.float64)
        for i, ts in enumerate(ds.timestamps):
            z = data_io.rgbd.load_color_aligned_depth(side, int(ts))
            gt = render_box_depth(T_cw[i], K[i, 0, 0], K[i, 1, 1], K[i, 0, 2], K[i, 1, 2],
                                  int(ds.widths[i]), int(ds.heights[i]),
                                  scene.box_min, scene.box_max, scene.clutter)
            m = np.isfinite(gt)
            hit = m & np.isfinite(z)
            n_px += int(m.sum())
            hits += int(hit.sum())
            errs.append(np.abs(z[hit] - gt[hit]))
    err = np.concatenate(errs)
    hit_share = hits / max(n_px, 1)
    log(f"[{phase}] rendered vs analytic depth over {n_frames} frames: hit share "
        f"{hit_share:.4f}, |err| median {np.median(err) * 1e3:.4f} mm, p95 "
        f"{np.quantile(err, 0.95) * 1e3:.4f} mm")

    n_opt = {side: len(ds) for side, ds in datasets.items()}
    checks = {
        "colorless_mesh_raw.ply, colorless_mesh_clean.ply, color_mesh.ply exist":
            all((recon / n).is_file() for n in MESHES),
        "optimised colour datasets exist": all(ds is not None for ds in datasets.values()),
        "one depth map per optimised frame": all(
            len(list(data_io.rgbd.rgbd_path_config.get_color_aligned_depth_dir(side)
                     .glob("*.npy"))) == n for side, n in n_opt.items()),
        "mesh on the walls (p99 < 2 voxels)":
            float(np.quantile(dist, 0.99)) < 2 * voxel_size,
        "depth hit share > 0.9": hit_share > 0.9,
        "depth median |err| < 1 mm": float(np.median(err)) < 1e-3,
        "last GN residual <= first": res_last <= res_first,
    }
    if sampled:
        checks["colored points == 2 x vertices"] = n_points == 2 * len(mesh.vertices)
    return checks, datasets


# Phase 8: points sampled per mesh by compare_mesh_to_ground_truth (its
# default), and the subsample held card against CPU.
GT_SAMPLES = 100_000
CPU_SUBSAMPLE = 20_000


def ground_truth_mesh(scene: SyntheticSceneConfig) -> TriangleMesh:
    """The scene's surfaces: the room box and each clutter box, 12
    triangles per box."""
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 5, 7, 3)]
    box = np.asarray([t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))], np.int64)
    verts, tris = [], []
    for lo, hi in [(scene.box_min, scene.box_max)] + list(scene.clutter):
        tris.append(box + 8 * len(verts))
        verts.append([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                      for z in (lo[2], hi[2])])
    return TriangleMesh(np.asarray(verts, float).reshape(-1, 3), np.concatenate(tris))


def read_points3d_records(path: Path) -> np.ndarray:
    """points3D.bin as one structured array (every record without a track,
    as build_colmap_project writes them: 51 bytes each)."""
    data = path.read_bytes()
    rec = np.dtype([("id", "<i8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                    ("error", "<f8"), ("track", "<u8")])
    n = int(np.frombuffer(data[:8], "<u8")[0])
    if len(data) != 8 + n * rec.itemsize:
        raise AssertionError(f"points3D.bin holds tracks or a wrong count ({n} points, "
                             f"{len(data)} bytes)")
    return np.frombuffer(data[8:], rec)


def exports_and_evaluation(work: Path, session: Path, scene: SyntheticSceneConfig,
                           rc) -> None:
    """Phase 8 on phase 7's furnished-room session (the shipped config at
    full width): the FBX export of --export-fbx, build_colmap_project
    --include_points, compare_mesh_to_ground_truth against the scene's own
    surfaces (nearest_distances on the card, timed, and card == CPU on a
    20 000-point subsample), evaluate_mesh_quality on the PLY and its FBX,
    and downsample_fbx_mesh --ratio 0.25."""
    recon = session / "reconstruction"
    ply_path = recon / "color_mesh.ply"
    ply = read_ply(ply_path)
    secs = {}

    t0 = time.perf_counter()
    fbx_path = pipeline_cli.convert_reconstruction_mesh_to_fbx(session)
    fbx = read_fbx_mesh(fbx_path)
    secs["fbx"] = time.perf_counter() - t0
    fbx_same = {
        "vertices": bool(np.array_equal(fbx.vertices, ply.vertices)),
        "triangles": bool(np.array_equal(fbx.triangles, ply.triangles)),
        "colours": bool(np.array_equal(fbx.vertex_colors, ply.vertex_colors)),
        "colours as uint8": bool(np.array_equal(np.round(fbx.vertex_colors * 255),
                                                np.round(ply.vertex_colors * 255))),
    }
    log(f"[phase 8] FBX export of color_mesh.ply ({len(ply.vertices)} vertices, "
        f"{len(ply.triangles)} triangles, {fbx_path.stat().st_size / 1e6:.1f} MB) read back "
        f"equal: {fbx_same} ({secs['fbx']:.1f} s)")

    # The shipped config samples no colored cloud (step 5 off): sample it
    # as step 5 does, at the shipped ratio, for the Point3D records.
    t0 = time.perf_counter()
    data_io = DataIO(session)
    pcd = sample_points_uniformly(ply, int(len(ply.vertices) * rc.points_per_vertex_ratio))
    data_io.reconstruction.save_colored_pcd(pcd)
    t1 = time.perf_counter()
    model_dir = build_colmap_project.main(["--project_dir", str(session), "--include_points"])
    secs["colmap"] = time.perf_counter() - t1
    cameras = read_cameras_binary(model_dir / "cameras.bin")
    images = read_images_binary(model_dir / "images.bin")
    points = read_points3d_records(model_dir / "points3D.bin")
    datasets = build_colmap_project.load_dataset_map(data_io, 1)
    pose_err, n_frames = 0.0, sum(len(ds) for ds in datasets.values())
    for cam_id, (side, ds) in enumerate(datasets.items(), start=1):
        tf = ds.transforms.convert_coordinate_system(CoordinateSystem.COLMAP, is_camera=True)
        by_ts = {int(ts): i for i, ts in enumerate(ds.timestamps)}
        for im in images.values():
            if im.camera_id != cam_id:
                continue
            i = by_ts[int(im.name.split("_")[1].split(".")[0])]
            R = qvec2rotmat(im.qvec)  # world to camera
            pose_err = max(pose_err, float(np.abs(-R.T @ im.tvec - tf.positions[i]).max()),
                           float(np.abs(R.T - quat.as_matrix(tf.rotations[i])).max()))
    # The CLI reads color.ply back (uint8 / 255) and truncates * 255 to
    # uint8: within one unit of the stored colour.
    stored = np.round(data_io.reconstruction.load_colored_pcd().colors * 255)
    colmap_ok = {
        "2 cameras": len(cameras) == 2,
        "one image per frame of the colour datasets": len(images) == n_frames > 0,
        "every image file copied": all((model_dir.parents[2] / "input" / im.name).is_file()
                                       for im in images.values()),
        "one Point3D per colored point": len(points) == len(pcd.points),
        "Point3D ids and colours": bool(
            np.array_equal(points["id"], np.arange(1, len(points) + 1))
            and np.abs(points["rgb"] - stored).max() <= 1),
        "image poses == dataset poses in the COLMAP frame (1e-6)": pose_err <= 1e-6,
    }
    log(f"[phase 8] COLMAP project: {len(cameras)} cameras, {len(images)} images (the "
        f"optimized colour datasets' {n_frames} keyframes), {len(points)} Point3D "
        f"({time.perf_counter() - t0:.1f} s with step 5's sampling, "
        f"{secs['colmap']:.1f} s the CLI); largest pose difference {pose_err:.3g}; {colmap_ok}")

    t0 = time.perf_counter()
    gt_path = work / "ground_truth.ply"
    write_ply_mesh(gt_path, ground_truth_mesh(scene))
    cmp = compare_mesh_to_ground_truth.main(["--pred", str(ply_path), "--gt", str(gt_path),
                                             "--samples", str(GT_SAMPLES)])
    secs["compare"] = time.perf_counter() - t0
    pred_pts, _ = compare_mesh_to_ground_truth.load_points(ply_path, GT_SAMPLES)
    gt_pts, _ = compare_mesh_to_ground_truth.load_points(gt_path, GT_SAMPLES)
    nn_ms = host_ms(lambda: nearest_distances(pred_pts, gt_pts, device="cuda"), reps=3)
    rng = np.random.default_rng(SEED)
    sub_p = pred_pts[rng.choice(len(pred_pts), CPU_SUBSAMPLE, replace=False)]
    sub_g = gt_pts[rng.choice(len(gt_pts), CPU_SUBSAMPLE, replace=False)]
    card = nearest_distances(sub_p, sub_g, device="cuda")
    t1 = time.perf_counter()
    cpu = nearest_distances(sub_p, sub_g, device="cpu")
    cpu_s = time.perf_counter() - t1
    nn_equal = bool(np.array_equal(card, cpu))
    vs = rc.depth_integration.voxel_size
    log(f"[phase 8] mesh vs ground truth ({len(scene.clutter) + 1} boxes): "
        f"{json.dumps(cmp)} ({secs['compare']:.1f} s)")
    log(f"[phase 8] nearest_distances {len(pred_pts)} -> {len(gt_pts)} points on the card: "
        f"{nn_ms:.1f} ms (median of 3, synchronized wall time with the copies); on a "
        f"{CPU_SUBSAMPLE}-point subsample card == CPU bit for bit: {nn_equal} (CPU "
        f"{cpu_s:.2f} s)")

    t0 = time.perf_counter()
    [q_ply] = evaluate_mesh_quality.main([str(ply_path)])
    [q_fbx] = evaluate_mesh_quality.main([str(fbx_path)])
    secs["quality"] = time.perf_counter() - t0
    raw_ply, raw_fbx = dataclasses.asdict(q_ply.raw), dataclasses.asdict(q_fbx.raw)
    for k in ("name", "path"):
        raw_ply.pop(k), raw_fbx.pop(k)
    log(f"[phase 8] quality of the PLY and its FBX: raw metrics equal "
        f"{raw_ply == raw_fbx}; {raw_ply} ({secs['quality']:.1f} s)")

    t0 = time.perf_counter()
    down = downsample_fbx_mesh.main(["--input", str(fbx_path), "--output",
                                     str(work / "decimated.fbx"), "--ratio", "0.25"])
    secs["decimate"] = time.perf_counter() - t0
    target = int(len(ply.triangles) * 0.25)
    log(f"[phase 8] downsample_fbx_mesh --ratio 0.25: {len(ply.triangles)} -> "
        f"{len(down.triangles)} triangles (target {target}; {secs['decimate']:.1f} s)")

    checks = dict(
        {f"FBX read back: {k}": v for k, v in fbx_same.items()},
        **{f"COLMAP: {k}": v for k, v in colmap_ok.items()},
        **{f"mean_to_gt < 2 voxels ({2 * vs} m)": cmp["mean_to_gt"] < 2 * vs,
           "nearest_distances card == CPU": nn_equal,
           "quality raw metrics PLY == FBX": raw_ply == raw_fbx,
           "decimated within [0.75, 1.3] x target": 0.75 * target <= len(down.triangles)
           <= 1.3 * target})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"export and evaluation checks failed: {failed}")


def step_clis(work: Path) -> None:
    """Phase 8, second part: the step CLIs on phase 5's small capture on the
    card (launch counts reset just before each, read just after), their
    outputs against phase 5's run_full_pipeline on the card, then
    run_full_pipeline's CLI with --profile and --export-fbx on a fresh copy
    of the capture."""
    cfg_path = work / "small_colored.yml"  # JSON, which YAML reads
    cfg_path.write_text(json.dumps(dataclasses.asdict(small_configs()), default=str))
    session = work / "steps"
    write_synthetic_project(session, SMALL_SCENE)
    args = ["--project_dir", str(session), "--config", str(cfg_path)]
    t0 = time.perf_counter()
    launches = {}
    for name, cli in (("convert_yuv_to_rgb", convert_yuv_to_rgb),
                      ("convert_depth_to_linear_map", convert_depth_to_linear_map),
                      ("reconstruct_scene", reconstruct_scene)):
        _build.reset_launch_counts()
        cli.main(args)
        torch.cuda.synchronize()
        launches[name] = _build.launch_counts()
    ref = work / "small_cuda/reconstruction"
    va = np.load(session / "reconstruction/colorless_vbg.npz")
    vb = np.load(ref / "colorless_vbg.npz")
    same = {"colorless_vbg.npz": all(np.array_equal(va[k], vb[k]) for k in vb.files)}
    for name in MESHES[:2]:
        ma, mb = read_ply(session / "reconstruction" / name), read_ply(ref / name)
        same[name] = bool(np.array_equal(ma.vertices, mb.vertices)
                          and np.array_equal(ma.triangles, mb.triangles))
    log(f"[phase 8] step CLIs on phase 5's capture ({time.perf_counter() - t0:.1f} s), "
        f"launches {launches}; outputs equal to phase 5's run_full_pipeline on the card: "
        f"{same}")

    profiled = work / "profiled"
    write_synthetic_project(profiled, SMALL_SCENE)
    t0 = time.perf_counter()
    pipeline_cli.main(["--session_dir", str(profiled), "--config", str(cfg_path),
                       "--profile", str(work / "trace"), "--export-fbx"])
    secs = time.perf_counter() - t0
    trace_path = work / "trace" / pipeline_cli.TRACE_NAME
    events = json.loads(trace_path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = {e.get("name") for e in events if e.get("cat") == "kernel"}
    n_kernel_events = sum(e.get("cat") == "kernel" for e in events)
    log(f"[phase 8] run_full_pipeline --profile --export-fbx: {secs:.1f} s, trace "
        f"{trace_path.stat().st_size / 1e6:.1f} MB, {len(events)} events, "
        f"{n_kernel_events} CUDA kernel events of {len(kernels)} kernels; hand kernels "
        f"in it: {sorted(k for k in kernels if 'i420' in k or 'patch_lookup' in k)}")
    checks = dict({f"{k} equal": v for k, v in same.items()}, **{
        "K2 launched by convert_yuv_to_rgb": launches["convert_yuv_to_rgb"]["i420_to_bgr"] > 0,
        "K1 launched by reconstruct_scene": launches["reconstruct_scene"]["patch_lookup"] > 0,
        "trace names the stages": all(n in names for n in (
            "convert_yuv_to_rgb", "convert_depth_to_linear", "reconstruct_scene",
            "export_fbx")),
        "trace holds CUDA kernel events": n_kernel_events > 0,
        "K1 and K2 in the trace": any("patch_lookup" in k for k in kernels)
        and any("i420" in k for k in kernels),
        "color_mesh.fbx written": (profiled / "reconstruction/color_mesh.fbx").is_file(),
        "export_fbx stage in pipeline_runtime.txt":
            "  export_fbx: " in (profiled / "pipeline_runtime.txt").read_text(),
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"step CLI checks failed: {failed}")


REPO = Path(__file__).resolve().parent
RANK_RUN = "mq3d_tpu_torch.parallel.dryrun:rank_run"


def capture_frames(session: Path, configs: PipelineConfigs):
    """A capture's depth frames, left side then right, loaded as step 3
    loads them: (depth, K, T_wc, valid) stacks."""
    ic = configs.reconstruction.depth_integration
    data_io = DataIO(session)
    parts = []
    for side, ds in load_depth_datasets(data_io, configs.reconstruction).items():
        depth, valid = load_filtered_depth_stack(
            data_io.depth, side, ds, np.arange(len(ds)), ic.use_confidence_filtered_depth,
            ic.confidence_threshold, ic.valid_count_threshold)
        parts.append((depth, ds.get_render_intrinsic_matrices().astype(np.float32),
                      ds.transforms.extrinsics_wc.astype(np.float32), valid))
    return tuple(np.concatenate(x) for x in zip(*parts))


def sharded_world_of_one(work: Path, session: Path, configs: PipelineConfigs, smi: str):
    """Phase 9, part 1: phase 3's capture through integrate_dataset_sharded
    on an NCCL group of one rank, replicated and partitioned, against
    TSDFVolume.integrate chunked the same way: bit for bit (the all-reduce
    is the identity).  Returns the frames, the config, the chunk, the
    reference volume's active rows and K1's launches."""
    ic = configs.reconstruction.depth_integration
    cfg = tsdf_config_from_integration(ic)
    chunk = int(ic.frames_per_batch)
    frames = capture_frames(session, configs)
    depth, K, T, valid = frames
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = TSDFVolume(cfg, device="cuda")
    for s in range(0, len(depth), chunk):
        ref.integrate(depth[s:s + chunk], K[s:s + chunk], T[s:s + chunk], valid[s:s + chunk])
    torch.cuda.synchronize()
    secs = {"TSDFVolume.integrate": time.perf_counter() - t0}
    a, n = ref.state, ref.n_active
    same, k1 = {}, {}
    group = pdist.init_group("nccl", 0, 1, f"file://{work}/nccl_store", timeout_s=600)
    try:
        for mode in ("replicated", "partitioned"):
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = integrate_dataset_sharded(cfg, group, depth, K, T, valid,
                                          frames_per_rank_chunk=chunk,
                                          partition_state=mode == "partitioned", device="cuda")
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t0
            k1[mode] = _build.launch_counts()["patch_lookup"]
            same[mode] = {
                "counters": (a.n_active, a.overflow, a.dropped_active)
                == (b.n_active, b.overflow, b.dropped_active),
                "slot_table": torch.equal(a.slot_table, b.slot_table),
                "block_coords": torch.equal(a.block_coords, b.block_coords),
                "tsdf": torch.equal(a.tsdf[:n], b.tsdf[:n]),
                "weight": torch.equal(a.weight[:n], b.weight[:n]),
            }
            del b
    finally:
        pdist.destroy_group()
    log(f"[phase 9] NCCL world of 1, phase 3's capture ({len(depth)} frames "
        f"{depth.shape[2]}x{depth.shape[1]}, {chunk}-frame chunks, {cfg.voxel_size * 100:g} cm "
        f"voxels, "
        f"{cfg.block_count} blocks; {n} active): bit-equal to TSDFVolume.integrate "
        f"{same}; K1 launches {k1}; seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()) + f" ({smi})")
    failed = [f"{m}: {k}" for m, d in same.items() for k, ok in d.items() if not ok]
    if failed or min(k1.values()) == 0:
        raise AssertionError(f"sharded world of 1 differs or launched no K1: {failed}, {k1}")
    arrays = {"slot_table": a.slot_table.cpu().numpy(),
              "block_coords": a.block_coords[:n].cpu().numpy(),
              "tsdf": a.tsdf[:n].cpu().numpy(), "weight": a.weight[:n].cpu().numpy()}
    return frames, cfg, chunk, arrays, k1


def fragment_pairs(session: Path, rc):
    """Every pair of phase 7's fragment clouds (furnished room) at the
    first ICP level: voxel-downsampled sources and targets, the level's
    correspondence distance and iteration cap."""
    fp = rc.fragment_pose_refinement
    rio = DataIO(session).reconstruction
    clouds = []
    for side in Side:
        i = 0
        while rio.reconstruction_path_config.get_fragment_pcd_path(side, i).exists():
            clouds.append(icp.voxel_down_sample(rio.load_fragment_pcd(side, i).points,
                                                fp.icp_voxel_sizes[0]).astype(np.float32))
            i += 1
    pairs = [(s, t) for s in range(len(clouds)) for t in range(s + 1, len(clouds))]
    return ([clouds[s] for s, _ in pairs], [clouds[t] for _, t in pairs],
            float(fp.max_corr_dists[0]), int(fp.max_iterations[0]))


def sharded_two_ranks(world1, views, furnished: Path, rc, gn_path: Path, smi: str):
    """Phase 9, part 2: two gloo ranks on cuda:0 (NCCL refuses two ranks on
    one GPU; gloo's collectives stage through host memory): the same frames
    and chunks as part 1, replicated and partitioned, then the sharded
    raycast of phase 6's views at 1280x960, pair ICP on phase 7's fragment
    pairs and the Gauss-Newton terms of phase 6's first call, each against
    the unsharded port.  Returns K1's launches per rank."""
    (depth, K, T, valid), cfg, chunk, ref, _ = world1
    Kr, Tr, w, h = views
    sources, targets, max_corr, max_iter = fragment_pairs(furnished, rc)
    jobs = [
        ("integrate", {"cfg": cfg, "depth": depth, "K": K, "T": T, "valid": valid,
                       "frames_per_rank_chunk": chunk // 2}),
        ("raycast", {"K": Kr, "T": Tr, "width": w, "height": h, "views": 4}),
        ("icp", {"sources": sources, "targets": targets,
                 "max_corrs": [max_corr] * len(sources), "max_iteration": max_iter}),
        ("gn", {"path": str(gn_path)}),
    ]
    t0 = time.perf_counter()
    out = pdist.spawn_ranks(RANK_RUN, 2, "gloo", "cuda", jobs, timeout_s=600)
    wall = time.perf_counter() - t0
    integ = [r[0] for r in out]
    (_, ray, icp_r, gn), a = out[0], out[0][0]["arrays"]
    n = len(ref["block_coords"])
    tsdf_err = float(np.abs(a["tsdf"] - ref["tsdf"]).max()) if len(a["tsdf"]) == n else np.inf
    both = np.isfinite(ray["z"]) & np.isfinite(ray["z_single"])
    ray_err = float(np.abs(ray["z"][both] - ray["z_single"][both]).max(initial=0))
    icp_err = float(np.abs(icp_r["sharded"]["T"] - icp_r["plain"]["T"]).max())
    fit_err = float(np.abs(icp_r["sharded"]["fitness"] - icp_r["plain"]["fitness"]).max())
    gn_ok = all(np.allclose(x, y, rtol=1e-6, atol=1e-8)
                for x, y in zip(gn["sharded"], gn["plain"]))
    k1 = [r["modes"]["replicated"]["launches"]["patch_lookup"] for r in integ]
    checks = {
        "same slot table and counters on both ranks": len(
            {(r["digest_tables"], r["n_active"], r["overflow"], r["dropped_active"])
             for r in integ}) == 1,
        "partitioned == replicated on both ranks": all(
            r["partitioned_equal"] and r["pad_rows_zero"] for r in integ),
        "K1 launched on each rank": min(k1) > 0,
        "slot table == single process": np.array_equal(a["slot_table"], ref["slot_table"]),
        "block coords == single process": np.array_equal(a["block_coords"], ref["block_coords"]),
        "weights == single process": np.array_equal(a["weight"], ref["weight"]),
        "tsdf within 1e-5 of single process": tsdf_err <= 1e-5,
        "raycast: no overflow": ray["overflow"] == 0 and ray["overflow_single"] == 0,
        "raycast: same hits as single process": np.array_equal(
            np.isfinite(ray["z"]), np.isfinite(ray["z_single"])),
        "raycast within 1e-6 of single process": ray_err <= 1e-6,
        "pair ICP transforms within 1e-5 of unsharded": icp_err <= 1e-5,
        "pair ICP fitness within 1e-5 of unsharded": fit_err <= 1e-5,
        "Gauss-Newton terms == unsharded (rtol 1e-6, atol 1e-8)": gn_ok,
    }
    log(f"[phase 9] 2 gloo ranks on cuda:0 ({wall:.1f} s wall, process start-up "
        f"included; {smi}): integration seconds per rank "
        + str([{m: round(v["seconds"], 2) for m, v in r["modes"].items()} for r in integ])
        + f", K1 launches per rank {k1}, tsdf max |diff| to single process {tsdf_err:.3g}")
    log(f"[phase 9] sharded raycast of the first {len(ray['views_kept'])} of phase 6's "
        f"{ray['views_offered']} keyframe views that render alone without edge overflow "
        f"({ray['views_fitting']} do; kept {ray['views_kept']}), {w}x{h}: "
        f"{ray['seconds'] * 1e3 / len(ray['views_kept']):.2f}"
        f" ms per frame on 2 ranks (readback and gather included), overflow "
        f"{ray['overflow']} (single process {ray['overflow_single']}), max |dz| {ray_err:.3g}; "
        f"pair ICP {len(sources)} pairs ({min(map(len, sources))}-{max(map(len, sources))} "
        f"points): {icp_r['seconds']:.2f} s, max |dT| {icp_err:.3g}, max |dfitness| "
        f"{fit_err:.3g}, fitness {np.round(icp_r['sharded']['fitness'], 4).tolist()}; "
        f"Gauss-Newton terms of {gn['frames']} keyframes x {gn['vertices']} vertices: "
        f"{gn['seconds']:.3f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"two-rank checks failed: {failed}")
    return k1


def batch_two_hosts(work: Path, smi: str) -> dict:
    """Phase 9, part 3: batch_run_full_pipeline as two hosts (two
    processes joined by a gloo group) over three copies of phase 5's small
    capture, the second without its left depth: both hosts must print the
    merged status [1, 0, 1] and exit 1.  Returns the kernels' launches of
    the two sessions that ran."""
    base = work / "batch"
    names = [f"20250101_00000{i}" for i in range(3)]
    write_synthetic_project(base / names[0], SMALL_SCENE)
    for name in names[1:]:
        shutil.copytree(base / names[0], base / name)
    shutil.rmtree(base / names[1] / "left_depth")
    cfg_path = work / "batch_colored.yml"  # JSON, which YAML reads
    cfg_path.write_text(json.dumps(dataclasses.asdict(small_configs()), default=str))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mq3d_tpu_torch.scripts.batch_run_full_pipeline",
         "--base-dirs", str(base), "--config", str(cfg_path), "--n-hosts", "2",
         "--host-id", str(h), "--init-method", f"file://{work}/batch_store",
         "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for h in (0, 1)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    statuses = [re.findall(r"status (\[[^\]]*\])", o) for o in outs]
    sessions = [m for o in outs for m in re.findall(
        r"\[Info\] Session (\S+) finished in (\S+)s \(exit (\d+)\)", o)]
    launches = {}
    for name in (names[0], names[2]):
        line = re.search(r"kernel_launches: (.*)", (base / name / "pipeline_runtime.txt")
                         .read_text()).group(1)
        launches[name] = {k: int(v) for k, v in (kv.split("=") for kv in line.split())}
    log(f"[phase 9] batch CLI as 2 hosts over {len(names)} sessions ({wall:.1f} s wall; "
        f"{smi}): exit codes {[p.returncode for p in procs]}, merged status per host "
        f"{statuses}; sessions (name, seconds, exit) {sessions}; launches of the sessions "
        f"that ran {launches}")
    checks = {
        "both hosts exit 1": [p.returncode for p in procs] == [1, 1],
        "both hosts print [1, 0, 1]": statuses == [["[1, 0, 1]"], ["[1, 0, 1]"]],
        "K1 and K2 launched in the sessions": all(
            v["patch_lookup"] > 0 and v["i420_to_bgr"] > 0 for v in launches.values()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        tails = "\n".join(o[-3000:] for o in outs)
        raise AssertionError(f"batch CLI checks failed: {failed}\n{tails}")
    return launches


def multi_rank_paths(work: Path, session: Path, configs: PipelineConfigs, views,
                     furnished: Path, rc, gn_path: Path, smi: str) -> dict:
    """Phase 9: the multi-device and batch-of-sessions paths on the card.
    Two ranks on one card share it, so their times say nothing about
    scaling over cards."""
    t0 = time.perf_counter()
    world1 = sharded_world_of_one(work, session, configs, smi)
    log(f"[phase 9] part 1 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k1_ranks = sharded_two_ranks(world1, views, furnished, rc, gn_path, smi)
    log(f"[phase 9] part 2 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    batch = batch_two_hosts(work, smi)
    log(f"[phase 9] part 3 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun_multichip(2, device="cuda", backend="gloo", timeout_s=600)
    log(f"[phase 9] dryrun_multichip(2, cuda, gloo), tiny and production shapes, done in "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    return {"patch_lookup": {"nccl_world_of_1": world1[4]["replicated"],
                             "gloo_ranks": k1_ranks,
                             "batch_sessions": sum(v["patch_lookup"] for v in batch.values())},
            "i420_to_bgr": {"batch_sessions": sum(v["i420_to_bgr"] for v in batch.values())}}


def _printed(fn, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


def native_checks(work: Path, session: Path, info: dict) -> None:
    """Phase 10, first part: the runtime against its plain versions on
    phase 7's furnished-room capture, and both timed."""
    io_ = DataIO(session)
    side = Side.LEFT
    ds = io_.depth.load_depth_dataset(side)
    pc = io_.depth.depth_path_config
    paths = [pc.get_depth_map_path(side, int(t)) for t in ds.timestamps]
    frame = int(ds.widths[0]) * int(ds.heights[0]) * 4
    cases = work / "raw_cases"
    cases.mkdir()
    (cases / "short.raw").write_bytes(paths[0].read_bytes()[:frame // 3])
    (cases / "long.raw").write_bytes(paths[1].read_bytes() + paths[2].read_bytes()[:4096])
    all_paths = paths + [cases / "missing.raw", cases / "short.raw", cases / "long.raw"]
    buf, ok = native.read_raw_batch(all_paths, frame)
    plain_buf, plain_ok = native.read_raw_batch_plain(all_paths, frame)
    raw_equal = bool(np.array_equal(buf, plain_buf) and np.array_equal(ok, plain_ok))
    if not (raw_equal and ok[:len(paths)].all() and ok[len(paths):].tolist() == [False, False, True]
            and np.array_equal(buf[-1], buf[1])):
        raise AssertionError(f"read_raw_batch != the per-file read (ok {ok[-3:].tolist()})")
    read_ms = host_ms(lambda: native.read_raw_batch(paths, frame), reps=3)
    read_plain_ms = host_ms(lambda: native.read_raw_batch_plain(paths, frame), reps=3)
    log(f"[phase 10] read_raw_batch of {len(paths)} raw depth files ({frame} bytes each) + a "
        f"missing, a short and a long file: equal to the per-file read (ok of the three "
        f"{ok[-3:].tolist()}); {read_ms:.2f} ms native, {read_plain_ms:.2f} ms plain "
        f"(median of 3, files in the page cache)")

    rgb_dir = io_.color.image_path_config.get_rgb_dir(side)
    rgb = sorted(rgb_dir.glob("*.png"), key=lambda q: int(q.stem))
    bgrs = np.stack([imread_bgr(q) for q in rgb])
    out_native, out_plain = work / "png_native", work / "png_plain"
    out_native.mkdir()
    out_plain.mkdir()
    native_paths = [out_native / q.name for q in rgb]
    plain_paths = [out_plain / q.name for q in rgb]
    written = native.write_png_batch(native_paths, bgrs)
    write_png_batch_plain(plain_paths, bgrs)
    same_zlib = info["zlib_runtime"] == info["zlib_python"]
    bytes_equal = all(a.read_bytes() == b.read_bytes() for a, b in zip(native_paths, plain_paths))
    step0_equal = all(a.read_bytes() == b.read_bytes() for a, b in zip(native_paths, rgb))
    step = 1 if not same_zlib else 10
    pixels_equal = all(np.array_equal(imread_bgr(native_paths[i]), bgrs[i])
                       and np.array_equal(imread_bgr(plain_paths[i]), bgrs[i])
                       for i in range(0, len(rgb), step))
    if not (written.all() and pixels_equal and step0_equal and (bytes_equal or not same_zlib)):
        raise AssertionError(f"write_png_batch: written {written.all()}, pixels {pixels_equal}, "
                             f"bytes {bytes_equal}, step 0's files {step0_equal}")
    png_ms = host_ms(lambda: native.write_png_batch(native_paths, bgrs), reps=3)
    png_plain_ms = host_ms(lambda: write_png_batch_plain(plain_paths, bgrs), reps=3)
    png_pool_ms = host_ms(lambda: pool_write_png_batch(plain_paths, bgrs), reps=3)
    log(f"[phase 10] write_png_batch of {len(rgb)} {bgrs.shape[2]}x{bgrs.shape[1]} BGR frames "
        f"({bgrs.nbytes / 1e6:.1f} MB): pixels equal (every {step}th decoded), bytes equal to "
        f"encode_png's {bytes_equal} (zlib {info['zlib_runtime']} and Python's "
        f"{info['zlib_python']}) and to step 0's files {step0_equal}; {png_ms:.1f} ms native on "
        f"{info['threads']} threads, {png_plain_ms:.1f} ms plain (encode_png, one thread), "
        f"{png_pool_ms:.1f} ms encode_png on step 0's earlier pool of "
        f"{min(len(rgb), os.cpu_count() or 1, 8)} threads (median of 3 after a warm call)")

    w, h, rs = 1280, 960, 1344
    y_size = rs * h
    data = np.random.default_rng(SEED).integers(0, 256, y_size + rs * (h // 2 - 1) + w - 1,
                                                np.uint8).tobytes()
    planes = [(0, w, h, rs, 1), (y_size, w // 2, h // 2, rs, 2), (y_size + 1, w // 2, h // 2, rs, 2)]
    for args in planes:
        if not np.array_equal(native.destride_plane(data, *args), destride_plane(data, *args)):
            raise AssertionError(f"destride_plane {args}: native != numpy")
    ds_ms = host_ms(lambda: [native.destride_plane(data, *a) for a in planes], reps=5)
    ds_plain_ms = host_ms(lambda: [destride_plane(data, *a) for a in planes], reps=5)
    log(f"[phase 10] destride_plane of a {w}x{h} YUV_420_888 buffer (row stride {rs}, NV12 "
        f"chroma, short last row): Y, U and V equal to the numpy version; {ds_ms:.3f} ms "
        f"native, {ds_plain_ms:.3f} ms numpy (median of 5)")


def pool_write_png_batch(paths, imgs) -> None:
    """Step 0's PNG batch write before the native runtime: encode_png per
    frame on a pool of up to 8 threads (zlib releases the interpreter
    lock).  Timed beside the runtime; used nowhere in the port."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(len(paths), os.cpu_count() or 1, 8)) as pool:
        list(pool.map(lambda p, img: Path(p).write_bytes(encode_png(img)), paths, imgs))


def host_tools(work: Path, session: Path) -> None:
    """Phase 10, second part: the host tools on phase 7's furnished room."""
    io_ = DataIO(session)
    datasets = [io_.depth.load_depth_dataset(s) for s in Side] + [
        io_.color.load_color_dataset(s) for s in Side]
    ply_path = work / "trajectories.ply"
    _printed(visualize_camera_trajectories.main, ["--project_dir", str(session),
                                                  "--output", str(ply_path)])
    cloud = read_ply(ply_path)
    want = 5 * sum(-(-len(d) // 10) for d in datasets)
    colours = {tuple(c) for c in np.asarray(cloud.colors)}
    if not (len(cloud.points) == want and np.isfinite(cloud.points).all() and len(colours) == 4):
        raise AssertionError(f"trajectories.ply: {len(cloud.points)} points (want {want}), "
                             f"{len(colours)} colours")

    def offset(project: Path) -> dict:
        return json.loads(_printed(find_optimal_timestamp_offset.main, [
            "--project_dir", str(project), "--target", "left_camera_rgb",
            "--tolerance_ms", "2"]))

    found = offset(session)
    copy = work / "renamed_copy"
    for name in ("left_depth", "left_camera_rgb"):
        shutil.copytree(session / name, copy / name)
    printed = _printed(rename_timestamps.main, ["--project_dir", str(copy), "--offset_ms", "7",
                                                "--modalities", "left_depth"])
    src = sorted(session.joinpath("left_depth").iterdir(), key=lambda q: int(q.stem))
    renamed_ok = all(copy.joinpath("left_depth", f"{int(q.stem) + 7}.raw").read_bytes()
                     == q.read_bytes() for q in src)
    shifted = offset(copy)
    if not (found == {"best_offset_ms": 0.0, "best_overlap": 1.0} and renamed_ok
            and shifted == {"best_offset_ms": -5.0, "best_overlap": 1.0}):
        raise AssertionError(f"timestamp tools: offset {found}, renamed {renamed_ok}, "
                             f"after the shift {shifted}")

    study = work / "study"
    (study / "P01").mkdir(parents=True)
    (study / "P01" / "room_fog").symlink_to(session)
    (study / "P01" / "room_nofog").symlink_to(copy)
    _printed(analyze_fog_no_fog_mapping.main, ["--base_dir", str(study)])
    rows = (study / "master_fog_no_fog_report.csv").read_text().splitlines()
    if not (len(rows) == 2 and f"{study / 'P01' / 'room_fog'}" in rows[1]):
        raise AssertionError(f"master_fog_no_fog_report.csv: {rows}")
    log(f"[phase 10] visualize_camera_trajectories: {len(cloud.points)} frustum vertices of 4 "
        f"trajectories; find_optimal_timestamp_offset {found}; rename_timestamps {printed.strip()!r}"
        f" on a copy, every file moved with its bytes, and the offset then found {shifted}; "
        f"analyze_fog_no_fog_mapping: 1 pair")

    if importlib.util.find_spec("pandas") is None:
        log("[phase 10] no pandas here: the motion-stats CLIs, analyze_recording_lengths and "
            "trim_recordings run only in the CPU tests (tests/test_torch_tools.py)")
        return
    lengths = _printed(analyze_recording_lengths.main, [str(session)])
    stats = json.loads(_printed(compute_hmd_motion_stats.main, [
        str(session), "--summary-csv", str(work / "hmd_all_summary.csv")]).split("\n[Info]")[0])
    duration = stats[str(session)]["duration_s"]
    with open(session / "hmd_poses.csv", newline="") as f:
        t_ms = [float(r["unix_time"]) for r in csv.DictReader(f)]
    keep = len(src) // 4
    trimmed = _printed(trim_recordings.main, [str(copy), "--max-frames", str(keep)])
    kept = len(list((copy / "left_depth").iterdir()))
    if not (f"frames={len(src):6d}" in lengths and kept == keep
            and duration == max(t_ms) / 1000.0 - min(t_ms) / 1000.0):
        raise AssertionError(f"pandas tools: duration {duration}, kept {kept}")
    log(f"[phase 10] pandas present: analyze_recording_lengths, compute_hmd_motion_stats "
        f"(duration {duration:.3f} s over {stats[str(session)]['n_samples']} poses) and "
        f"trim_recordings --max-frames {keep} "
        f"({trimmed.strip().replace(str(copy), 'copy')}) ran; the CPU tests hold every tool "
        f"against the JAX package")


def native_runtime_and_tools(work: Path, session: Path) -> None:
    """Phase 10: the native IO runtime on this host (built in phase 1),
    then the host tools."""
    info = native.runtime_info()
    log(f"[phase 10] native IO runtime {native._lib_path().name}, built in phase 1 from "
        f"{native.SOURCE.name} in {native.last_build_seconds():.2f} s: {info['gxx']}; zlib "
        f"{info['zlib_compiled']} "
        f"compiled, {info['zlib_runtime']} loaded, Python's {info['zlib_python']}; "
        f"{info['threads']} threads for n_threads=0")
    native_checks(work, session, info)
    host_tools(work, session)


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
        f"sources, one nvcc each in parallel and one link: nvcc "
        f"{_build.last_build_seconds():.1f} s, phase {time.perf_counter() - t0:.1f} s")
    for line in _build.last_build_report().splitlines():
        log(f"[phase 1] {line}")
    native.build(force=True)
    native.library()
    log(f"[phase 1] built the native IO runtime {native._lib_path().name} from "
        f"{native.SOURCE.name} with g++: {native.last_build_seconds():.2f} s")

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    kernels = [check_k1(rng), check_k2(rng), check_k3()]
    check_gray()
    time_fma(rng)
    kernels[2]["launches"] = probe_path()
    log(f"[phase 2] done in {time.perf_counter() - t0:.1f} s")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        scene = quest_scene(n_frames=60)
        t0 = time.perf_counter()
        session, configs, vol, launches = main_path(work, scene)
        log(f"[phase 3] done in {time.perf_counter() - t0:.1f} s")
        for k in kernels[:2]:
            k["launches"] = launches[k["name"]]

        t0 = time.perf_counter()
        plain_path(session, configs, vol)
        del vol
        log(f"[phase 4] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        small_cpu_vs_card(work)
        small_pose_cpu_vs_card(work)
        log(f"[phase 5] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        gn_path = work / "gn_inputs.pt"
        views = colored_path(session, scene, gn_path)
        log(f"[phase 6] done in {time.perf_counter() - t0:.1f} s")
        capture = session

        t0 = time.perf_counter()
        # The issue's box room, whose bare parallel walls let the fragment
        # ICP slide (the JAX package's too): its run is checked, its
        # accuracy printed.  The furnished room is checked in full.
        _, run_checks, _, _, _ = shipped_config_path(work, quest_scene(200), "box room")
        furnished = quest_scene(200, ROOM_CLUTTER)
        k1, furnished_run, accuracy, session, rc = shipped_config_path(
            work, furnished, "furnished room")
        failed = [f"box room: {k}" for k, ok in run_checks.items() if not ok] + [
            f"furnished room: {k}" for k, ok in dict(furnished_run, **accuracy).items() if not ok]
        if failed:
            raise AssertionError(f"shipped config checks failed: {failed}")
        kernels[0]["launches_fragment_path"] = k1
        time_pose_programs(session, rc)
        log(f"[phase 7] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        exports_and_evaluation(work, session, furnished, rc)
        step_clis(work)
        log(f"[phase 8] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        phase9 = multi_rank_paths(work, capture, configs, views, session, rc, gn_path, smi)
        for k in kernels[:2]:
            k["launches_phase9"] = phase9[k["name"]]
        log(f"[phase 9] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        native_runtime_and_tools(work, session)
        log(f"[phase 10] done in {time.perf_counter() - t0:.1f} s")
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
