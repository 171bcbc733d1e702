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
     launch); K4 (`fma`) as bits against its plain version on tie,
     near-tie and special-value triples and at step 1's full-size and a
     Phase B tile's layouts, timed there with its byte bound; bgr_to_gray
     on the card against the CPU over all 2^24 BGR triples; the gather
     probe's seven calls
     (mq3d_tpu_torch.tools.probe_gather, K3's own path, counts reset just
     before and read just after)
  3. the main path: a synthetic capture at Quest scale through
     run_full_pipeline with the production TSDF settings (launch counts
     reset just before, read just after; every `fma` call on the card
     counted, and each must have launched K4: share 1.0; K5 once a window
     with blocks, K1 not at all, K5's pairs, each through the flat fetch);
     check_k5 on the run's first window, saved during the run: K5
     bit-equal to the tile path with K1 on the card and to the CPU tile
     loop, its device ms beside the tile path's and the bound of K5's
     operation count, and the tile path's share of tiles that took the
     flat gather; K1 timed again on the first whole tile of that tile
     path (the kernels line gives K1's main-path launches, 0, and its
     launches on that tile path apart)
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
     just after: steps 4-5 have no hand kernel yet, step 6 runs K6, one
     launch a pyramid level of each of the run's render calls), with
     substep seconds, mesh size, Gauss-Newton residuals, raycast ms per
     frame and peak memory; the mesh must lie on the box walls and the
     rendered depth must match the analytic box depth; check_k6 on one
     16-view call at 1280x960 of that volume: K6 bit-equal to the plain
     march and refine on the card, one launch a level, no host sync in
     the call, its counters, its device ms beside its compulsory-traffic
     bound and its no-cache sector figure, and the call's ms with K6 and
     with the plain path
  7. the shipped configuration at full width on the card: a Quest-scale
     capture of 200 frames per side of the room furnished with
     ROOM_CLUTTER through run_full_pipeline with
     config/pipeline_config.yml unchanged (every step, steps 1-2
     included; launch counts reset just before, read just after, and K5's
     launches of the fragment integrations counted apart), with substep
     seconds, edge counts, the pair ICP's last fitness and rmse, and peak
     memory; confidence maps, poses against the ground truth, the
     colorless cloud and the colored outputs must pass their gates (the
     bare box room's run of this config is phase 13's run_prod_e2e).
     Last, the device programs of steps 1-2 timed alone at these shapes
  8. the user's tools after reconstruction, on the card: on phase 7's
     furnished-room session, the FBX export of --export-fbx read back
     against color_mesh.ply, build_colmap_project --include_points
     (cameras, images, poses in the COLMAP frame, one Point3D per point of
     step 5's sampling at the shipped ratio), compare_mesh_to_ground_truth
     against the scene's boxes (mean_to_gt under 2 voxels; nearest_distances
     timed, card == CPU on a 20 000-point subsample), evaluate_mesh_quality
     on the PLY and its FBX (equal raw metrics) and downsample_fbx_mesh
     --ratio 0.25; then the step CLIs on phase 5's small capture (K2 and
     K5 launched, outputs equal to phase 5's card run) and
     run_full_pipeline --profile --export-fbx (a trace with the stages and
     CUDA kernel events, K5 and K2 among them)
  9. the multi-device and batch-of-sessions paths (mq3d_tpu_torch.parallel):
     phase 3's capture through integrate_dataset_sharded on an NCCL group
     of one rank, replicated and partitioned, bit-equal to
     TSDFVolume.integrate chunked the same way (K5 counted); the same
     frames on two gloo ranks sharing cuda:0 (weights and blocks equal to
     the single-process volume, tsdf within 1e-5, partitioned == replicated
     bit for bit, K5 launched on each rank), with the sharded raycast at
     1280x960 of the first 4 of phase 6's keyframe views that render alone
     within the edge budget (within 1e-6 of the single-process render, no
     edge overflow), pair ICP on phase 7's fragment pairs and the
     Gauss-Newton terms of phase 6's first call, each against the unsharded
     port; batch_run_full_pipeline as two hosts over three copies of phase
     5's capture, one without its left depth (both print [1, 0, 1] and exit
     1; K5 and K2 launched in the sessions); dryrun_multichip on two gloo
     ranks, tiny and production shapes.  Two ranks share one card, so
     these times say nothing about scaling over cards
  10. the native IO runtime and the host tools on phase 7's furnished room:
     phase 1's build of the runtime on this host (g++ and zlib versions,
     thread count, build seconds); read_raw_batch against the per-file read
     on the side's raw depth files plus a missing, a short and a long file;
     write_png_batch on the side's 200 colour frames against encode_png
     (equal pixels, and equal bytes where both link one zlib) and against
     step 0's own files; destride_plane against the numpy one at Quest
     scale; median times of the PNG batch (native, and encode_png on the
     8-thread pool step 0 used before the runtime; encode_png on one
     thread is timed on its one call), the raw read and the de-striding;
     then visualize_camera_trajectories,
     find_optimal_timestamp_offset, rename_timestamps on a copy and
     analyze_fog_no_fog_mapping with their outputs checked, and the tools
     that read CSVs with pandas when this machine has pandas
  11. the uint16 stream and scan-fused paths: bench.py's workload cut to
     200 frames for time (mq3d_tpu_torch.bench.make_capture:
     320x288 from 50 unique renders; bench_config(), the production TSDF
     settings; groups of 5 chunks of 20 frames) through the bench's parts,
     bench_integrate_fused_u16 on the quantized stack and
     bench_integrate_fused on the same stack dequantized on the host, one
     rep each (volumes identical, K5 launched on each run, counts reset
     just before and read just after; frames/s after a warm-up group and
     bytes to the card per launch printed); TSDFVolume.integrate_scan on
     the first 200 frames against 10 integrate(auto_split=False) calls
     (identical); the u16 volume against bench_integrate_fused's on the
     unquantized depth (printed);
     convert_yuv420_888_to_bgr on a 1280x960 frame of the furnished room
     equal to its convert_yuv_batch row (K2 launched once); then the
     study at the reference's size (10 participants x Fog/NoFog, 180 s of
     HMD and two-hand controller poses at 90 Hz each) through the
     motion-stats CLIs, the engine (every paired t-test equal to scipy's
     ttest_rel; the built-in fog effect on head_cumulative_radians found
     at one-tailed p < 0.05), the report writers and the survey CLI, and
     the ten study CLIs in full where matplotlib and seaborn import
  12. the bench's entry point: `python -m mq3d_tpu_torch.bench --reps 1
     --frames 200` (its capture cut from 1000 frames for time) in a
     subprocess (its one JSON line on stdout with every key of bench.py's
     line plus `device`, every number finite and positive, the card named),
     then the two CPU reference tools once, bench_reference_cpu on 100
     frames with --parity (the C++ loop within 2 % of the port's total
     observations) and bench_reference_raycast on 4 views (its renders of
     the port's marching-cubes mesh against the analytic depth)
  13. the last tools of tools/, each in a subprocess: `python -m
     mq3d_tpu_torch.tools.run_prod_e2e` at its defaults (a fresh capture of
     500 frames per side at Quest scale, 640x480 colour, through the
     shipped config/pipeline_config.yml, every step on; rc 0, the
     colorless cloud and volume, the colour mesh and the colour-aligned
     depth written, every stage in pipeline_runtime.txt, [Substep] lines,
     K5 and K2 launched, the card's name and power limit printed; its
     stage and substep seconds printed; then phase 7's checks of the run
     on its session and output: the bare box room's parallel walls let
     the fragments slide against each other in the scene ICP, the JAX
     package's algorithm too, so confidence maps and packs, 5 fragments
     per side and the colored outputs are gated and the accuracy against
     the ground truth only printed); bench_reference_stages --parity
     with cut reps (the C++ confidence and the port's: valid counts equal
     on >= 99.9 % of pixels, p99 |dconf| <= 0.01; both ICP residual
     rotations under 0.01 deg; B9 and B10 on the card beside the C++ on one
     and on all of the host's threads); bench_raycast on 4 views at
     1280x960 (median error under a quarter voxel, 2.5 mm; K5 launched
     while its volume is built)
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
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from mq3d_tpu_torch import bench
from mq3d_tpu_torch.analysis import report as study_report
from mq3d_tpu_torch.analysis import stats as study_stats
from mq3d_tpu_torch.config.configs import (
    PRODUCTION_INTEGRATION,
    PipelineConfigs,
    colored_recipe,
    colorless_recipe,
)
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.dataio.ply import TriangleMesh, read_ply, write_ply_mesh
from mq3d_tpu_torch.eval import metrics as eval_metrics
from mq3d_tpu_torch.eval.metrics import nearest_distances
from mq3d_tpu_torch.eval.quality import CSV_FIELDS as QUALITY_CSV_FIELDS
from mq3d_tpu_torch.export.colmap import qvec2rotmat, read_cameras_binary, read_images_binary
from mq3d_tpu_torch.export.fbx import read_fbx_mesh
from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops import icp, odometry, posegraph, raycast
from mq3d_tpu_torch.ops import fma as fma_ops
from mq3d_tpu_torch.ops import tsdf as tsdf_ops
from mq3d_tpu_torch.ops.tsdf import TSDFVolume
from mq3d_tpu_torch.ops.gather import MODES as gather_modes
from mq3d_tpu_torch.ops.gather import gather, gather_plain
from mq3d_tpu_torch.ops.sampling import sample_points_uniformly
from mq3d_tpu_torch.ops.ray_march import (
    GATHERS_PER_SAMPLE,
    GATHERS_PER_STEP,
    SECTOR_BYTES,
    march_base,
    march_fine,
    ray_march_counts,
    reset_ray_march_counts,
)
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup, patch_lookup_plain
from mq3d_tpu_torch.ops.tsdf_window import (
    OPS_MERGE_VOXEL,
    OPS_PAIR_VOXEL,
    integrate_window,
    reset_window_pair_count,
    window_pair_count,
)
from mq3d_tpu_torch.ops.yuv import (
    bgr_to_gray,
    convert_yuv420_888_to_bgr,
    convert_yuv_batch,
    yuv420_to_8uc3,
    yuv420_to_bgr,
)
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
    analyze_combined_motion_stats,
    analyze_controller_motion_stats,
    analyze_fog_no_fog_mapping,
    analyze_hmd_motion_stats,
    analyze_mesh_quality_stats,
    analyze_recording_lengths,
    analyze_simple_mesh_metrics,
    analyze_survey_hypotheses,
    build_colmap_project,
    compare_mesh_to_ground_truth,
    compute_controller_motion_stats,
    compute_hmd_motion_stats,
    convert_depth_to_linear_map,
    convert_yuv_to_rgb,
    downsample_fbx_mesh,
    evaluate_mesh_quality,
    find_optimal_timestamp_offset,
    generate_comprehensive_quality_analysis,
    generate_participant_demographics,
    generate_simple_pairwise_report,
    reconstruct_scene,
    rename_timestamps,
    trim_recordings,
    visualize_camera_trajectories,
)
from mq3d_tpu_torch.scripts import run_full_pipeline as pipeline_cli
from mq3d_tpu_torch.testing.fma_cases import compare_bits, special_triples, tie_triples
from mq3d_tpu_torch.testing.synthetic import (
    ROOM_CLUTTER,
    SyntheticSceneConfig,
    orbit_poses_o3d,
    quest_scene,
    render_box_depth,
    write_synthetic_project,
)
from mq3d_tpu_torch.tools import probe_gather
from mq3d_tpu_torch.tools import run_prod_e2e
from mq3d_tpu_torch.ops.yuv import destride_plane
from mq3d_tpu_torch.utils import native
from mq3d_tpu_torch.utils.devtime import bound_ms as bound
from mq3d_tpu_torch.utils.devtime import floor_ms, time_ms
from mq3d_tpu_torch.utils.png import encode_png, imread_bgr, write_png_batch_plain

SEED = 0
# bench.py's capture is 1000 frames; phases 11 and 12 run it at 200 (two
# groups of 5 chunks of 20 frames: one warm-up, one timed) so that the
# whole smoke, phase 13's 500-frames-per-side run included, ends well
# inside its 1200 s.
BENCH_FRAMES = 200


def log(msg: str) -> None:
    print(msg, flush=True)


class _Tee(io.StringIO):
    """Standard output that is also kept, for the lines a run prints."""

    def write(self, text: str) -> int:
        sys.__stdout__.write(text)
        return super().write(text)

    def flush(self) -> None:
        sys.__stdout__.flush()


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


def _fma_bytes(a, b, c) -> int:
    """K4's bytes: each operand's distinct elements read once, 4 bytes an
    output element written."""
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
    sizes, strides = fma_ops.merge_layout(
        shape, [fma_ops.broadcast_strides(t, shape) for t in (a, b, c)])
    distinct = sum(int(np.prod([n for n, st in zip(sizes, s) if st != 0])) for s in strides)
    return 4 * (distinct + int(np.prod(shape)))


def check_k4(rng) -> dict:
    """K4 (`ops.fma.fma` on the card) against its plain version, as bits
    (NaN as NaN), on tie, near-tie and special-value triples and at the main
    path's layouts, each launching K4 once; timed with its byte bound and
    the plain version at step 1's full-size shape (16 references x 20
    neighbours x 288 x 320, a stride-3 point component against a broadcast
    pose scalar) and at a Phase B tile (512 pairs x 16^3 voxels)."""
    err = 0.0

    def same_bits(got, want, what):
        nonlocal err
        equal, case_err = compare_bits(got, want)
        err = max(err, case_err)
        if not equal:
            raise AssertionError(f"K4 fma differs from its plain version: {what}, "
                                 f"by up to {case_err}")

    def kernel(a, b, c):
        before = _build.launch_counts()["fma"]
        out = fma_ops.fma(a, b, c)
        torch.cuda.synchronize()
        if _build.launch_counts()["fma"] != before + 1:
            raise AssertionError("fma on the card did not launch K4 once")
        return out

    for name, arrays in (("ties", tie_triples(4099)), ("specials", special_triples(1 << 18))):
        a, b, c = (torch.from_numpy(x).cuda() for x in arrays)
        same_bits(kernel(a, b, c), fma_ops.fma_plain(a, b, c), name)
        same_bits(kernel(a[1:], b[1:], c[1:]), fma_ops.fma_plain(a[1:], b[1:], c[1:]),
                  f"{name}, unaligned")

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()

    p = randn(16, 1, 288, 320, 3)
    T = randn(16, 20, 1, 1, 4, 4)
    full = (p[..., 1], T[..., 0, 1], randn(16, 20, 288, 320))
    q = randn(512, 4096, 3)
    tile = (randn(512, 1), q[..., 2], randn(512, 4096))
    rows, plain_rows = [], []
    for what, args in (("step 1, 16x20x288x320, pose scalar", full),
                       ("Phase B tile, 512x4096", tile)):
        shape = torch.broadcast_shapes(*(t.shape for t in args))
        dense = [t.expand(shape).contiguous() for t in args]
        same_bits(kernel(*args), fma_ops.fma_plain(*dense), what)
        ms = time_ms(lambda: fma_ops.fma(*args))
        plain_ms = time_ms(lambda: fma_ops.fma_plain(*args))
        nbytes = _fma_bytes(*args)
        b_ms, b_by = bound(nbytes, 2 * int(np.prod(shape)))
        log(f"[phase 2] K4 fma at {what}: equal as bits; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
        rows.append({"shape": what, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by})
    log(f"[phase 2] K4 fma on ties, near-ties and special values (subnormal, huge, inf, "
        f"NaN, signed zeros), aligned and unaligned, and at the two shapes: equal as bits, "
        f"largest difference where both are finite {err}")
    return {"name": "fma", "route": "cuda", "source": "mq3d_tpu_torch/csrc/fma.cu",
            "replaces": "XLA's fused multiply-add, no Pallas kernel",
            "max_abs_err": err, "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": None, "shapes": rows}


_FMA_MODULES = (fma_ops, tsdf_ops, confidence, icp, raycast, eval_metrics)


@contextlib.contextmanager
def counting_fma_calls(counts: dict):
    """Count each `fma` call whose operands lie on the card and whose
    result is not empty (counts["card_calls"]; an empty one launches
    nothing), in every module that calls it."""
    fma = fma_ops.fma

    def counted(a, b, c):
        if a.is_cuda and np.prod(fma_ops.broadcast_shape(a.shape, b.shape, c.shape)) > 0:
            counts["card_calls"] = counts.get("card_calls", 0) + 1
        return fma(a, b, c)

    for m in _FMA_MODULES:
        m.fma = counted
    try:
        yield counts
    finally:
        for m in _FMA_MODULES:
            m.fma = fma


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

    # Keep the run's first K5 window (the first chunk's) for check_k5, its
    # blocks' table rows as they stood before it; count the windows.
    saved, windows = [], []

    def keep_first_window(cfg, tsdf, weight, block_coords, *rest):
        slots = rest[-1]
        if not saved:
            saved.append((cfg, tsdf[slots], weight[slots], block_coords[slots],
                          *(t.clone() for t in rest[:-1])))
        windows.append(slots.numel())
        return integrate_window(cfg, tsdf, weight, block_coords, *rest)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    os.environ["MQ3D_SUBSTEP_TIMING"] = "1"  # reconstruction substep seconds
    tsdf_ops.integrate_window = keep_first_window
    _build.reset_launch_counts()
    reset_window_pair_count()
    t0 = time.perf_counter()
    with counting_fma_calls({}) as fma_calls:
        run = run_full_pipeline(session, configs, device="cuda")
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _build.launch_counts()
    pairs = window_pair_count()
    tsdf_ops.integrate_window = integrate_window
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
    fma_share = launches["fma"] / max(fma_calls.get("card_calls", 0), 1)
    log(f"[phase 3] K4: {launches['fma']} launches for {fma_calls.get('card_calls', 0)} "
        f"fma calls on the card, share {fma_share:.4f}")
    log(f"[phase 3] K5: {launches['tsdf_window']} launches for {len(windows)} windows "
        f"({sum(n > 0 for n in windows)} with blocks); {pairs} (block, frame) pairs, every "
        f"one through the flat fetch")
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
        "K5 launched": launches["tsdf_window"] > 0,
        "one K5 launch per window with blocks":
            launches["tsdf_window"] == sum(n > 0 for n in windows),
        "K1 off the main path": launches["patch_lookup"] == 0,
        "K2 launched": launches["i420_to_bgr"] > 0,
        "every fma on the card launched K4":
            launches["fma"] > 0 and launches["fma"] == fma_calls.get("card_calls"),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    k5, k1_tile, k1_launches = check_k5(*saved[0])
    time_k1_on_tile(*k1_tile)
    k5["launches"] = launches["tsdf_window"]
    k5["pairs"] = pairs
    return session, configs, vol, launches, k5, k1_launches


def check_k5(cfg, tsdf0, weight0, block_coords, depth, K, E, touched, wkeys):
    """K5 on the main path's first window, a whole chunk of production
    frames, its blocks' tables as they stood before it: bit-equal to the
    tile path with K1 (depth_lookup "pallas"), whose first whole tile is
    kept for K1's row, and to the CPU tile loop (untimed); device ms from a
    cold L2 beside the tile path's and the bound of K5's operation count
    (ops.tsdf_window: operations a pair and voxel and a merged voxel;
    bytes of the frames, poses and tables); the tile path's share of tiles
    that took the flat gather (a voxel outside its pair's patch).  Returns
    (K5's row, K1's tile, K1's launches on that tile path)."""
    n, R3 = len(wkeys), cfg.r3
    C = depth.shape[0]
    rows = torch.arange(n, device=wkeys.device)

    def k5(tables):
        integrate_window(cfg, tables.tsdf, tables.weight, block_coords, depth, K, E, touched,
                         wkeys, rows)

    tile_cfg = dataclasses.replace(cfg, depth_lookup="pallas")
    tile = []

    def keep_first_tile(patch, vi, ui):
        if not tile and patch.shape[0] == cfg.integrate_tile:
            tile.append((patch.clone(), vi.clone(), ui.clone()))
        return patch_lookup(patch, vi, ui)

    window = (depth, K, E, block_coords, rows, touched, wkeys)

    def tile_path(tables, lookup="pallas", inputs=window):
        *frames_and_coords, slots, grid, keys = inputs
        widx, f = tsdf_ops._pairs_from_grid(grid, keys)
        sums, cnts = tsdf_ops._integrate_pairs(tile_cfg, *frames_and_coords, slots, widx, f,
                                               lookup)
        tsdf_ops._merge_window(tables, slots, sums, cnts)

    def fresh(device=tsdf0.device):
        return types.SimpleNamespace(tsdf=tsdf0.to(device, copy=True),
                                     weight=weight0.to(device, copy=True))

    def same(a, b):
        return {k: torch.equal(getattr(a, k).cpu().view(torch.int32),
                               getattr(b, k).cpu().view(torch.int32)) for k in ("tsdf", "weight")}

    got, want, cpu = fresh(), fresh(), fresh("cpu")
    reset_window_pair_count()
    _build.reset_launch_counts()
    k5(got)
    pairs = window_pair_count()
    tsdf_ops.reset_lookup_tile_counts()
    tsdf_ops.patch_lookup = keep_first_tile
    tile_path(want)
    tsdf_ops.patch_lookup = patch_lookup
    tiles = tsdf_ops.lookup_tile_counts()
    launches = _build.launch_counts()
    t0 = time.perf_counter()
    tile_path(cpu, "flat", tuple(t.cpu() for t in window))
    cpu_s = time.perf_counter() - t0
    equal = {"tile path on the card": same(got, want), "CPU tile loop": same(got, cpu)}
    if (not all(all(e.values()) for e in equal.values()) or launches["tsdf_window"] != 1
            or not tile):
        raise AssertionError(f"K5 on the main path's first window: equal {equal}, launches "
                             f"{launches}, K1 tile kept {bool(tile)}")
    scratch = fresh()
    ms = time_ms(lambda: k5(scratch))
    tile_ms = time_ms(lambda: tile_path(scratch), reps=3, warmup=1)
    ops = pairs * R3 * OPS_PAIR_VOXEL + n * R3 * OPS_MERGE_VOXEL
    nbytes = (depth.numel() + C * (16 + 9) + n * R3 * 2 * 2) * 4  # float32
    b_ms, b_by = bound(nbytes, ops)
    over = tiles["over"] / max(tiles["patch"] + tiles["over"], 1)
    log(f"[phase 3] K5 tsdf_window on the first window ({n} blocks, {C} frames, "
        f"{pairs} pairs, each through the flat fetch): bit-equal to the tile path with K1 and "
        f"to the CPU tile loop ({cpu_s:.1f} s); the tile path's tiles {tiles}, over share "
        f"{over:.4f}; kernel {ms:.4f} ms, tile path {tile_ms:.4f} ms (its host syncs inside "
        f"the timed span), bound {b_ms:.4f} ms ({b_by}: {ops / 1e9:.2f} G operations, "
        f"{nbytes / 1e6:.1f} MB), {100 * b_ms / ms:.1f} % of it")
    return ({"name": "tsdf_window", "route": "cuda",
             "source": "mq3d_tpu_torch/csrc/tsdf_window.cu",
             "replaces": "Phase B's tile loop (JAX _integrate_pairs, tile_body, _merge_window; "
                         "K1's fetch folded in)",
             "max_abs_err": 0.0, "ms": ms, "plain_ms": tile_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None, "window_blocks": n,
             "window_pairs": pairs, "tile_path_over_share": over},
            tile[0], launches["patch_lookup"])


def time_k1_on_tile(patch, vi, ui) -> None:
    """K1 on one integration tile of the main path's first window, taken
    through the tile path (its patch-relative indices are those of real
    voxels, not random ones)."""
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


def _same_volume(a, b) -> dict:
    """{field: equal} of two TSDF states over a's active blocks."""
    n = a.n_active
    return {"n_active": a.n_active == b.n_active,
            "slot_table": torch.equal(a.slot_table, b.slot_table),
            "block_coords": torch.equal(a.block_coords[:n], b.block_coords[:n]),
            "tsdf": torch.equal(a.tsdf[:n], b.tsdf[:n]),
            "weight": torch.equal(a.weight[:n], b.weight[:n]),
            "counters": (a.overflow, a.dropped_active) == (b.overflow, b.dropped_active)}


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
    same = _same_volume(vol.state, plain.state)
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
    # K6 launches once a pyramid level of each render call on the card.
    render = raycast._render_frames
    render_levels = []

    def count_levels(*args):
        if args[5].is_cuda:  # K
            render_levels.append(len(raycast._pyramid_scales(args[10], args[11])))
        return render(*args)

    raycast._render_frames = count_levels
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            run = run_full_pipeline(session, configs, device="cuda")
        torch.cuda.synchronize()
    finally:
        raycast._render_frames = render
    total = time.perf_counter() - t0
    launches = _build.launch_counts()
    color_opt._gn_terms = gn_terms
    del os.environ["MQ3D_SUBSTEP_TIMING"]
    printed = out.getvalue()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[phase 6] stage seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in run.stage_seconds.items())
        + f"; total {total:.2f} s; peak device memory {peak_gb:.2f} GB; launches "
        f"{launches} (steps 4-5 run plain PyTorch, step 6 K6; K2/K5 of steps 0/3 ran in "
        f"phase 3)")
    k6_launches = launches.get("ray_march", 0)
    log(f"[phase 6] K6: {k6_launches} launches for {len(render_levels)} render calls of "
        f"{sum(render_levels)} pyramid levels in all")
    if not 0 < k6_launches == sum(render_levels):
        raise AssertionError(f"step 6 launched K6 {k6_launches} times for "
                             f"{len(render_levels)} render calls of {sum(render_levels)} levels")

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
    views = (np.concatenate([ds.get_render_intrinsic_matrices() for ds in datasets.values()])
             .astype(np.float32),
             np.concatenate([ds.transforms.extrinsics_wc for ds in datasets.values()])
             .astype(np.float32),
             int(ds0.widths[0]), int(ds0.heights[0]))
    k6 = check_k6(vol, *views)
    k6.update(launches=k6_launches, render_calls=len(render_levels))
    return views, k6


def check_k6(vol: TSDFVolume, K, T_wc, width: int, height: int, n_views: int = 16) -> dict:
    """K6 at the benchmark's shape: one render call of `n_views` views
    (phase 6's keyframe views, repeated in order) at width x height of a
    1 cm volume.  Its maps and overflow bit-equal to the plain march and
    refine on the card; one K6 launch a pyramid level, no K4 launch but the
    edge tests' two a fine level, no host sync inside the call; K6's
    counters (lanes equal to the base pixels plus each fine level's
    cap_p * f^2).  Times: each level's K6 launch from a cold L2, summed,
    beside its bound, the compulsory traffic of k6_compulsory_bytes over
    3.35 TB/s, and beside the time of its gathers at one 32-byte sector
    each from HBM (2 a march step, 5 a refine sample, plus 4 bytes a
    lane's depth; no cache serves any of them, so the L1 and L2 beat it);
    the whole call with K6 and with the plain path (host clock,
    synchronized).  Returns K6's row of the kernel table; phase 6 puts
    its own run's K6 launches under `launches`."""
    idx = np.arange(n_views) % len(K)
    Kb, Tb = K[idx], T_wc[idx]

    def call():
        z, over = raycast._render_frames_device(vol, Kb, Tb, width, height)
        torch.cuda.synchronize()
        return z, over

    call()  # the scene's preparation and the build, outside what is checked
    saved = []

    def keep_base(*args):
        saved.append((march_base, args))
        return march_base(*args)

    def keep_fine(*args):
        # A copy of the upsampled map it writes in place, for the timing.
        saved.append((march_fine, args[:12] + (args[12].clone(),) + args[13:]))
        return march_fine(*args)

    render = raycast._render_frames

    def no_sync(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return render(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    raycast.march_base, raycast.march_fine, raycast._render_frames = keep_base, keep_fine, no_sync
    _build.reset_launch_counts()
    reset_ray_march_counts()
    try:
        z, over = call()
    finally:
        raycast.march_base, raycast.march_fine = march_base, march_fine
        raycast._render_frames = render
    launches = _build.launch_counts()
    counts = ray_march_counts()
    with raycast._plain_path():
        z_p, over_p = call()
    scales = raycast._pyramid_scales(width, height)
    levels = len(scales)
    base_lanes = n_views * (height // scales[0]) * (width // scales[0])
    fine_lanes = sum(a[9].numel() * a[8] ** 2 for fn, a in saved if fn is march_fine)
    same = torch.equal(z.view(torch.int32), z_p.view(torch.int32))
    checks = {
        "maps bit-equal to the plain path": same,
        "overflow equal": int(over) == int(over_p),
        "one K6 launch a level": launches["ray_march"] == levels == len(saved),
        "K4 only in the edge tests": launches["fma"] == 2 * (levels - 1),
        "lanes counted": (counts["base"]["lanes"], counts["fine"]["lanes"])
        == (base_lanes, fine_lanes),
        "hits within lanes": all(0 < c["hits"] <= c["lanes"] for c in counts.values()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"K6 at {n_views} x {width}x{height}: failed {failed}; launches "
                             f"{launches}, counts {counts}")
    ms = sum(time_ms(lambda fn=fn, a=a: fn(*a)) for fn, a in saved)
    samples = {"base": raycast._REFINE_SAMPLES_BASE + raycast._REFINE_ITERS_BASE,
               "fine": raycast._REFINE_SAMPLES_FINE + raycast._REFINE_ITERS_FINE}
    gathers = sum(GATHERS_PER_STEP * c["steps"] + GATHERS_PER_SAMPLE * c["hits"] * samples[k]
                  for k, c in counts.items())
    nbytes = gathers * SECTOR_BYTES + 4 * (base_lanes + fine_lanes)
    s_ms, _ = bound(nbytes, 0)
    per_level = k6_compulsory_bytes(call)
    b_ms, b_by = bound(sum(per_level), 0)
    call_ms = host_ms(call)
    with raycast._plain_path():
        plain_ms = host_ms(call, reps=3)
    log(f"[phase 6] K6 ray_march, one call of {n_views} views at {width}x{height} (levels "
        f"{scales}): maps and overflow ({int(over)} px) bit-equal to the plain march and refine "
        f"on the card, no host sync inside the call; launches {launches}; counts {counts} "
        f"(hit share base {counts['base']['hits'] / counts['base']['lanes']:.4f}, fine "
        f"{counts['fine']['hits'] / max(counts['fine']['lanes'], 1):.4f}); K6 {ms:.4f} ms over "
        f"its {levels} launches, bound {b_ms:.4f} ms ({b_by}: compulsory traffic "
        f"{sum(per_level) / 1e6:.2f} MB, by level {[round(b / 1e6, 2) for b in per_level]}), "
        f"{100 * b_ms / ms:.1f} % of it; with no cache, its {gathers} gathers at one "
        f"{SECTOR_BYTES} B sector each from HBM ({nbytes / 1e6:.1f} MB) would take "
        f"{s_ms:.4f} ms; the call {call_ms:.2f} ms with K6, {plain_ms:.2f} ms with the plain "
        f"path (host clock)")
    return {"name": "ray_march", "route": "cuda", "source": "mq3d_tpu_torch/csrc/ray_march.cu",
            "replaces": "the JAX march's lax.while_loop and _refine (mq3d_tpu/ops/raycast.py "
                        "_march :234, _refine :305)",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
            "bound_ms": b_ms, "bound_by": b_by, "compulsory_bytes": per_level,
            "sector_ms": s_ms, "library_ms": None,
            "launches_check_call": launches["ray_march"], "counts": counts}


def k6_compulsory_bytes(call) -> list:
    """Per pyramid level of one render call, the bytes that K6 cannot move
    less of from a cold L2: each distinct 32-byte sector of the slot
    distances and of the z-pair table that the level's lanes gather, read
    once, and 4 bytes a depth written.  Found by running the plain march
    and refine with their gathers recorded as K6 makes them: a lane's
    march gathers while its t lies in its window (a lane that found its
    bracket repeats its last gather, which adds no sector), its refine's
    only if it found a bracket.  Every lane writes at the base level; a
    fine level counts the lanes that take a step.  The reads of the rays'
    inputs are left out, so it is a lower bound."""
    at, sample_ids, march, refine = (raycast._at, raycast._sample_ids, raycast._march,
                                     raycast._refine)
    rec = {"mode": None, "seen": {}}  # seen: the sectors gathered, a bitmap a table
    per_level = []
    offsets = [(dx * raycast._EXT + dy) * raycast._EXT for dx in (0, 1) for dy in (0, 1)]

    def mark(name, table, elems):
        seen = rec["seen"].setdefault(name, torch.zeros(
            table.numel() * table.element_size() // SECTOR_BYTES + 1, dtype=torch.bool,
            device=table.device))
        seen[elems * table.element_size() // SECTOR_BYTES] = True

    def rec_march(cfg, slot_dist, ext, n_bucket, origins, dirs, t_init, t_min, t_max,
                  max_iter):
        rec.update(mode="march", ext=ext, t_hi=t_max, writes=None,
                   all_write=not per_level, n=origins.shape[0])
        return march(cfg, slot_dist, ext, n_bucket, origins, dirs, t_init, t_min, t_max,
                     max_iter)

    def rec_at(origins, dirs, t):
        if rec["mode"] == "march":
            rec["mask"] = t <= rec["t_hi"]
            if rec["writes"] is None:
                rec["writes"] = rec["n"] if rec["all_write"] else int(rec["mask"].sum())
        return at(origins, dirs, t)

    def rec_sample_ids(cfg, n_bucket, slot_dist, g):
        idx, sd = sample_ids(cfg, n_bucket, slot_dist, g)
        G = cfg.grid_dim
        key = raycast._block_keys(torch.div(g, cfg.block_resolution, rounding_mode="floor"), G)
        if rec["mode"] == "march":
            mask, offs = rec["mask"], [0]
        else:
            found = rec["found"]
            mask, offs = found.view(-1, *[1] * (idx.dim() - 1)).expand_as(idx), offsets
        mark("slot", slot_dist, key[mask & (key < G ** 3)])
        for off in offs:
            mark("ext", rec["ext"], torch.clamp(idx[mask] + off, max=rec["ext"].numel() - 1))
        return idx, sd

    def rec_refine(cfg, slot_dist, ext, n_bucket, origins, dirs, found, *rest, **kw):
        rec.update(mode="refine", found=found)
        out = refine(cfg, slot_dist, ext, n_bucket, origins, dirs, found, *rest, **kw)
        sectors = sum(int(seen.sum()) for seen in rec["seen"].values())
        rec["seen"] = {}
        per_level.append(sectors * SECTOR_BYTES + 4 * rec["writes"])
        rec["mode"] = None
        return out

    raycast._at, raycast._sample_ids = rec_at, rec_sample_ids
    raycast._march, raycast._refine = rec_march, rec_refine
    try:
        with raycast._plain_path():
            call()
    finally:
        raycast._at, raycast._sample_ids = at, sample_ids
        raycast._march, raycast._refine = march, refine
    return per_level


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
    capture of `room` on the card.  Returns (K5's launches on the fragment
    integrations, {check: passed} of the run, {check: passed} of its
    accuracy against the scene's ground truth, the session, the
    reconstruction config)."""
    session = work / f"shipped_{room.replace(' ', '_')}"
    t0 = time.perf_counter()
    write_synthetic_project(session, scene, workers=8)
    log(f"[phase 7] {room}: synthetic capture of 2 sides x {scene.n_frames} frames, depth "
        f"{scene.depth_width}x{scene.depth_height}, colour "
        f"{scene.color_width}x{scene.color_height}, {len(scene.clutter)} clutter boxes "
        f"({time.perf_counter() - t0:.1f} s); config {SHIPPED_CONFIG.name} as shipped")
    configs = PipelineConfigs.parse_config_yml(SHIPPED_CONFIG)
    rc = configs.reconstruction

    # K5's launches and pairs of the fragment integrations, apart from
    # step 3's: counted around that call of the run.
    frag = {}
    integrate_fragments = refine.integrate_and_save_fragment_point_clouds

    def counted(*args, **kwargs):
        k5, pairs = _build.launch_counts()["tsdf_window"], window_pair_count()
        result = integrate_fragments(*args, **kwargs)
        frag["k5"] = _build.launch_counts()["tsdf_window"] - k5
        frag["pairs"] = window_pair_count() - pairs
        return result

    refine.integrate_and_save_fragment_point_clouds = counted
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    os.environ["MQ3D_SUBSTEP_TIMING"] = "1"
    _build.reset_launch_counts()
    reset_window_pair_count()
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

    log(f"[phase 7] stage seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in run.stage_seconds.items())
        + f"; total {total:.2f} s; peak device memory {peak_gb:.2f} GB")
    log("[phase 7] substep seconds (summed over repeats): "
        + ", ".join(f"{k} {v:.3f}" for k, v in substeps_of(printed).items()))
    log(f"[phase 7] launches {launches}; K5 on the fragment integrations {frag['k5']} "
        f"(pairs {frag['pairs']}), on step 3 {launches['tsdf_window'] - frag['k5']}")
    run_checks, accuracy = check_shipped_run("phase 7", session, scene, printed, rc, room)
    run_checks["K5 launched on the fragment integrations"] = frag["k5"] > 0
    run_checks["K5 launched on step 3"] = launches["tsdf_window"] > frag["k5"]
    log(f"[phase 7] {room}: run checks {run_checks}; accuracy checks {accuracy}")
    return frag["k5"], run_checks, accuracy, session, rc


def substeps_of(printed: str) -> dict:
    """{substep: seconds summed over its repeats} of a run's [Substep] lines."""
    substeps: dict = {}
    for name, secs in re.findall(r"\[Substep\] (\S+): (\S+)s", printed):
        substeps[name] = substeps.get(name, 0.0) + float(secs)
    return substeps


def check_shipped_run(phase: str, session: Path, scene: SyntheticSceneConfig, printed: str,
                      rc, room: str):
    """The outputs of a run of the shipped configuration (phase 7's
    furnished room, phase 13's run_prod_e2e box room), read from its
    session and its printed output: edge counts and the pair ICP's last
    fitness and rmse, confidence maps and packs, optimized poses against
    the scene's ground truth, the colorless cloud on the walls, the
    colored outputs.  Returns ({check: passed} of the run, {check:
    passed} of its accuracy)."""
    frag_graphs = [tuple(map(int, m)) for m in re.findall(
        r"Fragment pose graph: (\d+) odometry edges, (\d+) loop candidates, (\d+) loops kept",
        printed)]
    prefilter = re.findall(r"Pre-filter kept (\d+) / (\d+) uncertain pairs", printed)
    scene_graph = _SCENE_RE.findall(printed)
    pairs = _PAIR_RE.findall(printed)
    log(f"[{phase}] fragments {len(frag_graphs)}: odometry edges "
        f"{sum(g[0] for g in frag_graphs)}, loop candidates {sum(g[1] for g in frag_graphs)}, "
        f"loops kept {sum(g[2] for g in frag_graphs)}; pre-filter kept {prefilter}; scene "
        f"graph (nodes, edges, pruned) {scene_graph}")
    log(f"[{phase}] pair ICP at the last level: " + "; ".join(
        f"({s}, {t}) fitness {f} rmse {r}{' dropped' if d else ''}" for s, t, f, r, d in pairs))

    gt_cw = orbit_poses_o3d(scene).extrinsics_cw
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
        cw = opt.transforms.extrinsics_cw
        dpos = np.linalg.norm(cw[:, :3, 3] - gt_cw[:, :3, 3], axis=-1)
        cos = (np.einsum("nij,nij->n", cw[:, :3, :3], gt_cw[:, :3, :3]) - 1) / 2
        pose_err.append((float(dpos.max()), float(np.degrees(np.arccos(np.clip(cos, -1, 1))).max()),
                         len(opt) == len(gt_cw)))
    pcd = read_ply(session / "reconstruction/colorless.ply")
    dist = wall_distance(pcd.points, scene)
    vs = rc.depth_integration.voxel_size
    log(f"[{phase}] {room}: confidence maps and packs complete {conf_ok}; mean confidence "
        f"where valid_count >= 2 {conf_means}; optimized poses vs ground truth (max position "
        f"error m, max angle deg, all frames) {pose_err}; colorless points {len(pcd.points)}, "
        f"wall distance median {np.median(dist):.5f} m p99 {np.quantile(dist, 0.99):.5f} m")
    colored, _ = check_colored_outputs(phase, session, scene, printed, vs,
                                       sampled=rc.sample_point_cloud_from_colored_mesh)
    per_side = -(-scene.n_frames // rc.fragment_generation.fragment_size)
    run_checks = {
        "steps 1 and 2 on": rc.estimate_depth_confidences and rc.optimize_depth_pose,
        "a confidence map for every frame, the pack complete and loading": all(conf_ok.values()),
        "mean confidence > 0.95 where valid_count >= 2": min(conf_means) > 0.95,
        f"{per_side} fragments per side": len(frag_graphs) == 2 * per_side,
        "colored outputs written": all(v for k, v in colored.items()
                                       if "exist" in k or "one depth map" in k),
    }
    accuracy = dict(colored, **{
        "optimized poses within 2 cm and 1 deg of the ground truth": all(
            p < 0.02 and a < 1.0 and n for p, a, n in pose_err),
        "colorless points on the walls (p99 < 2 voxels)":
            float(np.quantile(dist, 0.99)) < 2 * vs,
    })
    return run_checks, accuracy


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
        f"in it: {sorted(k for k in kernels if 'i420' in k or 'tsdf_window' in k)}")
    checks = dict({f"{k} equal": v for k, v in same.items()}, **{
        "K2 launched by convert_yuv_to_rgb": launches["convert_yuv_to_rgb"]["i420_to_bgr"] > 0,
        "K5 launched by reconstruct_scene": launches["reconstruct_scene"]["tsdf_window"] > 0,
        "trace names the stages": all(n in names for n in (
            "convert_yuv_to_rgb", "convert_depth_to_linear", "reconstruct_scene",
            "export_fbx")),
        "trace holds CUDA kernel events": n_kernel_events > 0,
        "K5 and K2 in the trace": any("tsdf_window" in k for k in kernels)
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
    reference volume's active rows and K5's launches."""
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
    same, k5 = {}, {}
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
            k5[mode] = _build.launch_counts()["tsdf_window"]
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
        f"{same}; K5 launches {k5}; seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()) + f" ({smi})")
    failed = [f"{m}: {k}" for m, d in same.items() for k, ok in d.items() if not ok]
    if failed or min(k5.values()) == 0:
        raise AssertionError(f"sharded world of 1 differs or launched no K5: {failed}, {k5}")
    arrays = {"slot_table": a.slot_table.cpu().numpy(),
              "block_coords": a.block_coords[:n].cpu().numpy(),
              "tsdf": a.tsdf[:n].cpu().numpy(), "weight": a.weight[:n].cpu().numpy()}
    return frames, cfg, chunk, arrays, k5


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
    the unsharded port.  Returns K5's launches per rank."""
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
    k5 = [r["modes"]["replicated"]["launches"]["tsdf_window"] for r in integ]
    checks = {
        "same slot table and counters on both ranks": len(
            {(r["digest_tables"], r["n_active"], r["overflow"], r["dropped_active"])
             for r in integ}) == 1,
        "partitioned == replicated on both ranks": all(
            r["partitioned_equal"] and r["pad_rows_zero"] for r in integ),
        "K5 launched on each rank": min(k5) > 0,
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
        + f", K5 launches per rank {k5}, tsdf max |diff| to single process {tsdf_err:.3g}")
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
    return k5


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
        "K5 and K2 launched in the sessions": all(
            v["tsdf_window"] > 0 and v["i420_to_bgr"] > 0 for v in launches.values()),
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
    k5_ranks = sharded_two_ranks(world1, views, furnished, rc, gn_path, smi)
    log(f"[phase 9] part 2 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    batch = batch_two_hosts(work, smi)
    log(f"[phase 9] part 3 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun_multichip(2, device="cuda", backend="gloo", timeout_s=600)
    log(f"[phase 9] dryrun_multichip(2, cuda, gloo), tiny and production shapes, done in "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    return {"tsdf_window": {"nccl_world_of_1": world1[4]["replicated"],
                            "gloo_ranks": k5_ranks,
                            "batch_sessions": sum(v["tsdf_window"] for v in batch.values())},
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
    # The plain batch takes 7-8 s a call: the one call whose bytes are
    # compared is also its time (pure Python and zlib: no warm-up to take).
    t0 = time.perf_counter()
    write_png_batch_plain(plain_paths, bgrs)
    png_plain_ms = (time.perf_counter() - t0) * 1e3
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
    png_pool_ms = host_ms(lambda: pool_write_png_batch(plain_paths, bgrs), reps=3)
    log(f"[phase 10] write_png_batch of {len(rgb)} {bgrs.shape[2]}x{bgrs.shape[1]} BGR frames "
        f"({bgrs.nbytes / 1e6:.1f} MB): pixels equal (every {step}th decoded), bytes equal to "
        f"encode_png's {bytes_equal} (zlib {info['zlib_runtime']} and Python's "
        f"{info['zlib_python']}) and to step 0's files {step0_equal}; {png_ms:.1f} ms native on "
        f"{info['threads']} threads, {png_plain_ms:.1f} ms plain (encode_png, one thread; one "
        f"call), {png_pool_ms:.1f} ms encode_png on step 0's earlier pool of "
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


# ---------------------------------------------------------------------------
# Phase 11: the uint16 depth stream at bench.py's workload, the single-frame
# YUV API and the study analysis at the reference's size
# ---------------------------------------------------------------------------

def _tsdf_diff(a, b, cfg) -> dict:
    """a's volume against b's: max and mean |a.tsdf - b.tsdf| over the
    voxels both observed (weight > 0 in both), the voxels whose weights
    differ, and a's blocks that b lacks."""
    n = a.n_active
    slots = b.slot_table[tsdf_ops._block_keys(a.block_coords[:n], cfg.grid_dim)].long()
    has = slots >= 0
    ia, ib = torch.nonzero(has).squeeze(1), slots[has]
    both = (a.weight[ia] > 0) & (b.weight[ib] > 0)
    diff = (a.tsdf[ia] - b.tsdf[ib]).abs()[both]
    return {"max": float(diff.max()) if diff.numel() else 0.0,
            "mean": float(diff.mean()) if diff.numel() else 0.0,
            "weights differ": int((a.weight[ia] != b.weight[ib]).sum()),
            "voxels compared": int(diff.numel()),
            "blocks absent": int((~has).sum())}


def _group_bytes(depth_itemsize: int, extra: int = 0) -> int:
    """Bytes to the card per scan-fused launch of the bench: the group's
    depth, K, T_wc and valid, each chunk's T_cw (integrate_chunk works it
    out on the host from T_wc), and `extra` (the uint16 scale)."""
    per = bench.SCAN * bench.CHUNK
    return per * (bench.H * bench.W * depth_itemsize + 9 * 4 + 16 * 4 + 1 + 16 * 4) + extra


def u16_stream(smi: str) -> dict:
    """Phase 11 (a): bench.py's workload, its first BENCH_FRAMES frames
    (cut from 1000 for the smoke's time), through the bench's
    parts (mq3d_tpu_torch.bench): bench_integrate_fused_u16 on the
    quantized stack, then bench_integrate_fused on the same stack
    dequantized on the host; TSDFVolume.integrate_scan on the first 200
    frames against 10 integrate(auto_split=False) calls; the u16 volume
    against bench_integrate_fused's on the unquantized depth."""
    t0 = time.perf_counter()
    depth, K, T_wc, valid = bench.make_capture(BENCH_FRAMES)[:4]
    cfg = bench.bench_config()
    dq, scale = tsdf_ops.quantize_depth_u16(depth, cfg.depth_max)
    dep_f = dq.astype(np.float32) * np.float32(1.0 / np.float32(scale))
    per = bench.SCAN * bench.CHUNK
    log(f"[phase 11] bench.py's capture (bench.make_capture): {len(depth)} frames of "
        f"{depth.shape[2]}x{depth.shape[1]} ({bench.UNIQUE} unique renders), groups of "
        f"{bench.SCAN} chunks of {bench.CHUNK} frames; bench.bench_config() (voxel "
        f"{cfg.voxel_size} m, {cfg.block_count} blocks, chunk_active_capacity "
        f"{cfg.chunk_active_capacity}); scale {scale!r} ({time.perf_counter() - t0:.1f} s)")

    # Run 1: the uint16 stream, dequantized on the card; run 2: the
    # host-dequantized float32 stack.  Each part leaves its first group
    # untimed and synchronizes at both ends of the clock.
    _build.reset_launch_counts()
    (u16_fps,), state = bench.bench_integrate_fused_u16(cfg, depth, K, T_wc, valid, "cuda", 1)
    u16_k5 = _build.launch_counts()["tsdf_window"]
    _build.reset_launch_counts()
    (f32_fps,), f32_state = bench.bench_integrate_fused(cfg, dep_f, K, T_wc, valid, "cuda", 1)
    f32_k5 = _build.launch_counts()["tsdf_window"]
    same = _same_volume(state, f32_state)
    del f32_state

    # The first 200 frames: integrate_scan == 10 integrate(auto_split=False).
    scan = TSDFVolume(cfg, device="cuda")
    for s0 in range(0, 200, per):
        scan.integrate_scan(*[bench._group(a, s0) for a in (dep_f, K, T_wc, valid)])
    chunked = TSDFVolume(cfg, device="cuda")
    for c in range(0, 200, bench.CHUNK):
        sl = slice(c, c + bench.CHUNK)
        chunked.integrate(dep_f[sl], K[sl], T_wc[sl], valid[sl], auto_split=False)
    first_same = all(_same_volume(chunked.state, scan.state).values())
    del chunked, scan

    # The u16 volume against one built on the unquantized depth.
    (exact_fps,), exact = bench.bench_integrate_fused(cfg, depth, K, T_wc, valid, "cuda", 1)
    diff = _tsdf_diff(state, exact, cfg)
    log(f"[phase 11] uint16 stream (bench_integrate_fused_u16): {u16_fps:.1f} frames/s "
        f"({len(depth) - per} frames after a warm-up group), {_group_bytes(2, 4)} bytes to "
        f"the card per launch, K5 launches {u16_k5}; bench_integrate_fused on the dequantized "
        f"float32 stack: {f32_fps:.1f} frames/s, {_group_bytes(4)} bytes per launch, K5 "
        f"launches {f32_k5}; on the unquantized depth {exact_fps:.1f} frames/s; {smi}")
    log(f"[phase 11] n_active {state.n_active}, overflow {state.overflow}, dropped_active "
        f"{state.dropped_active} (no auto-split); u16 == dequantized float32: {same}; first "
        f"200 frames, integrate_scan == 10 integrate(auto_split=False): {first_same}; "
        f"against the unquantized depth ({exact.n_active} blocks): {diff}")
    checks = {"u16 == dequantized float32": all(same.values()),
              "K5 launched on the u16 run": u16_k5 > 0,
              "K5 launched on the float32 run": f32_k5 > 0,
              "integrate_scan == per-chunk integrate": first_same,
              "n_active > 0": state.n_active > 0}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"uint16 stream checks failed: {failed}")
    return {"u16": u16_k5, "f32": f32_k5}


def single_frame_yuv(work: Path) -> int:
    """Phase 11 (a), last part: on a 4-frame capture of the furnished
    room at Quest scale, convert_yuv420_888_to_bgr on one 1280x960 frame
    equals that frame's row of convert_yuv_batch; K2 launched once."""
    sample = work / "yuv_sample"
    write_synthetic_project(sample, quest_scene(4, ROOM_CLUTTER), workers=4)
    color = DataIO(sample).color
    fmt = color.load_image_format_info(Side.LEFT)
    raws = [color.load_yuv(Side.LEFT, ts) for ts in color.get_yuv_timestamps(Side.LEFT)]
    batch = convert_yuv_batch(raws, fmt, device="cuda")
    row = len(raws) // 2
    _build.reset_launch_counts()
    one = convert_yuv420_888_to_bgr(raws[row], fmt, device="cuda")
    k2 = _build.launch_counts()["i420_to_bgr"]
    equal = one.shape == (fmt.height, fmt.width, 3) and np.array_equal(one, batch[row])
    log(f"[phase 11] convert_yuv420_888_to_bgr on frame {row} of {len(raws)} "
        f"({fmt.width}x{fmt.height}) of the furnished room: equal to convert_yuv_batch's row "
        f"{equal}; K2 launches {k2}")
    if not (equal and k2 == 1):
        raise AssertionError(f"single-frame YUV: equal {equal}, K2 launches {k2}")
    return k2


STUDY_PAIRS, STUDY_ROWS, STUDY_DT_MS = 10, 16_200, 11.1  # 180 s at 90 Hz


def _write_study_session(d: Path, rng, sweep: float, reach: float) -> None:
    """hmd_poses.csv (STUDY_ROWS rows) and controller_poses.csv (two hands)
    in tests/test_analysis_tree.py's pose-CSV schema: a head turning
    through `sweep` radians on a small circle, hands swinging by `reach`."""
    d.mkdir(parents=True)
    n = STUDY_ROWS
    t = np.arange(n) * STUDY_DT_MS + 1.7e12
    ang = np.linspace(0, sweep, n)
    pos = np.stack([np.cos(ang), np.full(n, 1.6), np.sin(ang)], -1)
    pos += rng.normal(0, 0.002, (n, 3))
    quat_ = np.stack([np.zeros(n), np.sin(ang / 2), np.zeros(n), np.cos(ang / 2)], -1)
    head = "unix_time,pos_x,pos_y,pos_z,rot_x,rot_y,rot_z,rot_w"
    rows = np.concatenate([t[:, None], pos, quat_], 1)
    np.savetxt(d / "hmd_poses.csv", rows, fmt="%.17g", delimiter=",", header=head,
               comments="")
    swing = reach * np.sin(np.linspace(0, 40 * np.pi, n))
    with open(d / "controller_poses.csv", "w") as f:
        f.write(head.replace("unix_time,", "unix_time,hand,") + "\n")
        for hand, off in (("left", -0.3), ("right", 0.3)):
            p = pos + np.stack([np.full(n, off), swing, np.zeros(n)], -1)
            p += rng.normal(0, 0.002, (n, 3))
            f.writelines(f"{r[0]!r},{hand},{r[1]!r},{r[2]!r},{r[3]!r},{r[4]!r},{r[5]!r},"
                         f"{r[6]!r},{r[7]!r}\n"
                         for r in np.concatenate([t[:, None], p, quat_], 1).tolist())


def _write_quality_scores(path: Path, rng) -> None:
    """A seeded 10-pair quality_scores.csv in eval/quality.write_scores_csv's
    columns, the fog meshes scoring higher."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=QUALITY_CSV_FIELDS)
        w.writeheader()
        for i in range(STUDY_PAIRS):
            for cond, boost in (("fog", 1.2), ("nofog", 1.0)):
                row = {k: float(rng.uniform(0.3, 0.9)) for k in QUALITY_CSV_FIELDS}
                row.update(name=f"P{i:02d}_20260101_{100000 + i:06d}__20260101_"
                                f"{110000 + i:06d}_{cond}", path=f"/meshes/{i}_{cond}.ply",
                           Q_raw=float(rng.uniform(0.4, 0.7) * boost),
                           Q_norm=float(rng.uniform(0.2, 0.8) * boost),
                           num_vertices=int(rng.integers(100_000, 1_000_000)),
                           num_triangles=int(rng.integers(200_000, 2_000_000)),
                           component_count=int(rng.integers(1, 30)),
                           degenerate_triangles=int(rng.integers(0, 50)))
                w.writerow(row)


def _write_survey(path: Path, rng) -> None:
    """A seeded survey of 10 in tests/test_analysis_tree.py's schema."""
    n = STUDY_PAIRS
    cols = {"Participant": [f"P{i}" for i in range(n)],
            "Age": rng.integers(20, 40, n).tolist(),
            "Gender": rng.choice(["F", "M", "NB"], n).tolist(),
            "Nationality": rng.choice(["DE", "FR", "IT"], n).tolist(),
            "Education - Highest Obtained": rng.choice(["BSc", "MSc", "PhD"], n).tolist(),
            "Education - Currently Pursued": rng.choice(["MSc", "PhD", "None"], n).tolist(),
            "Experience using VR Tools (yrs)": rng.uniform(0, 10, n).tolist(),
            "Experience with Video Games (yrs)": rng.uniform(0, 20, n).tolist(),
            "Laterality": rng.choice(["Right", "Left"], n).tolist(),
            "Glass-wearer": rng.choice(["Yes", "No"], n).tolist(),
            "Wore glasses during experiment": rng.choice(["Yes", "No"], n).tolist(),
            "SUS_Score_sphere": rng.uniform(60, 95, n).tolist()}
    for base in ("FSS_FlowTotal", "TLX_1", "TLX_2", "TLX_4", "TLX_6"):
        cols[f"{base}_sphere"] = rng.uniform(2, 6, n).tolist()
        cols[f"{base}_nosphere"] = rng.uniform(2, 6, n).tolist()
    for i in (11, 12, 13, 14):
        cols[f"IPQ_{i}_sphere"] = rng.integers(1, 8, n).tolist()
        cols[f"IPQ_{i}_nosphere"] = rng.integers(1, 8, n).tolist()
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        w.writerows(zip(*cols.values()))


def _paired_t_checked(df, metrics, results) -> int:
    """Every paired t-test row of `results` against scipy's ttest_rel on
    the paired columns (one-tailed rows: halved toward fog > nofog), equal
    exactly; returns the rows checked."""
    from scipy import stats as sps

    checked = 0
    by_name = {m.display: m for m in metrics}
    for _, r in results.iterrows():
        if "t-test" not in r["test"] or "Paired" not in r["test"]:
            continue
        m = by_name[r["metric"]]
        fog, nofog, _ = study_stats.paired_values(df, m.col)
        t, p = sps.ttest_rel(fog, nofog)
        if m.one_tailed:
            p = p / 2 if t > 0 else 1 - p / 2
        if (r["statistic"], r["p_value"]) != (float(t), float(p)):
            raise AssertionError(f"{m.col}: engine t={r['statistic']!r} p={r['p_value']!r}, "
                                 f"scipy t={float(t)!r} p={float(p)!r}")
        checked += 1
    return checked


def study(work: Path) -> None:
    """Phase 11 (b): the study at the reference's size: 10 participants x
    {Fog, NoFog}, 180 s of poses each, through the motion-stats CLIs, the
    engine, the report writers and the survey CLI; the figure CLIs where
    matplotlib and seaborn import."""
    if importlib.util.find_spec("pandas") is None:
        log("[phase 11] no pandas here: the study runs only in the CPU tests "
            "(tests/test_torch_study*.py)")
        return
    import pandas as pd
    import scipy

    root = work / "study11"
    rng = np.random.default_rng(SEED)
    secs = {}
    t0 = time.perf_counter()
    sessions, participants = [], []
    for i in range(STUDY_PAIRS):
        pace, reach = rng.uniform(0.8, 1.2), rng.uniform(0.05, 0.3)
        for cond, turns in (("Fog", 3 * np.pi), ("NoFog", 2 * np.pi)):
            d = root / cond / f"s{i:02d}"
            _write_study_session(d, rng, turns * pace, reach * rng.uniform(0.9, 1.1))
            sessions.append(str(d))
            participants += ["--participant", f"P{i:02d}"]
    secs["sessions written"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    hmd_csv, ctl_csv = root / "hmd_all_summary.csv", root / "controller_all_summary.csv"
    _printed(compute_hmd_motion_stats.main, sessions + ["--summary-csv", str(hmd_csv)]
             + participants)
    _printed(compute_controller_motion_stats.main,
             sessions + ["--summary-csv", str(ctl_csv)] + participants)
    secs["motion stats"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    hmd = study_stats.infer_condition(pd.read_csv(hmd_csv))
    ctl = study_stats.infer_condition(pd.read_csv(ctl_csv))
    hand, inter = analyze_controller_motion_stats.split_hand_frames(ctl)
    _write_quality_scores(root / "quality_scores.csv", rng)
    quality = analyze_mesh_quality_stats.load_and_pair(root / "quality_scores.csv")
    tables = {}
    checked = 0
    for name, df, metrics in (("hmd", hmd, study_stats.HMD_METRICS),
                              ("hand", hand, study_stats.HAND_METRICS),
                              ("interhand", inter, study_stats.INTER_HAND_METRICS),
                              ("quality", quality, study_stats.QUALITY_METRICS)):
        tables[name] = study_stats.condition_tests(df, metrics)
        checked += _paired_t_checked(df, metrics, tables[name])
    improvements = study_stats.improvement_analysis(hmd, study_stats.HMD_METRICS)
    secs["engine"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = root / "reports"
    study_report.write_statistical_report(tables["hmd"], hmd, improvements,
                                          out / "statistical_report.txt")
    study_report.write_latex_table(tables["hmd"][["metric", "statistic", "p_value"]],
                                   out / "hmd.tex", caption="HMD motion", label="tab:hmd")
    study_report.write_html_dashboard(out / "study.html", "Fog vs NoFog", [
        {"title": name, "table": t, "sig_col": "significant"} for name, t in tables.items()])
    survey_csv = root / "survey.csv"
    _write_survey(survey_csv, rng)
    _printed(analyze_survey_hypotheses.main, ["--input", str(survey_csv), "--output_dir",
                                              str(root / "survey")])
    hypotheses = pd.read_csv(root / "survey" / "survey_hypotheses_results.csv")
    secs["writers and survey"] = time.perf_counter() - t0

    head = tables["hmd"].set_index("metric").loc["Cumulative Head Rotation"]
    log(f"[phase 11] study: {STUDY_PAIRS} participants x 2 conditions, {STUDY_ROWS} HMD and "
        f"{2 * STUDY_ROWS} controller rows per session; {len(hmd)} HMD, {len(hand)} hand, "
        f"{len(inter)} inter-hand and {len(quality)} quality rows; {checked} paired t-tests "
        f"equal to scipy's ttest_rel; head_cumulative_radians {head['test']}, p="
        f"{head['p_value']:.3g}, d={head['cohens_d']:.3f}; {len(hypotheses)} survey "
        f"hypotheses; pandas {pd.__version__}, scipy {scipy.__version__}; seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    checks = {"20 HMD sessions": len(hmd) == 2 * STUDY_PAIRS,
              "paired t-tests checked": checked > 0,
              "fog effect found (head_cumulative_radians, one-tailed p < 0.05)":
                  ("fog > nofog" in head["test"] or "greater" in head["test"])
                  and head["p_value"] < 0.05,
              "report written": (out / "statistical_report.txt").is_file(),
              "six survey hypotheses": len(hypotheses) == 6}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"study checks failed: {failed}")

    if not all(importlib.util.find_spec(m) for m in ("matplotlib", "seaborn")):
        log("[phase 11] no matplotlib or seaborn here: the figures were not drawn (the ten "
            "study CLIs run in full in the CPU tests, tests/test_torch_study_cli*.py)")
        return
    t0 = time.perf_counter()
    figs = root / "figures"
    _printed(analyze_hmd_motion_stats.main, ["--input_csv", str(hmd_csv), "--output_dir",
                                             str(figs / "hmd")])
    argv, sys.argv = sys.argv, ["analyze_hmd_motion_stats_median", "--input_csv",
                                str(hmd_csv), "--output_dir", str(figs / "hmd_median")]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_module("mq3d_tpu_torch.scripts.analyze_hmd_motion_stats_median",
                             run_name="__main__")
    finally:
        sys.argv = argv
    _printed(analyze_controller_motion_stats.main, ["--input_csv", str(ctl_csv),
                                                    "--output_dir", str(figs / "ctl")])
    _printed(analyze_combined_motion_stats.main, [
        "--hmd_csv", str(hmd_csv), "--controller_csv", str(ctl_csv), "--output_dir",
        str(figs / "combined")])
    q = ["--quality-scores", str(root / "quality_scores.csv")]
    _printed(analyze_mesh_quality_stats.main, q + ["--output-dir", str(figs / "quality")])
    _printed(analyze_simple_mesh_metrics.main, q + ["--output-dir", str(figs / "simple")])
    _printed(generate_simple_pairwise_report.main, q + ["--output", str(figs / "pairs.html")])
    _printed(generate_comprehensive_quality_analysis.main,
             q + ["--output", str(figs / "comprehensive.html")])
    _printed(generate_participant_demographics.main, ["--input", str(survey_csv),
                                                      "--output_dir", str(figs / "demo")])
    pngs = sorted(figs.rglob("*.png"))
    log(f"[phase 11] matplotlib and seaborn here: the figure CLIs wrote {len(pngs)} PNGs in "
        f"{time.perf_counter() - t0:.1f} s")
    if len(pngs) < 20:
        raise AssertionError(f"figure CLIs wrote {len(pngs)} PNGs")


# ---------------------------------------------------------------------------
# Phase 12: the bench's entry point and the two CPU reference tools
# ---------------------------------------------------------------------------

# The keys of bench.py's JSON line (bench.py:509-538); the port adds `device`.
BENCH_EXTRA_KEYS = (
    "tsdf_streamed_frames_per_sec", "tsdf_streamed_u16_frames_per_sec",
    "tsdf_streamed_per_chunk_frames_per_sec", "tsdf_staging_mb_per_sec",
    "raycast_ms_per_frame", "raycast_vs_embree_cpu", "raycast_vs_legacy_budget",
    "raycast_stream_ms_per_frame", "raycast_stream_u16_ms_per_frame",
    "sharded_prod_frames_per_sec", "e2e_pipeline_seconds")


def _run_module(argv, timeout: int) -> subprocess.CompletedProcess:
    """python -m <argv> from the repo root; raises with its output on failure."""
    proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"python -m {' '.join(argv)} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return proc


def bench_entry_point() -> None:
    """Phase 12: `python -m mq3d_tpu_torch.bench --reps 1 --frames 200` (the
    bench's capture cut from 1000 frames for the smoke's time) in a subprocess,
    its one JSON line parsed with every key of bench.py's line and every
    number finite; then bench_reference_cpu on 100 frames with --parity
    and bench_reference_raycast on 4 views, each once."""
    t0 = time.perf_counter()
    proc = _run_module(["mq3d_tpu_torch.bench", "--reps", "1", "--frames",
                        str(BENCH_FRAMES)], timeout=900)
    out = proc.stdout.strip().splitlines()
    line = json.loads(out[-1])
    extra = line["extra"]
    numbers = [line["value"], line["vs_baseline"]] + [extra.get(k) for k in BENCH_EXTRA_KEYS]
    for msg in proc.stderr.splitlines():
        if msg.startswith("[bench]"):
            log(f"[phase 12] {msg}")
    log(f"[phase 12] python -m mq3d_tpu_torch.bench --reps 1 --frames {BENCH_FRAMES} "
        f"({time.perf_counter() - t0:.1f} "
        f"s): {out[-1]}")
    checks = {"one line on stdout": len(out) == 1,
              "metric": (line["metric"], line["unit"]) == ("tsdf_frames_per_sec", "frames/s"),
              "bench.py's keys and device": set(extra) == set(BENCH_EXTRA_KEYS) | {"device"},
              "every number finite and positive": all(
                  isinstance(v, (int, float)) and np.isfinite(v) and v > 0 for v in numbers),
              "the card named": extra["device"].get("platform") == "gpu"
                  and extra["device"].get("kind") == torch.cuda.get_device_name(0)}

    t0 = time.perf_counter()
    proc = _run_module(["mq3d_tpu_torch.tools.bench_reference_cpu", "100", "--reps", "1",
                        "--parity"], timeout=600)
    ref_cpu = json.loads(proc.stdout.strip().splitlines()[-1])
    for msg in proc.stdout.strip().splitlines()[:-1]:
        log(f"[phase 12] bench_reference_cpu: {msg}")
    log(f"[phase 12] bench_reference_cpu 100 --reps 1 --parity: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    proc = _run_module(["mq3d_tpu_torch.tools.bench_reference_raycast", "4"], timeout=600)
    ref_rc = json.loads(proc.stdout.strip().splitlines()[-1])
    for msg in proc.stdout.strip().splitlines()[:-1]:
        log(f"[phase 12] bench_reference_raycast: {msg}")
    log(f"[phase 12] bench_reference_raycast 4: {time.perf_counter() - t0:.1f} s")
    checks["reference parity within 2 %"] = ref_cpu["parity"]["rel"] < 0.02
    checks["reference rates positive"] = all(
        v > 0 for v in list(ref_cpu["frames_per_sec"].values())
        + list(ref_rc["ms_per_frame"].values()))
    checks["reference raycast against the analytic depth"] = (
        ref_rc["accuracy"]["coverage"] > 0.9 and ref_rc["accuracy"]["median_mm"] < 5.0)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench entry point checks failed: {failed}")


PROD_E2E_STAGES = ("convert_yuv_to_rgb", "convert_depth_to_linear", "reconstruct_scene")


def _launch_line(text: str, prefix: str) -> dict:
    """The launch counts a tool printed as `<prefix> {...}`."""
    line = next(x for x in text.splitlines() if x.startswith(prefix))
    return json.loads(line[len(prefix):].strip().replace("'", '"'))


def prod_e2e(work: Path, smi: str) -> dict:
    """Phase 13, first part: `python -m mq3d_tpu_torch.tools.run_prod_e2e`
    at its defaults in a fresh process.  Returns its launch counts."""
    proj = work / "prod_e2e"
    t0 = time.perf_counter()
    proc = _run_module(["mq3d_tpu_torch.tools.run_prod_e2e", "--project", str(proj)],
                       timeout=1000)
    secs = time.perf_counter() - t0
    out, err = proc.stdout, proc.stderr
    for msg in out.splitlines():
        if msg.startswith("[prod-e2e]"):
            log(f"[phase 13] {msg}")
    launches = _launch_line(err, "[prod-e2e] kernel launches")
    runtime = (proj / "pipeline_runtime.txt").read_text()
    stages = dict(re.findall(r"^  (\w+): (\S+)$", runtime, re.M))
    substeps = substeps_of(out)
    log(f"[phase 13] run_prod_e2e in {secs:.1f} s (subprocess); stages {stages}; launches "
        f"{launches}")
    log("[phase 13] substep seconds (summed over repeats): "
        + ", ".join(f"{k} {v:.3f}" for k, v in substeps.items()))
    # The bare box room through the shipped config: its bare parallel
    # walls let the fragments slide against each other in the scene ICP
    # (the JAX package's algorithm too), so its run is checked and its
    # accuracy only printed.
    rc = PipelineConfigs.parse_config_yml(SHIPPED_CONFIG).reconstruction
    run_checks, accuracy = check_shipped_run("phase 13", proj, run_prod_e2e.scene_config(),
                                             out, rc, "box room")
    log(f"[phase 13] box room: run checks {run_checks}; accuracy (printed) {accuracy}")
    recon = proj / "reconstruction"
    aligned = [len(list((proj / f"{side}_color_aligned_depth").glob("*.npy")))
               for side in ("left", "right")]
    checks = {
        "rc 0": proc.returncode == 0,
        "colorless.ply, colorless_vbg.npz and color_mesh.ply written": all(
            (recon / a).is_file() and (recon / a).stat().st_size > 0
            for a in ("colorless.ply", "colorless_vbg.npz", "color_mesh.ply")),
        "colour-aligned depth on both sides": min(aligned) > 0,
        "every stage in pipeline_runtime.txt": set(PROD_E2E_STAGES) <= set(stages),
        "[Substep] lines": len(substeps) > 0,
        "K5 launched": launches.get("tsdf_window", 0) > 0,
        "K2 launched": launches.get("i420_to_bgr", 0) > 0,
        "the card's name and power limit printed": smi in err,
        **{f"box room: {k}": v for k, v in run_checks.items()},
    }
    log(f"[phase 13] run_prod_e2e: colour-aligned depth maps {aligned}; checks {checks}")
    shutil.rmtree(proj, ignore_errors=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"run_prod_e2e checks failed: {failed}")
    return launches


def stage_baselines_and_raycast() -> int:
    """Phase 13, second part: bench_reference_stages --parity with cut reps
    and bench_raycast on 4 views, each in a subprocess, with their gates.
    Returns K5's launches of bench_raycast's volume build."""
    t0 = time.perf_counter()
    proc = _run_module(["mq3d_tpu_torch.tools.bench_reference_stages", "--parity",
                        "--conf-reps", "3", "--icp-reps", "1"], timeout=900)
    lines = proc.stdout.strip().splitlines()
    for msg in lines[:-1]:
        log(f"[phase 13] bench_reference_stages: {msg}")
    st = json.loads(lines[-1])
    log(f"[phase 13] bench_reference_stages --parity: {time.perf_counter() - t0:.1f} s")
    conf, icp_res = st["confidence"], st["icp"]
    t0 = time.perf_counter()
    proc = _run_module(["mq3d_tpu_torch.tools.bench_raycast", "4"], timeout=600)
    lines = proc.stdout.strip().splitlines()
    for msg in lines[:-1]:
        log(f"[phase 13] bench_raycast: {msg}")
    rc = json.loads(lines[-1])
    log(f"[phase 13] bench_raycast 4: {time.perf_counter() - t0:.1f} s; launches "
        f"{rc['launches']}")
    checks = {
        "confidence valid counts equal on >= 99.9 %": conf["parity"]["valid_count_match"] >= 0.999,
        "confidence p99 |dconf| <= 0.01": conf["parity"]["conf_abs_diff_p99"] <= 0.01,
        "C++ ICP residual rotation < 0.01 deg": icp_res["residual_rotation_deg"] < 0.01,
        "port ICP residual rotation < 0.01 deg": icp_res["port"]["residual_rotation_deg"] < 0.01,
        "the port's stages on the card": conf["port_device"].startswith("cuda")
            and icp_res["port"]["device"].startswith("cuda"),
        "raycast median error < 2.5 mm": rc["accuracy"]["median_mm"] < 2.5,
        "K5 launched building the raycast's volume": rc["launches"]["tsdf_window"] > 0,
    }
    log(f"[phase 13] stage baselines and raycast checks {checks}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"stage baseline / raycast checks failed: {failed}")
    return rc["launches"]["tsdf_window"]


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = bench.nvidia_smi()
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
    kernels = [check_k1(rng), check_k2(rng), check_k3(), check_k4(rng)]
    check_gray()
    kernels[2]["launches"] = probe_path()
    log(f"[phase 2] done in {time.perf_counter() - t0:.1f} s")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        scene = quest_scene(n_frames=60)
        t0 = time.perf_counter()
        session, configs, vol, launches, k5, k1_launches = main_path(work, scene)
        log(f"[phase 3] done in {time.perf_counter() - t0:.1f} s")
        kernels[0]["launches"] = launches["patch_lookup"]
        kernels[0]["launches_reference_tile_path"] = k1_launches  # on K5's first window
        kernels[1]["launches"] = launches["i420_to_bgr"]
        kernels[3]["launches"] = launches["fma"]
        kernels.append(k5)

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
        views, k6 = colored_path(session, scene, gn_path)
        kernels.append(k6)
        log(f"[phase 6] done in {time.perf_counter() - t0:.1f} s")
        capture = session

        t0 = time.perf_counter()
        # The furnished room, checked in full.  The bare box room's run of
        # the shipped config is phase 13's run_prod_e2e.
        furnished = quest_scene(200, ROOM_CLUTTER)
        k5_frag, furnished_run, accuracy, session, rc = shipped_config_path(
            work, furnished, "furnished room")
        failed = [f"furnished room: {k}"
                  for k, ok in dict(furnished_run, **accuracy).items() if not ok]
        if failed:
            raise AssertionError(f"shipped config checks failed: {failed}")
        kernels[4]["launches_fragment_path"] = k5_frag
        time_pose_programs(session, rc)
        log(f"[phase 7] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        exports_and_evaluation(work, session, furnished, rc)
        step_clis(work)
        log(f"[phase 8] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        phase9 = multi_rank_paths(work, capture, configs, views, session, rc, gn_path, smi)
        for k in (kernels[1], kernels[4]):
            k["launches_phase9"] = phase9[k["name"]]
        log(f"[phase 9] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        native_runtime_and_tools(work, session)
        log(f"[phase 10] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        phase11 = u16_stream(smi)
        kernels[4]["launches_phase11"] = phase11
        kernels[1]["launches_phase11"] = single_frame_yuv(work)
        study(work)
        log(f"[phase 11] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        bench_entry_point()
        log(f"[phase 12] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        launches = prod_e2e(work, smi)
        kernels[4]["launches_phase13"] = {"run_prod_e2e": launches["tsdf_window"],
                                          "bench_raycast": stage_baselines_and_raycast()}
        kernels[1]["launches_phase13"] = {"run_prod_e2e": launches["i420_to_bgr"]}
        log(f"[phase 13] done in {time.perf_counter() - t0:.1f} s")
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
