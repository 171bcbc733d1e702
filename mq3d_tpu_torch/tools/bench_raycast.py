"""Raycast micro-benchmark at the reference's colour-camera resolution.

    python -m mq3d_tpu_torch.tools.bench_raycast [n_frames] [--device cuda]

Counterpart of tools/bench_raycast.py.  It builds the bench's volume (50
frames of the 320x288 box-room orbit integrated at the production
`TSDFConfig()`: voxel 1 cm, 16^3 blocks, 50 000 blocks;
`bench_reference_raycast.build_volume`, K5 on the card) and renders
n_frames (default 4) orbit views at 1280x960 through
`ops/raycast.py::raycast_depth`, the workload of the color-aligned depth
step: one warm call, then the median, min and max ms per frame (each call
ends with the depth map on the host).  Last, the median and p95 error and
the coverage of the last view against the analytic box depth
(`render_box_depth`), and one JSON line.  It prints the hand-written
kernels' launches of the volume's build on standard error.

There is no fallback: without CUDA the tool raises unless --device cpu is
given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.kernels._build import launch_counts, reset_launch_counts
from mq3d_tpu_torch.ops.raycast import raycast_depth
from mq3d_tpu_torch.ops.tsdf import TSDFConfig
from mq3d_tpu_torch.tools.bench_reference_raycast import (
    accuracy,
    analytic_depth,
    build_volume,
    view_intrinsics,
)

W_C, H_C = 1280, 960  # colour (raycast target)


def render_views(vol, gt, cfg_s, n_frames: int, w: int, h: int):
    """One warm render of view 0, then views 0..n_frames-1 of the orbit,
    each timed.  Returns (warm seconds, ms per view, the last view's
    depth)."""
    K = view_intrinsics(cfg_s, w, h)
    poses = gt.extrinsics_cw
    t0 = time.perf_counter()
    raycast_depth(vol, K, np.linalg.inv(poses[0]), w, h)
    warm = time.perf_counter() - t0
    times, d = [], None
    for i in range(n_frames):
        T_wc = np.linalg.inv(poses[i % len(poses)])
        t0 = time.perf_counter()
        d = raycast_depth(vol, K, T_wc, w, h)
        times.append((time.perf_counter() - t0) * 1e3)
    return warm, times, d


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_frames", nargs="?", type=int, default=4)
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if args.n_frames < 1:
        parser.error("n_frames must be at least 1")
    dev = resolve_device(args.device)  # raises without CUDA
    reset_launch_counts()
    t0 = time.perf_counter()
    vol, gt, cfg_s = build_volume(dev, TSDFConfig())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"volume: {vol.n_active} active blocks ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    print(f"[bench-raycast] volume build: kernel launches {launch_counts()}", file=sys.stderr,
          flush=True)
    warm, ms, d = render_views(vol, gt, cfg_s, args.n_frames, W_C, H_C)
    print(f"warmup: {warm:.2f}s; finite {np.isfinite(d).mean() * 100:.1f}%", flush=True)
    med = statistics.median(ms)
    print(f"per-frame: median {med:.1f} ms  min {min(ms):.1f} ms  max {max(ms):.1f} ms   "
          f"({W_C}x{H_C})", flush=True)
    acc = accuracy(d, analytic_depth(gt, cfg_s, args.n_frames - 1, W_C, H_C))
    print(f"accuracy: median {acc['median_mm']:.2f} mm  p95 {acc['p95_mm']:.2f} mm  "
          f"coverage {acc['coverage'] * 100:.1f}%", flush=True)
    line = {"n_frames": args.n_frames, "device": str(dev), "active_blocks": vol.n_active,
            "warm_s": warm, "ms_per_frame": med, "ms": ms, "accuracy": acc,
            "launches": launch_counts()}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
