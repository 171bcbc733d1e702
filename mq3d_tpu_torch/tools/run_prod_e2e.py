"""Production-scale end-to-end run with substep accounting.

    python -m mq3d_tpu_torch.tools.run_prod_e2e [--project DIR] [--frames 500] \
        [--keep] [--device cuda]

Counterpart of tools/run_prod_e2e.py: in a fresh process, the shipped
`config/pipeline_config.yml` (every step on) through the port's
`scripts.run_full_pipeline` on a synthetic capture of --frames frames per
side (default 500) at Quest scale (320x288 depth, 640x480 colour, a whole
orbit), with MQ3D_SUBSTEP_TIMING=1 so that every [Substep] line lands in
the log.

The capture is written first (default project: prod_e2e_torch under the
temporary directory) and its seconds are printed apart: the pipeline
starts from a capture on disk, as the reference's does.  --keep reuses a
capture already there.  Then it prints the pipeline's wall clock
(synchronized at both ends) and its pipeline_runtime.txt, and on standard
error the hand-written kernels' launches of the run (K5 tsdf_window, K2
i420_to_bgr) and, on the card, its name and power limit as nvidia-smi
gives them.

There is no fallback: without CUDA the tool raises unless --device cpu is
given, and then its seconds are CPU seconds, not the card's.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.kernels._build import launch_counts, reset_launch_counts
from mq3d_tpu_torch.scripts._cli import DEFAULT_CONFIG
from mq3d_tpu_torch.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.tools._reference import host_threads

FRAMES = 500
DEPTH_W, DEPTH_H = 320, 288
COLOR_W, COLOR_H = 640, 480
SWEEP = 2 * np.pi
CONFIG = DEFAULT_CONFIG  # config/pipeline_config.yml, as shipped
DEFAULT_PROJECT = Path(tempfile.gettempdir()) / "prod_e2e_torch"


def log(msg: str) -> None:
    print(f"[prod-e2e] {msg}", flush=True)


def scene_config(frames: int = FRAMES) -> SyntheticSceneConfig:
    return SyntheticSceneConfig(n_frames=frames, depth_width=DEPTH_W, depth_height=DEPTH_H,
                                color_width=COLOR_W, color_height=COLOR_H, sweep=SWEEP)


def write_capture(project: Path, frames: int = FRAMES) -> float:
    """A fresh capture of `frames` frames per side in `project` (removed
    first); returns the seconds it took."""
    shutil.rmtree(project, ignore_errors=True)
    t0 = time.perf_counter()
    write_synthetic_project(project, scene_config(frames), workers=host_threads())
    return time.perf_counter() - t0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--project", type=Path, default=DEFAULT_PROJECT)
    parser.add_argument("--frames", type=int, default=FRAMES, help="frames per side")
    parser.add_argument("--keep", action="store_true",
                        help="reuse an existing generated capture")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if args.frames < 1:
        parser.error("--frames must be at least 1")
    dev = resolve_device(args.device)  # raises without CUDA
    if dev.type == "cuda":
        from mq3d_tpu_torch.bench import nvidia_smi

        print(f"[prod-e2e] device {torch.cuda.get_device_name(dev)}; nvidia-smi: "
              f"{nvidia_smi()}", file=sys.stderr, flush=True)
    proj = args.project
    capture_s = None
    if not (args.keep and proj.exists()):
        capture_s = write_capture(proj, args.frames)
        log(f"capture generated in {capture_s:.1f} s ({args.frames} frames/side)")

    from mq3d_tpu_torch.scripts import run_full_pipeline as rfp

    os.environ["MQ3D_SUBSTEP_TIMING"] = "1"
    reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    rfp.main(["--session_dir", str(proj), "--config", str(CONFIG), "--device", str(dev)])
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    log(f"pipeline wall-clock: {wall:.1f} s")
    print(f"[prod-e2e] kernel launches {launches}", file=sys.stderr, flush=True)
    rt = proj / "pipeline_runtime.txt"
    if rt.exists():
        print(rt.read_text(), flush=True)
    return {"capture_s": capture_s, "pipeline_s": wall, "launches": launches}


if __name__ == "__main__":
    main()
