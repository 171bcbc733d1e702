"""CLI: full pipeline for one capture session, with runtime accounting.

    python -m mq3d_tpu_torch.scripts.run_full_pipeline \
        --session_dir <capture dir> --config <pipeline yml> [--device cpu]

Counterpart of scripts/run_full_pipeline.py of the JAX build: YUV->RGB,
depth->linear and scene reconstruction (steps 0-6 as the config switches
them; the default config/pipeline_config.yml turns every one on) in one
process on the card (or the CPU with --device cpu), then a
pipeline_runtime.txt summary in the session directory.

--export-fbx also writes reconstruction/color_mesh.fbx (stage export_fbx).
--profile DIR wraps the run in torch.profiler (CPU activity, and CUDA on
the card) and writes DIR/pipeline_trace.json, a Chrome trace in which the
ranges of utils/log.py's `span` appear by name: the stages, the substeps,
step 1's phases and each `fma` (README.md lists them).

pipeline_runtime.txt also counts the hand-written kernels' launches of the
run (kernel_launches: patch_lookup=... i420_to_bgr=... gather=... fma=...
tsdf_window=...).
"""

from __future__ import annotations

import argparse
import contextlib
import re
import time
from pathlib import Path
from typing import Optional

from mq3d_tpu_torch.scripts._cli import DEFAULT_CONFIG, add_device

SESSION_RE = re.compile(r"^\d{8}_\d{6}$")
TRACE_NAME = "pipeline_trace.json"


def find_latest_session(base_dir: Path) -> Path:
    """Newest session dir named YYYYMMDD_HHMMSS."""
    candidates = [
        d for d in base_dir.iterdir() if d.is_dir() and SESSION_RE.match(d.name)
    ]
    if not candidates:
        raise FileNotFoundError(f"No session directories under {base_dir}")
    return max(candidates, key=lambda d: d.stat().st_mtime)


def convert_reconstruction_mesh_to_fbx(project_dir: Path) -> Optional[Path]:
    """reconstruction/color_mesh.ply -> color_mesh.fbx (binary FBX 7.4);
    None when there is no colored mesh."""
    from mq3d_tpu_torch.export.fbx import convert_ply_to_fbx

    mesh_path = Path(project_dir) / "reconstruction/color_mesh.ply"
    if not mesh_path.exists():
        print("[Warning] No colored mesh to convert to FBX.")
        return None
    out = mesh_path.with_suffix(".fbx")
    convert_ply_to_fbx(mesh_path, out)
    print(f"[Info] FBX written to {out}")
    return out


def _profiler(trace_dir: Optional[Path], device: str):
    """torch.profiler over the run when trace_dir is given, else nothing."""
    if trace_dir is None:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def main(argv=None):
    from mq3d_tpu_torch.dataio.data_io import DataIO
    from mq3d_tpu_torch.kernels._build import launch_counts
    from mq3d_tpu_torch.models.side import Side
    from mq3d_tpu_torch.pipeline.processor import run_full_pipeline

    parser = argparse.ArgumentParser(description="Run the full reconstruction pipeline")
    parser.add_argument("--session_dir", type=Path, default=None,
                        help="capture session directory")
    parser.add_argument("--base_dir", type=Path, default=None,
                        help="auto-select the newest session under this directory")
    parser.add_argument("--config", type=Path, default=DEFAULT_CONFIG)
    parser.add_argument("--no-cache", action="store_true",
                        help="force recomputation of all cached artifacts")
    parser.add_argument("--export-fbx", action="store_true",
                        help="also write reconstruction/color_mesh.fbx")
    parser.add_argument("--profile", type=Path, default=None,
                        help=f"write a torch.profiler trace ({TRACE_NAME}) into this directory")
    add_device(parser)
    args = parser.parse_args(argv)

    if args.session_dir is not None:
        session = args.session_dir
    elif args.base_dir is not None:
        session = find_latest_session(args.base_dir)
        print(f"[Info] Auto-selected session: {session}")
    else:
        parser.error("Provide --session_dir or --base_dir")

    from mq3d_tpu_torch.utils.log import StageTimer

    t0 = time.time()
    with _profiler(args.profile, args.device) as prof:
        stages = run_full_pipeline(session, args.config, device=args.device,
                                   force_recompute=args.no_cache).stage_seconds
        if args.export_fbx:
            timer = StageTimer()
            with timer.stage("export_fbx"):
                convert_reconstruction_mesh_to_fbx(session)
            stages.update(timer.records)
    if prof is not None:
        args.profile.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.profile / TRACE_NAME))
        print(f"[Info] Profiler trace written to {args.profile / TRACE_NAME}")
    elapsed = time.time() - t0
    from mq3d_tpu_torch.recon import reconstruct as _recon_mod

    adjusted = max(0.0, elapsed - _recon_mod.LAST_VIEW_SECONDS)
    color_io = DataIO(session).color
    captures = max(max(len(color_io.get_rgb_timestamps(side)) for side in Side), 1)
    summary = (
        f"device: {args.device}\n"
        f"total_runtime_seconds: {elapsed:.1f}\n"
        f"adjusted_runtime_seconds: {adjusted:.1f}\n"
        f"captures: {captures}\n"
        f"seconds_per_capture: {adjusted / captures:.3f}\n"
        "kernel_launches: " + " ".join(f"{k}={v}" for k, v in launch_counts().items()) + "\n"
        "per_stage_seconds:\n"
        + "".join(f"  {name}: {dt:.1f}\n" for name, dt in stages.items())
    )
    (session / "pipeline_runtime.txt").write_text(summary)
    print("\n" + summary)


if __name__ == "__main__":
    main()
