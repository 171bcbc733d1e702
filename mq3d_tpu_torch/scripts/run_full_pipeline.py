"""CLI: full pipeline for one capture session, with runtime accounting.

    python -m mq3d_tpu_torch.scripts.run_full_pipeline \
        --session_dir <capture dir> --config <pipeline yml> [--device cpu]

Counterpart of scripts/run_full_pipeline.py of the JAX build: YUV->RGB,
depth->linear and scene reconstruction (steps 0 and 3) in one process on
the card (or the CPU with --device cpu), then a pipeline_runtime.txt summary
in the session directory.
"""

from __future__ import annotations

import argparse
import re
import time
from pathlib import Path

SESSION_RE = re.compile(r"^\d{8}_\d{6}$")
_DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "config/pipeline_config.yml"


def find_latest_session(base_dir: Path) -> Path:
    """Newest session dir named YYYYMMDD_HHMMSS."""
    candidates = [
        d for d in base_dir.iterdir() if d.is_dir() and SESSION_RE.match(d.name)
    ]
    if not candidates:
        raise FileNotFoundError(f"No session directories under {base_dir}")
    return max(candidates, key=lambda d: d.stat().st_mtime)


def main(argv=None):
    from mq3d_tpu_torch.dataio.data_io import DataIO
    from mq3d_tpu_torch.models.side import Side
    from mq3d_tpu_torch.pipeline.processor import run_full_pipeline

    parser = argparse.ArgumentParser(description="Run the full reconstruction pipeline")
    parser.add_argument("--session_dir", type=Path, default=None,
                        help="capture session directory")
    parser.add_argument("--base_dir", type=Path, default=None,
                        help="auto-select the newest session under this directory")
    parser.add_argument("--config", type=Path, default=_DEFAULT_CONFIG)
    parser.add_argument("--no-cache", action="store_true",
                        help="force recomputation of all cached artifacts")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    if args.session_dir is not None:
        session = args.session_dir
    elif args.base_dir is not None:
        session = find_latest_session(args.base_dir)
        print(f"[Info] Auto-selected session: {session}")
    else:
        parser.error("Provide --session_dir or --base_dir")

    t0 = time.time()
    stages = run_full_pipeline(session, args.config, device=args.device,
                               force_recompute=args.no_cache).stage_seconds
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
        "per_stage_seconds:\n"
        + "".join(f"  {name}: {dt:.1f}\n" for name, dt in stages.items())
    )
    (session / "pipeline_runtime.txt").write_text(summary)
    print("\n" + summary)


if __name__ == "__main__":
    main()
