"""CLI: trim capture sessions consistently across modalities, in place.

    python -m mq3d_tpu_torch.scripts.trim_recordings SESSION [SESSION ...] \
        [--max-duration-ms N] [--max-frames N] [--dry-run]

Counterpart of scripts/trim_recordings.py of the JAX build (host code;
pandas rewrites the pose and descriptor CSVs inside analysis/sessions.py).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis.sessions import trim_recording


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("sessions", type=Path, nargs="+")
    parser.add_argument("--max-duration-ms", type=int, default=None)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    for session in args.sessions:
        removed = trim_recording(
            session, max_duration_ms=args.max_duration_ms,
            max_frames=args.max_frames, dry_run=args.dry_run,
        )
        tag = "[dry-run] " if args.dry_run else ""
        total = sum(removed.values())
        print(f"{tag}{session}: removed {total} frames "
              + ", ".join(f"{k}:{v}" for k, v in removed.items()))


if __name__ == "__main__":
    main()
