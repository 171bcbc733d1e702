"""CLI: apply a millisecond offset to frame filenames, in place.

    python -m mq3d_tpu_torch.scripts.rename_timestamps --project_dir <dir> \
        --offset_ms N [--modalities DIR ...] [--dry-run]

Counterpart of scripts/rename_timestamps.py of the JAX build (host code,
no pandas).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis.sessions import rename_timestamps


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--project_dir", type=Path, required=True)
    parser.add_argument("--offset_ms", type=int, required=True)
    parser.add_argument("--modalities", nargs="*", default=None,
                        help="directory names; default: all frame modalities")
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    n = rename_timestamps(
        args.project_dir, args.offset_ms, args.modalities, dry_run=args.dry_run
    )
    print(f"{'[dry-run] ' if args.dry_run else ''}renamed {n} files by "
          f"{args.offset_ms:+d} ms")


if __name__ == "__main__":
    main()
