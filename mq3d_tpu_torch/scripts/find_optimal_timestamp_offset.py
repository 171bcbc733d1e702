"""CLI: scan for the time offset maximizing cross-modality frame overlap.

    python -m mq3d_tpu_torch.scripts.find_optimal_timestamp_offset \
        --project_dir <dir> [--source left_depth] [--target left_camera_rgb] \
        [--range_ms 500] [--step_ms 5] [--tolerance_ms 17]

Counterpart of scripts/find_optimal_timestamp_offset.py of the JAX build
(host numpy, no pandas); prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.analysis.sessions import find_optimal_timestamp_offset


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--project_dir", type=Path, required=True)
    parser.add_argument("--source", default="left_depth")
    parser.add_argument("--target", default="left_camera_rgb")
    parser.add_argument("--range_ms", type=int, default=500)
    parser.add_argument("--step_ms", type=int, default=5)
    parser.add_argument("--tolerance_ms", type=int, default=17)
    args = parser.parse_args(argv)

    result = find_optimal_timestamp_offset(
        args.project_dir, args.source, args.target,
        offsets_ms=np.arange(-args.range_ms, args.range_ms + 1, args.step_ms),
        tolerance_ms=args.tolerance_ms,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
