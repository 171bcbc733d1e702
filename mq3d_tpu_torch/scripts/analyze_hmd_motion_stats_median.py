"""Median-emphasis variant of the HMD motion analysis (reference:
analysis/analysis/analyze_hmd_motion_stats_median.py — identical pipeline
to the mean-based script with median-headline reporting).  Thin alias for
`python -m mq3d_tpu_torch.scripts.analyze_hmd_motion_stats --median`; the
counterpart of scripts/analyze_hmd_motion_stats_median.py of the JAX
build."""

import sys

from mq3d_tpu_torch.scripts.analyze_hmd_motion_stats import main

if __name__ == "__main__":
    main(sys.argv[1:] + ["--median"])
