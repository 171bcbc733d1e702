"""CLI: per-modality frame counts / durations + discrepancy report.

    python -m mq3d_tpu_torch.scripts.analyze_recording_lengths SESSION [SESSION ...]

Counterpart of scripts/analyze_recording_lengths.py of the JAX build (host
code; pandas reads hmd_poses.csv inside analysis/sessions.py).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis.sessions import (
    analyze_duration_discrepancy,
    analyze_recording_lengths,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("sessions", type=Path, nargs="+")
    args = parser.parse_args(argv)

    for session in args.sessions:
        print(f"\n=== {session} ===")
        for m in analyze_recording_lengths(session):
            dur = f"{m.duration_ms} ms" if m.duration_ms is not None else "-"
            print(f"  {m.name:28s} frames={m.n_frames:6d} duration={dur}")
        disc = analyze_duration_discrepancy(session)
        print(f"  max duration discrepancy: {disc['max_discrepancy_ms']:.0f} ms")


if __name__ == "__main__":
    main()
