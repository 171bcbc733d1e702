"""CLI: per-session modality duration discrepancy report.

    python -m mq3d_tpu_torch.scripts.analyze_duration_discrepancy SESSION [SESSION ...]

Counterpart of scripts/analyze_duration_discrepancy.py of the JAX build
(host code; pandas reads hmd_poses.csv inside analysis/sessions.py): the
durations come from the session directories.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis.sessions import (
    analyze_duration_discrepancy,
    analyze_recording_lengths,
)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Analyze duration discrepancies between modalities")
    ap.add_argument("sessions", type=Path, nargs="+")
    args = ap.parse_args(argv)

    for session in args.sessions:
        print("\n" + "=" * 80)
        print(f"Analysis for: {session}")
        print("=" * 80)
        lengths = analyze_recording_lengths(session)
        print("\nIndividual Modality Durations:")
        for m in lengths:
            dur = (f"{m.duration_ms / 1000.0:.2f}s"
                   if m.duration_ms is not None else "N/A")
            print(f"  {m.name:28s} {dur}")
        disc = analyze_duration_discrepancy(session)
        print(f"\nMax duration discrepancy: "
              f"{disc['max_discrepancy_ms'] / 1000.0:.2f}s")
        if disc["max_discrepancy_ms"] > 2000:
            print("  [Warning] modalities differ by more than 2 s — check "
                  "recording synchronization (trim_recordings.py can align "
                  "them)")


if __name__ == "__main__":
    main()
