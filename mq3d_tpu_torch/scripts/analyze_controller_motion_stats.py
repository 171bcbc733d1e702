"""Statistical analysis of controller/hand motion data: Fog vs NoFog.

Same surface as the reference
(analysis/analysis/analyze_controller_motion_stats.py): splits the motion
CSV into per-hand rows and per-session inter-hand rows, runs the shared
paired-test engine over both registries, and writes per-group artifacts.

Artifacts: statistical_results_hand.csv, statistical_results_interhand.csv,
boxplots_hand_metrics.png, boxplots_interhand_metrics.png,
statistical_report.txt.

The counterpart of scripts/analyze_controller_motion_stats.py of the JAX
build (host pandas and scipy; nothing here runs on the card).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis import plots, report
from mq3d_tpu_torch.analysis.stats import (
    HAND_METRICS,
    INTER_HAND_METRICS,
    condition_tests,
    improvement_analysis,
    infer_condition,
)


def split_hand_frames(df: pd.DataFrame):
    """(hand_df, interhand_df): per-hand rows vs one inter-hand row per
    session (reference analyze_controller_motion_stats.py:91-115)."""
    hand_df = df[df["hand"].notna()].copy() if "hand" in df.columns else df.copy()
    if "avg_inter_hand_distance_m" in df.columns:
        inter = df[df["avg_inter_hand_distance_m"].notna()].copy()
        dedup_keys = [k for k in ("capture_name", "capture_path")
                      if k in inter.columns]
        if dedup_keys:
            inter = inter.drop_duplicates(subset=dedup_keys, keep="first")
    else:
        inter = df.iloc[0:0].copy()
    return hand_df, inter


def main(argv=None):
    import pandas as pd

    ap = argparse.ArgumentParser(
        description="Statistical analysis of controller motion data")
    ap.add_argument("--input_csv", type=Path,
                    default=Path("analysis/data/controller_all_summary.csv"))
    ap.add_argument("--output_dir", type=Path,
                    default=Path("analysis/reports/controller_motion_analysis"))
    ap.add_argument("--exclude-participant", action="append", default=[])
    args = ap.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    df = infer_condition(pd.read_csv(args.input_csv))
    if args.exclude_participant and "participant" in df.columns:
        df = df[~df["participant"].isin(args.exclude_participant)]
    hand_df, inter_df = split_hand_frames(df)
    print(f"[Info] {len(hand_df)} hand rows, {len(inter_df)} inter-hand rows")

    hand_stats = condition_tests(hand_df, HAND_METRICS)
    hand_stats.to_csv(args.output_dir / "statistical_results_hand.csv",
                      index=False)
    plots.box_grid(hand_df, HAND_METRICS,
                   args.output_dir / "boxplots_hand_metrics.png")

    inter_stats = condition_tests(inter_df, INTER_HAND_METRICS)
    inter_stats.to_csv(args.output_dir / "statistical_results_interhand.csv",
                       index=False)
    plots.box_grid(inter_df, INTER_HAND_METRICS,
                   args.output_dir / "boxplots_interhand_metrics.png")

    combined = pd.concat([hand_stats, inter_stats], ignore_index=True)
    report.write_statistical_report(
        combined, df, improvement_analysis(hand_df, HAND_METRICS),
        args.output_dir / "statistical_report.txt",
        title="CONTROLLER MOTION ANALYSIS: FOG vs NOFOG COMPARISON")
    print(f"[Info] Analysis complete: {args.output_dir}")


if __name__ == "__main__":
    main()
