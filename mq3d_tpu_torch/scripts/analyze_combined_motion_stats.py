"""Combined HMD + controller motion analysis: Fog vs NoFog.

Same surface and combined-metric formulas as the reference
(analysis/analysis/analyze_combined_motion_stats.py:65-178): merges the HMD
and per-session-aggregated controller CSVs, derives the seven combined
metrics (combined distance/speeds, activity, motion complexity, engagement,
workspace utilization), and runs the shared paired-test engine.

Artifacts: combined_data.csv, statistical_results.csv,
combined_metrics_boxplots.png, combined_analysis_report.txt.

The counterpart of scripts/analyze_combined_motion_stats.py of the JAX
build (host pandas and scipy; nothing here runs on the card).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis import plots, report
from mq3d_tpu_torch.analysis.stats import (
    condition_tests,
    improvement_analysis,
    infer_condition,
    registry,
)

COMBINED_METRICS = registry({
    "combined_total_distance_m": ("Combined Total Distance", "m"),
    "combined_avg_speed_kmh": ("Combined Average Speed", "km/h"),
    "combined_peak_speed_kmh": ("Combined Peak Speed", "km/h"),
    "activity_score": ("Activity Score", ""),
    "motion_complexity": ("Motion Complexity", ""),
    "engagement_score": ("Engagement Score", ""),
    "workspace_utilization": ("Workspace Utilization", ""),
}, one_tailed=("activity_score", "engagement_score"))

_HAND_AGG = {
    "total_distance_m": "mean",
    "net_displacement_m": "mean",
    "avg_speed_kmh": "mean",
    "peak_speed_kmh": "max",
    "avg_acceleration_ms2": "mean",
    "peak_acceleration_ms2": "max",
    "cumulative_rotation_rad": "mean",
    "avg_angular_speed_rad_s": "mean",
    "peak_angular_speed_rad_s": "max",
    "workspace_volume_m3": "sum",
    "jitter_stddev_m": "mean",
}


def _minmax(s: pd.Series) -> pd.Series:
    return (s - s.min()) / (s.max() - s.min() + 1e-10)


def load_and_merge(hmd_csv: Path, controller_csv: Path) -> pd.DataFrame:
    import pandas as pd

    hmd = infer_condition(pd.read_csv(hmd_csv))
    ctl = infer_condition(pd.read_csv(controller_csv))

    hand = ctl[ctl["hand"].notna()] if "hand" in ctl.columns else ctl
    agg_cols = {k: v for k, v in _HAND_AGG.items() if k in hand.columns}
    keys = [k for k in ("capture_name", "capture_path", "participant",
                        "condition") if k in hand.columns]
    hand_agg = hand.groupby(keys, as_index=False).agg(agg_cols)

    merged = hmd.merge(
        hand_agg,
        on=[k for k in ("capture_name", "capture_path", "participant",
                        "condition") if k in hmd.columns and k in hand_agg],
        how="left", suffixes=("", "_ctl"))

    if "synchronization_score" in ctl.columns:
        inter = ctl[ctl["synchronization_score"].notna()]
        ikeys = [k for k in ("capture_name", "capture_path")
                 if k in inter.columns and k in merged.columns]
        if ikeys:
            merged = merged.merge(
                inter.groupby(ikeys, as_index=False)
                .first()[ikeys + ["synchronization_score"]],
                on=ikeys, how="left")
    return merged


def compute_combined_metrics(df: pd.DataFrame) -> pd.DataFrame:
    import pandas as pd

    df = df.copy()
    df["combined_total_distance_m"] = (
        df["body_distance_m"] + df.get("total_distance_m",
                                       pd.Series(0, index=df.index)).fillna(0))
    df["combined_avg_speed_kmh"] = (
        df["body_avg_speed_kmh"]
        + df.get("avg_speed_kmh", pd.Series(0, index=df.index)).fillna(0)) / 2
    df["combined_peak_speed_kmh"] = df[
        [c for c in ("body_peak_speed_kmh", "peak_speed_kmh")
         if c in df.columns]].max(axis=1)

    hand_dist = df.get("total_distance_m", pd.Series(dtype=float))
    df["activity_score"] = (
        _minmax(df["body_distance_m"])
        + _minmax(hand_dist).reindex(df.index).fillna(0)) / 2
    sync = df.get("synchronization_score",
                  pd.Series(0.5, index=df.index)).fillna(0.5)
    df["motion_complexity"] = (
        _minmax(df["body_avg_speed_kmh"]) * 0.4
        + _minmax(df.get("avg_speed_kmh", pd.Series(dtype=float)))
        .reindex(df.index).fillna(0) * 0.4
        + sync * 0.2)
    df["engagement_score"] = (
        _minmax(df["head_cumulative_radians"]) * 0.5
        + _minmax(df.get("cumulative_rotation_rad", pd.Series(dtype=float)))
        .reindex(df.index).fillna(0) * 0.5)
    df["workspace_utilization"] = (
        _minmax(df["body_net_displacement_m"]) * 0.5
        + _minmax(df.get("workspace_volume_m3", pd.Series(dtype=float)))
        .reindex(df.index).fillna(0) * 0.5)
    return df


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Combined HMD + controller motion analysis")
    ap.add_argument("--hmd_csv", type=Path,
                    default=Path("analysis/data/hmd_all_summary.csv"))
    ap.add_argument("--controller_csv", type=Path,
                    default=Path("analysis/data/controller_all_summary.csv"))
    ap.add_argument("--output_dir", type=Path,
                    default=Path("analysis/reports/combined_motion_analysis"))
    args = ap.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    df = compute_combined_metrics(
        load_and_merge(args.hmd_csv, args.controller_csv))
    df.to_csv(args.output_dir / "combined_data.csv", index=False)
    print(f"[Info] Merged {len(df)} sessions")

    stats_df = condition_tests(df, COMBINED_METRICS)
    stats_df.to_csv(args.output_dir / "statistical_results.csv", index=False)
    plots.box_grid(df, COMBINED_METRICS,
                   args.output_dir / "combined_metrics_boxplots.png")
    report.write_statistical_report(
        stats_df, df, improvement_analysis(df, COMBINED_METRICS),
        args.output_dir / "combined_analysis_report.txt",
        title="COMBINED MOTION ANALYSIS: FOG vs NOFOG COMPARISON")
    print(f"[Info] Analysis complete: {args.output_dir}")


if __name__ == "__main__":
    main()
