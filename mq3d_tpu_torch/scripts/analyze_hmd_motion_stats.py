"""Statistical analysis of HMD motion data: Fog vs NoFog; the counterpart
of scripts/analyze_hmd_motion_stats.py of the JAX build (host pandas, scipy
and matplotlib; nothing here runs on the card).

Same CLI surface and artifact set as the reference
(reference: analysis/analysis/analyze_hmd_motion_stats.py): paired
statistical tests, box/violin/paired/improvement plots, a full text report,
and optional merge of the per-session HMD metrics into the master
fog/no-fog report CSV.

Usage:
    python -m mq3d_tpu_torch.scripts.analyze_hmd_motion_stats \
        --input_csv analysis/data/hmd_all_summary.csv \
        --output_dir analysis/reports/hmd_motion_analysis_final \
        [--exclude-participant NAME]... [--median] \
        [--merge-to-master --master-report master.csv]

--median switches descriptive aggregation emphasis to medians (covers the
reference's analyze_hmd_motion_stats_median.py variant, which differs from
the mean script only in the headline aggregation of the report tables).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis import plots, report
from mq3d_tpu_torch.analysis.stats import (
    HMD_METRICS,
    condition_tests,
    improvement_analysis,
    improvements_frame,
    infer_condition,
)

# Per-session HMD columns merged into the master report
# (reference analyze_hmd_motion_stats.py:832-839).
MASTER_HMD_COLUMNS = [
    "num_samples", "duration_seconds", "sampling_hz",
    "body_distance_m", "body_net_displacement_m", "body_avg_speed_kmh",
    "body_peak_speed_kmh",
    "head_cumulative_radians", "head_avg_angular_speed_rad_s",
    "head_peak_angular_speed_rad_s",
    "yaw_range_rad", "pitch_range_rad", "roll_range_rad",
    "cumulative_vertical_rotation_rad", "cumulative_horizontal_rotation_rad",
    "viewing_sphere_coverage_percent",
    "viewing_sphere_coverage_with_fov_percent",
]

KEY_METRIC_COLS = [
    "body_distance_m", "body_avg_speed_kmh", "head_cumulative_radians",
    "head_avg_angular_speed_rad_s", "cumulative_vertical_rotation_rad",
    "cumulative_horizontal_rotation_rad",
    "viewing_sphere_coverage_with_fov_percent",
]


def merge_to_master(hmd_csv: Path, master_csv: Path) -> int:
    """Join per-session HMD metrics onto the master fog/no-fog report by
    (session_id, condition)."""
    import pandas as pd

    hmd = pd.read_csv(hmd_csv)
    master = pd.read_csv(master_csv)
    lookup = {
        (str(r["capture_name"]), str(r["condition"]).lower()): r
        for _, r in hmd.iterrows()
    }
    for cond in ("fog", "nofog"):
        for col in MASTER_HMD_COLUMNS:
            master[f"{cond}_hmd_{col}"] = None
    updated = 0
    for idx, row in master.iterrows():
        for cond in ("fog", "nofog"):
            session = row.get(f"{cond}_session_id")
            hit = lookup.get((str(session), cond))
            if hit is not None:
                for col in MASTER_HMD_COLUMNS:
                    if col in hit:
                        master.at[idx, f"{cond}_hmd_{col}"] = hit[col]
                updated += 1
    master.to_csv(master_csv, index=False)
    print(f"[Info] Updated {updated} rows in master report: {master_csv}")
    return updated


def main(argv=None):
    import pandas as pd

    ap = argparse.ArgumentParser(
        description="Statistical analysis of HMD motion data")
    ap.add_argument("--input_csv", type=Path,
                    default=Path("analysis/data/hmd_all_summary.csv"))
    ap.add_argument("--output_dir", type=Path,
                    default=Path("analysis/reports/hmd_motion_analysis"))
    ap.add_argument("--exclude-participant", action="append", default=[])
    ap.add_argument("--median", action="store_true",
                    help="median-emphasis report variant")
    ap.add_argument("--merge-to-master", action="store_true")
    ap.add_argument("--master-report", type=Path,
                    default=Path("analysis/data/master_fog_no_fog_report.csv"))
    args = ap.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    df = infer_condition(pd.read_csv(args.input_csv))
    if args.exclude_participant and "participant" in df.columns:
        before = len(df)
        df = df[~df["participant"].isin(args.exclude_participant)]
        print(f"[Info] Excluded {args.exclude_participant}; "
              f"rows {before} -> {len(df)}")
    print(f"[Info] Loaded {len(df)} sessions")

    stats_df = condition_tests(df, HMD_METRICS)
    stats_df.to_csv(args.output_dir / "statistical_results.csv", index=False)

    plots.box_grid(df, HMD_METRICS, args.output_dir / "boxplots_comparison.png")
    plots.violin_grid(
        df, HMD_METRICS, args.output_dir / "violinplots_comparison.png")
    key = [m for m in HMD_METRICS if m.col in KEY_METRIC_COLS]
    plots.summary_bar_chart(
        stats_df, key, args.output_dir / "summary_bar_chart.png")
    plots.paired_participant_plot(
        df, key, args.output_dir / "paired_participant_plots.png")

    improvements = improvement_analysis(df, HMD_METRICS)
    if improvements:
        improvements_frame(improvements).to_csv(
            args.output_dir / "improvement_analysis.csv", index=False)
        for imp in improvements:
            plots.improvement_plot(imp, args.output_dir)
        plots.improvement_summary_plot(
            improvements, args.output_dir / "improvements_summary.png")

    title = "HMD MOTION ANALYSIS: FOG vs NOFOG COMPARISON"
    if args.median:
        title += " (MEDIAN-BASED)"
    report.write_statistical_report(
        stats_df, df, improvements,
        args.output_dir / "statistical_report.txt", title=title)

    if args.merge_to_master and args.master_report.exists():
        merge_to_master(args.input_csv, args.master_report)

    print(f"[Info] Analysis complete: {args.output_dir}")


if __name__ == "__main__":
    main()
