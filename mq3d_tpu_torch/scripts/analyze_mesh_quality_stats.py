"""Statistical analysis of mesh reconstruction quality: Fog vs NoFog.

Same surface as the reference (analysis/analysis/analyze_mesh_quality_stats.py):
loads quality_scores.csv rows named {participant}_{pair}__{session}_{fog|nofog},
pairs them per participant, and runs the shared paired-test engine over the
quality-score components with a directional hypothesis on Q.

Artifacts: quality_statistical_results.csv, quality_statistical_report.txt,
boxplots_quality.png, violinplots_quality.png, improvements_*.png.

The counterpart of scripts/analyze_mesh_quality_stats.py of the JAX
build (host pandas and scipy; nothing here runs on the card).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis import plots, report
from mq3d_tpu_torch.analysis.stats import (
    QUALITY_METRICS,
    condition_tests,
    improvement_analysis,
    improvements_frame,
)


def extract_pair_id(name: str):
    """{participant}_{nofog}__{fog}_{condition} -> pair id without the
    condition suffix (reference analyze_mesh_quality_stats.py:42-57)."""
    if name.endswith("_fog"):
        return name[:-4]
    if name.endswith("_nofog"):
        return name[:-6]
    return None


def load_and_pair(csv_path: Path) -> pd.DataFrame:
    import pandas as pd

    df = pd.read_csv(csv_path)
    df["participant"] = df["name"].map(extract_pair_id)
    df["condition"] = df["name"].map(
        lambda x: "Fog" if str(x).endswith("_fog")
        else ("NoFog" if str(x).endswith("_nofog") else None))
    return df[df["participant"].notna() & df["condition"].notna()].copy()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Statistical analysis of mesh quality scores")
    ap.add_argument("--quality-scores", type=Path,
                    default=Path("analysis/mesh_quality_batch/quality_scores.csv"))
    ap.add_argument("--output-dir", type=Path,
                    default=Path("analysis/reports/mesh_quality_analysis"))
    args = ap.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    df = load_and_pair(args.quality_scores)
    print(f"[Info] Loaded {len(df)} evaluated meshes "
          f"({df['participant'].nunique()} pairs)")

    stats_df = condition_tests(df, QUALITY_METRICS)
    stats_df.to_csv(args.output_dir / "quality_statistical_results.csv",
                    index=False)

    plots.box_grid(df, QUALITY_METRICS,
                   args.output_dir / "boxplots_quality.png")
    plots.violin_grid(df, QUALITY_METRICS,
                      args.output_dir / "violinplots_quality.png")
    plots.summary_bar_chart(stats_df, QUALITY_METRICS,
                            args.output_dir / "summary_bar_chart.png")

    improvements = improvement_analysis(df, QUALITY_METRICS)
    if improvements:
        improvements_frame(improvements).to_csv(
            args.output_dir / "improvement_analysis.csv", index=False)
        for imp in improvements:
            plots.improvement_plot(imp, args.output_dir)
        plots.improvement_summary_plot(
            improvements, args.output_dir / "improvements_summary.png")

    report.write_statistical_report(
        stats_df, df, improvements,
        args.output_dir / "quality_statistical_report.txt",
        title="MESH QUALITY ANALYSIS: FOG vs NOFOG COMPARISON")
    print(f"[Info] Analysis complete: {args.output_dir}")


if __name__ == "__main__":
    main()
