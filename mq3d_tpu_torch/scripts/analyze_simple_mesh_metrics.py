"""Simple geometric mesh metric analysis: Fog vs NoFog.

Same surface as the reference
(analysis/analysis/analyze_simple_mesh_metrics.py): loads the quality-scores
CSV (rows named {pair}_{fog|nofog}), pairs per participant, and runs the
shared paired-test engine over the basic geometric metrics (vertex/triangle
counts, components, boundary-edge ratio, degenerate triangles).

Artifacts: simple_metrics_results.csv, simple_metrics_report.txt,
boxplots_simple_metrics.png.

The counterpart of scripts/analyze_simple_mesh_metrics.py of the JAX
build (host pandas and scipy; nothing here runs on the card).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis import plots, report
from mq3d_tpu_torch.analysis.stats import condition_tests, registry
from mq3d_tpu_torch.scripts.analyze_mesh_quality_stats import load_and_pair

SIMPLE_METRICS = registry({
    "num_vertices": ("Vertex Count", ""),
    "num_triangles": ("Triangle Count", ""),
    "component_count": ("Component Count", ""),
    "boundary_edge_ratio": ("Boundary Edge Ratio", ""),
    "degenerate_triangles": ("Degenerate Triangles", ""),
})


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Simple geometric mesh metric analysis")
    ap.add_argument("--quality-scores", type=Path,
                    default=Path("analysis/mesh_quality_batch/quality_scores.csv"))
    ap.add_argument("--output-dir", type=Path,
                    default=Path("analysis/reports/simple_mesh_analysis"))
    args = ap.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    df = load_and_pair(args.quality_scores)
    print(f"[Info] Loaded {len(df)} meshes "
          f"({df['participant'].nunique()} pairs)")

    stats_df = condition_tests(df, SIMPLE_METRICS)
    stats_df.to_csv(args.output_dir / "simple_metrics_results.csv",
                    index=False)
    plots.box_grid(df, SIMPLE_METRICS,
                   args.output_dir / "boxplots_simple_metrics.png")
    report.write_statistical_report(
        stats_df, df, [],
        args.output_dir / "simple_metrics_report.txt",
        title="SIMPLE MESH METRICS STATISTICAL ANALYSIS REPORT")
    print(f"[Info] Analysis complete: {args.output_dir}")


if __name__ == "__main__":
    main()
