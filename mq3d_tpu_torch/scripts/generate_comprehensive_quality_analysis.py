"""Comprehensive mesh-quality HTML dashboard: Fog vs NoFog.

Same surface and section structure as the reference
(analysis/reporting/generate_comprehensive_quality_analysis.py): per-metric
comparison/box/scatter charts inlined as base64, statistics with paired
tests per metric, category sections (quality scores, geometry, smoothness,
completeness, color, topology, size), executive summary cards, and a
statistical summary table — one fully self-contained HTML file.

The counterpart of scripts/generate_comprehensive_quality_analysis.py of
the JAX build (host code).  That script sets the study style by importing
its plots module; here metric_charts sets it (analysis/plots.styled_pyplot)
before its first figure.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from mq3d_tpu_torch.analysis.plots import fig_to_base64, styled_pyplot
from mq3d_tpu_torch.analysis.stats import (
    FOG,
    NOFOG,
    MetricSpec,
    condition_tests,
    infer_condition,
)

CATEGORIES = {
    "Quality Scores": [
        "Q_raw", "Q_norm", "S_geom", "S_smooth", "S_complete",
        "S_color", "S_shape", "S_topology", "S_bonuses"],
    "Geometry Metrics": [
        "mean_aspect_ratio", "mean_skewness", "degenerate_triangles",
        "non_manifold_edges", "boundary_edge_ratio", "component_count"],
    "Smoothness Metrics": [
        "normal_deviation_avg_deg", "dihedral_min_deg", "dihedral_max_deg",
        "dihedral_penalty", "surface_roughness"],
    "Completeness Metrics": ["is_single_component", "vertex_density_stddev"],
    "Color Metrics": [
        "has_color", "uncolored_vertex_ratio", "color_gradient_stddev"],
    "Topology Metrics": ["is_manifold", "is_watertight"],
    "Size Metrics": ["num_vertices", "num_triangles", "total_edges"],
}

_HIGHER_BETTER = set(CATEGORIES["Quality Scores"]) | {
    "is_manifold", "is_watertight", "is_single_component", "has_color",
    "num_vertices", "num_triangles", "total_edges", "dihedral_max_deg",
}


def higher_is_better(metric: str) -> bool:
    return metric in _HIGHER_BETTER


def parse_name(name: str) -> Tuple[Optional[str], Optional[str]]:
    name = str(name)
    if name.endswith("_fog"):
        return name[:-4], FOG
    if name.endswith("_nofog"):
        return name[:-6], NOFOG
    return None, None


def metric_charts(df: pd.DataFrame, col: str, display: str) -> List[str]:
    plt = styled_pyplot()

    fog = df[df["condition"] == FOG][col].dropna().to_numpy(float)
    nofog = df[df["condition"] == NOFOG][col].dropna().to_numpy(float)
    out = []

    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.bar([0, 1], [fog.mean() if len(fog) else 0,
                    nofog.mean() if len(nofog) else 0],
           yerr=[fog.std(ddof=1) if len(fog) > 1 else 0,
                 nofog.std(ddof=1) if len(nofog) > 1 else 0],
           color=["#4477aa", "#ee6677"], alpha=0.8, capsize=5)
    ax.set_xticks([0, 1])
    ax.set_xticklabels([FOG, NOFOG])
    ax.set_title(f"{display} — Fog vs NoFog Comparison")
    out.append(fig_to_base64(fig))

    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.boxplot([fog, nofog], tick_labels=[FOG, NOFOG], showmeans=True)
    ax.set_title(f"{display} — Distribution Comparison")
    out.append(fig_to_base64(fig))

    paired = df.pivot_table(index="participant", columns="condition",
                            values=col, aggfunc="first")
    if FOG in paired.columns and NOFOG in paired.columns:
        p = paired.dropna()
        if len(p) >= 2:
            fig, ax = plt.subplots(figsize=(5.5, 5.5))
            ax.scatter(p[FOG], p[NOFOG], alpha=0.7, color="#4477aa")
            lims = [min(p.min().min(), 0), p.max().max() * 1.05]
            ax.plot(lims, lims, "k--", alpha=0.5, label="y = x")
            ax.set_xlabel(FOG)
            ax.set_ylabel(NOFOG)
            ax.set_title(f"{display} — Fog vs NoFog Scatter")
            ax.legend()
            out.append(fig_to_base64(fig))
    return out


def main(argv=None):
    import pandas as pd

    ap = argparse.ArgumentParser(
        description="Comprehensive mesh quality HTML analysis")
    ap.add_argument("--quality-scores", type=Path,
                    default=Path("analysis/mesh_quality_batch/quality_scores.csv"))
    ap.add_argument("--output", type=Path,
                    default=Path("analysis/reports/comprehensive_quality_analysis.html"))
    ap.add_argument("--exclude-participant", action="append", default=[])
    args = ap.parse_args(argv)

    df = pd.read_csv(args.quality_scores)
    parsed = df["name"].map(parse_name)
    df["participant"] = parsed.map(lambda t: t[0])
    df["condition"] = parsed.map(lambda t: t[1])
    df = df[df["participant"].notna() & df["condition"].notna()].copy()
    excluded = []
    if args.exclude_participant:
        mask = df["participant"].map(
            lambda p: any(e.lower() in str(p).lower()
                          for e in args.exclude_participant))
        excluded = sorted(df[mask]["participant"].unique())
        df = df[~mask]
    print(f"[Info] {len(df)} records, "
          f"{df['participant'].nunique()} participants")

    all_cols = [c for cols in CATEGORIES.values() for c in cols
                if c in df.columns and not df[c].isna().all()]
    specs = [MetricSpec(c, c.replace("_", " ").title(), "",
                        one_tailed=higher_is_better(c)) for c in all_cols]
    stats_df = condition_tests(df, specs)

    html: List[str] = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        "<title>Comprehensive Mesh Quality Analysis</title><style>",
        "body { font-family: 'Segoe UI', sans-serif; margin: 20px; "
        "background: #f5f5f5; }",
        ".container { max-width: 1400px; margin: 0 auto; background: white; "
        "padding: 30px; border-radius: 8px; }",
        "h1 { color: #2c3e50; border-bottom: 3px solid #3498db; "
        "padding-bottom: 10px; }",
        "h2 { color: #34495e; border-left: 4px solid #3498db; "
        "padding-left: 15px; margin-top: 40px; }",
        "table { border-collapse: collapse; width: 100%; font-size: 14px; }",
        "th, td { border: 1px solid #ddd; padding: 8px; }",
        "th { background: #3498db; color: white; }",
        "tr:nth-child(even) { background: #f8f9fa; }",
        ".significant { color: #e74c3c; font-weight: bold; }",
        ".metric-section { margin: 30px 0; padding: 20px; "
        "background: #fafafa; border: 1px solid #e0e0e0; }",
        "img { max-width: 100%; }",
        "</style></head><body><div class='container'>",
        "<h1>Comprehensive Mesh Quality Analysis: Fog vs NoFog</h1>",
        "<h2 id='summary'>Executive Summary</h2>",
        f"<p><strong>Participants (included):</strong> "
        f"{df['participant'].nunique()}</p>",
        f"<p><strong>Records:</strong> {len(df)} "
        f"({int((df['condition'] == FOG).sum())} fog, "
        f"{int((df['condition'] == NOFOG).sum())} nofog)</p>",
    ]
    if excluded:
        html.append(f"<p><strong>Excluded:</strong> "
                    f"{', '.join(map(str, excluded))}</p>")
    n_sig = int(stats_df["significant"].sum()) if len(stats_df) else 0
    html.append(f"<p><strong>Significant metrics (p &lt; 0.05):</strong> "
                f"{n_sig} / {len(stats_df)}</p>")

    for category, cols in CATEGORIES.items():
        present = [c for c in cols if c in df.columns
                   and not df[c].isna().all()]
        if not present:
            continue
        html.append(f"<h2>{category}</h2>")
        for col in present:
            display = col.replace("_", " ").title()
            row = stats_df[stats_df["metric"] == display]
            html.append("<div class='metric-section'>")
            html.append(f"<h3>{display}</h3>")
            if len(row):
                r = row.iloc[0]
                cls = "significant" if r["significant"] else ""
                html.append(
                    f"<p class='{cls}'>Fog M={r['fog_mean']:.4g} "
                    f"(SD {r['fog_std']:.4g}) vs NoFog "
                    f"M={r['nofog_mean']:.4g} (SD {r['nofog_std']:.4g}); "
                    f"{r['test']}: p={r['p_value']:.4f}, "
                    f"d={r['cohens_d']:.3f} ({r['effect_size']})</p>")
            for b64 in metric_charts(df, col, display):
                html.append(
                    f"<img src='data:image/png;base64,{b64}'/>")
            html.append("</div>")

    html.append("<h2 id='statistics'>Statistical Summary</h2>")
    if len(stats_df):
        head = "".join(f"<th>{c}</th>" for c in
                       ["metric", "fog_mean", "nofog_mean", "test",
                        "p_value", "cohens_d", "effect_size"])
        body = []
        for _, r in stats_df.sort_values("p_value").iterrows():
            cls = " class='significant'" if r["significant"] else ""
            body.append(
                f"<tr{cls}><td>{r['metric']}</td>"
                f"<td>{r['fog_mean']:.4g}</td>"
                f"<td>{r['nofog_mean']:.4g}</td><td>{r['test']}</td>"
                f"<td>{r['p_value']:.4f}</td><td>{r['cohens_d']:.3f}</td>"
                f"<td>{r['effect_size']}</td></tr>")
        html.append(f"<table><tr>{head}</tr>{''.join(body)}</table>")
    html.append("</div></body></html>")

    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text("\n".join(html))
    print(f"[Info] Report saved to: {args.output}")


if __name__ == "__main__":
    main()
