"""Study report writers: text, CSV, HTML dashboards, LaTeX tables; the
counterpart of mq3d_tpu/analysis/report.py (the same bytes).

Reproduces the reference's report formats from the shared engine tables
(reference: analysis/analysis/analyze_hmd_motion_stats.py:666-813
statistical_report.txt; analysis/reporting/generate_simple_pairwise_report.py
and generate_comprehensive_quality_analysis.py self-contained HTML with
base64-inlined charts; generate_participant_demographics.py:301-446
LaTeX + HTML tables).  pandas is imported only where a writer needs it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mq3d_tpu_torch.analysis.stats import FOG, NOFOG, Improvement


def write_statistical_report(
    stats_df: pd.DataFrame,
    df: pd.DataFrame,
    improvements: Sequence[Improvement],
    out_path: Path,
    title: str = "HMD MOTION ANALYSIS: FOG vs NOFOG COMPARISON",
    participant_col: str = "participant",
) -> Path:
    """statistical_report.txt, section-for-section like the reference
    (sample sizes / significant / non-significant / improvements /
    interpretation summary / methodology)."""
    import pandas as pd

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    bar = "=" * 80
    dash = "-" * 80
    L: List[str] = [bar, title, bar, ""]

    fog_n = int((df["condition"] == FOG).sum())
    nofog_n = int((df["condition"] == NOFOG).sum())
    has_participants = (participant_col in df.columns
                        and df[participant_col].notna().any())
    L += ["Sample Sizes:",
          f"  Fog condition: {fog_n} sessions",
          f"  NoFog condition: {nofog_n} sessions",
          f"  Total: {fog_n + nofog_n} sessions"]
    if has_participants:
        L += [f"  Participants: {df[participant_col].nunique()}",
              "  Design: Paired (each participant has both Fog and NoFog "
              "measurements)"]
    L += ["", bar, "STATISTICAL RESULTS", bar, ""]

    sig = stats_df[stats_df["significant"]].sort_values("p_value")
    if len(sig):
        L += ["SIGNIFICANT DIFFERENCES (p < 0.05):", dash]
        for _, r in sig.iterrows():
            direction = ("higher" if r["fog_mean"] > r["nofog_mean"]
                         else "lower")
            test_info = (f"{r['test']}, statistic={r['statistic']:.3f}, "
                         f"p={r['p_value']:.4f}")
            if pd.notna(r.get("n_pairs")):
                test_info += f", n_pairs={int(r['n_pairs'])}"
            L += [
                "",
                f"{r['metric']} ({r['unit']}):",
                f"  Fog:      M={r['fog_mean']:.3f}, SD={r['fog_std']:.3f}, "
                f"Median={r['fog_median']:.3f}, "
                f"IQR=[{r['fog_q25']:.3f}, {r['fog_q75']:.3f}]",
                f"  NoFog:    M={r['nofog_mean']:.3f}, "
                f"SD={r['nofog_std']:.3f}, "
                f"Median={r['nofog_median']:.3f}, "
                f"IQR=[{r['nofog_q25']:.3f}, {r['nofog_q75']:.3f}]",
                f"  Test:     {test_info}",
                f"  Effect:    Cohen's d={r['cohens_d']:.3f} "
                f"({r['effect_size']})",
                f"  Result:    Fog condition shows {direction} "
                f"{r['metric'].lower()} compared to NoFog condition.",
            ]
        L.append("")

    nonsig = stats_df[~stats_df["significant"]].sort_values("metric")
    if len(nonsig):
        L += ["NON-SIGNIFICANT DIFFERENCES (p >= 0.05):", dash]
        for _, r in nonsig.iterrows():
            L.append(f"{r['metric']}: p={r['p_value']:.4f}, "
                     f"Cohen's d={r['cohens_d']:.3f} ({r['effect_size']})")
        L.append("")

    if improvements:
        L += [bar, "IMPROVEMENT ANALYSIS (Fog - NoFog)", bar, "",
              "This section tests directional hypotheses that Fog > NoFog.",
              "One-tailed tests are used to test if improvements are "
              "significantly > 0.", ""]
        for imp in improvements:
            r = imp.row
            L += [
                f"{r['metric']} ({r['unit']}):",
                f"  Mean improvement: {r['mean_improvement']:.3f} "
                f"{r['unit']}",
                f"  Improvement percentage: {r['improvement_percent']:.1f}% "
                "relative to NoFog",
                f"  Range: [{r['min_improvement']:.3f}, "
                f"{r['max_improvement']:.3f}] {r['unit']}",
                f"  Median: {r['median_improvement']:.3f} {r['unit']}",
                f"  Test: {r['test']}",
                f"  Statistic: {r['statistic']:.3f}, p={r['p_value']:.4f}"
                + (" *** SIGNIFICANT ***" if r["significant"]
                   else " (not significant)"),
                f"  Effect size: Cohen's d={r['cohens_d']:.3f} "
                f"({r['effect_size']})",
                "",
            ]

    L += [bar, "INTERPRETATION SUMMARY", bar, "",
          f"Out of {len(stats_df)} metrics analyzed, {len(sig)} showed "
          "statistically significant differences between Fog and NoFog "
          "conditions.", ""]
    if len(sig):
        L.append("Key Findings:")
        for _, r in sig.head(5).iterrows():
            direction = ("increased" if r["fog_mean"] > r["nofog_mean"]
                         else "decreased")
            L.append(f"  - {r['metric']}: {direction} in Fog condition "
                     f"(p={r['p_value']:.4f}, d={r['cohens_d']:.3f})")
    L += ["", "Effect Size Guidelines (Cohen's d):",
          "  |d| < 0.2:  Negligible effect",
          "  0.2 <= |d| < 0.5:  Small effect",
          "  0.5 <= |d| < 0.8:  Medium effect",
          "  |d| >= 0.8:  Large effect",
          "", bar, "METHODOLOGY", bar, ""]
    if has_participants:
        L += ["PAIRED DESIGN ANALYSIS:",
              "  - Each participant completed both Fog and NoFog conditions",
              "  - Paired statistical tests account for within-subject "
              "variability", "",
              "Statistical tests were chosen based on data distribution:",
              "  - Shapiro-Wilk test on the paired differences",
              "  - Normal differences: Paired t-test",
              "  - Non-normal differences: Wilcoxon signed-rank test",
              "  - One-tailed tests (fog > nofog) for metrics with "
              "directional hypotheses"]
    else:
        L += ["Statistical tests were chosen based on data distribution:",
              "  - Shapiro-Wilk test used to assess normality",
              "  - Normal distributions: Independent samples t-test",
              "  - Non-normal distributions: Mann-Whitney U test"]
    L += ["  - Effect sizes calculated using Cohen's d",
          "  - Significance threshold: alpha = 0.05"]

    out_path.write_text("\n".join(L) + "\n")
    return out_path


# ---------------------------------------------------------------------------
# HTML dashboards
# ---------------------------------------------------------------------------

_HTML_STYLE = """
body { font-family: -apple-system, 'Segoe UI', Helvetica, Arial, sans-serif;
       margin: 2em auto; max-width: 1200px; color: #222; }
h1 { border-bottom: 3px solid #4477aa; padding-bottom: .3em; }
h2 { border-bottom: 1px solid #ccc; padding-bottom: .2em; margin-top: 2em; }
table { border-collapse: collapse; margin: 1em 0; width: 100%; }
th, td { border: 1px solid #ddd; padding: 6px 10px; text-align: right; }
th { background: #f0f4f8; }
td:first-child, th:first-child { text-align: left; }
tr.sig { background: #e8f5e9; }
img { max-width: 100%; margin: 1em 0; }
.badge { display: inline-block; padding: 2px 8px; border-radius: 10px;
         font-size: .85em; color: white; }
.badge.sig { background: #2e7d32; }
.badge.ns { background: #9e9e9e; }
"""


def _df_to_html_table(df: pd.DataFrame, sig_col: Optional[str] = None
                      ) -> str:
    head = "".join(f"<th>{c}</th>" for c in df.columns)
    body = []
    for _, r in df.iterrows():
        cls = (' class="sig"'
               if sig_col and bool(r.get(sig_col)) else "")
        cells = "".join(
            f"<td>{v:.4g}</td>" if isinstance(v, (float, np.floating))
            else f"<td>{v}</td>"
            for v in r.to_list()
        )
        body.append(f"<tr{cls}>{cells}</tr>")
    return (f'<table><tr>{head}</tr>{"".join(body)}</table>')


def write_html_dashboard(
    out_path: Path,
    title: str,
    sections: Sequence[Dict],
) -> Path:
    """Self-contained HTML report.  Each section is
    {"title": str, "text": str?, "table": DataFrame?, "sig_col": str?,
     "images_b64": [str]?, "image_files": [Path]?}.
    base64 images make the file fully self-contained (reference
    generate_simple_pairwise_report.py:46-54)."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    parts = [f"<html><head><meta charset='utf-8'><title>{title}</title>",
             f"<style>{_HTML_STYLE}</style></head><body>",
             f"<h1>{title}</h1>"]
    for sec in sections:
        parts.append(f"<h2>{sec['title']}</h2>")
        if sec.get("text"):
            parts.append(f"<p>{sec['text']}</p>")
        table = sec.get("table")
        if table is not None and len(table):
            parts.append(_df_to_html_table(table, sec.get("sig_col")))
        for b64 in sec.get("images_b64", []) or []:
            parts.append(f'<img src="data:image/png;base64,{b64}"/>')
        for f in sec.get("image_files", []) or []:
            parts.append(f'<img src="{Path(f).name}"/>')
    parts.append("</body></html>")
    out_path.write_text("\n".join(parts))
    return out_path


# ---------------------------------------------------------------------------
# LaTeX tables
# ---------------------------------------------------------------------------

def _latex_escape(s: str) -> str:
    for a, b in (("\\", r"\textbackslash{}"), ("&", r"\&"), ("%", r"\%"),
                 ("$", r"\$"), ("#", r"\#"), ("_", r"\_"), ("{", r"\{"),
                 ("}", r"\}"), ("^", r"\^{}"), ("~", r"\~{}")):
        s = s.replace(a, b)
    return s


def write_latex_table(df: pd.DataFrame, out_path: Path,
                      caption: str = "", label: str = "") -> Path:
    """Booktabs LaTeX table from a results frame (reference
    generate_participant_demographics.py:301-379)."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    cols = list(df.columns)
    spec = "l" + "r" * (len(cols) - 1)
    L = [r"\begin{table}[htbp]", r"  \centering"]
    if caption:
        L.append(f"  \\caption{{{_latex_escape(caption)}}}")
    if label:
        L.append(f"  \\label{{{label}}}")
    L += [f"  \\begin{{tabular}}{{{spec}}}", r"    \toprule",
          "    " + " & ".join(_latex_escape(str(c)) for c in cols)
          + r" \\", r"    \midrule"]
    for _, r in df.iterrows():
        cells = [
            f"{v:.3f}" if isinstance(v, (float, np.floating))
            else _latex_escape(str(v))
            for v in r.to_list()
        ]
        L.append("    " + " & ".join(cells) + r" \\")
    L += [r"    \bottomrule", r"  \end{tabular}", r"\end{table}", ""]
    out_path.write_text("\n".join(L))
    return out_path
