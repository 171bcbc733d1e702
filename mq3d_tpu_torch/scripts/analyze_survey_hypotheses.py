"""Survey hypothesis tests (H4-H7): Assisted (sphere) vs Unassisted.

Same hypotheses, scale derivations, and test choices as the reference
(analysis/analysis/analyze_survey_hypotheses.py): Wilcoxon signed-rank
throughout (small N), IPQ Realism derived by reverse-coding IPQ_11 then
averaging items 11R-14, SUS descriptives with benchmark labels.

Input: Excel or CSV with *_sphere / *_nosphere paired columns.
Artifacts: survey_hypotheses_results.csv, statistical_report.txt.

The counterpart of scripts/analyze_survey_hypotheses.py of the JAX
build (host pandas and scipy; nothing here runs on the card).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis.stats import wilcoxon_hypothesis

HYPOTHESES = [
    # (key, column base, alternative, name)
    ("H4_Flow", "FSS_FlowTotal", "greater",
     "H4: Flow Total (Assisted > Unassisted)"),
    ("H5_Performance", "TLX_4", "less",
     "H5: Perceived Performance (Assisted < Unassisted)"),
    ("H6_Realism", "IPQ_Realism", "less",
     "H6: IPQ Realism (Assisted < Unassisted)"),
    ("H7a_Physical", "TLX_2", "greater",
     "H7a: Physical Demand (Assisted > Unassisted)"),
    ("H7b_Frustration", "TLX_6", "less",
     "H7b: Frustration (Assisted < Unassisted)"),
    ("Mental_Demand", "TLX_1", "two-sided", "Mental Demand (two-sided)"),
]


def load_survey(path: Path) -> pd.DataFrame:
    import pandas as pd

    if path.suffix.lower() in (".xlsx", ".xls"):
        df = pd.read_excel(path)
    else:
        df = pd.read_csv(path)
    return derive_ipq_realism(df)


def derive_ipq_realism(df: pd.DataFrame) -> pd.DataFrame:
    """IPQ Realism subscale: reverse-code item 11 (8 - x), then mean of
    items 11R, 12, 13, 14 per condition (reference :29-53)."""
    df = df.copy()
    for cond in ("sphere", "nosphere"):
        items = [f"IPQ_{i}_{cond}" for i in (12, 13, 14)]
        rev = f"IPQ_11_{cond}"
        if rev in df.columns and all(c in df.columns for c in items):
            df[f"IPQ_11_{cond}_REV"] = 8 - df[rev]
            df[f"IPQ_Realism_{cond}"] = df[
                [f"IPQ_11_{cond}_REV"] + items].mean(axis=1)
    return df


def sus_descriptives(df: pd.DataFrame) -> dict:
    import pandas as pd

    sus = df.get("SUS_Score_sphere", pd.Series(dtype=float)).dropna()
    if not len(sus):
        return {"n": 0, "benchmark": "No data"}
    mean = float(sus.mean())
    return {
        "n": len(sus), "mean": mean, "std": float(sus.std(ddof=1)),
        "median": float(sus.median()), "min": float(sus.min()),
        "max": float(sus.max()),
        "benchmark": ("Excellent" if mean > 80 else
                      "Above Average" if mean > 68 else "Below Average"),
    }


def main(argv=None):
    import pandas as pd

    ap = argparse.ArgumentParser(
        description="Statistical analysis of survey hypotheses (H4-H7)")
    ap.add_argument("--input", type=Path,
                    default=Path("analysis/data/survey_results.csv"))
    ap.add_argument("--output_dir", type=Path,
                    default=Path("analysis/reports/survey_hypotheses_analysis"))
    args = ap.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    df = load_survey(args.input)
    print(f"[Info] Loaded {len(df)} participants")

    rows = []
    for key, base, alternative, name in HYPOTHESES:
        a, u = f"{base}_sphere", f"{base}_nosphere"
        if a not in df.columns or u not in df.columns:
            print(f"[Warning] Skipping {key}: columns {a}/{u} missing")
            continue
        rows.append({"hypothesis": key,
                     **wilcoxon_hypothesis(df[a], df[u], alternative, name)})
    results = pd.DataFrame(rows)
    results.to_csv(args.output_dir / "survey_hypotheses_results.csv",
                   index=False)

    sus = sus_descriptives(df)
    bar = "=" * 80
    L = [bar, "STATISTICAL ANALYSIS REPORT: SURVEY HYPOTHESES (H4-H7)", bar,
         "", f"N = {len(df)} participants",
         "All hypothesis tests are Wilcoxon signed-rank (paired, "
         "non-parametric).",
         "One-tailed tests are used when directional hypotheses are "
         "specified.", ""]
    for _, r in results.iterrows():
        L += [
            r["test_name"],
            "-" * 70,
            f"  n={int(r['n'])}, W={r['statistic']:.1f}, "
            f"p={r['p_value']:.4f} ({r['alternative']})"
            + ("  *** SIGNIFICANT ***" if r["significant"] else ""),
            f"  median assisted={r['median_assisted']:.3f}  "
            f"unassisted={r['median_unassisted']:.3f}",
            f"  effect size r={r['effect_size_r']:.3f}",
            "",
        ]
    L += [bar, "SUS SCORE (Assisted condition)", bar]
    if sus["n"]:
        L += [f"  n={sus['n']}, M={sus['mean']:.2f}, SD={sus['std']:.2f}, "
              f"Median={sus['median']:.2f}, "
              f"range=[{sus['min']:.1f}, {sus['max']:.1f}]",
              f"  Benchmark: {sus['benchmark']} "
              "(>80 Excellent, >68 Above Average)"]
    else:
        L.append("  No data")
    (args.output_dir / "statistical_report.txt").write_text(
        "\n".join(L) + "\n")
    print(f"[Info] Analysis complete: {args.output_dir}")


if __name__ == "__main__":
    main()
