"""Participant demographics report: tables (CSV/LaTeX/HTML) + distributions.

Same artifact set as the reference
(analysis/reporting/generate_participant_demographics.py): numeric
summaries (age, VR/game experience) and categorical distributions (gender,
nationality, education, laterality, glasses), written as a demographics
table in CSV/LaTeX/HTML plus PNG+PDF distribution plots.

The counterpart of scripts/generate_participant_demographics.py of the JAX
build (host code).  Like that script it draws in matplotlib's current
style: it does not set the study style of analysis/plots.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from mq3d_tpu_torch.analysis.plots import agg_pyplot
from mq3d_tpu_torch.analysis.report import (
    write_html_dashboard,
    write_latex_table,
)

NUMERIC_FIELDS = {
    "Age": "age",
    "Experience using VR Tools (yrs)": "vr_experience",
    "Experience with Video Games (yrs)": "game_experience",
}
CATEGORICAL_FIELDS = {
    "Gender": "gender",
    "Nationality": "nationality",
    "Education - Highest Obtained": "education_highest",
    "Education - Currently Pursued": "education_current",
    "Laterality": "laterality",
    "Glass-wearer": "glasses",
    "Wore glasses during experiment": "wore_glasses",
}


def demographics_table(df: pd.DataFrame) -> pd.DataFrame:
    import pandas as pd

    rows = []
    for col, key in NUMERIC_FIELDS.items():
        if col not in df.columns:
            continue
        x = df[col].dropna()
        if not len(x):
            continue
        rows.append({
            "Characteristic": col, "Category": "",
            "Value": f"M={x.mean():.1f}, SD={x.std(ddof=1):.1f}, "
                     f"Mdn={x.median():.1f}, "
                     f"range=[{x.min():.0f}, {x.max():.0f}]",
            "N": len(x),
        })
    for col, key in CATEGORICAL_FIELDS.items():
        if col not in df.columns:
            continue
        counts = df[col].value_counts()
        for cat, n in counts.items():
            rows.append({
                "Characteristic": col, "Category": str(cat),
                "Value": f"{n} ({n / len(df) * 100:.0f}%)", "N": int(n),
            })
    return pd.DataFrame(rows)


def plot_distributions(df: pd.DataFrame, out_dir: Path):
    plt = agg_pyplot()

    def save(fig, stem):
        fig.tight_layout()
        fig.savefig(out_dir / f"{stem}.png", dpi=300, bbox_inches="tight")
        fig.savefig(out_dir / f"{stem}.pdf", bbox_inches="tight")
        plt.close(fig)

    if "Age" in df.columns and df["Age"].notna().any():
        fig, ax = plt.subplots(figsize=(7, 5))
        ax.hist(df["Age"].dropna(), bins=10, color="#4477aa",
                edgecolor="black", alpha=0.8)
        ax.set_xlabel("Age (years)")
        ax.set_ylabel("Participants")
        ax.set_title("Age Distribution")
        save(fig, "age_distribution")

    if "Gender" in df.columns:
        counts = df["Gender"].value_counts()
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.pie(counts.to_numpy(), labels=list(counts.index),
               autopct="%1.0f%%", startangle=90)
        ax.set_title("Gender Distribution")
        save(fig, "gender_distribution")

    exp_cols = [c for c in ("Experience using VR Tools (yrs)",
                            "Experience with Video Games (yrs)")
                if c in df.columns]
    if exp_cols:
        fig, axes = plt.subplots(1, len(exp_cols),
                                 figsize=(6 * len(exp_cols), 5))
        axes = [axes] if len(exp_cols) == 1 else list(axes)
        for ax, c in zip(axes, exp_cols):
            ax.hist(df[c].dropna(), bins=8, color="#66ccee",
                    edgecolor="black", alpha=0.8)
            ax.set_xlabel(c)
            ax.set_ylabel("Participants")
        fig.suptitle("Prior Experience")
        save(fig, "experience_distributions")

    for col, stem in (("Education - Highest Obtained", "education_levels"),
                      ("Laterality", "laterality_glasses")):
        if col not in df.columns:
            continue
        counts = df[col].value_counts()
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.barh(range(len(counts)), counts.to_numpy(), color="#228833",
                alpha=0.8)
        ax.set_yticks(range(len(counts)))
        ax.set_yticklabels(list(counts.index))
        for i, v in enumerate(counts.to_numpy()):
            ax.text(v + 0.1, i, str(v), va="center", fontsize=10)
        ax.set_title(col)
        save(fig, stem)


def main(argv=None):
    import pandas as pd

    ap = argparse.ArgumentParser(
        description="Generate participant demographics report")
    ap.add_argument("--input", type=Path,
                    default=Path("analysis/data/survey_results.csv"))
    ap.add_argument("--output_dir", type=Path,
                    default=Path("analysis/reports/participant_demographics"))
    args = ap.parse_args(argv)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    if args.input.suffix.lower() in (".xlsx", ".xls"):
        df = pd.read_excel(args.input)
    else:
        df = pd.read_csv(args.input)
    print(f"[Info] Loaded {len(df)} participants")

    table = demographics_table(df)
    table.to_csv(args.output_dir / "demographics_table.csv", index=False)
    write_latex_table(table, args.output_dir / "demographics_table.tex",
                      caption="Participant demographics",
                      label="tab:demographics")
    plot_distributions(df, args.output_dir)
    write_html_dashboard(
        args.output_dir / "demographics_table.html",
        "Participant Demographics",
        [{"title": "Summary", "table": table},
         {"title": "Distributions",
          "image_files": sorted(args.output_dir.glob("*.png"))}])
    print(f"[Info] Demographics report written to {args.output_dir}")


if __name__ == "__main__":
    main()
