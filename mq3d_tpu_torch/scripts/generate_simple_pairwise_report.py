"""Self-contained pairwise HTML report of simple mesh metrics.

Same surface and report content as the reference
(analysis/reporting/generate_simple_pairwise_report.py): one row per
fog/nofog pair with per-metric fog/nofog/delta columns, plus per-pair bar
and delta charts inlined as base64 so the HTML is a single portable file.

The counterpart of scripts/generate_simple_pairwise_report.py of the JAX
build (host code).  That script sets the study style by importing its
plots module; here main() sets it (analysis/plots.styled_pyplot) before
the first figure.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.analysis.plots import fig_to_base64, styled_pyplot
from mq3d_tpu_torch.analysis.report import write_html_dashboard
from mq3d_tpu_torch.scripts.analyze_simple_mesh_metrics import SIMPLE_METRICS


def split_pair_name(name: str):
    """{participant}_{nofog_session}__{fog_session}_{cond} ->
    (participant, pair_id)."""
    base = (name[:-4] if name.endswith("_fog")
            else name[:-6] if name.endswith("_nofog") else None)
    if base is None or "__" not in base:
        return None, None
    left, fog_session = base.rsplit("__", 1)
    # left = {participant}_{nofog_session}; session ids are 15 chars
    participant = left[:-16] if len(left) > 16 else left
    return participant, base[len(participant) + 1 if participant else 0:]


def build_pairs(df: pd.DataFrame) -> pd.DataFrame:
    import pandas as pd

    df = df.copy()
    parsed = df["name"].map(split_pair_name)
    df["participant"] = parsed.map(lambda t: t[0])
    df["pair_id"] = parsed.map(lambda t: t[1])
    df["condition"] = df["name"].map(
        lambda x: "Fog" if str(x).endswith("_fog")
        else ("NoFog" if str(x).endswith("_nofog") else None))
    df = df[df["participant"].notna() & df["condition"].notna()]

    rows = []
    for (participant, pair_id), g in df.groupby(["participant", "pair_id"]):
        fog = g[g["condition"] == "Fog"]
        nofog = g[g["condition"] == "NoFog"]
        if not len(fog) or not len(nofog):
            continue
        row = {"participant": participant, "pair_id": pair_id}
        for m in SIMPLE_METRICS:
            if m.col in df.columns:
                f, n = fog.iloc[0][m.col], nofog.iloc[0][m.col]
                row[f"fog_{m.col}"] = f
                row[f"nofog_{m.col}"] = n
                row[f"delta_{m.col}"] = n - f
        rows.append(row)
    return (pd.DataFrame(rows).sort_values("participant")
            .reset_index(drop=True) if rows else pd.DataFrame())


def main(argv=None):
    import pandas as pd

    ap = argparse.ArgumentParser(
        description="Simple pairwise mesh-metric HTML report")
    ap.add_argument("--quality-scores", type=Path,
                    default=Path("analysis/mesh_quality_batch/quality_scores.csv"))
    ap.add_argument("--master-report", type=Path, default=None)
    ap.add_argument("--output", type=Path,
                    default=Path("analysis/reports/simple_pairwise_report.html"))
    args = ap.parse_args(argv)
    plt = styled_pyplot()

    df = pd.read_csv(args.quality_scores)
    pairs = build_pairs(df)
    if args.master_report and Path(args.master_report).exists():
        master = pd.read_csv(args.master_report)
        mapping = dict(zip(master["pair_id"], master["participant"]))
        pairs["participant"] = pairs["pair_id"].map(mapping).fillna(
            pairs["participant"])
    print(f"[Info] Found {len(pairs)} pairs")

    sections = [{"title": "Summary Table", "table": pairs}]
    x = np.arange(len(pairs))
    for m in SIMPLE_METRICS:
        if f"fog_{m.col}" not in pairs.columns:
            continue
        fog = pairs[f"fog_{m.col}"].to_numpy(float)
        nofog = pairs[f"nofog_{m.col}"].to_numpy(float)
        delta = pairs[f"delta_{m.col}"].to_numpy(float)

        fig, ax = plt.subplots(figsize=(10, 5))
        ax.bar(x - 0.2, fog, width=0.4, label="Fog", alpha=0.7)
        ax.bar(x + 0.2, nofog, width=0.4, label="NoFog", alpha=0.7)
        ax.set_xticks(x)
        ax.set_xticklabels(pairs["participant"], rotation=45, ha="right")
        ax.set_ylabel(m.display)
        ax.set_title(f"{m.display} per pair")
        ax.legend()
        bars_b64 = fig_to_base64(fig)

        fig, ax = plt.subplots(figsize=(10, 4))
        ax.bar(x, delta,
               color=["green" if d >= 0 else "red" for d in delta],
               alpha=0.7)
        ax.axhline(0, color="black", linewidth=1)
        ax.set_xticks(x)
        ax.set_xticklabels(pairs["participant"], rotation=45, ha="right")
        ax.set_ylabel("Delta (NoFog - Fog)")
        ax.set_title(f"{m.display} Delta per pair")
        delta_b64 = fig_to_base64(fig)

        sections.append({"title": m.display,
                         "images_b64": [bars_b64, delta_b64]})

    write_html_dashboard(args.output,
                         "Simple Mesh Metrics - Pairwise Comparison",
                         sections)
    print(f"[Info] HTML report saved to: {args.output}")


if __name__ == "__main__":
    main()
