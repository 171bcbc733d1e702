"""Publication-quality study plots (fog vs no-fog); the counterpart of
mq3d_tpu/analysis/plots.py (the same PNG bytes).

Shared plotting layer for the analysis scripts; reproduces the reference's
artifact set (reference: analysis/analysis/analyze_hmd_motion_stats.py:
264-663 — box/violin grids, paired participant plots, per-metric and
summary improvement charts, summary bar charts) from the shared engine's
tables instead of each script carrying its own matplotlib code.

All functions are headless-safe (Agg) and write PNG at 300 dpi.

matplotlib, seaborn and pandas are imported inside the functions, so the
module imports where they are missing.  The JAX build sets the study style
(seaborn whitegrid, the colorblind palette, the rcParams below) when its
module is imported; here `styled_pyplot` sets it once, before the first
figure, and every figure function starts with it.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from mq3d_tpu_torch.analysis.stats import FOG, NOFOG, Improvement, MetricSpec

_RC = {
    "font.size": 11,
    "axes.labelsize": 12,
    "axes.titlesize": 14,
    "figure.dpi": 100,
    "savefig.dpi": 300,
    "savefig.bbox": "tight",
    "savefig.pad_inches": 0.1,
}
_PALETTE = None  # seaborn's colorblind palette, set with the style


def agg_pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def styled_pyplot():
    """agg_pyplot() with the study style applied, once per process."""
    global _PALETTE
    plt = agg_pyplot()
    if _PALETTE is None:
        import seaborn as sns

        sns.set_style("whitegrid")
        sns.set_palette("colorblind")
        plt.rcParams.update(_RC)
        _PALETTE = sns.color_palette("colorblind")
    return plt


def _sig_stars(p: float) -> str:
    return ("***" if p < 0.001 else "**" if p < 0.01 else
            "*" if p < 0.05 else "ns")


def _available(df: pd.DataFrame,
               metrics: Sequence[MetricSpec]) -> List[MetricSpec]:
    return [m for m in metrics if m.col in df.columns]


def _grid(df: pd.DataFrame, metrics: Sequence[MetricSpec], out: Path,
          kind: str) -> Optional[Path]:
    """Shared box/violin grid over all metrics, 3 per row."""
    plt = styled_pyplot()
    import seaborn as sns

    avail = _available(df, metrics)
    if not avail:
        return None
    n_cols = 3
    n_rows = (len(avail) + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(15, 5 * n_rows))
    axes = np.atleast_1d(axes).ravel()
    for ax, m in zip(axes, avail):
        sub = df[[m.col, "condition"]].dropna()
        kw = dict(data=sub, x="condition", y=m.col, hue="condition",
                  dodge=False, ax=ax, palette="colorblind", legend=False)
        if kind == "box":
            sns.boxplot(showmeans=True, **kw)
        else:
            sns.violinplot(inner="quart", **kw)
        ax.set_ylabel(f"{m.display} ({m.unit})")
        ax.set_xlabel("")
        ax.set_title(m.display)
    for ax in axes[len(avail):]:
        ax.set_visible(False)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return out


def box_grid(df, metrics, out: Path):
    return _grid(df, metrics, Path(out), "box")


def violin_grid(df, metrics, out: Path):
    return _grid(df, metrics, Path(out), "violin")


def paired_participant_plot(df: pd.DataFrame,
                            metrics: Sequence[MetricSpec],
                            out: Path,
                            participant_col: str = "participant"
                            ) -> Optional[Path]:
    """Per-participant NoFog->Fog connected scatter, one panel per metric."""
    from mq3d_tpu_torch.analysis.stats import paired_values

    plt = styled_pyplot()
    avail = [m for m in _available(df, metrics)]
    panels = []
    for m in avail:
        fog, nofog, parts = paired_values(df, m.col, participant_col)
        if len(parts):
            panels.append((m, fog, nofog, parts))
    if not panels:
        return None
    fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 6))
    axes = np.atleast_1d(axes)
    for ax, (m, fog, nofog, parts) in zip(axes, panels):
        x = np.arange(len(parts))
        ax.scatter(x - 0.15, nofog, color=_PALETTE[1], s=50, alpha=0.7,
                   label="NoFog", zorder=3)
        ax.scatter(x + 0.15, fog, color=_PALETTE[0], s=50, alpha=0.7,
                   label="Fog", zorder=3)
        for i in range(len(parts)):
            ax.plot([x[i] - 0.15, x[i] + 0.15], [nofog[i], fog[i]], "k-",
                    alpha=0.3, linewidth=0.5, zorder=1)
        ax.set_xticks(x)
        ax.set_xticklabels(
            [p[:10] + "..." if len(p) > 10 else p for p in parts],
            rotation=45, ha="right")
        ax.set_ylabel(f"{m.display} ({m.unit})")
        ax.set_title(f"{m.display}\n(Paired by Participant)")
        ax.legend()
        ax.grid(True, alpha=0.3, axis="y")
    fig.tight_layout()
    out = Path(out)
    fig.savefig(out)
    plt.close(fig)
    return out


def improvement_plot(imp: Improvement, out_dir: Path) -> Path:
    """Per-participant improvement bars for one metric."""
    plt = styled_pyplot()
    diff = imp.differences
    fig, ax = plt.subplots(figsize=(10, 6))
    x = np.arange(len(imp.participants))
    ax.barh(x, diff, color=["green" if d > 0 else "red" for d in diff],
            alpha=0.7, edgecolor="black")
    ax.axvline(x=0, color="black", linestyle="--", linewidth=1)
    ax.axvline(x=diff.mean(), color="blue", linestyle="-", linewidth=2,
               label=f"Mean improvement: {diff.mean():.2f} {imp.metric.unit}")
    ax.set_yticks(x)
    ax.set_yticklabels(
        [p[:15] + "..." if len(p) > 15 else p for p in imp.participants])
    ax.set_xlabel(f"Improvement ({imp.metric.unit})\n(Fog - NoFog)")
    ax.set_title(
        f"{imp.metric.display}\nIndividual Participant Improvements\n"
        f"Mean: {diff.mean():.2f} {imp.metric.unit}, "
        f"p={imp.p_value:.4f} {_sig_stars(imp.p_value)}")
    ax.legend()
    ax.grid(True, alpha=0.3, axis="x")
    fig.tight_layout()
    safe = (imp.metric.display.replace(" ", "_").replace("(", "")
            .replace(")", "").replace("/", "_"))
    out = Path(out_dir) / f"improvements_{safe}.png"
    fig.savefig(out)
    plt.close(fig)
    return out


def improvement_summary_plot(improvements: List[Improvement],
                             out: Path) -> Optional[Path]:
    plt = styled_pyplot()
    if len(improvements) < 2:
        return None
    fig, ax = plt.subplots(figsize=(10, 6))
    names = [i.metric.display for i in improvements]
    means = [float(i.differences.mean()) for i in improvements]
    stds = [float(i.differences.std(ddof=1)) for i in improvements]
    ps = [i.p_value for i in improvements]
    x = np.arange(len(names))
    colors = ["green" if p < 0.05 else "orange" if p < 0.10 else "gray"
              for p in ps]
    ax.barh(x, means, xerr=stds, color=colors, alpha=0.7,
            edgecolor="black", capsize=5)
    ax.axvline(x=0, color="black", linestyle="--", linewidth=1)
    ax.set_yticks(x)
    ax.set_yticklabels(names)
    ax.set_xlabel("Mean Improvement (Fog - NoFog)")
    ax.set_title("Summary of Improvements Across Coverage Metrics")
    ax.grid(True, alpha=0.3, axis="x")
    span = max(abs(v) for v in means) or 1.0
    for i, (p, mean, sd) in enumerate(zip(ps, means, stds)):
        ax.text(mean + sd + 0.01 * span, i, _sig_stars(p), va="center",
                fontsize=12, fontweight="bold")
    fig.tight_layout()
    out = Path(out)
    fig.savefig(out)
    plt.close(fig)
    return out


def summary_bar_chart(stats_df: pd.DataFrame,
                      metrics: Sequence[MetricSpec], out: Path
                      ) -> Optional[Path]:
    """Fog/NoFog mean ± SD bars with significance brackets per metric."""
    plt = styled_pyplot()
    rows = [(m, stats_df[stats_df["metric"] == m.display])
            for m in metrics]
    rows = [(m, r.iloc[0]) for m, r in rows if len(r)]
    if not rows:
        return None
    fig, axes = plt.subplots(1, len(rows), figsize=(5 * len(rows), 5))
    axes = np.atleast_1d(axes)
    for ax, (m, row) in zip(axes, rows):
        means = [row["fog_mean"], row["nofog_mean"]]
        stds = [row["fog_std"], row["nofog_std"]]
        ax.bar([0, 1], means, yerr=stds, capsize=5,
               color=[_PALETTE[0], _PALETTE[1]], alpha=0.7,
               edgecolor="black")
        if row["significant"]:
            top = max(means) + max(stds)
            ax.plot([0, 1], [top * 1.1] * 2, "k-", linewidth=1)
            ax.plot([0, 0], [top * 1.05, top * 1.1], "k-", linewidth=1)
            ax.plot([1, 1], [top * 1.05, top * 1.1], "k-", linewidth=1)
            p = row["p_value"]
            ax.text(0.5, top * 1.15,
                    f"p={p:.3f}" if p >= 0.001 else "p<0.001",
                    ha="center", fontsize=9)
        ax.set_xticks([0, 1])
        ax.set_xticklabels([FOG, NOFOG])
        ax.set_ylabel(f"{m.display} ({m.unit})")
        ax.set_title(m.display)
        ax.grid(True, alpha=0.3, axis="y")
    fig.tight_layout()
    out = Path(out)
    fig.savefig(out)
    plt.close(fig)
    return out


def fig_to_base64(fig) -> str:
    """Inline <img> payload for self-contained HTML reports."""
    plt = styled_pyplot()
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=150, bbox_inches="tight")
    plt.close(fig)
    buf.seek(0)
    import base64

    return base64.b64encode(buf.read()).decode("ascii")
