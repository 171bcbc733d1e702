"""Study reporting: master fog/no-fog CSV maintenance and paired statistics;
the counterpart of mq3d_tpu/eval/reporting.py.

Re-design of the reference's reporting layer (reference:
scripts/evaluation/evaluate_fbx_quality.py:679-1029 `update_master_fog_report`
— the subject of the repo's only test, test_quality_update.py:26-137 — plus
analysis/analysis/* paired fog-vs-nofog statistics and HTML reports).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class PairQualityScores:
    """Per-mesh quality record as written into the master report."""

    name: str
    Q_raw: float
    Q_norm: float
    S_geom: float = 0.0
    S_smooth: float = 0.0
    S_complete: float = 0.0
    S_color: float = 0.0
    S_shape: float = 0.0
    S_topology: float = 0.0
    S_bonuses: float = 0.0


QUALITY_COLUMNS = [
    "Q_raw", "Q_norm",
    "S_geom", "S_smooth", "S_complete", "S_color",
    "S_shape", "S_topology", "S_bonuses",
]
DELTA_COL = "relative_quality_delta_nofog_minus_fog"


def update_master_fog_report(
    master_csv: Path,
    scores: List[PairQualityScores],
    pair_meta: List[Dict[str, str]],
) -> None:
    """Progressively write per-mesh and relative quality metrics back into
    master_fog_no_fog_report.csv.

    Semantics (matching the reference):
      * adds fog_*/nofog_* columns for every quality metric plus the delta
        column when missing;
      * fills *_evaluate_quality_score_placeholder with Q_norm for backward
        compatibility;
      * updates only rows whose fog AND nofog meshes are both evaluated;
        other rows (and unknown participants) are left untouched.
    """
    master_csv = Path(master_csv)
    if not master_csv.exists():
        return

    scores_by_name = {s.name: s for s in scores}
    meta_index: Dict[Tuple[str, str], Dict[str, str]] = {}
    for m in pair_meta:
        participant = (m.get("participant") or "").strip()
        pair_id = (m.get("pair_id") or "").strip()
        if participant and pair_id:
            meta_index[(participant, pair_id)] = m

    with master_csv.open("r", newline="") as f:
        reader = csv.DictReader(f)
        rows: List[Dict[str, Any]] = list(reader)
        fieldnames = list(reader.fieldnames or [])

    for condition in ("fog", "nofog"):
        for col in QUALITY_COLUMNS:
            new_col = f"{condition}_{col}"
            if new_col not in fieldnames:
                fieldnames.append(new_col)
    if DELTA_COL not in fieldnames:
        fieldnames.append(DELTA_COL)

    for row in rows:
        participant = (row.get("participant") or "").strip()
        pair_id = (row.get("pair_id") or "").strip()
        meta = meta_index.get((participant, pair_id))
        if not meta:
            continue
        fog_score = scores_by_name.get(meta.get("fog_name") or "")
        nofog_score = scores_by_name.get(meta.get("nofog_name") or "")
        if fog_score is None or nofog_score is None:
            continue

        for condition, score in (("fog", fog_score), ("nofog", nofog_score)):
            for col in QUALITY_COLUMNS:
                row[f"{condition}_{col}"] = f"{getattr(score, col):.6f}"
            placeholder = f"{condition}_evaluate_quality_score_placeholder"
            if placeholder in row:
                row[placeholder] = f"{score.Q_norm:.6f}"

        row[DELTA_COL] = f"{nofog_score.Q_norm - fog_score.Q_norm:.6f}"

    with master_csv.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)


def write_pairwise_summary(
    path: Path, scores: List[PairQualityScores], pair_meta: List[Dict[str, str]]
):
    """pairwise_summary.csv: one row per pair with fog/nofog Q_norm
    (reference analysis/reports/mesh_quality_batch/pairwise_summary.csv)."""
    scores_by_name = {s.name: s for s in scores}
    rows = []
    for m in pair_meta:
        fog = scores_by_name.get(m.get("fog_name") or "")
        nofog = scores_by_name.get(m.get("nofog_name") or "")
        if fog is None or nofog is None:
            continue
        rows.append(
            {
                "participant": m.get("participant", ""),
                "pair_id": m.get("pair_id", ""),
                "fog_Q_norm": f"{fog.Q_norm:.6f}",
                "nofog_Q_norm": f"{nofog.Q_norm:.6f}",
                "delta_nofog_minus_fog": f"{nofog.Q_norm - fog.Q_norm:.6f}",
            }
        )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        writer = csv.DictWriter(
            f,
            fieldnames=["participant", "pair_id", "fog_Q_norm", "nofog_Q_norm",
                        "delta_nofog_minus_fog"],
        )
        writer.writeheader()
        writer.writerows(rows)


# ---------------------------------------------------------------------------
# Paired statistics (fog vs nofog), reference analysis/analysis/*
# ---------------------------------------------------------------------------

@dataclass
class PairedTestResult:
    metric: str
    n: int
    mean_fog: float
    mean_nofog: float
    t_statistic: float
    t_pvalue: float
    wilcoxon_statistic: float
    wilcoxon_pvalue: float
    cohens_d: float


def paired_statistics(metric: str, fog_values, nofog_values) -> PairedTestResult:
    """Paired t-test + Wilcoxon signed-rank + Cohen's d for one metric."""
    import numpy as np
    from scipy import stats

    fog = np.asarray(fog_values, float)
    nofog = np.asarray(nofog_values, float)
    assert fog.shape == nofog.shape
    diff = fog - nofog
    t_stat, t_p = stats.ttest_rel(fog, nofog)
    try:
        w_stat, w_p = stats.wilcoxon(fog, nofog)
    except ValueError:  # all-zero differences
        w_stat, w_p = 0.0, 1.0
    sd = diff.std(ddof=1)
    d = float(diff.mean() / sd) if sd > 0 else 0.0
    return PairedTestResult(
        metric=metric,
        n=len(fog),
        mean_fog=float(fog.mean()),
        mean_nofog=float(nofog.mean()),
        t_statistic=float(t_stat),
        t_pvalue=float(t_p),
        wilcoxon_statistic=float(w_stat),
        wilcoxon_pvalue=float(w_p),
        cohens_d=d,
    )


def write_statistical_report(
    results: List[PairedTestResult], txt_path: Path, csv_path: Optional[Path] = None,
    html_path: Optional[Path] = None,
):
    """statistical_report.txt / statistical_results.csv / HTML dashboard
    (reference analysis/reports/hmd_motion_analysis_final/*)."""
    txt_path = Path(txt_path)
    txt_path.parent.mkdir(parents=True, exist_ok=True)
    lines = ["Paired fog vs no-fog statistics", "=" * 40, ""]
    for r in results:
        sig = "*" if r.t_pvalue < 0.05 else ""
        lines += [
            f"{r.metric} (n={r.n}){sig}",
            f"  fog mean={r.mean_fog:.4f}  nofog mean={r.mean_nofog:.4f}",
            f"  paired t: t={r.t_statistic:.3f}, p={r.t_pvalue:.4f}",
            f"  wilcoxon: W={r.wilcoxon_statistic:.1f}, p={r.wilcoxon_pvalue:.4f}",
            f"  cohen's d={r.cohens_d:.3f}",
            "",
        ]
    txt_path.write_text("\n".join(lines))

    if csv_path is not None:
        with Path(csv_path).open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(vars(results[0]).keys()))
            writer.writeheader()
            for r in results:
                writer.writerow(vars(r))

    if html_path is not None:
        rows = "".join(
            "<tr>" + "".join(
                f"<td>{v:.4g}</td>" if isinstance(v, float) else f"<td>{v}</td>"
                for v in vars(r).values()
            ) + "</tr>"
            for r in results
        )
        header = "".join(f"<th>{k}</th>" for k in vars(results[0]).keys())
        Path(html_path).write_text(
            "<html><body><h1>Fog vs No-Fog paired statistics</h1>"
            f"<table border=1><tr>{header}</tr>{rows}</table></body></html>"
        )
