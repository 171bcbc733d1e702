"""Statistical engine for the fog/no-fog study analyses; the counterpart
of mq3d_tpu/analysis/stats.py (host numpy and scipy, the same code, so the
same numbers).

One shared engine replaces the reference's per-script re-implementations
(reference: analysis/analysis/analyze_hmd_motion_stats.py:100-261,
analyze_controller_motion_stats.py:117-330,
analyze_mesh_quality_stats.py, analyze_combined_motion_stats.py — each
carries its own copy of the normality-gated paired test + Cohen's d +
improvement analysis).  Here the scripts declare *metric registries* and
call into this module.  pandas is imported only inside the functions that
build frames.

Test-selection semantics match the reference exactly:
  * paired design when a participant column pairs both conditions:
      Shapiro-Wilk on the differences -> paired t-test if normal, else
      Wilcoxon signed-rank; one-tailed (fog > nofog) for metrics with a
      directional hypothesis.
  * independent fallback: Shapiro-Wilk per group -> t-test if both normal,
      else Mann-Whitney U.
  * Cohen's d: mean(diff)/std(diff) for paired, pooled-std for independent;
      interpreted negligible/small/medium/large at 0.2/0.5/0.8.
  * improvement analysis: per-participant (fog - nofog) with a one-tailed
      one-sample test against zero.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import stats as sps

FOG, NOFOG = "Fog", "NoFog"


@dataclass(frozen=True)
class MetricSpec:
    """One study metric: CSV column, display name, unit, hypothesis."""

    col: str
    display: str
    unit: str
    one_tailed: bool = False  # directional hypothesis: fog > nofog


def registry(entries: Dict[str, Tuple[str, str]],
             one_tailed: Sequence[str] = ()) -> List[MetricSpec]:
    ot = set(one_tailed)
    return [
        MetricSpec(col, display, unit, one_tailed=col in ot)
        for col, (display, unit) in entries.items()
    ]


# --- metric registries (column names are the on-disk CSV contract;
#     reference analyze_hmd_motion_stats.py:69-84, :120-127) ---------------

HMD_IMPROVEMENT_COLS = (
    "head_avg_angular_speed_rad_s",
    "head_cumulative_radians",
    "cumulative_vertical_rotation_rad",
    "cumulative_horizontal_rotation_rad",
    "viewing_sphere_coverage_percent",
    "viewing_sphere_coverage_with_fov_percent",
)

HMD_METRICS = registry({
    "body_distance_m": ("Total Body Distance", "m"),
    "body_net_displacement_m": ("Net Body Displacement", "m"),
    "body_avg_speed_kmh": ("Average Body Speed", "km/h"),
    "body_peak_speed_kmh": ("Peak Body Speed", "km/h"),
    "head_cumulative_radians": ("Cumulative Head Rotation", "rad"),
    "head_avg_angular_speed_rad_s": ("Average Head Angular Speed", "rad/s"),
    "head_peak_angular_speed_rad_s": ("Peak Head Angular Speed", "rad/s"),
    "yaw_range_rad": ("Yaw Range", "rad"),
    "pitch_range_rad": ("Pitch Range", "rad"),
    "roll_range_rad": ("Roll Range", "rad"),
    "cumulative_vertical_rotation_rad":
        ("Cumulative Vertical Rotation (Pitch)", "rad"),
    "cumulative_horizontal_rotation_rad":
        ("Cumulative Horizontal Rotation (Yaw)", "rad"),
    "viewing_sphere_coverage_percent": ("Viewing Sphere Coverage", "%"),
    "viewing_sphere_coverage_with_fov_percent":
        ("Viewing Sphere Coverage (with FOV)", "%"),
}, one_tailed=HMD_IMPROVEMENT_COLS)

# reference analyze_controller_motion_stats.py:64-88
HAND_METRICS = registry({
    "total_distance_m": ("Total Distance Traveled", "m"),
    "net_displacement_m": ("Net Displacement", "m"),
    "avg_speed_kmh": ("Average Speed", "km/h"),
    "peak_speed_kmh": ("Peak Speed", "km/h"),
    "avg_acceleration_ms2": ("Average Acceleration", "m/s²"),
    "peak_acceleration_ms2": ("Peak Acceleration", "m/s²"),
    "cumulative_rotation_rad": ("Cumulative Rotation", "rad"),
    "avg_angular_speed_rad_s": ("Average Angular Speed", "rad/s"),
    "peak_angular_speed_rad_s": ("Peak Angular Speed", "rad/s"),
    "workspace_volume_m3": ("Workspace Volume", "m³"),
    "jitter_stddev_m": ("Tracking Jitter", "m"),
})

INTER_HAND_METRICS = registry({
    "avg_inter_hand_distance_m": ("Average Inter-Hand Distance", "m"),
    "min_inter_hand_distance_m": ("Minimum Inter-Hand Distance", "m"),
    "max_inter_hand_distance_m": ("Maximum Inter-Hand Distance", "m"),
    "inter_hand_distance_stddev_m": ("Inter-Hand Distance StdDev", "m"),
    "avg_relative_speed_kmh": ("Average Relative Speed", "km/h"),
    "peak_relative_speed_kmh": ("Peak Relative Speed", "km/h"),
    "movement_correlation": ("Movement Correlation", ""),
    "synchronization_score": ("Synchronization Score", ""),
})

# reference analyze_mesh_quality_stats.py (quality score components)
QUALITY_METRICS = registry({
    "Q_raw": ("Quality Score (raw)", ""),
    "Q_norm": ("Quality Score (normalized)", ""),
    "S_geom": ("Geometric Fidelity", ""),
    "S_smooth": ("Smoothness", ""),
    "S_complete": ("Completeness", ""),
    "S_color": ("Color Quality", ""),
    "S_shape": ("Shape Regularity", ""),
    "S_topology": ("Topology Quality", ""),
}, one_tailed=("Q_raw", "Q_norm"))


def infer_condition(df: pd.DataFrame,
                    path_col: str = "capture_path") -> pd.DataFrame:
    """Add a condition column from /Fog/ / /NoFog/ path markers if missing
    (reference analyze_hmd_motion_stats.py:92-95)."""
    if "condition" not in df.columns and path_col in df.columns:
        df = df.copy()
        df["condition"] = df[path_col].map(
            lambda x: FOG if "/Fog/" in str(x)
            else (NOFOG if "/NoFog/" in str(x) else "Unknown")
        )
    return df


def _shapiro_p(x: np.ndarray) -> float:
    if len(x) > 5000 or len(x) < 3 or np.allclose(x, x[0]):
        return 0.05  # reference treats oversize samples as borderline-normal
    return float(sps.shapiro(x).pvalue)


def _effect_label(d: float) -> str:
    a = abs(d)
    return ("negligible" if a < 0.2 else
            "small" if a < 0.5 else
            "medium" if a < 0.8 else "large")


def _one_tailed_from_t(stat: float, p_two: float) -> float:
    """Convert a two-tailed paired-t p-value to one-tailed (fog > nofog)."""
    return p_two / 2.0 if stat > 0 else 1.0 - p_two / 2.0


def paired_values(df: pd.DataFrame, col: str,
                  participant_col: str = "participant"
                  ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(fog, nofog, participants) aligned by participant; empty if unpaired."""
    if participant_col not in df.columns:
        return np.empty(0), np.empty(0), []
    sub = df[[participant_col, "condition", col]].dropna()
    fog = sub[sub["condition"] == FOG].set_index(participant_col)[col]
    nofog = sub[sub["condition"] == NOFOG].set_index(participant_col)[col]
    fog = fog[~fog.index.duplicated(keep="first")]
    nofog = nofog[~nofog.index.duplicated(keep="first")]
    common = fog.index.intersection(nofog.index)
    return (fog[common].to_numpy(float), nofog[common].to_numpy(float),
            list(common))


def condition_tests(df: pd.DataFrame, metrics: Sequence[MetricSpec],
                    participant_col: str = "participant") -> pd.DataFrame:
    """Fog-vs-NoFog comparison for each metric; returns the
    statistical_results.csv table (one row per metric)."""
    import pandas as pd

    rows = []
    fog_df = df[df["condition"] == FOG]
    nofog_df = df[df["condition"] == NOFOG]

    for m in metrics:
        if m.col not in df.columns:
            continue
        fog = fog_df[m.col].dropna().to_numpy(float)
        nofog = nofog_df[m.col].dropna().to_numpy(float)
        if len(fog) < 2 or len(nofog) < 2:
            continue

        desc = {}
        for name, x in (("fog", fog), ("nofog", nofog)):
            desc.update({
                f"{name}_n": len(x),
                f"{name}_mean": float(np.mean(x)),
                f"{name}_std": float(np.std(x, ddof=1)),
                f"{name}_median": float(np.median(x)),
                f"{name}_q25": float(np.quantile(x, 0.25)),
                f"{name}_q75": float(np.quantile(x, 0.75)),
            })

        fp, np_, participants = paired_values(df, m.col, participant_col)
        n_pairs: Optional[int] = None
        if len(participants) >= 2:
            diff = fp - np_
            alternative = "greater" if m.one_tailed else "two-sided"
            if _shapiro_p(diff) > 0.05:
                stat, p_two = sps.ttest_rel(fp, np_)
                stat = float(stat)
                if m.one_tailed:
                    p = _one_tailed_from_t(stat, float(p_two))
                    test = "Paired t-test (one-tailed: fog > nofog)"
                else:
                    p = float(p_two)
                    test = "Paired t-test"
            else:
                try:
                    stat, p = sps.wilcoxon(fp, np_, alternative=alternative)
                    stat, p = float(stat), float(p)
                except ValueError:  # all-zero differences
                    stat, p = 0.0, 1.0
                test = (f"Wilcoxon signed-rank ({alternative})"
                        if m.one_tailed else "Wilcoxon signed-rank")
            sd = float(np.std(diff, ddof=1))
            d = float(np.mean(diff) / sd) if sd > 0 else 0.0
            n_pairs = len(participants)
        else:
            if _shapiro_p(fog) > 0.05 and _shapiro_p(nofog) > 0.05:
                stat, p = sps.ttest_ind(fog, nofog)
                test = "Independent samples t-test"
            else:
                stat, p = sps.mannwhitneyu(fog, nofog,
                                           alternative="two-sided")
                test = "Mann-Whitney U"
            stat, p = float(stat), float(p)
            pooled = np.sqrt(
                ((len(fog) - 1) * np.var(fog, ddof=1)
                 + (len(nofog) - 1) * np.var(nofog, ddof=1))
                / (len(fog) + len(nofog) - 2)
            )
            d = float((np.mean(fog) - np.mean(nofog)) / pooled) \
                if pooled > 0 else 0.0

        rows.append({
            "metric": m.display, "unit": m.unit, **desc,
            "test": test, "n_pairs": n_pairs,
            "statistic": stat, "p_value": p, "significant": p < 0.05,
            "cohens_d": d, "effect_size": _effect_label(d),
        })
    return pd.DataFrame(rows)


@dataclass
class Improvement:
    metric: MetricSpec
    participants: List[str]
    differences: np.ndarray
    nofog_mean: float
    test: str = ""
    statistic: float = 0.0
    p_value: float = 1.0
    cohens_d: float = 0.0

    @property
    def row(self) -> dict:
        diff = self.differences
        return {
            "metric": self.metric.display, "unit": self.metric.unit,
            "n_participants": len(self.participants),
            "mean_improvement": float(diff.mean()),
            "std_improvement": float(diff.std(ddof=1)),
            "median_improvement": float(np.median(diff)),
            "min_improvement": float(diff.min()),
            "max_improvement": float(diff.max()),
            "improvement_percent": (
                float(diff.mean() / abs(self.nofog_mean) * 100)
                if abs(self.nofog_mean) > 1e-10 else 0.0
            ),
            "test": self.test, "statistic": self.statistic,
            "p_value": self.p_value, "significant": self.p_value < 0.05,
            "cohens_d": self.cohens_d,
            "effect_size": _effect_label(self.cohens_d),
        }


def improvement_analysis(df: pd.DataFrame, metrics: Sequence[MetricSpec],
                         participant_col: str = "participant"
                         ) -> List[Improvement]:
    """Per-participant (fog - nofog) improvements for the directional
    metrics, with one-tailed one-sample tests against zero
    (reference analyze_hmd_motion_stats.py:436-599)."""
    out = []
    for m in metrics:
        if not m.one_tailed or m.col not in df.columns:
            continue
        fp, np_, participants = paired_values(df, m.col, participant_col)
        if len(participants) < 2:
            continue
        diff = fp - np_
        if _shapiro_p(diff) > 0.05:
            stat, p_two = sps.ttest_1samp(diff, 0.0)
            stat = float(stat)
            p = _one_tailed_from_t(stat, float(p_two))
            test = "One-sample t-test (one-tailed: improvement > 0)"
        else:
            try:
                stat, p = sps.wilcoxon(diff, alternative="greater")
                stat, p = float(stat), float(p)
            except ValueError:
                stat, p = 0.0, 1.0
            test = "Wilcoxon signed-rank (one-tailed: improvement > 0)"
        sd = float(diff.std(ddof=1))
        out.append(Improvement(
            metric=m, participants=participants, differences=diff,
            nofog_mean=float(np_.mean()), test=test, statistic=stat,
            p_value=p, cohens_d=float(diff.mean() / sd) if sd > 0 else 0.0,
        ))
    return out


def improvements_frame(improvements: List[Improvement]) -> pd.DataFrame:
    import pandas as pd

    return pd.DataFrame([i.row for i in improvements])


def wilcoxon_hypothesis(assisted: pd.Series, unassisted: pd.Series,
                        alternative: str, name: str) -> dict:
    """One named Wilcoxon signed-rank hypothesis test (survey H4-H7 flow;
    reference analyze_survey_hypotheses.py:57-137)."""
    import pandas as pd

    paired = pd.DataFrame({"a": assisted, "u": unassisted}).dropna()
    n = len(paired)
    base = {"test_name": name, "n": n, "alternative": alternative}
    if n < 2:
        return {**base, "statistic": float("nan"), "p_value": float("nan"),
                "significant": False, "median_assisted": float("nan"),
                "median_unassisted": float("nan"), "effect_size_r": float("nan")}
    a, u = paired["a"].to_numpy(float), paired["u"].to_numpy(float)
    try:
        stat, p = sps.wilcoxon(a, u, alternative=alternative)
        stat, p = float(stat), float(p)
    except ValueError:
        stat, p = 0.0, 1.0
    # effect size r = Z / sqrt(N) via normal approximation of W
    mean_w = n * (n + 1) / 4.0
    sd_w = np.sqrt(n * (n + 1) * (2 * n + 1) / 24.0)
    z = (stat - mean_w) / sd_w if sd_w > 0 else 0.0
    return {
        **base, "statistic": stat, "p_value": p, "significant": p < 0.05,
        "median_assisted": float(np.median(a)),
        "median_unassisted": float(np.median(u)),
        "effect_size_r": float(abs(z) / np.sqrt(n)),
    }
