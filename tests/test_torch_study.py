"""The port's study-analysis engine and report writers against the JAX
package's (mq3d_tpu_torch/analysis/{stats,report}.py).

Both packages run the same numpy, scipy and pandas code on the same frames,
so every table is compared exactly (assert_frame_equal with
check_exact=True) and every written file byte for byte.  The frames are
those of tests/test_analysis_tree.py (same seeds, same generators): 10
fog/no-fog pairs with a fog effect on the directional metrics.  The
functions that make them are shared with the study CLI tests.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch
from pandas.testing import assert_frame_equal
from scipy import stats as sps

from mq3d_tpu.analysis import report as jreport
from mq3d_tpu.analysis import stats as jstats
from mq3d_tpu_torch.analysis import report as treport
from mq3d_tpu_torch.analysis import stats as tstats

torch.set_num_threads(1)

N_PAIRS = 10


def hmd_frame() -> pd.DataFrame:
    """tests/test_analysis_tree.py's hmd_df."""
    rng = np.random.default_rng(7)
    rows = []
    for i in range(N_PAIRS):
        base = {
            "body_distance_m": rng.uniform(5, 20),
            "body_net_displacement_m": rng.uniform(0.5, 3),
            "body_avg_speed_kmh": rng.uniform(0.5, 2),
            "body_peak_speed_kmh": rng.uniform(2, 6),
            "head_cumulative_radians": rng.uniform(10, 20),
            "head_avg_angular_speed_rad_s": rng.uniform(0.5, 1.5),
            "head_peak_angular_speed_rad_s": rng.uniform(2, 5),
            "yaw_range_rad": rng.uniform(2, 6),
            "pitch_range_rad": rng.uniform(1, 3),
            "roll_range_rad": rng.uniform(0.5, 2),
            "cumulative_vertical_rotation_rad": rng.uniform(10, 25),
            "cumulative_horizontal_rotation_rad": rng.uniform(8, 20),
            "viewing_sphere_coverage_percent": rng.uniform(40, 70),
            "viewing_sphere_coverage_with_fov_percent": rng.uniform(60, 80),
        }
        for cond, boost in (("Fog", 1.25), ("NoFog", 1.0)):
            row = {"participant": f"P{i:02d}", "condition": cond,
                   "capture_name": f"cap_{i}_{cond.lower()}",
                   "capture_path": f"/data/{cond}/cap_{i}",
                   "num_samples": 1000, "duration_seconds": 60.0,
                   "sampling_hz": 16.7}
            for k, v in base.items():
                factor = boost if "rotation" in k or "coverage" in k \
                    or "head" in k else 1.0
                row[k] = v * factor * rng.uniform(0.95, 1.05)
            rows.append(row)
    return pd.DataFrame(rows)


def quality_frame() -> pd.DataFrame:
    """tests/test_analysis_tree.py's quality_df."""
    rng = np.random.default_rng(11)
    rows = []
    for i in range(N_PAIRS):
        for cond in ("fog", "nofog"):
            boost = 1.2 if cond == "fog" else 1.0
            rows.append({
                "name": f"P{i:02d}_20260101_{100000 + i:06d}__"
                        f"20260101_{110000 + i:06d}_{cond}",
                "Q_raw": rng.uniform(0.4, 0.7) * boost,
                "Q_norm": rng.uniform(0.2, 0.8) * boost,
                "S_geom": rng.uniform(0.5, 0.9),
                "S_smooth": rng.uniform(0.4, 0.8),
                "S_complete": rng.uniform(0.6, 1.0),
                "S_color": rng.uniform(0.5, 0.9),
                "S_shape": rng.uniform(0.3, 0.7),
                "S_topology": rng.uniform(0.5, 1.0),
                "S_bonuses": rng.uniform(0, 0.2),
                "num_vertices": int(rng.uniform(1e5, 1e6)),
                "num_triangles": int(rng.uniform(2e5, 2e6)),
                "component_count": int(rng.integers(1, 30)),
                "boundary_edge_ratio": rng.uniform(0, 0.2),
                "degenerate_triangles": int(rng.integers(0, 50)),
                "is_manifold": int(rng.integers(0, 2)),
                "is_watertight": int(rng.integers(0, 2)),
                "mean_aspect_ratio": rng.uniform(1.2, 3.0),
                "surface_roughness": rng.uniform(0.001, 0.05),
            })
    return pd.DataFrame(rows)


def controller_frame(hmd_df: pd.DataFrame) -> pd.DataFrame:
    """tests/test_analysis_tree.py's controller_df: two hand rows and one
    inter-hand row per session."""
    rng = np.random.default_rng(13)
    rows = []
    for _, r in hmd_df.iterrows():
        keys = {k: r[k] for k in ("capture_name", "capture_path", "participant",
                                  "condition")}
        for hand in ("left", "right"):
            rows.append({
                **keys, "hand": hand,
                "total_distance_m": rng.uniform(20, 80),
                "net_displacement_m": rng.uniform(0.2, 1),
                "avg_speed_kmh": rng.uniform(1, 4),
                "peak_speed_kmh": rng.uniform(5, 15),
                "avg_acceleration_ms2": rng.uniform(1, 5),
                "peak_acceleration_ms2": rng.uniform(10, 40),
                "cumulative_rotation_rad": rng.uniform(50, 200),
                "avg_angular_speed_rad_s": rng.uniform(1, 4),
                "peak_angular_speed_rad_s": rng.uniform(5, 20),
                "workspace_volume_m3": rng.uniform(0.1, 1),
                "jitter_stddev_m": rng.uniform(0.001, 0.01),
                "avg_inter_hand_distance_m": np.nan,
                "synchronization_score": np.nan,
            })
        rows.append({
            **keys, "hand": np.nan,
            "avg_inter_hand_distance_m": rng.uniform(0.2, 0.6),
            "min_inter_hand_distance_m": rng.uniform(0.01, 0.1),
            "max_inter_hand_distance_m": rng.uniform(0.8, 1.5),
            "inter_hand_distance_stddev_m": rng.uniform(0.05, 0.2),
            "avg_relative_speed_kmh": rng.uniform(1, 3),
            "peak_relative_speed_kmh": rng.uniform(5, 12),
            "movement_correlation": rng.uniform(-0.2, 0.9),
            "synchronization_score": rng.uniform(0.3, 0.9),
        })
    return pd.DataFrame(rows)


def survey_frame() -> pd.DataFrame:
    """tests/test_analysis_tree.py's survey_df (14 participants)."""
    rng = np.random.default_rng(5)
    n = 14
    df = pd.DataFrame({
        "Participant": [f"P{i}" for i in range(n)],
        "Age": rng.integers(20, 40, n),
        "Gender": rng.choice(["F", "M", "NB"], n),
        "Nationality": rng.choice(["DE", "FR", "IT"], n),
        "Education - Highest Obtained": rng.choice(["BSc", "MSc", "PhD"], n),
        "Education - Currently Pursued": rng.choice(["MSc", "PhD", "None"], n),
        "Experience using VR Tools (yrs)": rng.uniform(0, 10, n),
        "Experience with Video Games (yrs)": rng.uniform(0, 20, n),
        "Laterality": rng.choice(["Right", "Left"], n),
        "Glass-wearer": rng.choice(["Yes", "No"], n),
        "Wore glasses during experiment": rng.choice(["Yes", "No"], n),
        "SUS_Score_sphere": rng.uniform(60, 95, n),
    })
    for base in ("FSS_FlowTotal", "TLX_1", "TLX_2", "TLX_4", "TLX_6"):
        df[f"{base}_sphere"] = rng.uniform(2, 6, n)
        df[f"{base}_nosphere"] = rng.uniform(2, 6, n)
    for i in (11, 12, 13, 14):
        df[f"IPQ_{i}_sphere"] = rng.integers(1, 8, n)
        df[f"IPQ_{i}_nosphere"] = rng.integers(1, 8, n)
    return df


def quality_pairs(df: pd.DataFrame) -> pd.DataFrame:
    """analyze_mesh_quality_stats.load_and_pair's columns, in memory."""
    df = df.copy()
    df["participant"] = df["name"].str.rsplit("_", n=1).str[0]
    df["condition"] = np.where(df["name"].str.endswith("_nofog"), "NoFog", "Fog")
    return df


@pytest.fixture(scope="module")
def frames():
    hmd = hmd_frame()
    ctl = controller_frame(hmd)
    return {
        "hmd": (hmd, "HMD_METRICS"),
        "hmd_unpaired": (hmd.drop(columns=["participant"]), "HMD_METRICS"),
        "quality": (quality_pairs(quality_frame()), "QUALITY_METRICS"),
        "hand": (ctl[ctl["hand"].notna()], "HAND_METRICS"),
        "interhand": (ctl[ctl["avg_inter_hand_distance_m"].notna()],
                      "INTER_HAND_METRICS"),
    }


REGISTRIES = ["HMD_METRICS", "HAND_METRICS", "INTER_HAND_METRICS",
              "QUALITY_METRICS"]


@pytest.mark.parametrize("name", REGISTRIES)
def test_registries_match(name):
    j, t = getattr(jstats, name), getattr(tstats, name)
    assert [dataclasses.astuple(m) for m in t] == [dataclasses.astuple(m) for m in j]
    assert tstats.HMD_IMPROVEMENT_COLS == jstats.HMD_IMPROVEMENT_COLS
    assert (tstats.FOG, tstats.NOFOG) == (jstats.FOG, jstats.NOFOG)
    entries = {m.col: (m.display, m.unit) for m in j}
    one = [m.col for m in j if m.one_tailed]
    assert tstats.registry(entries, one) == [tstats.MetricSpec(*dataclasses.astuple(m))
                                             for m in j]


@pytest.mark.parametrize("case", ["hmd", "hmd_unpaired", "quality", "hand", "interhand"])
def test_condition_tests_match(frames, case):
    df, reg = frames[case]
    j = jstats.condition_tests(df, getattr(jstats, reg))
    t = tstats.condition_tests(df, getattr(tstats, reg))
    assert len(t) == len(getattr(tstats, reg))
    assert_frame_equal(t, j, check_exact=True)
    if case == "hmd_unpaired":  # the independent-sample fallback ran
        assert t["n_pairs"].isna().all()
        assert t["test"].str.contains("Independent|Mann-Whitney").all()
    else:
        assert (t["n_pairs"] == N_PAIRS).all()


def test_paired_t_equals_scipy(frames):
    """Every paired t-test row's statistic and p are scipy's ttest_rel on
    the paired columns (one-tailed rows: halved toward fog > nofog)."""
    df, _ = frames["hmd"]
    res = tstats.condition_tests(df, tstats.HMD_METRICS)
    checked = 0
    for m, (_, r) in zip(tstats.HMD_METRICS, res.iterrows()):
        if "t-test" not in r["test"]:
            continue
        fog, nofog, _ = tstats.paired_values(df, m.col)
        t, p = sps.ttest_rel(fog, nofog)
        if m.one_tailed:
            p = p / 2 if t > 0 else 1 - p / 2
        assert r["statistic"] == float(t) and r["p_value"] == float(p), m.col
        checked += 1
    assert checked >= 5


@pytest.mark.parametrize("case", ["hmd", "quality"])
def test_improvement_analysis_matches(frames, case):
    df, reg = frames[case]
    j = jstats.improvement_analysis(df, getattr(jstats, reg))
    t = tstats.improvement_analysis(df, getattr(tstats, reg))
    assert len(t) == len(j) > 0
    for a, b in zip(j, t):
        assert dataclasses.astuple(b.metric) == dataclasses.astuple(a.metric)
        assert b.participants == a.participants
        np.testing.assert_array_equal(b.differences, a.differences)
        assert b.row == a.row
    assert_frame_equal(tstats.improvements_frame(t), jstats.improvements_frame(j),
                       check_exact=True)


def test_paired_values_and_infer_condition_match(frames):
    df, _ = frames["hmd"]
    for col in ("body_distance_m", "viewing_sphere_coverage_percent"):
        for a, b in zip(jstats.paired_values(df, col), tstats.paired_values(df, col)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    empty = tstats.paired_values(df.drop(columns=["participant"]), "body_distance_m")
    assert [len(x) for x in empty] == [0, 0, 0]
    paths = pd.DataFrame({"capture_path": ["/x/Fog/a", "/x/NoFog/b", "/c", None]})
    out = tstats.infer_condition(paths)
    assert_frame_equal(out, jstats.infer_condition(paths), check_exact=True)
    assert list(out["condition"]) == ["Fog", "NoFog", "Unknown", "Unknown"]
    assert tstats.infer_condition(df) is df  # a condition column is kept


@pytest.mark.parametrize("alternative", ["greater", "less", "two-sided"])
@pytest.mark.parametrize("kind", ["shifted", "ties", "zero", "short"])
def test_wilcoxon_hypothesis_matches(alternative, kind):
    rng = np.random.default_rng(3)
    a = pd.Series(rng.uniform(4, 7, 14))
    u = {"shifted": a - rng.uniform(0.5, 1.5, 14),
         "ties": a.round(0) - rng.integers(0, 3, 14),
         "zero": a.copy(),
         "short": pd.Series([np.nan] * 13 + [1.0])}[kind]
    j = jstats.wilcoxon_hypothesis(a, u, alternative, "H")
    t = tstats.wilcoxon_hypothesis(a, u, alternative, "H")
    assert t.keys() == j.keys()
    for k in j:
        assert t[k] == j[k] or (t[k] != t[k] and j[k] != j[k]), k
    if kind == "shifted":
        w, p = sps.wilcoxon(a.to_numpy(), u.to_numpy(), alternative=alternative)
        assert (t["statistic"], t["p_value"]) == (float(w), float(p))


def _write_all(rep, stats_mod, df, reg, out, with_images):
    stats_df = stats_mod.condition_tests(df, reg)
    imps = stats_mod.improvement_analysis(df, reg)
    rep.write_statistical_report(stats_df, df, imps, out / "report.txt")
    rep.write_statistical_report(stats_df, df, [], out / "plain.txt", title="T")
    rep.write_latex_table(stats_df, out / "table.tex", caption="Fog & NoFog_%",
                          label="tab:x")
    rep.write_latex_table(stats_df[["metric", "p_value"]], out / "bare.tex")
    sections = [{"title": "Stats", "text": "paired", "table": stats_df,
                 "sig_col": "significant"},
                {"title": "Empty", "table": stats_df.iloc[0:0]}]
    if with_images:
        sections.append({"title": "Figures", "images_b64": ["aGVsbG8="],
                         "image_files": [out / "fig.png"]})
    rep.write_html_dashboard(out / "dash.html", "Study", sections)


@pytest.mark.parametrize("case", ["hmd", "hmd_unpaired", "quality"])
def test_writers_match_byte_for_byte(frames, tmp_path, case):
    df, reg = frames[case]
    files = {}
    for pkg, rep, st in (("jax", jreport, jstats), ("port", treport, tstats)):
        out = tmp_path / pkg
        _write_all(rep, st, df, getattr(st, reg), out, case == "hmd")
        files[pkg] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert list(files["port"]) == list(files["jax"])
    assert len(files["port"]) == 5
    for name, blob in files["jax"].items():
        assert files["port"][name] == blob, name
