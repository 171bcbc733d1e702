"""mq3d_tpu_torch's host tools against the JAX package's, on the CPU:
eval/motion_stats.py, the two motion-stats CLIs, the camera-trajectory
visualiser, analysis/sessions.py and the six session CLIs.

The port's CLIs run as main(argv); the JAX scripts' main() reads sys.argv,
patched here, in the same process.  Inputs are made from seeded numpy
draws.  Tolerances: none.  Statistics are equal value for value (the same
numpy code), CSV, report and PLY files equal byte for byte, printed output
equal once each copy's own path is replaced by a placeholder, and the
session trees the in-place tools leave behind equal in names and bytes.
"""

import dataclasses
import importlib
import shutil
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from mq3d_tpu.analysis import sessions as jax_sessions
from mq3d_tpu.eval import motion_stats as jax_ms
from mq3d_tpu_torch.analysis import sessions
from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.eval import motion_stats
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.scripts import (
    analyze_duration_discrepancy,
    analyze_fog_no_fog_mapping,
    analyze_recording_lengths,
    compute_controller_motion_stats,
    compute_hmd_motion_stats,
    find_optimal_timestamp_offset,
    rename_timestamps,
    trim_recordings,
    visualize_camera_trajectories,
)
from mq3d_tpu_torch.testing.synthetic import SyntheticSceneConfig, write_synthetic_project

torch.set_num_threads(1)


def jax_script(name: str, argv, monkeypatch):
    """Run scripts/<name>.py's main() with sys.argv set to argv."""
    module = importlib.import_module(f"scripts.{name}")
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + [str(a) for a in argv])
    return module.main()


def _track(rng, n, ms=False, repeat=False):
    """A pose track: timestamps at ~90 Hz with jitter, a random walk of
    positions and of unit quaternions."""
    t = 1000.0 + np.cumsum(rng.uniform(0.008, 0.014, n))
    if repeat and n > 3:
        t[2] = t[1]  # a repeated timestamp (dt = 0 becomes NaN)
    if ms:
        t = t * 1000.0
    pos = np.cumsum(rng.normal(0, 0.01, (n, 3)), axis=0)
    q = np.cumsum(rng.normal(0, 0.05, (n, 4)), axis=0) + np.array([0, 0, 0, 3.0])
    return t, pos, q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("n,ms,repeat", [(1, False, False), (2, False, False),
                                         (5, True, False), (300, False, True),
                                         (300, True, False)])
def test_motion_stats_match_jax(n, ms, repeat):
    t, pos, q = _track(np.random.default_rng(n), n, ms, repeat)
    with warnings.catch_warnings():
        # numpy warns on the empty and all-NaN reductions of the tiny
        # tracks, in the JAX package's code too.
        warnings.simplefilter("ignore")
        got = motion_stats.compute_motion_stats(t, pos, q)
        want = jax_ms.compute_motion_stats(t, pos, q)
    np.testing.assert_equal(dataclasses.asdict(got), dataclasses.asdict(want))
    row = motion_stats.hmd_summary_row(got, "c", "/p", participant="P1", condition="Fog")
    np.testing.assert_equal(row, jax_ms.hmd_summary_row(want, "c", "/p", participant="P1",
                                                        condition="Fog"))
    row = motion_stats.controller_summary_row(got, "c", "/p", "left")
    np.testing.assert_equal(row, jax_ms.controller_summary_row(want, "c", "/p", "left"))


@pytest.mark.parametrize("shift", [0.0, 0.5, 100.0])
def test_inter_hand_stats_match_jax(shift):
    rng = np.random.default_rng(7)
    lt, lp, _ = _track(rng, 200)
    rt, rp, _ = _track(rng, 180)
    rt = rt + shift  # 100 s apart: no overlap, all zeros
    got = motion_stats.inter_hand_stats(lt, lp, rt, rp)
    assert got == jax_ms.inter_hand_stats(lt, lp, rt, rp)
    assert (got["avg_inter_hand_distance_m"] == 0.0) == (shift == 100.0)


def _write_pose_csv(path: Path, t_s, pos, q, hand=None):
    """A pose CSV as the capture app writes it (unix_time in ms)."""
    lines = ["unix_time," + ("hand," if hand is not None else "")
             + "pos_x,pos_y,pos_z,rot_x,rot_y,rot_z,rot_w"]
    for i in range(len(t_s)):
        h = "" if hand is None else f"{hand[i]},"
        lines.append(f"{int(round(t_s[i] * 1000))},{h}" + ",".join(
            repr(float(v)) for v in (*pos[i], *q[i])))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def motion_sessions(tmp_path_factory):
    """Three fog/nofog pairs (.../Fog/sN, .../NoFog/sN), each with an HMD
    track; controllers in one combined CSV for the fog sessions and in two
    per-hand CSVs for the others (one nofog session has none)."""
    base = tmp_path_factory.mktemp("motion")
    rng = np.random.default_rng(11)
    fog, nofog = [], []
    for i in range(3):
        for cond, out in (("Fog", fog), ("NoFog", nofog)):
            s = base / cond / f"s{i}"
            s.mkdir(parents=True)
            _write_pose_csv(s / "hmd_poses.csv", *_track(rng, 240))
            if cond == "Fog":
                tl, pl, ql = _track(rng, 150)
                tr, pr, qr = _track(rng, 140)
                order = np.argsort(np.concatenate([tl, tr]), kind="stable")
                cat = [np.concatenate(a)[order] for a in ((tl, tr), (pl, pr), (ql, qr))]
                hand = np.array(["left"] * 150 + ["Right"] * 140)[order]
                _write_pose_csv(s / "controller_poses.csv", *cat, hand=hand)
            elif i > 0:
                for h in ("left", "right"):
                    _write_pose_csv(s / f"{h}_controller_poses.csv", *_track(rng, 120))
            out.append(s)
    pairs = base / "pairs.csv"
    pairs.write_text("fog_dir,nofog_dir\n" + "".join(
        f"{f},{n}\n" for f, n in zip(fog, nofog)))
    return base, fog + nofog, pairs


def test_stats_from_pose_csv_matches_jax(motion_sessions):
    _, sess, _ = motion_sessions
    for s in sess[:2]:
        np.testing.assert_equal(dataclasses.asdict(motion_stats.stats_from_pose_csv(s / "hmd_poses.csv")),
                                dataclasses.asdict(jax_ms.stats_from_pose_csv(s / "hmd_poses.csv")))


def test_compute_hmd_motion_stats_cli_matches_jax(motion_sessions, tmp_path, capsys, monkeypatch):
    base, sess, pairs = motion_sessions
    out = {}
    for who in ("port", "jax"):
        argv = [*sess, "--pairs", pairs, "--report_dir", tmp_path / who / "report",
                "--summary-csv", tmp_path / who / "hmd_all_summary.csv",
                "--participant", "A", "--participant", "B"]
        if who == "port":
            compute_hmd_motion_stats.main([str(a) for a in argv])
        else:
            jax_script("compute_hmd_motion_stats", argv, monkeypatch)
        out[who] = capsys.readouterr().out.replace(str(tmp_path / who), "<out>")
    assert out["port"] == out["jax"]
    assert "Reports written" in out["port"]
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                   if p.is_file())
    assert [str(f) for f in files] == [
        "hmd_all_summary.csv", "report/statistical_report.html",
        "report/statistical_report.txt", "report/statistical_results.csv"]
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_compute_controller_motion_stats_cli_matches_jax(motion_sessions, tmp_path, capsys,
                                                          monkeypatch):
    _, sess, _ = motion_sessions
    out = {}
    for who in ("port", "jax"):
        argv = [*sess, "--summary-csv", tmp_path / who / "controller_all_summary.csv",
                "--participant", "A"]
        if who == "port":
            compute_controller_motion_stats.main([str(a) for a in argv])
        else:
            jax_script("compute_controller_motion_stats", argv, monkeypatch)
        out[who] = capsys.readouterr().out.replace(str(tmp_path / who), "<out>")
    assert out["port"] == out["jax"]
    assert '"inter_hand"' in out["port"]
    got = (tmp_path / "port/controller_all_summary.csv").read_bytes()
    assert got == (tmp_path / "jax/controller_all_summary.csv").read_bytes()
    # 3 fog sessions (2 hands + inter-hand) and 2 nofog sessions with hands.
    assert got.count(b"\n") == 1 + 5 * 3


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A small synthetic capture with RGB frames for the colour trajectories."""
    d = tmp_path_factory.mktemp("tools_capture") / "session"
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=8))
    io = DataIO(d)
    for side in Side:
        ts = io.color.get_yuv_timestamps(side)
        io.color.save_bgr_batch(np.zeros((len(ts), 4, 6, 3), np.uint8), side, ts)
    return d


def _copies(src: Path, tmp_path: Path):
    a, b = tmp_path / "port" / src.name, tmp_path / "jax" / src.name
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return a, b


def _tree(root: Path):
    return {str(p.relative_to(root)): (p.read_bytes() if p.is_file() else None)
            for p in sorted(root.rglob("*"))}


def test_visualize_camera_trajectories_matches_jax(capture, tmp_path, capsys, monkeypatch):
    a, b = _copies(capture, tmp_path)
    visualize_camera_trajectories.main(["--project_dir", str(a), "--interval", "3"])
    out_a = capsys.readouterr().out.replace(str(a), "<session>")
    jax_script("visualize_camera_trajectories", ["--project_dir", b, "--interval", "3"],
               monkeypatch)
    out_b = capsys.readouterr().out.replace(str(b), "<session>")
    assert out_a == out_b
    # Four trajectories of 3 glyphs (frames 0, 3, 6), 5 vertices each.
    assert "(60 points)" in out_a
    assert _tree(a) == _tree(b)


def test_visualize_camera_trajectories_output_flag(capture, tmp_path, monkeypatch):
    visualize_camera_trajectories.main(["--project_dir", str(capture), "--output",
                                        str(tmp_path / "port.ply")])
    jax_script("visualize_camera_trajectories", ["--project_dir", capture, "--output",
                                                 tmp_path / "jax.ply"], monkeypatch)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


# The session tools in the order a user would run them: read-only reports,
# a timestamp shift of the left depth, the offset search that finds it,
# then a trim (which rewrites the CSVs and drops the caches).
SESSION_STEPS = [
    ("analyze_recording_lengths", lambda s: [s]),
    ("analyze_duration_discrepancy", lambda s: [s]),
    ("rename_timestamps", lambda s: ["--project_dir", s, "--offset_ms", "7",
                                     "--modalities", "left_depth"]),
    ("rename_timestamps", lambda s: ["--project_dir", s, "--offset_ms", "-3", "--dry-run"]),
    ("find_optimal_timestamp_offset", lambda s: ["--project_dir", s, "--target",
                                                 "left_camera_raw", "--tolerance_ms", "2"]),
    ("trim_recordings", lambda s: [s, "--max-frames", "5", "--dry-run"]),
    ("trim_recordings", lambda s: [s, "--max-frames", "5"]),
    ("analyze_recording_lengths", lambda s: [s]),
    ("trim_recordings", lambda s: [s, "--max-duration-ms", "60"]),
]
PORT_SCRIPTS = {
    "analyze_recording_lengths": analyze_recording_lengths,
    "analyze_duration_discrepancy": analyze_duration_discrepancy,
    "find_optimal_timestamp_offset": find_optimal_timestamp_offset,
    "rename_timestamps": rename_timestamps,
    "trim_recordings": trim_recordings,
}


def test_session_tools_match_jax(capture, tmp_path, capsys, monkeypatch):
    a, b = _copies(capture, tmp_path)
    # A dataset cache, which trimming must remove.
    DataIO(a).depth.load_depth_dataset(Side.LEFT)
    DataIO(b).depth.load_depth_dataset(Side.LEFT)
    capsys.readouterr()
    for name, argv in SESSION_STEPS:
        PORT_SCRIPTS[name].main([str(x) for x in argv(a)])
        out_a = capsys.readouterr().out.replace(str(a), "<session>")
        jax_script(name, argv(b), monkeypatch)
        out_b = capsys.readouterr().out.replace(str(b), "<session>")
        assert out_a == out_b, name
        assert _tree(a) == _tree(b), name
        if name == "find_optimal_timestamp_offset":
            assert out_a.strip() == '{"best_offset_ms": -5.0, "best_overlap": 1.0}'
    tree = _tree(a)
    assert sorted(k for k in tree if k.startswith("left_depth/")) == [
        f"left_depth/{1_000_000 + 33 * i + 7}.raw" for i in range(2)]
    assert "dataset" not in tree and "cache" not in tree


def test_sessions_module_matches_jax(capture):
    got = sessions.analyze_recording_lengths(capture)
    want = jax_sessions.analyze_recording_lengths(capture)
    assert [dataclasses.asdict(m) for m in got] == [dataclasses.asdict(m) for m in want]
    assert got[-1].name == "hmd_poses" and got[-1].n_frames == 15
    assert (sessions.analyze_duration_discrepancy(capture)
            == jax_sessions.analyze_duration_discrepancy(capture))
    for offsets in (None, np.arange(-40, 41, 1)):
        assert (sessions.find_optimal_timestamp_offset(capture, offsets_ms=offsets)
                == jax_sessions.find_optimal_timestamp_offset(capture, offsets_ms=offsets))
    assert (sessions.trim_recording(capture, max_frames=3, dry_run=True)
            == jax_sessions.trim_recording(capture, max_frames=3, dry_run=True))


def test_analyze_fog_no_fog_mapping_matches_jax(tmp_path, capsys, monkeypatch):
    base = tmp_path / "study"
    for participant, names in (("P02", ["a_fog", "a_nofog", "b_fog", "c_nofog"]),
                               ("P01", ["x_nofog", "x_fog", "notes"]), ("P03", [])):
        for n in names:
            (base / participant / n).mkdir(parents=True)
        (base / participant).mkdir(parents=True, exist_ok=True)
    (base / "readme.txt").write_text("not a participant")
    analyze_fog_no_fog_mapping.main(["--base_dir", str(base), "--output",
                                     str(tmp_path / "port.csv")])
    out_a = capsys.readouterr().out.replace("port.csv", "<out>")
    jax_script("analyze_fog_no_fog_mapping", ["--base_dir", base, "--output",
                                              tmp_path / "jax.csv"], monkeypatch)
    out_b = capsys.readouterr().out.replace("jax.csv", "<out>")
    assert out_a == out_b and "2 pairs written" in out_a
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    # Default output under --base_dir; no pairs: a warning and no file.
    analyze_fog_no_fog_mapping.main(["--base_dir", str(base)])
    assert (base / "master_fog_no_fog_report.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    empty = tmp_path / "empty"
    (empty / "P1" / "only_fog").mkdir(parents=True)
    analyze_fog_no_fog_mapping.main(["--base_dir", str(empty)])
    assert "No fog/nofog pairs" in capsys.readouterr().out
    assert not (empty / "master_fog_no_fog_report.csv").exists()
