"""The port's study CLIs (mq3d_tpu_torch/scripts/analyze_*,
generate_*) against the JAX package's scripts.

Each case writes the same inputs into two directories, runs the JAX
script's main there and the port's main in the other (in this process, as
tests/test_analysis_tree.py runs them), and compares:
  * the set of files under each directory (inputs included, so an input
    rewritten in place, --merge-to-master's master CSV, is compared too);
  * every file byte for byte: CSV, text, LaTeX, PNG, PDF and HTML with
    base64 figures;
  * standard output, once each directory's path is replaced by "<root>".
matplotlib writes the same PNG bytes for the same figure here; its PDFs
carry a creation date, which SOURCE_DATE_EPOCH pins for both packages.

The inputs are tests/test_analysis_tree.py's frames (tests/test_torch_study.py
builds them).  The 300-dpi grids of the full 14-metric HMD frame take
about 15 s per package, so the HMD variants (--median, --merge-to-master,
--exclude-participant, the median alias) run on a frame of four of its
metrics.  The cases are spread over four files, so that --dist loadfile
can run them side by side: this one (HMD, combined, the style in a fresh
interpreter), tests/test_torch_study_cli_motion.py (controller, the
median alias),
tests/test_torch_study_cli_mesh.py (mesh-quality statistics, survey,
demographics) and tests/test_torch_study_cli_reports.py (the two HTML
reports).
"""

import importlib
import runpy
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest
import torch

from mq3d_tpu_torch.analysis.stats import HMD_METRICS
from tests.test_torch_study import controller_frame, hmd_frame

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL_HMD = ["body_distance_m", "head_cumulative_radians",
             "viewing_sphere_coverage_percent",
             "viewing_sphere_coverage_with_fov_percent"]


def snapshot(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def run_cli(package: str, cli: str, argv: list, as_main: bool = False):
    """The CLI's main(argv); with as_main, the file run as a script with
    sys.argv set (the median alias adds its flag only there)."""
    if not as_main:
        mod = importlib.import_module(
            f"scripts.{cli}" if package == "jax" else f"mq3d_tpu_torch.scripts.{cli}")
        return mod.main(argv)
    old = sys.argv
    sys.argv = [cli] + argv
    try:
        if package == "jax":
            runpy.run_path(str(REPO / "scripts" / f"{cli}.py"), run_name="__main__")
        else:
            sys.modules.pop(f"mq3d_tpu_torch.scripts.{cli}", None)
            runpy.run_module(f"mq3d_tpu_torch.scripts.{cli}", run_name="__main__")
    finally:
        sys.argv = old


def compare_clis(tmp_path, capsys, cli, write_inputs, argv_of, as_main=False):
    """Run both packages' `cli` on copies of the same inputs; return the
    port's files after asserting they equal the JAX script's."""
    seen = {}
    for package in ("jax", "port"):
        root = tmp_path / package
        root.mkdir()
        write_inputs(root)
        capsys.readouterr()
        run_cli(package, cli, argv_of(root), as_main)
        out = capsys.readouterr().out.replace(str(root), "<root>")
        seen[package] = (out, snapshot(root))
    (j_out, j_files), (t_out, t_files) = seen["jax"], seen["port"]
    assert list(t_files) == list(j_files)
    for name, blob in j_files.items():
        assert t_files[name] == blob, name
    assert t_out == j_out
    return t_files


@pytest.fixture(autouse=True)
def fixed_pdf_date(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")


@pytest.fixture(scope="module")
def hmd():
    return hmd_frame()


def hmd_small(hmd):
    return hmd.drop(columns=[m.col for m in HMD_METRICS if m.col not in SMALL_HMD])


def _master(n):
    return pd.DataFrame({
        "participant": [f"P{i:02d}" for i in range(n)],
        "pair_id": [str(i) for i in range(n)],
        "fog_session_id": [f"cap_{i}_fog" for i in range(n)],
        "nofog_session_id": [f"cap_{i}_nofog" for i in range(n)],
    })


def hmd_case(frame, extra=(), master=False):
    def write(root):
        frame.to_csv(root / "hmd.csv", index=False)
        if master:
            _master(10).to_csv(root / "master.csv", index=False)

    def argv(root):
        a = ["--input_csv", str(root / "hmd.csv"), "--output_dir", str(root / "out"),
             *extra]
        return a + (["--merge-to-master", "--master-report", str(root / "master.csv")]
                    if master else [])
    return write, argv


HMD_CASES = ["full", "flags"]


@pytest.mark.parametrize("case", HMD_CASES)
def test_hmd_cli_matches_jax(tmp_path, capsys, hmd, case):
    """The full 14-metric frame; then --median, --merge-to-master and
    --exclude-participant together on four metrics."""
    if case == "full":
        write, argv = hmd_case(hmd)
    else:
        write, argv = hmd_case(hmd_small(hmd), ["--median", "--exclude-participant", "P03",
                                                  "--exclude-participant", "P07"],
                                master=True)
    files = compare_clis(tmp_path, capsys, "analyze_hmd_motion_stats", write, argv)
    pngs = [n for n in files if n.endswith(".png")]
    assert pngs and all(files[n][:8] == b"\x89PNG\r\n\x1a\n" for n in pngs)
    report = files["out/statistical_report.txt"]
    assert (b"(MEDIAN-BASED)" in report) == (case != "full")
    if case == "full":
        assert len([n for n in pngs if "improvements_" in n]) == 7
    if case == "flags":
        assert b"Fog condition: 8 sessions" in report
        header = files["master.csv"].decode().splitlines()[0]
        assert "fog_hmd_body_distance_m" in header


def test_combined_cli_matches_jax(tmp_path, capsys, hmd):
    ctl = controller_frame(hmd)

    def write(root):
        hmd.to_csv(root / "hmd.csv", index=False)
        ctl.to_csv(root / "ctl.csv", index=False)

    def argv(root):
        return ["--hmd_csv", str(root / "hmd.csv"), "--controller_csv",
                str(root / "ctl.csv"), "--output_dir", str(root / "out")]
    files = compare_clis(tmp_path, capsys, "analyze_combined_motion_stats", write, argv)
    assert "out/combined_metrics_boxplots.png" in files


_FRESH = """
import sys
sys.path.insert(0, {repo!r})
from pathlib import Path
import pandas as pd
from mq3d_tpu_torch.analysis import plots
from mq3d_tpu_torch.analysis.stats import HMD_METRICS
assert "mq3d_tpu.analysis.plots" not in sys.modules
df = pd.read_csv({csv!r})
plots.box_grid(df, HMD_METRICS, Path({out!r}))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "mq3d_tpu"))
assert not bad, bad
"""


def test_port_plots_alone_set_the_study_style(tmp_path, hmd):
    """In a fresh interpreter that never imports the JAX package, the
    port's box grid has the bytes of the JAX package's, drawn here after
    its plots module set the style in this process."""
    from mq3d_tpu.analysis import plots as jplots
    from mq3d_tpu.analysis.stats import HMD_METRICS as JAX_HMD_METRICS

    small = hmd_small(hmd)
    csv = tmp_path / "hmd.csv"
    small.to_csv(csv, index=False)
    jplots.box_grid(pd.read_csv(csv), JAX_HMD_METRICS, tmp_path / "jax.png")
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH.format(repo=str(REPO), csv=str(csv),
                                             out=str(tmp_path / "port.png"))],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
