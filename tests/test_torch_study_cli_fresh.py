"""The three study CLIs whose JAX scripts import matplotlib at their top,
each package's run in a fresh interpreter of its own.

The in-process comparisons of tests/test_torch_study_cli*.py may run after
another CLI imported the JAX package's plots module, which sets the study
style (seaborn whitegrid, the colorblind palette, rcParams) for the whole
process.  Here each script starts from matplotlib's defaults, as it does
for a user: the demographics CLI draws unstyled in the JAX package and
the two HTML reports styled (their scripts import its plots module), so a
port that styles the one or misses the style in the others writes other
bytes.  The comparison is tests/test_torch_study_cli.py's: the same set of
files, each byte for byte, and stdout once paths are replaced.
"""

import os
import subprocess
import sys

import pytest
import torch

from tests.test_torch_study import quality_frame, survey_frame
from tests.test_torch_study_cli import REPO, snapshot
from tests.test_torch_study_cli_reports import FEW

torch.set_num_threads(1)

_RUN = """
import importlib, sys
sys.path.insert(0, {repo!r})
importlib.import_module({module!r}).main({argv!r})
if {port!r}:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "mq3d_tpu"))
    assert not bad, bad
"""

CASES = {
    # cli: (input frame, input name, argv after the root)
    "generate_participant_demographics": (
        survey_frame, "survey.csv", ["--input", "survey.csv", "--output_dir", "out"]),
    "generate_simple_pairwise_report": (
        quality_frame, "quality_scores.csv",
        ["--quality-scores", "quality_scores.csv", "--output", "report.html"]),
    "generate_comprehensive_quality_analysis": (
        lambda: quality_frame()[FEW], "quality_scores.csv",
        ["--quality-scores", "quality_scores.csv", "--output", "report.html"]),
}


@pytest.mark.parametrize("cli", list(CASES))
def test_cli_in_a_fresh_interpreter_matches_jax(tmp_path, cli):
    make, in_name, rel_argv = CASES[cli]
    frame = make()
    env = dict(os.environ, SOURCE_DATE_EPOCH="1700000000")
    seen = {}
    for package, module in (("jax", f"scripts.{cli}"),
                            ("port", f"mq3d_tpu_torch.scripts.{cli}")):
        root = tmp_path / package
        root.mkdir()
        frame.to_csv(root / in_name, index=False)
        argv = [str(root / a) if i % 2 else a for i, a in enumerate(rel_argv)]
        proc = subprocess.run(
            [sys.executable, "-c", _RUN.format(repo=str(REPO), module=module, argv=argv,
                                               port=package == "port")],
            capture_output=True, text=True, timeout=300, cwd=root, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        seen[package] = (proc.stdout.replace(str(root), "<root>"), snapshot(root))
    (j_out, j_files), (t_out, t_files) = seen["jax"], seen["port"]
    assert list(t_files) == list(j_files)
    for name, blob in j_files.items():
        assert t_files[name] == blob, name
    assert t_out == j_out
    assert any(n.endswith(".png") or n.endswith(".html") for n in t_files)
