"""The port's analyze_controller_motion_stats and
analyze_hmd_motion_stats_median against the JAX package's scripts:
tests/test_torch_study_cli.py's comparison (files byte for byte, stdout),
on tests/test_analysis_tree.py's controller frame, whole and with
--exclude-participant, and on four metrics of its HMD frame."""

import pytest
import torch

from tests.test_torch_study import controller_frame, hmd_frame
from tests.test_torch_study_cli import (  # noqa: F401
    compare_clis,
    fixed_pdf_date,
    hmd_case,
    hmd_small,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("exclude", [[], ["P01", "P04"]], ids=["all", "exclude"])
def test_controller_cli_matches_jax(tmp_path, capsys, exclude):
    ctl = controller_frame(hmd_frame())

    def write(root):
        ctl.to_csv(root / "ctl.csv", index=False)

    def argv(root):
        flags = [a for p in exclude for a in ("--exclude-participant", p)]
        return ["--input_csv", str(root / "ctl.csv"), "--output_dir",
                str(root / "out"), *flags]
    files = compare_clis(tmp_path, capsys, "analyze_controller_motion_stats",
                         write, argv)
    for name in ("statistical_results_hand.csv", "statistical_results_interhand.csv",
                 "boxplots_hand_metrics.png", "boxplots_interhand_metrics.png",
                 "statistical_report.txt"):
        assert f"out/{name}" in files, name
    # The report counts the frame's rows: two hands and one inter-hand row
    # per session.
    assert f"Fog condition: {3 * (10 - len(exclude))} sessions".encode() in \
        files["out/statistical_report.txt"]


def test_hmd_median_alias_matches_jax(tmp_path, capsys):
    """The alias run as a script (it adds --median only under __main__)."""
    write, argv = hmd_case(hmd_small(hmd_frame()))
    files = compare_clis(tmp_path, capsys, "analyze_hmd_motion_stats_median",
                         write, argv, as_main=True)
    assert b"(MEDIAN-BASED)" in files["out/statistical_report.txt"]
