"""The port's mesh-quality statistics, survey and demographics CLIs
against the JAX package's scripts: tests/test_torch_study_cli.py's
comparison (files byte for byte, PNG and PDF included; stdout), on
tests/test_analysis_tree.py's quality and survey frames."""

import pytest
import torch

from tests.test_torch_study import quality_frame, survey_frame
from tests.test_torch_study_cli import compare_clis, fixed_pdf_date  # noqa: F401

torch.set_num_threads(1)

CASES = {
    # cli: (input name, input flag, output flag, output name, expected files)
    "analyze_mesh_quality_stats": (
        "quality_scores.csv", "--quality-scores", "--output-dir", "out",
        ["quality_statistical_results.csv", "quality_statistical_report.txt",
         "boxplots_quality.png", "violinplots_quality.png", "summary_bar_chart.png",
         "improvement_analysis.csv", "improvements_summary.png"]),
    "analyze_simple_mesh_metrics": (
        "quality_scores.csv", "--quality-scores", "--output-dir", "out",
        ["simple_metrics_results.csv", "simple_metrics_report.txt",
         "boxplots_simple_metrics.png"]),
    "analyze_survey_hypotheses": (
        "survey.csv", "--input", "--output_dir", "out",
        ["survey_hypotheses_results.csv", "statistical_report.txt"]),
    "generate_participant_demographics": (
        "survey.csv", "--input", "--output_dir", "out",
        ["demographics_table.csv", "demographics_table.tex",
         "demographics_table.html", "age_distribution.png", "age_distribution.pdf",
         "gender_distribution.png", "experience_distributions.png",
         "education_levels.png", "laterality_glasses.pdf"]),
}


@pytest.mark.parametrize("cli", list(CASES))
def test_mesh_and_survey_cli_matches_jax(tmp_path, capsys, cli):
    in_name, in_flag, out_flag, out_name, expected = CASES[cli]
    frame = survey_frame() if in_name == "survey.csv" else quality_frame()

    def write(root):
        frame.to_csv(root / in_name, index=False)

    def argv(root):
        return [in_flag, str(root / in_name), out_flag, str(root / out_name)]
    files = compare_clis(tmp_path, capsys, cli, write, argv)
    for name in expected:
        assert f"{out_name}/{name}" in files, name
