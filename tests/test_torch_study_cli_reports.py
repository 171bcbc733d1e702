"""The port's two self-contained HTML reports against the JAX package's
scripts: tests/test_torch_study_cli.py's comparison (the HTML, base64
figures included, byte for byte; stdout), on tests/test_analysis_tree.py's
quality frame, with --master-report and --exclude-participant."""

import pandas as pd
import pytest
import torch

from tests.test_torch_study import quality_frame
from tests.test_torch_study_cli import compare_clis, fixed_pdf_date  # noqa: F401

torch.set_num_threads(1)

# The comprehensive report draws three charts per metric column: its
# --exclude-participant case keeps three of the frame's metrics.
FEW = ["name", "Q_raw", "num_vertices", "is_manifold"]


@pytest.mark.parametrize("case", ["pairwise", "pairwise_master", "comprehensive",
                                  "comprehensive_exclude"])
def test_html_report_cli_matches_jax(tmp_path, capsys, case):
    frame = quality_frame()
    extra = []
    if case == "comprehensive_exclude":
        frame = frame[FEW]
        extra = ["--exclude-participant", "p03", "--exclude-participant", "P05"]
    # --master-report renames the pairs' participants from a master CSV.
    master = pd.DataFrame({"pair_id": [f"20260101_{100000 + i:06d}__20260101_"
                                       f"{110000 + i:06d}" for i in range(0, 10, 2)],
                           "participant": [f"Alias{i}" for i in range(0, 10, 2)]})

    def write(root):
        frame.to_csv(root / "quality_scores.csv", index=False)
        master.to_csv(root / "master.csv", index=False)

    def argv(root):
        a = ["--quality-scores", str(root / "quality_scores.csv"),
             "--output", str(root / "report.html"), *extra]
        return a + (["--master-report", str(root / "master.csv")]
                    if case == "pairwise_master" else [])
    cli = ("generate_simple_pairwise_report" if case.startswith("pairwise")
           else "generate_comprehensive_quality_analysis")
    files = compare_clis(tmp_path, capsys, cli, write, argv)
    html = files["report.html"].decode()
    assert "data:image/png;base64," in html
    if case == "pairwise_master":
        assert "Alias2" in html
    if case == "comprehensive_exclude":
        assert "<strong>Excluded:</strong> P03_" in html and "P05_" in html
