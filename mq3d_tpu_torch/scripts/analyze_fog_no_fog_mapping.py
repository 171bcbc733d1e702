"""CLI: build/refresh the master fog/no-fog pairing report.

    python -m mq3d_tpu_torch.scripts.analyze_fog_no_fog_mapping --base_dir <dir> \
        [--output <csv>]

Counterpart of scripts/analyze_fog_no_fog_mapping.py of the JAX build
(stdlib csv only).  Scans participant directories containing paired capture
sessions named <participant>/<session>_fog and _nofog and writes
master_fog_no_fog_report.csv (default under --base_dir) with one row per
pair, ready for progressive quality-column updates
(eval/reporting.update_master_fog_report).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def discover_pairs(base_dir: Path):
    pairs = []
    for participant_dir in sorted(p for p in base_dir.iterdir() if p.is_dir()):
        sessions = {p.name: p for p in participant_dir.iterdir() if p.is_dir()}
        fogs = {n[: -len("_fog")]: p for n, p in sessions.items() if n.endswith("_fog")}
        nofogs = {
            n[: -len("_nofog")]: p for n, p in sessions.items() if n.endswith("_nofog")
        }
        for pair_id in sorted(set(fogs) & set(nofogs)):
            pairs.append(
                {
                    "participant": participant_dir.name,
                    "pair_id": pair_id,
                    "fog_dir": str(fogs[pair_id]),
                    "nofog_dir": str(nofogs[pair_id]),
                    "fog_name": f"{participant_dir.name}_{pair_id}_fog",
                    "nofog_name": f"{participant_dir.name}_{pair_id}_nofog",
                    "fog_evaluate_quality_score_placeholder": "",
                    "nofog_evaluate_quality_score_placeholder": "",
                }
            )
    return pairs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_dir", type=Path, required=True,
                        help="directory of participant directories")
    parser.add_argument("--output", type=Path, default=None,
                        help="default: <base_dir>/master_fog_no_fog_report.csv")
    args = parser.parse_args(argv)

    pairs = discover_pairs(args.base_dir)
    out = args.output or (args.base_dir / "master_fog_no_fog_report.csv")
    if not pairs:
        print("[Warning] No fog/nofog pairs found.")
        return
    with out.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(pairs[0].keys()))
        writer.writeheader()
        writer.writerows(pairs)
    print(f"[Info] {len(pairs)} pairs written to {out}")


if __name__ == "__main__":
    main()
