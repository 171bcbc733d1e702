"""CLI: HMD motion statistics per session + optional fog/nofog paired report.

    python -m mq3d_tpu_torch.scripts.compute_hmd_motion_stats SESSION [SESSION ...] \
        [--summary-csv <csv>] [--participant NAME ...] [--pairs <csv>] \
        [--report_dir <dir>]

Counterpart of scripts/compute_hmd_motion_stats.py of the JAX build (host
numpy; nothing here runs on the card).  Reads each session's
hmd_poses.csv (pandas, imported inside eval/motion_stats.stats_from_pose_csv)
and prints the statistics as JSON; --summary-csv writes hmd_all_summary.csv
rows, --pairs with --report_dir the paired fog/nofog statistical report.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from mq3d_tpu_torch.eval.motion_stats import hmd_summary_row, stats_from_pose_csv
from mq3d_tpu_torch.eval.reporting import paired_statistics, write_statistical_report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("sessions", type=Path, nargs="+",
                        help="session dirs (containing hmd_poses.csv)")
    parser.add_argument("--pairs", type=Path, default=None,
                        help="CSV with fog_dir,nofog_dir columns for paired stats")
    parser.add_argument("--report_dir", type=Path, default=None)
    parser.add_argument("--summary-csv", type=Path, default=None,
                        help="write hmd_all_summary.csv (the analysis "
                             "scripts' input schema)")
    parser.add_argument("--participant", action="append", default=[],
                        help="participant name per session (same order)")
    args = parser.parse_args(argv)

    per_session = {}
    for session in args.sessions:
        csv_path = session / "hmd_poses.csv"
        if not csv_path.exists():
            print(f"[Warning] no hmd_poses.csv in {session}")
            continue
        stats = stats_from_pose_csv(csv_path)
        per_session[str(session)] = dataclasses.asdict(stats)
        per_session[str(session)]["_stats_obj"] = stats
    print(json.dumps(
        {k: {m: v for m, v in d.items() if not m.startswith("_")}
         for k, d in per_session.items()}, indent=2))

    if args.summary_csv is not None:
        import csv as _csv

        rows = []
        for i, (path, d) in enumerate(per_session.items()):
            participant = (args.participant[i]
                           if i < len(args.participant) else None)
            condition = ("Fog" if "/Fog/" in path
                         else "NoFog" if "/NoFog/" in path else None)
            rows.append(hmd_summary_row(
                d["_stats_obj"], Path(path).name, path,
                participant=participant, condition=condition))
        args.summary_csv.parent.mkdir(parents=True, exist_ok=True)
        with args.summary_csv.open("w", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"[Info] Summary CSV written to {args.summary_csv}")

    if args.pairs is not None:
        import pandas as pd

        pairs = pd.read_csv(args.pairs)
        metrics = [m for m in next(iter(per_session.values())).keys()
                   if not m.startswith("_")] if per_session else []
        results = []
        for metric in metrics:
            fog_vals, nofog_vals = [], []
            for _, row in pairs.iterrows():
                f = per_session.get(str(Path(row["fog_dir"])))
                n = per_session.get(str(Path(row["nofog_dir"])))
                if f and n:
                    fog_vals.append(f[metric])
                    nofog_vals.append(n[metric])
            if len(fog_vals) >= 3:
                results.append(paired_statistics(metric, fog_vals, nofog_vals))
        if results and args.report_dir:
            args.report_dir.mkdir(parents=True, exist_ok=True)
            write_statistical_report(
                results,
                args.report_dir / "statistical_report.txt",
                args.report_dir / "statistical_results.csv",
                args.report_dir / "statistical_report.html",
            )
            print(f"[Info] Reports written to {args.report_dir}")


if __name__ == "__main__":
    main()
