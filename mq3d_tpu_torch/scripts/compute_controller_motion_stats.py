"""CLI: controller motion statistics (per hand + inter-hand coordination).

    python -m mq3d_tpu_torch.scripts.compute_controller_motion_stats \
        SESSION [SESSION ...] [--summary-csv <csv>] [--participant NAME ...]

Counterpart of scripts/compute_controller_motion_stats.py of the JAX build
(host numpy; nothing here runs on the card).  Expects controller_poses.csv
with columns unix_time, hand (left|right), pos_x..z, rot_x..w, or per-hand
files left_controller_poses.csv / right_controller_poses.csv (read with
pandas, imported inside load_hand).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from mq3d_tpu_torch.eval.motion_stats import (
    compute_motion_stats,
    controller_summary_row,
    inter_hand_stats,
)


def load_hand(session: Path, hand: str):
    import pandas as pd

    combined = session / "controller_poses.csv"
    per_hand = session / f"{hand}_controller_poses.csv"
    if combined.exists():
        df = pd.read_csv(combined, on_bad_lines="skip").dropna()
        df = df[df["hand"].str.lower() == hand]
    elif per_hand.exists():
        df = pd.read_csv(per_hand, on_bad_lines="skip").dropna()
    else:
        return None
    df = df.sort_values("unix_time")
    return (
        df["unix_time"].to_numpy() / 1000.0,
        df[["pos_x", "pos_y", "pos_z"]].to_numpy(),
        df[["rot_x", "rot_y", "rot_z", "rot_w"]].to_numpy(),
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("sessions", type=Path, nargs="+")
    parser.add_argument("--summary-csv", type=Path, default=None,
                        help="write controller_all_summary.csv (per-hand "
                             "rows + one inter-hand row per session, the "
                             "analysis scripts' input schema)")
    parser.add_argument("--participant", action="append", default=[],
                        help="participant name per session (same order)")
    args = parser.parse_args(argv)

    out = {}
    summary_rows = []
    for si, session in enumerate(args.sessions):
        participant = (args.participant[si]
                       if si < len(args.participant) else None)
        condition = ("Fog" if "/Fog/" in str(session)
                     else "NoFog" if "/NoFog/" in str(session) else None)
        entry = {}
        hands = {}
        for hand in ("left", "right"):
            data = load_hand(session, hand)
            if data is None:
                continue
            t, pos, rot = data
            stats = compute_motion_stats(t, pos, rot)
            entry[hand] = dataclasses.asdict(stats)
            hands[hand] = (t, pos)
            summary_rows.append(controller_summary_row(
                stats, session.name, str(session), hand,
                participant=participant, condition=condition))
        # Inter-hand coordination (reference :356-470).
        if len(hands) == 2:
            (tl, pl), (tr, pr) = hands["left"], hands["right"]
            inter = inter_hand_stats(tl, pl, tr, pr)
            entry["inter_hand"] = inter
            summary_rows.append({
                "capture_name": session.name, "capture_path": str(session),
                "participant": participant, "condition": condition,
                "hand": None, **inter,
            })
        if entry:
            out[str(session)] = entry
    print(json.dumps(out, indent=2))

    if args.summary_csv is not None and summary_rows:
        import csv as _csv

        fieldnames = []
        for r in summary_rows:
            for k in r:
                if k not in fieldnames:
                    fieldnames.append(k)
        args.summary_csv.parent.mkdir(parents=True, exist_ok=True)
        with args.summary_csv.open("w", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=fieldnames)
            w.writeheader()
            w.writerows(summary_rows)
        print(f"[Info] Summary CSV written to {args.summary_csv}")


if __name__ == "__main__":
    main()
