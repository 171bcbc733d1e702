"""CLI: batch mesh quality score Q with fog/no-fog pair reporting.

    python -m mq3d_tpu_torch.scripts.evaluate_mesh_quality mesh1.ply mesh2.fbx ...
        [--pair FOG NOFOG ...] [--from-csv master.csv] [--csv out.csv]
        [--report-dir DIR]

Counterpart of scripts/evaluate_mesh_quality.py of the JAX build (host
numpy + scipy; --device is accepted, as by every CLI of the port, and
nothing here runs on it).  Three modes:
  1. unpaired:   evaluate_mesh_quality mesh1.ply mesh2.ply ...
  2. pairs:      --pair fog1.ply nofog1.ply [--pair fog2.ply nofog2.ply ...]
  3. from CSV:   --from-csv master_fog_no_fog_report.csv
                 (rows with fog/nofog mesh paths; updates the master CSV
                 with per-condition scores + deltas in place)

Artifacts: quality_scores.csv (the reference's raw-metric schema), a batch
ranking printout, and for the pair modes pairwise_summary.csv and a
self-contained pairwise_quality_report.html (matplotlib, imported only
there).  FBX inputs, binary or ASCII, load through export/fbx.py's
read_fbx_mesh; the JAX script imports a reader its package lacks and fails
on them.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.dataio.ply import read_ply
from mq3d_tpu_torch.eval.quality import (
    compute_quality_scores,
    compute_raw_metrics,
    write_scores_csv,
)
from mq3d_tpu_torch.eval.reporting import PairQualityScores, update_master_fog_report
from mq3d_tpu_torch.export.fbx import read_fbx_mesh
from mq3d_tpu_torch.scripts._cli import add_device


def load_mesh_any(path: Path):
    """PLY through read_ply; anything else as FBX (binary or ASCII)."""
    path = Path(path)
    if path.suffix.lower() == ".ply":
        return read_ply(path)
    return read_fbx_mesh(path)


def fig_to_base64(fig) -> str:
    """Inline <img> payload for self-contained HTML reports."""
    import base64
    import io

    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=150, bbox_inches="tight")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def print_batch_summary(scores):
    ranked = sorted(scores, key=lambda s: s.Q_norm, reverse=True)
    print("\n" + "=" * 80)
    print("BATCH QUALITY RANKING (higher Q_norm is better)")
    print("=" * 80)
    print(f"{'Rank':<6} {'Name':<25} {'Q_norm':<8} {'Q_raw':<8} "
          f"{'S_geom':<8} {'S_smooth':<8} {'S_complete':<10} {'S_color':<8}")
    print("-" * 80)
    for rank, s in enumerate(ranked, start=1):
        print(f"{rank:<6} {s.name:<25} {s.Q_norm:>7.3f} {s.Q_raw:>7.3f} "
              f"{s.S_geom:>7.3f} {s.S_smooth:>7.3f} {s.S_complete:>9.3f} "
              f"{s.S_color:>7.3f}")


def print_pair_summaries(pairs):
    if not pairs:
        return
    all_scores = [s for p in pairs for s in p]
    ranked = sorted(all_scores, key=lambda s: s.Q_norm, reverse=True)
    rank_map = {s.name: i + 1 for i, s in enumerate(ranked)}
    total = len(all_scores)
    print("\n" + "=" * 80)
    print("FOG vs NO-FOG PAIR ANALYSIS")
    print("=" * 80)
    for idx, (fog, nofog) in enumerate(pairs, start=1):
        print(f"\nPair {idx}:")
        print(f"  {fog.name:<20}: Q = {fog.Q_norm:.3f} "
              f"(rank: {rank_map[fog.name]}/{total})")
        print(f"  {nofog.name:<20}: Q = {nofog.Q_norm:.3f} "
              f"(rank: {rank_map[nofog.name]}/{total})")
        print(f"  Improvement (fog - nofog): "
              f"{fog.Q_norm - nofog.Q_norm:+.3f} (relative)")
        for label, s in (("Fog", fog), ("No-fog", nofog)):
            m = s.raw
            print(f"  {label} mesh absolute metrics:")
            print(f"    - Aspect ratio (mean): {m.mean_aspect_ratio:.2f} "
                  f"(degenerate tris: {m.degenerate_triangles})")
            print(f"    - Skewness (mean):     {m.mean_skewness:.2f}")
            print(f"    - Normal deviation:    "
                  f"{m.normal_deviation_avg_deg:.2f} deg")
            print(f"    - Dihedral range:      "
                  f"min={m.dihedral_min_deg:.1f}, "
                  f"max={m.dihedral_max_deg:.1f} deg")
            print(f"    - Components:          {m.component_count}, "
                  f"boundary edges: {m.boundary_edge_ratio * 100:.1f}%")


def write_pairwise_reports(pairs, pair_meta, out_dir: Path):
    """pairwise_summary.csv + self-contained HTML with per-pair bars,
    deltas, and box plot (reference :745-899)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir.mkdir(parents=True, exist_ok=True)
    rows, labels, fog_vals, nofog_vals, deltas = [], [], [], [], []
    for i, (fog_s, nofog_s) in enumerate(pairs):
        meta = pair_meta[i] if i < len(pair_meta) else {}
        delta = nofog_s.Q_norm - fog_s.Q_norm
        rows.append([
            meta.get("participant", f"pair{i + 1}"),
            meta.get("pair_id", str(i + 1)),
            fog_s.name, f"{fog_s.Q_norm:.6f}",
            nofog_s.name, f"{nofog_s.Q_norm:.6f}",
            f"{delta:.6f}", f"{-delta:.6f}",
        ])
        labels.append(meta.get("participant") or f"pair{i + 1}")
        fog_vals.append(fog_s.Q_norm)
        nofog_vals.append(nofog_s.Q_norm)
        deltas.append(delta)

    with (out_dir / "pairwise_summary.csv").open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["participant", "pair_id", "fog_name", "fog_Q_norm",
                    "nofog_name", "nofog_Q_norm", "delta_nofog_minus_fog",
                    "delta_fog_minus_nofog"])
        w.writerows(rows)

    x = np.arange(len(labels))
    pngs = {}
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.bar(x - 0.2, fog_vals, width=0.4, label="Fog")
    ax.bar(x + 0.2, nofog_vals, width=0.4, label="NoFog")
    ax.set_xticks(x)
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_ylabel("Q_norm")
    ax.set_title("Quality scores per pair (normalized)")
    ax.legend()
    pngs["Per-pair scores"] = fig_to_base64(fig)

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(x, deltas, color=["green" if d >= 0 else "red" for d in deltas])
    ax.axhline(0, color="black", linewidth=1)
    ax.set_xticks(x)
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_ylabel("Delta (NoFog - Fog)")
    ax.set_title("Score delta per pair (Q_norm)")
    pngs["Score delta"] = fig_to_base64(fig)

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.boxplot([fog_vals, nofog_vals], tick_labels=["Fog", "NoFog"])
    ax.set_ylabel("Q_norm")
    ax.set_title("Score distribution")
    pngs["Distribution"] = fig_to_base64(fig)

    html = ["<html><head><title>Fog vs NoFog Mesh Quality</title>",
            "<style>table{border-collapse:collapse;width:100%;}"
            "th,td{border:1px solid #ddd;padding:6px;}"
            "th{background:#eee;}</style></head><body>",
            "<h2>Fog vs NoFog Mesh Quality (normalized scores)</h2>",
            "<table><tr><th>Participant</th><th>Pair ID</th><th>Fog</th>"
            "<th>Fog Q_norm</th><th>NoFog</th><th>NoFog Q_norm</th>"
            "<th>Delta (NoFog-Fog)</th><th>Delta (Fog-NoFog)</th></tr>"]
    for r in rows:
        html.append("<tr>" + "".join(f"<td>{c}</td>" for c in r) + "</tr>")
    html.append("</table><br/>")
    for title, b64 in pngs.items():
        html.append(f"<h3>{title}</h3>"
                    f"<img src='data:image/png;base64,{b64}' "
                    "style='max-width:100%;'/>")
    html.append("</body></html>")
    (out_dir / "pairwise_quality_report.html").write_text("\n".join(html))
    print(f"[Info] Wrote pairwise reports to {out_dir}")


def pairs_from_csv(master_csv: Path):
    """Pairs from master_fog_no_fog_report.csv rows whose fog and nofog
    meshes both exist (reference :932-1006)."""
    pairs, meta = [], []
    with master_csv.open() as f:
        for row in csv.DictReader(f):
            fog_path = row.get("fog_color_mesh_path") or row.get("fog_mesh_path")
            nofog_path = (row.get("nofog_color_mesh_path")
                          or row.get("nofog_mesh_path"))
            if not fog_path or not nofog_path:
                continue
            fog_p, nofog_p = Path(fog_path), Path(nofog_path)
            if not (fog_p.exists() and nofog_p.exists()):
                continue
            participant = row.get("participant", "")
            pair_id = row.get("pair_id", "")
            base = f"{participant}_{pair_id}"
            pairs.append((fog_p, nofog_p))
            meta.append({"participant": participant, "pair_id": pair_id,
                         "fog_name": f"{base}_fog",
                         "nofog_name": f"{base}_nofog"})
    return pairs, meta


def main(argv=None):
    ap = argparse.ArgumentParser(description="Batch mesh quality score Q")
    ap.add_argument("meshes", type=Path, nargs="*", help="mesh files")
    ap.add_argument("--pair", type=Path, nargs=2, action="append",
                    default=[], metavar=("FOG", "NOFOG"))
    ap.add_argument("--from-csv", type=Path, default=None,
                    help="master fog/no-fog report CSV")
    ap.add_argument("--csv", type=Path, default=None,
                    help="quality_scores.csv output path")
    ap.add_argument("--report-dir", type=Path, default=None,
                    help="pairwise report output directory")
    add_device(ap)
    args = ap.parse_args(argv)

    jobs = []  # (path, name)
    pair_meta = []
    pair_names = []
    if args.from_csv:
        pairs, pair_meta = pairs_from_csv(args.from_csv)
        for m, (fog_p, nofog_p) in zip(pair_meta, pairs):
            jobs.append((fog_p, m["fog_name"]))
            jobs.append((nofog_p, m["nofog_name"]))
            pair_names.append((m["fog_name"], m["nofog_name"]))
    elif args.pair:
        for i, (fog_p, nofog_p) in enumerate(args.pair, start=1):
            jobs.append((fog_p, f"{i}_fog"))
            jobs.append((nofog_p, f"{i}_nofog"))
            pair_names.append((f"{i}_fog", f"{i}_nofog"))
            pair_meta.append({"participant": f"pair{i}", "pair_id": str(i),
                              "fog_name": f"{i}_fog",
                              "nofog_name": f"{i}_nofog"})
    else:
        jobs = [(p, p.stem) for p in args.meshes]
    if not jobs:
        ap.error("no meshes given (positional, --pair, or --from-csv)")

    metrics = []
    for path, name in jobs:
        print(f"[Info] Evaluating {name} ({path})")
        metrics.append(compute_raw_metrics(load_mesh_any(path), name=name,
                                           path=str(path)))
    scores = compute_quality_scores(metrics)
    by_name = {s.name: s for s in scores}

    print_batch_summary(scores)
    if args.csv:
        write_scores_csv(scores, args.csv)
        print(f"[Info] CSV written to {args.csv}")

    if pair_names:
        pairs = [(by_name[f], by_name[n]) for f, n in pair_names]
        print_pair_summaries(pairs)
        out_dir = args.report_dir or Path("analysis/mesh_quality_batch")
        write_pairwise_reports(pairs, pair_meta, out_dir)
        if args.from_csv:
            update_master_fog_report(
                args.from_csv,
                [PairQualityScores(
                    name=s.name, Q_raw=s.Q_raw, Q_norm=s.Q_norm,
                    S_geom=s.S_geom, S_smooth=s.S_smooth,
                    S_complete=s.S_complete, S_color=s.S_color,
                    S_shape=s.S_shape, S_topology=s.S_topology,
                    S_bonuses=s.S_bonuses) for s in scores],
                pair_meta)
            print(f"[Info] Updated master report: {args.from_csv}")
    return scores


if __name__ == "__main__":
    main()
