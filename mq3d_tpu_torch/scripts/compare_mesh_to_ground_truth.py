"""CLI: compare a reconstructed mesh/point cloud against ground truth.

    python -m mq3d_tpu_torch.scripts.compare_mesh_to_ground_truth \
        --pred <ply> --gt <ply> [--align center|icp] [--heatmap <ply>] \
        [--html <html>] [--device cpu]

Counterpart of scripts/compare_mesh_to_ground_truth.py of the JAX build:
chamfer, Hausdorff, mean point-to-surface, F-score@tau (default 1% of the
GT bbox diagonal), voxel IoU, surface area and hole count, with optional
centering and ICP alignment before comparing.  The nearest-neighbour
distances and the ICP run on --device (default cuda).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.dataio.ply import PointCloud, TriangleMesh, read_ply, write_ply_pointcloud
from mq3d_tpu_torch.eval.metrics import (
    compare_point_clouds,
    count_boundary_edges,
    count_holes,
    mesh_surface_area,
    nearest_distances,
    normalize_scale,
    voxel_iou,
)
from mq3d_tpu_torch.ops.icp import ICPConvergenceCriteria, multi_scale_icp
from mq3d_tpu_torch.ops.sampling import sample_points_uniformly
from mq3d_tpu_torch.scripts._cli import add_device


def load_points(path: Path, n_samples: int):
    geom = read_ply(path)
    if isinstance(geom, TriangleMesh) and len(geom.triangles):
        pcd = sample_points_uniformly(geom, n_samples)
        return pcd.points, geom
    return geom.points, None


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred", type=Path, required=True, help="reconstructed PLY")
    parser.add_argument("--gt", type=Path, required=True, help="ground truth PLY")
    parser.add_argument("--samples", type=int, default=100_000)
    parser.add_argument("--align", nargs="?", const="icp", default="none",
                        choices=["none", "center", "icp"],
                        help="alignment before comparing (bare --align = icp)")
    parser.add_argument("--scale-normalize", action="store_true",
                        help="match pred bbox diagonal to gt before aligning")
    parser.add_argument("--fscore_tau", type=float, default=None)
    parser.add_argument("--iou_voxel", type=float, default=0.05)
    parser.add_argument("--heatmap", type=Path, default=None,
                        help="write an error-colored point cloud PLY")
    parser.add_argument("--html", type=Path, default=None, help="write an HTML report")
    add_device(parser)
    args = parser.parse_args(argv)

    pred_pts, pred_mesh = load_points(args.pred, args.samples)
    gt_pts, gt_mesh = load_points(args.gt, args.samples)

    scale_factor = 1.0
    if args.scale_normalize:
        pred_pts, scale_factor = normalize_scale(pred_pts, gt_pts)
        print(f"[Info] Scale normalization: factor={scale_factor:.6f}")

    if args.align != "none":
        pred_pts = pred_pts + (gt_pts.mean(0) - pred_pts.mean(0))
    if args.align == "icp":
        diag = float(np.linalg.norm(gt_pts.max(0) - gt_pts.min(0)))
        r = multi_scale_icp(
            pred_pts, gt_pts,
            voxel_sizes=[diag / 50, diag / 100],
            criteria_list=[ICPConvergenceCriteria(30), ICPConvergenceCriteria(15)],
            max_correspondence_distances=[diag / 10, diag / 25],
            device=args.device,
        )
        T = r.transformation
        pred_pts = pred_pts @ T[:3, :3].T + T[:3, 3]

    cmp = compare_point_clouds(pred_pts, gt_pts, fscore_threshold=args.fscore_tau,
                               device=args.device)
    out = {
        "chamfer": cmp.chamfer,
        "hausdorff": cmp.hausdorff,
        "mean_to_gt": cmp.mean_to_gt,
        "mean_from_gt": cmp.mean_from_gt,
        "precision": cmp.precision,
        "recall": cmp.recall,
        "fscore": cmp.fscore,
        "fscore_tau": cmp.threshold,
        "voxel_iou": voxel_iou(pred_pts, gt_pts, args.iou_voxel),
        "scale_factor": scale_factor,
    }
    if pred_mesh is not None:
        out["pred_surface_area"] = mesh_surface_area(pred_mesh.vertices, pred_mesh.triangles)
        out["pred_boundary_edges"] = count_boundary_edges(pred_mesh.triangles)
        out["pred_num_holes"] = count_holes(pred_mesh.vertices, pred_mesh.triangles)
    if gt_mesh is not None:
        out["gt_surface_area"] = mesh_surface_area(gt_mesh.vertices, gt_mesh.triangles)
        out["gt_num_holes"] = count_holes(gt_mesh.vertices, gt_mesh.triangles)
    print(json.dumps(out, indent=2))

    if args.heatmap is not None:
        # Error heatmap: pred points colored blue (0) -> red (>= 3 tau).
        d = nearest_distances(pred_pts, gt_pts, device=args.device)
        t = np.clip(d / (3 * cmp.threshold), 0, 1)
        colors = np.stack([t, np.zeros_like(t), 1 - t], -1)
        write_ply_pointcloud(args.heatmap, PointCloud(pred_pts, colors=colors))
        print(f"[Info] Error heatmap written to {args.heatmap}")

    if args.html is not None:
        rows = "".join(
            f"<tr><td>{k}</td><td>{v:.6g}</td></tr>"
            if isinstance(v, float) else f"<tr><td>{k}</td><td>{v}</td></tr>"
            for k, v in out.items()
        )
        args.html.write_text(
            "<html><body><h1>Mesh vs ground truth</h1>"
            f"<p>pred: {args.pred}<br>gt: {args.gt}</p>"
            f"<table border=1>{rows}</table></body></html>"
        )
        print(f"[Info] HTML report written to {args.html}")
    return out


if __name__ == "__main__":
    main()
