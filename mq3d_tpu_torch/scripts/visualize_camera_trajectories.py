"""CLI: export camera trajectories as frustum-glyph line geometry.

    python -m mq3d_tpu_torch.scripts.visualize_camera_trajectories \
        --project_dir <dir> [--output <ply>] [--interval 10]

Counterpart of scripts/visualize_camera_trajectories.py of the JAX build
(host numpy; nothing here runs on the card).  The four trajectories
(left/right depth + left/right color) are written as a single PLY of
frustum vertices (camera centre and four image corners at 0.1 m) with
per-trajectory colors, viewable in MeshLab/CloudCompare; default output
<project_dir>/reconstruction/trajectories.ply.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.dataio.ply import write_ply
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem

COLORS = {
    ("depth", Side.LEFT): (255, 0, 0),
    ("depth", Side.RIGHT): (0, 255, 0),
    ("color", Side.LEFT): (0, 0, 255),
    ("color", Side.RIGHT): (255, 255, 0),
}


def frustum_vertices(pose_cw, fx, fy, cx, cy, w, h, depth=0.1):
    corners_px = np.array([(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)], float)
    rays = np.stack(
        [(corners_px[:, 0] - cx) / fx, (corners_px[:, 1] - cy) / fy, np.ones(4)], -1
    )
    pts_cam = np.concatenate([np.zeros((1, 3)), rays * depth])
    return pts_cam @ pose_cw[:3, :3].T + pose_cw[:3, 3]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--project_dir", type=Path, required=True)
    parser.add_argument("--output", type=Path, default=None)
    parser.add_argument("--interval", type=int, default=10)
    args = parser.parse_args(argv)

    data_io = DataIO(args.project_dir)
    all_pts, all_colors = [], []

    def add_trajectory(ds, color):
        ds.transforms = ds.transforms.convert_coordinate_system(
            CoordinateSystem.OPEN3D, is_camera=True
        )
        K = ds.get_render_intrinsic_matrices()
        poses = ds.transforms.extrinsics_cw
        for i in range(0, len(ds), args.interval):
            pts = frustum_vertices(
                poses[i], K[i, 0, 0], K[i, 1, 1], K[i, 0, 2], K[i, 1, 2],
                int(ds.widths[i]), int(ds.heights[i]),
            )
            all_pts.append(pts)
            all_colors.append(np.tile(color, (len(pts), 1)))

    for side in Side:
        try:
            add_trajectory(data_io.depth.load_depth_dataset(side), COLORS[("depth", side)])
        except Exception as e:
            print(f"[Warning] depth trajectory {side.name}: {e}")
        try:
            add_trajectory(
                data_io.color.load_color_dataset(side), COLORS[("color", side)]
            )
        except Exception as e:
            print(f"[Warning] color trajectory {side.name}: {e}")

    if not all_pts:
        print("[Error] No trajectories found.")
        sys.exit(1)

    pts = np.concatenate(all_pts)
    colors = np.concatenate(all_colors).astype(np.uint8)
    out = args.output or (args.project_dir / "reconstruction/trajectories.ply")
    write_ply(out, pts, colors=colors)
    print(f"[Info] Trajectory glyphs written to {out} ({len(pts)} points)")


if __name__ == "__main__":
    main()
