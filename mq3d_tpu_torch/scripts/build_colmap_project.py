"""CLI: export a capture to a COLMAP sparse project.

    python -m mq3d_tpu_torch.scripts.build_colmap_project \
        --project_dir <capture dir> [--output_dir <dir>] [--interval K] \
        [--include_points]

Counterpart of scripts/build_colmap_project.py of the JAX build (host
numpy; the same bytes): loads the optimized color datasets (the raw ones
where there are none), converts the poses to the COLMAP frame, copies the
images as <SIDE>_<timestamp>.png into <output>/input, optionally loads the
colored point cloud as Point3D records, and writes the binary model to
<output>/distorted/sparse/0.  --device is accepted, as by every CLI of
the port; nothing here runs on it.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.export.colmap import Camera, Image, Point3D, write_model
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem, Transforms
from mq3d_tpu_torch.scripts._cli import add_device


def load_dataset_map(data_io: DataIO, interval: int):
    out = {}
    for side in Side:
        ds = data_io.color.load_optimized_color_dataset(side)
        if ds is None:
            print(f"[Info] No optimized color dataset for {side.name}; using raw.")
            ds = data_io.color.load_color_dataset(side, use_cache=True)
        out[side] = ds[::interval]
    return out


def build_model(data_io: DataIO, image_dir: Path, interval: int = 1,
                include_points: bool = False):
    """(cameras, images, points3D) of a capture, with its images copied
    into image_dir."""
    cameras, images = {}, {}
    image_id = 1
    for cam_id, (side, ds) in enumerate(load_dataset_map(data_io, interval).items(), start=1):
        colmap_tf = ds.transforms.convert_coordinate_system(
            CoordinateSystem.COLMAP, is_camera=True
        )
        positions_cw = colmap_tf.positions_cw
        # COLMAP wants w-first quaternions of the world-to-camera rotation.
        rot_cw = colmap_tf.rotations_cw[:, [3, 0, 1, 2]]
        cameras[cam_id] = Camera(
            id=cam_id, model="PINHOLE", width=int(ds.widths[0]), height=int(ds.heights[0]),
            params=np.array(
                [float(ds.fx[0]), float(ds.fy[0]), float(ds.cx[0]), float(ds.cy[0])]
            ),
        )
        for i in range(len(ds)):
            ts = int(ds.timestamps[i])
            name = f"{side.name}_{ts}.png"
            src = data_io.path_config.image.get_rgb_file_path(side, ts)
            if not src.exists():
                print(f"[Warning] Missing image {src}; skipping frame.")
                continue
            shutil.copy2(src, image_dir / name)
            images[image_id] = Image(id=image_id, qvec=rot_cw[i], tvec=positions_cw[i],
                                     camera_id=cam_id, name=name)
            image_id += 1

    points3D = {}
    if include_points:
        pcd = data_io.reconstruction.load_colored_pcd()
        if pcd is None:
            print("[Warning] No colored point cloud found; skipping Point3D export.")
        else:
            tf = Transforms(
                CoordinateSystem.OPEN3D, pcd.points, np.zeros((len(pcd.points), 4))
            ).convert_coordinate_system(CoordinateSystem.COLMAP, skip_rotation=True)
            colors = (
                (np.clip(pcd.colors, 0, 1) * 255).astype(np.uint8)
                if pcd.colors is not None
                else np.full((len(pcd.points), 3), 128, np.uint8)
            )
            for pid, (xyz, rgb) in enumerate(zip(tf.positions, colors), start=1):
                points3D[pid] = Point3D(id=pid, xyz=xyz, rgb=rgb)
    return cameras, images, points3D


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build a COLMAP project from a capture")
    parser.add_argument("--project_dir", type=Path, required=True)
    parser.add_argument("--output_dir", type=Path, default=None,
                        help="default: <project_dir>/colmap")
    parser.add_argument("--interval", type=int, default=1, help="use every k-th frame")
    parser.add_argument("--include_points", action="store_true",
                        help="export the colored point cloud as Point3D records")
    add_device(parser)
    args = parser.parse_args(argv)

    data_io = DataIO(args.project_dir)
    out_dir = args.output_dir or (args.project_dir / "colmap")
    image_dir = out_dir / "input"
    image_dir.mkdir(parents=True, exist_ok=True)
    cameras, images, points3D = build_model(data_io, image_dir, args.interval,
                                            args.include_points)
    model_dir = out_dir / "distorted/sparse/0"
    write_model(cameras, images, points3D, model_dir, ext=".bin")
    print(f"[Info] COLMAP model written to {model_dir} "
          f"({len(cameras)} cameras, {len(images)} images, {len(points3D)} points)")
    return model_dir


if __name__ == "__main__":
    main()
