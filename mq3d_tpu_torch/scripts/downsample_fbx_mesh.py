"""CLI: downsample a mesh (PLY or FBX) or a point cloud.

    python -m mq3d_tpu_torch.scripts.downsample_fbx_mesh \
        --input <ply|fbx> --output <ply|fbx> [--ratio 0.25] \
        [--method quadric|cluster] [--voxel V] [--uniform_k K]

Counterpart of scripts/downsample_fbx_mesh.py of the JAX build (host
numpy; --device is accepted, as by every CLI of the port, and nothing here
runs on it).  Meshes: quadric-error decimation (ops/decimate.py), falling
back to vertex clustering with a target-ratio search when it lands more
than 30 % above the target, or clustering alone (--method cluster,
--voxel).  Point clouds: voxel or uniform downsampling.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.dataio.ply import (
    PointCloud,
    TriangleMesh,
    read_ply,
    write_ply_mesh,
    write_ply_pointcloud,
)
from mq3d_tpu_torch.export.fbx import convert_fbx_to_ply, convert_ply_to_fbx
from mq3d_tpu_torch.ops.decimate import simplify_to_ratio
from mq3d_tpu_torch.ops.icp import uniform_down_sample, voxel_down_sample
from mq3d_tpu_torch.ops.mesh_filter import (
    remove_degenerate_and_duplicated_triangles,
    remove_unreferenced_vertices,
)
from mq3d_tpu_torch.scripts._cli import add_device


def vertex_clustering_decimate(mesh: TriangleMesh, voxel: float) -> TriangleMesh:
    verts = np.asarray(mesh.vertices)
    keys = np.floor(verts / voxel).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    # Cluster centroid per voxel.
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inverse, verts)
    counts = np.bincount(inverse)
    new_verts = sums / counts[:, None]
    new_tris = inverse[np.asarray(mesh.triangles)]
    new_tris = remove_degenerate_and_duplicated_triangles(new_tris)
    out = TriangleMesh(new_verts, new_tris)
    if mesh.vertex_colors is not None:
        csum = np.zeros((len(uniq), 3))
        np.add.at(csum, inverse, np.asarray(mesh.vertex_colors))
        out.vertex_colors = csum / counts[:, None]
    return remove_unreferenced_vertices(out)


def decimate_to_ratio(mesh: TriangleMesh, ratio: float) -> TriangleMesh:
    """Binary-search the clustering voxel size for a target triangle ratio."""
    target = max(int(len(mesh.triangles) * ratio), 4)
    bbox = np.asarray(mesh.vertices).max(0) - np.asarray(mesh.vertices).min(0)
    lo, hi = 1e-4, float(np.linalg.norm(bbox))
    best = mesh
    for _ in range(20):
        mid = (lo + hi) / 2
        cand = vertex_clustering_decimate(mesh, mid)
        if len(cand.triangles) > target:
            lo = mid
        else:
            hi = mid
            best = cand
        if abs(len(cand.triangles) - target) < max(target // 20, 10):
            best = cand
            break
    return best


def decimate_mesh(mesh: TriangleMesh, ratio: float, method: str = "quadric",
                  voxel: float | None = None) -> TriangleMesh:
    """The mesh path of the CLI."""
    if voxel:
        return vertex_clustering_decimate(mesh, voxel)
    if method == "cluster":
        return decimate_to_ratio(mesh, ratio)
    out = simplify_to_ratio(mesh, ratio)
    if len(out.triangles) > int(len(mesh.triangles) * ratio) * 1.3:
        print("[Info] Quadric decimation off target, fine-tuning with vertex clustering")
        out = decimate_to_ratio(mesh, ratio)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=Path, required=True, help="PLY or FBX")
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--ratio", type=float, default=0.25,
                        help="target triangle / point ratio")
    parser.add_argument("--voxel", type=float, default=None,
                        help="explicit clustering voxel size (overrides --ratio)")
    parser.add_argument("--uniform_k", type=int, default=None,
                        help="point clouds: keep every k-th point")
    parser.add_argument("--method", choices=["quadric", "cluster"], default="quadric",
                        help="mesh decimation method (quadric = QEM edge collapse)")
    add_device(parser)
    args = parser.parse_args(argv)

    if args.input.suffix.lower() == ".fbx":
        # Through a PLY, as the JAX build does: the same float32 vertices
        # and uint8 colours reach the decimation.
        tmp = args.input.with_suffix(".tmp.ply")
        convert_fbx_to_ply(args.input, tmp)
        geom = read_ply(tmp)
        tmp.unlink()
    else:
        geom = read_ply(args.input)
    if isinstance(geom, TriangleMesh) and len(geom.triangles):
        out = decimate_mesh(geom, args.ratio, args.method, args.voxel)
        print(f"[Info] Mesh: {len(geom.triangles)} -> {len(out.triangles)} triangles")
        if args.output.suffix.lower() == ".fbx":
            tmp_out = args.output.with_suffix(".tmp.ply")
            write_ply_mesh(tmp_out, out)
            convert_ply_to_fbx(tmp_out, args.output)
            tmp_out.unlink()
        else:
            write_ply_mesh(args.output, out)
    else:
        pts = geom.points
        if args.uniform_k:
            pts = uniform_down_sample(pts, args.uniform_k)
        elif args.voxel:
            pts = voxel_down_sample(pts, args.voxel)
        else:
            pts = uniform_down_sample(pts, max(int(1 / args.ratio), 1))
        print(f"[Info] Point cloud: {len(geom.points)} -> {len(pts)} points")
        write_ply_pointcloud(args.output, PointCloud(points=pts))
        out = None
    print(f"[Info] Written to {args.output}")
    return out


if __name__ == "__main__":
    main()
