"""Uniform point sampling from a triangle mesh (host numpy), the
counterpart of mq3d_tpu/ops/sampling.py.

Replaces o3d sample_points_uniformly (reference reconstruct_scene.py:162-171):
triangles are sampled proportionally to area, points uniformly by barycentric
coordinates; colors/normals interpolate from vertices.  The explicit
`np.random.default_rng(seed)` stream gives the JAX build's samples.
"""

from __future__ import annotations

import numpy as np

from mq3d_tpu_torch.dataio.ply import PointCloud, TriangleMesh


def sample_points_uniformly(mesh: TriangleMesh, number_of_points: int,
                            seed: int = 0) -> PointCloud:
    tris = np.asarray(mesh.triangles)
    verts = np.asarray(mesh.vertices)
    if len(tris) == 0 or number_of_points <= 0:
        return PointCloud(points=np.zeros((0, 3)))

    rng = np.random.default_rng(seed)
    p0 = verts[tris[:, 0]]
    p1 = verts[tris[:, 1]]
    p2 = verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    total = areas.sum()
    if total <= 0:
        return PointCloud(points=np.zeros((0, 3)))
    tri_idx = rng.choice(len(tris), size=number_of_points, p=areas / total)

    r1 = np.sqrt(rng.random(number_of_points))
    r2 = rng.random(number_of_points)
    w0 = 1.0 - r1
    w1 = r1 * (1.0 - r2)
    w2 = r1 * r2
    t = tris[tri_idx]

    def interp(a):
        return w0[:, None] * a[t[:, 0]] + w1[:, None] * a[t[:, 1]] + w2[:, None] * a[t[:, 2]]

    pts = interp(verts)
    colors = None
    if mesh.vertex_colors is not None:
        colors = interp(np.asarray(mesh.vertex_colors))
    normals = None
    if mesh.vertex_normals is not None:
        normals = interp(np.asarray(mesh.vertex_normals))
        nrm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.maximum(nrm, 1e-12)
    return PointCloud(points=pts, normals=normals, colors=colors)
