"""Mesh cleanup: connected-component filtering and degenerate removal.

Counterpart of mq3d_tpu/ops/mesh_filter.py (the reference's
filter_mesh_components, o3d_utils.py:241-321): drop floating fragments
below a triangle count, keeping the largest component if none qualify,
then remove degenerate/duplicated triangles, duplicated vertices and
unreferenced vertices.

Component labelling runs on the given device (min-label hook on the roots
with `scatter_reduce(..., "amin")`, then pointer-jump compression, O(log n)
rounds).  The scipy labelling is kept as the test oracle
(`cluster_connected_triangles_host`); the device path never falls back to
it.
"""

from __future__ import annotations

import numpy as np
import torch

from mq3d_tpu_torch.dataio.ply import TriangleMesh
from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.utils.log import substep


def cluster_connected_triangles_host(mesh: TriangleMesh):
    """Host/scipy oracle for cluster_connected_triangles."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    tris = np.asarray(mesh.triangles)
    nv = len(mesh.vertices)
    if len(tris) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    rows = np.concatenate([tris[:, 0], tris[:, 1], tris[:, 2]])
    cols = np.concatenate([tris[:, 1], tris[:, 2], tris[:, 0]])
    g = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(nv, nv))
    _, vlabels = connected_components(g, directed=False)
    _, tlabels = np.unique(vlabels[tris[:, 0]], return_inverse=True)
    return tlabels.astype(np.int64), np.bincount(tlabels).astype(np.int64)


_MAX_ROUNDS = 64  # bound on hook rounds, the JAX build's


def _vertex_labels_device(tris: torch.Tensor, nv: int) -> torch.Tensor:
    """Min-label vertex components of (M, 3) triangles on their device.

    Each round: HOOK, every triangle scatter-mins the minimum of its three
    vertex labels into the three labels' roots (labels as indices, so whole
    trees merge per round, not one edge's worth as plain label propagation
    would); COMPRESS, pointer-jump L = L[L] to a fixed point.  Stops when a
    round changes nothing or after `_MAX_ROUNDS`.  Each stop test reads one
    flag on the host."""
    t = tris.long()
    L = torch.arange(nv, dtype=torch.int64, device=tris.device)
    for _ in range(_MAX_ROUNDS):
        la, lb, lc = L[t[:, 0]], L[t[:, 1]], L[t[:, 2]]
        m = torch.minimum(torch.minimum(la, lb), lc)
        L2 = L.clone()
        for lx in (la, lb, lc):
            L2.scatter_reduce_(0, lx, m, "amin")
        while True:
            L3 = L2[L2]
            if not bool(torch.any(L3 != L2)):
                break
            L2 = L3
        changed = bool(torch.any(L2 != L))
        L = L2
        if not changed:
            break
    return L


def cluster_connected_triangles(mesh: TriangleMesh, device="cuda"):
    """Label triangles by connected component (components connected via
    shared vertices), labelled on `device`.  Returns (triangle_clusters
    (M,), cluster_n_triangles), clusters numbered by their least vertex."""
    tris = np.asarray(mesh.triangles)
    if len(tris) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dev = resolve_device(device)
    t = torch.from_numpy(np.ascontiguousarray(tris, np.int64)).to(dev)
    with substep("filter_mesh_components.labels"):
        vlabels = _vertex_labels_device(t, len(mesh.vertices)).cpu().numpy()
    _, tlabels = np.unique(vlabels[tris[:, 0]], return_inverse=True)
    return tlabels.astype(np.int64), np.bincount(tlabels).astype(np.int64)


def remove_duplicated_vertices(mesh: TriangleMesh) -> TriangleMesh:
    verts = np.asarray(mesh.vertices)
    uniq, index, inverse = np.unique(verts, axis=0, return_index=True, return_inverse=True)
    out = TriangleMesh(uniq, inverse.reshape(-1)[np.asarray(mesh.triangles)])
    if mesh.vertex_colors is not None:
        out.vertex_colors = np.asarray(mesh.vertex_colors)[index]
    if mesh.vertex_normals is not None:
        out.vertex_normals = np.asarray(mesh.vertex_normals)[index]
    return out


def remove_degenerate_and_duplicated_triangles(tris: np.ndarray) -> np.ndarray:
    good = (tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])
    tris = tris[good]
    # Duplicates irrespective of rotation order: canonical sorted key.
    _, keep = np.unique(np.sort(tris, axis=1), axis=0, return_index=True)
    return tris[np.sort(keep)]


def remove_unreferenced_vertices(mesh: TriangleMesh) -> TriangleMesh:
    tris = np.asarray(mesh.triangles)
    used = np.zeros(len(mesh.vertices), bool)
    used[tris.reshape(-1)] = True
    remap = np.full(len(mesh.vertices), -1, np.int64)
    remap[used] = np.arange(used.sum())
    out = TriangleMesh(np.asarray(mesh.vertices)[used], remap[tris])
    if mesh.vertex_colors is not None:
        out.vertex_colors = np.asarray(mesh.vertex_colors)[used]
    if mesh.vertex_normals is not None:
        out.vertex_normals = np.asarray(mesh.vertex_normals)[used]
    return out


def filter_mesh_components(mesh: TriangleMesh, min_triangle_count: int = 2000,
                           device="cuda") -> TriangleMesh:
    """Drop small disconnected components; keep the largest if none
    qualify.  Components are labelled on `device`."""
    tris = np.asarray(mesh.triangles)
    if len(tris) == 0:
        print("[Warning] Mesh filtering: input mesh has no triangles")
        return mesh

    tlabels, counts = cluster_connected_triangles(mesh, device)
    valid_clusters = np.nonzero(counts >= min_triangle_count)[0]
    if len(valid_clusters) == 0:
        print(f"[Warning] Mesh filtering: no components with >= {min_triangle_count} "
              f"triangles (largest has {counts.max()}); keeping largest only.")
        valid_clusters = np.asarray([np.argmax(counts)])

    mask = np.isin(tlabels, valid_clusters)
    removed = int((~mask).sum())
    out = TriangleMesh(
        np.asarray(mesh.vertices),
        remove_degenerate_and_duplicated_triangles(tris[mask]),
        vertex_colors=mesh.vertex_colors,
        vertex_normals=mesh.vertex_normals,
    )
    out = remove_duplicated_vertices(out)
    out = remove_unreferenced_vertices(out)
    kept, total = len(valid_clusters), len(counts)
    if total - kept > 0:
        print(f"[Info] Mesh filtering: kept {kept}/{total} components, "
              f"removed {removed} triangles")
    return out
