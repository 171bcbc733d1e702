"""Mesh quality score Q (host numpy + scipy), the counterpart of
mq3d_tpu/eval/quality.py — a re-design of the reference's evaluation
harness (reference: scripts/evaluation/evaluate_fbx_quality.py):

    Q_raw = 0.50 * S_geom + 0.25 * S_smooth + 0.15 * S_complete
          + 0.10 * S_color
    S_geom     = 0.25 * S_shape + 0.15 * S_topology + 0.10 * S_bonuses
    S_shape    = 0.5 * (1 - ar_norm) + 0.5 * (1 - skew_norm)
    S_topology = 0.4*(1-deg) + 0.3*(1-nonmanifold) + 0.2*(1-boundary)
               + 0.1*(1-(components-1))           (each batch min-max)
    S_bonuses  = 0.5 * is_manifold + 0.5 * is_watertight
    S_smooth   = 0.48*(1-normal_dev) + 0.32*(1-dihedral_penalty)
               + 0.20*(1-surface_roughness)
    S_complete = 0.50*(1-boundary_edge_ratio) + 0.30*is_single_component
               + 0.20*(1-density_std_norm)
    S_color    = 0.5*(1-uncolored_norm) + 0.5*(1-color_grad_norm), or 0.5
                 when colorless
    Q_norm     = batch min-max of Q_raw

The raw metric set matches the reference column-for-column
(evaluate_fbx_quality.py:148-185 RawMeshMetrics, :600-640 CSV schema) so
quality_scores.csv interchanges with the reference's analysis scripts.  The
computation is vectorized numpy + scipy (lexsorted edge tables, sparse
connected components) instead of the reference's per-triangle Python loops.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import List

import numpy as np

from mq3d_tpu_torch.dataio.ply import TriangleMesh


@dataclass
class RawMeshMetrics:
    """Per-mesh raw statistics before batch normalization (same fields as
    reference evaluate_fbx_quality.py:148-185)."""

    name: str = ""
    path: str = ""

    # Shape / topology
    mean_aspect_ratio: float = 1.0
    mean_skewness: float = 0.0
    degenerate_triangles: int = 0
    non_manifold_edges: int = 0
    boundary_edge_ratio: float = 0.0
    component_count: int = 0
    total_edges: int = 0

    # Smoothness
    normal_deviation_avg_deg: float = 0.0
    dihedral_min_deg: float = 180.0
    dihedral_max_deg: float = 0.0
    dihedral_penalty: float = 0.0
    surface_roughness: float = 0.0  # stddev of dihedral angles (deg)

    # Completeness
    is_single_component: bool = False
    vertex_density_stddev: float = 0.0

    # Color
    has_color: bool = False
    uncolored_vertex_ratio: float = 1.0
    color_gradient_stddev: float = 0.0

    # Derived booleans
    is_manifold: bool = False
    is_watertight: bool = False

    num_vertices: int = 0
    num_triangles: int = 0


def _edge_table(tris: np.ndarray, nv: int):
    """(unique edge keys, per-edge face counts, sorted (edge_key, face_id))
    from the packed undirected edge list."""
    edges = np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    edges_sorted = np.sort(edges, axis=1)
    keys = edges_sorted[:, 0].astype(np.int64) * nv + edges_sorted[:, 1]
    face_ids = np.tile(np.arange(len(tris)), 3)
    # Drop degenerate self-edges (u == v) as the reference's edge table does.
    ok = edges_sorted[:, 0] != edges_sorted[:, 1]
    keys, face_ids = keys[ok], face_ids[ok]
    order = np.argsort(keys, kind="stable")
    return keys[order], face_ids[order]


def compute_raw_metrics(
    mesh: TriangleMesh,
    name: str = "",
    path: str = "",
) -> RawMeshMetrics:
    """All raw per-mesh metrics, vectorized (reference :252-441)."""
    verts = np.asarray(mesh.vertices, np.float64)
    tris = np.asarray(mesh.triangles, np.int64)
    nv, nt = len(verts), len(tris)
    if nv == 0 or nt == 0:
        return RawMeshMetrics(name=name, path=path, num_vertices=nv,
                              num_triangles=nt)

    p0, p1, p2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    cross = np.cross(p1 - p0, p2 - p0)
    area2 = np.linalg.norm(cross, axis=-1)  # 2x area

    # Degenerates: repeated indices or tiny area (reference :276-283).
    repeated = ((tris[:, 0] == tris[:, 1]) | (tris[:, 1] == tris[:, 2])
                | (tris[:, 2] == tris[:, 0]))
    degenerate = repeated | (0.5 * area2 < 1e-10)
    good = ~degenerate

    e0 = np.linalg.norm(p1 - p0, axis=-1)
    e1 = np.linalg.norm(p2 - p1, axis=-1)
    e2 = np.linalg.norm(p0 - p2, axis=-1)
    lens = np.stack([e0, e1, e2], -1)
    aspect = lens.max(-1) / np.maximum(lens.min(-1), 1e-12)

    # Equiangle skewness (reference :88-110): interior angles via arccos.
    def angles_at(a, b, c):
        u, v = b - a, c - a
        un = u / (np.linalg.norm(u, axis=-1, keepdims=True) + 1e-12)
        vn = v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)
        return np.arccos(np.clip(np.einsum("ij,ij->i", un, vn), -1.0, 1.0))

    ang = np.stack([angles_at(p0, p1, p2), angles_at(p1, p2, p0),
                    angles_at(p2, p0, p1)], -1)
    ideal = np.radians(60.0)
    skew = np.clip(
        np.maximum((ideal - ang.min(-1)) / ideal,
                   (ang.max(-1) - ideal) / ideal), 0.0, 1.0)

    mean_aspect = float(aspect[good].mean()) if good.any() else 1.0
    mean_skew = float(skew[good].mean()) if good.any() else 0.0

    # Topology from the lexsorted edge table.
    keys_sorted, faces_sorted = _edge_table(tris, nv)
    uniq_keys, starts, counts = np.unique(
        keys_sorted, return_index=True, return_counts=True)
    total_edges = len(uniq_keys)
    boundary_edges = int((counts == 1).sum())
    non_manifold = int((counts > 2).sum())
    boundary_ratio = boundary_edges / total_edges if total_edges else 0.0

    # Connected components over the vertex adjacency graph.
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    eu = (uniq_keys // nv).astype(np.int64)
    ev = (uniq_keys % nv).astype(np.int64)
    adj = coo_matrix(
        (np.ones(len(eu), np.int8), (eu, ev)), shape=(nv, nv))
    n_components, _ = connected_components(adj, directed=False)
    # The reference counts components over vertices that appear in the
    # adjacency dict (all vertices, isolated ones included).
    is_manifold = non_manifold == 0
    is_watertight = bool(is_manifold and boundary_edges == 0
                         and n_components == 1)

    # Face normals (normalized) and area-weighted vertex normals
    # (Open3D ComputeVertexNormals convention the reference relies on).
    fn = cross / np.maximum(area2, 1e-12)[:, None]
    vn = np.zeros((nv, 3))
    for k in range(3):
        np.add.at(vn, tris[:, k], cross)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)

    # Vertex-normal deviation along unique edges (degrees).
    cosd = np.clip(np.einsum("ij,ij->i", vn[eu], vn[ev]), -1.0, 1.0)
    normal_dev = float(np.degrees(np.arccos(cosd)).mean()) \
        if total_edges else 0.0

    # Dihedral angles across interior (2-face) edges.
    pair_mask = counts == 2
    if pair_mask.any():
        fa = faces_sorted[starts[pair_mask]]
        fb = faces_sorted[starts[pair_mask] + 1]
        cosf = np.clip(np.einsum("ij,ij->i", fn[fa], fn[fb]), -1.0, 1.0)
        dihedral = np.degrees(np.arccos(cosf))
        dihed_min = float(dihedral.min())
        dihed_max = float(dihedral.max())
        dihedral_penalty = (max(0.0, 30.0 - dihed_min)
                            + max(0.0, dihed_max - 170.0))
        roughness = float(dihedral.std())
    else:
        dihed_min, dihed_max = 180.0, 0.0
        dihedral_penalty, roughness = 0.0, 0.0

    # Completeness: 10^3 bbox voxel grid, stddev of non-empty cell
    # densities (reference :357-384).
    bb_min = verts.min(0)
    extent = verts.max(0) - bb_min
    extent[extent == 0.0] = 1e-6
    grid_res = 10
    voxel_sizes = extent / grid_res
    voxel_vol = float(np.prod(voxel_sizes)) or 1.0
    idx = np.clip((verts - bb_min) / voxel_sizes, 0,
                  grid_res - 1e-9).astype(np.int64)
    flat_idx = (idx[:, 0] * grid_res + idx[:, 1]) * grid_res + idx[:, 2]
    cell_counts = np.bincount(flat_idx, minlength=grid_res ** 3)
    nonzero = cell_counts[cell_counts > 0].astype(np.float64) / voxel_vol
    density_std = float(nonzero.std()) if nonzero.size else 0.0

    # Color metrics (reference :391-424).
    has_color = (mesh.vertex_colors is not None
                 and len(mesh.vertex_colors) > 0)
    if has_color:
        vc = np.asarray(mesh.vertex_colors, np.float64)
        if vc.max() > 1.0:
            vc = vc / 255.0
        if vc.shape[0] != nv:
            vc = np.resize(vc, (nv, 3))
        uncolored_ratio = 0.0
        grad = np.linalg.norm(vc[eu] - vc[ev], axis=-1)
        color_std = float(grad.std()) if len(grad) else 0.0
    else:
        uncolored_ratio = 1.0
        color_std = 0.0

    return RawMeshMetrics(
        name=name, path=path,
        mean_aspect_ratio=mean_aspect,
        mean_skewness=mean_skew,
        degenerate_triangles=int(degenerate.sum()),
        non_manifold_edges=non_manifold,
        boundary_edge_ratio=float(boundary_ratio),
        component_count=int(n_components),
        total_edges=int(total_edges),
        normal_deviation_avg_deg=normal_dev,
        dihedral_min_deg=dihed_min,
        dihedral_max_deg=dihed_max,
        dihedral_penalty=float(dihedral_penalty),
        surface_roughness=roughness,
        is_single_component=bool(n_components == 1),
        vertex_density_stddev=density_std,
        has_color=bool(has_color),
        uncolored_vertex_ratio=float(uncolored_ratio),
        color_gradient_stddev=color_std,
        is_manifold=bool(is_manifold),
        is_watertight=is_watertight,
        num_vertices=nv,
        num_triangles=nt,
    )


def min_max_normalize(values: np.ndarray) -> np.ndarray:
    """Reference min_max_normalize (:120-132): constant batches -> 0.5."""
    v = np.asarray(values, np.float64)
    lo, hi = float(np.min(v)), float(np.max(v))
    if np.isclose(lo, hi):
        return np.full_like(v, 0.5)
    return (v - lo) / (hi - lo)


@dataclass
class QualityScores:
    """Per-mesh quality scores after batch normalization (reference
    :449-472)."""

    name: str
    path: str
    S_shape: float
    S_topology: float
    S_bonuses: float
    S_geom: float
    S_smooth: float
    S_complete: float
    S_color: float
    Q_raw: float
    Q_norm: float
    raw: RawMeshMetrics = field(repr=False, default=None)


def compute_quality_scores(
    raw_metrics: List[RawMeshMetrics],
) -> List[QualityScores]:
    """Batch-normalized quality scores, formula-exact to the reference
    (:475-589)."""
    n = len(raw_metrics)
    if n == 0:
        return []

    def arr(get):
        return np.array([get(m) for m in raw_metrics], float)

    ar_n = min_max_normalize(arr(lambda m: m.mean_aspect_ratio))
    skew_n = min_max_normalize(arr(lambda m: m.mean_skewness))
    deg_n = min_max_normalize(arr(lambda m: m.degenerate_triangles))
    nonman_n = min_max_normalize(arr(lambda m: m.non_manifold_edges))
    bound_n = min_max_normalize(arr(lambda m: m.boundary_edge_ratio))
    comp_n = min_max_normalize(arr(lambda m: max(0, m.component_count - 1)))
    ndev_n = min_max_normalize(arr(lambda m: m.normal_deviation_avg_deg))
    dpen_n = min_max_normalize(arr(lambda m: m.dihedral_penalty))
    rough_n = min_max_normalize(arr(lambda m: m.surface_roughness))
    dens_n = min_max_normalize(arr(lambda m: m.vertex_density_stddev))
    uncol_n = min_max_normalize(arr(lambda m: m.uncolored_vertex_ratio))
    cgrad_n = min_max_normalize(arr(lambda m: m.color_gradient_stddev))

    scores: List[QualityScores] = []
    for i, m in enumerate(raw_metrics):
        S_shape = 0.5 * (1.0 - ar_n[i]) + 0.5 * (1.0 - skew_n[i])
        S_topology = (0.4 * (1.0 - deg_n[i]) + 0.3 * (1.0 - nonman_n[i])
                      + 0.2 * (1.0 - bound_n[i]) + 0.1 * (1.0 - comp_n[i]))
        S_bonuses = (0.5 * float(m.is_manifold)
                     + 0.5 * float(m.is_watertight))
        S_geom = 0.25 * S_shape + 0.15 * S_topology + 0.10 * S_bonuses
        S_smooth = (0.48 * (1.0 - ndev_n[i]) + 0.32 * (1.0 - dpen_n[i])
                    + 0.20 * (1.0 - rough_n[i]))
        S_complete = (0.50 * (1.0 - m.boundary_edge_ratio)
                      + 0.30 * float(m.is_single_component)
                      + 0.20 * (1.0 - dens_n[i]))
        if m.has_color:
            S_color = (0.5 * (1.0 - uncol_n[i])
                       + 0.5 * (1.0 - cgrad_n[i]))
        else:
            S_color = 0.5
        Q_raw = (0.50 * S_geom + 0.25 * S_smooth + 0.15 * S_complete
                 + 0.10 * S_color)
        scores.append(QualityScores(
            name=m.name, path=m.path, S_shape=float(S_shape),
            S_topology=float(S_topology), S_bonuses=float(S_bonuses),
            S_geom=float(S_geom), S_smooth=float(S_smooth),
            S_complete=float(S_complete), S_color=float(S_color),
            Q_raw=float(Q_raw), Q_norm=0.0, raw=m))

    q_norm = min_max_normalize(np.array([s.Q_raw for s in scores]))
    for i, s in enumerate(scores):
        s.Q_norm = float(q_norm[i])
    return scores


CSV_FIELDS = [
    "name", "path", "Q_raw", "Q_norm", "S_geom", "S_smooth", "S_complete",
    "S_color", "S_shape", "S_topology", "S_bonuses",
    "mean_aspect_ratio", "mean_skewness", "degenerate_triangles",
    "non_manifold_edges", "boundary_edge_ratio", "component_count",
    "total_edges", "normal_deviation_avg_deg", "dihedral_min_deg",
    "dihedral_max_deg", "dihedral_penalty", "surface_roughness",
    "is_single_component", "vertex_density_stddev", "has_color",
    "uncolored_vertex_ratio", "color_gradient_stddev", "is_manifold",
    "is_watertight", "num_vertices", "num_triangles",
]


def write_scores_csv(scores: List[QualityScores], csv_path: Path) -> Path:
    """quality_scores.csv with the reference's exact column set
    (:600-676), consumable by the analysis scripts."""
    import csv as _csv

    csv_path = Path(csv_path)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    with csv_path.open("w", newline="") as f:
        w = _csv.DictWriter(f, fieldnames=CSV_FIELDS)
        w.writeheader()
        for s in scores:
            row = {k: getattr(s, k) for k in CSV_FIELDS
                   if hasattr(s, k) and k not in ("name", "path")}
            row["name"] = s.name
            row["path"] = str(s.path)
            row.update({k: v for k, v in asdict(s.raw).items()
                        if k in CSV_FIELDS and k not in ("name", "path")})
            w.writerow(row)
    return csv_path


# ---------------------------------------------------------------------------
# Backwards-compatible condensed surface (round-1 API)
# ---------------------------------------------------------------------------

def score_batch(metrics: List[RawMeshMetrics]):
    """Round-1 compatibility: returns objects exposing .q / .s_geom etc."""

    @dataclass
    class _Compat:
        s_geom: float
        s_smooth: float
        s_complete: float
        s_color: float
        q: float

    return [
        _Compat(s_geom=s.S_geom, s_smooth=s.S_smooth,
                s_complete=s.S_complete, s_color=s.S_color, q=s.Q_raw)
        for s in compute_quality_scores(metrics)
    ]
