"""Point-cloud registration: multi-scale ICP, evaluation, information matrix.

Counterpart of mq3d_tpu/ops/icp.py (Open3D's multi_scale_icp,
evaluate_registration and get_information_matrix, reference
refine_fragment_poses.py:136-182), with the same two tree-free nearest
neighbour structures:

- the CSR voxel bucket grid (`GridNN`): exact in-radius nearest neighbour
  over the 2x2x2 cell neighbourhood at cell = 2 x radius;
- the discrete-Voronoi nearest-id field (`VoroNN`): one scatter-min builds
  a dense field of the target id nearest to each cell centre, and a query
  takes the nearest of the 8 ids around it, within O(cell) of the true
  nearest.  Past _VORO_MAX_CELLS cells the builder returns the CSR grid.

Point-to-point ICP (Horn's quaternion method on the masked
correspondence moments) runs on tensors for a batch of sources that share
one target: every pass is (sources, points)-shaped, retired sources keep
their state under `torch.where` as XLA keeps a lane of a vmapped
while_loop, and the host tests whether any source is still running every
_ACTIVE_CHECK_EVERY iterations, so each source stops at the iteration its
own loop would.  One batched formulation serves single pairs and batches;
the JAX package's source-tiled variants exist only for a TPU lane-width
limit.  Batches are cut by max_stack_bytes of stacked sources.

Arithmetic follows XLA's CPU code: the transforms are
`ops.tsdf._apply_pose`, the Voronoi scatter's cell centres and squared
distances are fused multiply-add chains (its ids equal the JAX
package's), the query's squared distances take the chain XLA uses most
(`_d2`; on voxel-lattice clouds near-ties then break the same way), and
divisors are tensors.  The JAX package sums the float32 moments one point
after another; the port sums them in another order (which also differs
between the CPU and the card), so poses agree to a tolerance
(tests/test_torch_icp.py, tests/test_torch_fragments.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from mq3d_tpu_torch.ops.tsdf import _apply_pose, _fma, _sqrt, _to_i32

# Iterations between the host's tests of whether any source still runs.
_ACTIVE_CHECK_EVERY = 4
# Stacked sources per batch of the information matrices, and the default
# bound of an ICP batch: keeps the (sources, points) temporaries bounded.
_MAX_STACK_BYTES = 256 * 1024 * 1024


# ---------------------------------------------------------------------------
# Downsampling (host)
# ---------------------------------------------------------------------------

def voxel_down_sample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Average points per voxel (o3d voxel_down_sample semantics)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel_size).astype(np.int64)
    kmin = keys.min(axis=0)
    keys = keys - kmin
    dims = keys.max(axis=0) + 1
    lin = (keys[:, 0] * dims[1] + keys[:, 1]) * dims[2] + keys[:, 2]
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    pts_s = points[order]
    boundaries = np.concatenate([[True], lin_s[1:] != lin_s[:-1]])
    seg_ids = np.cumsum(boundaries) - 1
    n_seg = seg_ids[-1] + 1
    sums = np.zeros((n_seg, 3))
    np.add.at(sums, seg_ids, pts_s)
    counts = np.bincount(seg_ids)
    return sums / counts[:, None]


def uniform_down_sample(points: np.ndarray, every_k: int) -> np.ndarray:
    """Every k-th point (o3d uniform_down_sample)."""
    return points[:: max(int(every_k), 1)]


# ---------------------------------------------------------------------------
# Grid-bucket nearest neighbour
# ---------------------------------------------------------------------------

@dataclass
class GridNN:
    """CSR voxel bucket index over a target cloud: `order` holds target ids
    sorted by cell, `starts[lin]` each cell's offset into it (padded cells
    read start == end == n_target), and `max_occ` (the largest cell's
    occupancy, capped at `capacity`, as a power of two) bounds the query
    loop.  Arrays are numpy after the build; `to(device)` moves them."""

    target: np.ndarray  # (M_pad, 3) float32, padded with +inf
    order: np.ndarray  # (M_ord_pad,) int32 target ids sorted by cell
    starts: np.ndarray  # (n_cells_pad,) int32 CSR offsets into order
    gmin: np.ndarray  # (3,) float32
    dims: np.ndarray  # (3,) int32
    cell: float
    capacity: int
    max_occ: int
    n_target: int

    def to(self, device) -> "GridNN":
        for k in ("target", "order", "starts", "gmin", "dims"):
            setattr(self, k, torch.as_tensor(getattr(self, k), device=device))
        return self


def _bucket_pow2(n: int, floor: int = 1024) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def build_grid_nn(target: np.ndarray, radius: float, capacity: int = 32) -> GridNN:
    """Host-side build: one sort over target points.  Cell size is 2x the
    search radius, so the 2x2x2 neighbourhood around floor(rel - 0.5)
    covers at least `radius` in every direction."""
    target = np.asarray(target, np.float32)
    m = len(target)
    cell = float(radius) * 2.0
    gmin = target.min(axis=0) - cell if m else np.zeros(3, np.float32)
    keys = np.floor((target - gmin) / cell).astype(np.int64) if m else np.zeros((0, 3), np.int64)
    dims = (keys.max(axis=0) + 2) if m else np.ones(3, np.int64)
    lin = (keys[:, 0] * dims[1] + keys[:, 1]) * dims[2] + keys[:, 2]
    n_cells = int(np.prod(dims))

    order = np.argsort(lin, kind="stable").astype(np.int32)
    counts = np.bincount(lin, minlength=n_cells) if m else np.zeros(n_cells, np.int64)
    starts = np.full(_bucket_pow2(n_cells + 1), m, np.int32)
    starts[0] = 0
    starts[1:n_cells + 1] = np.cumsum(counts).astype(np.int32)
    max_occ = _bucket_pow2(int(min(counts.max() if m else 0, capacity)), 1)

    order_pad = np.zeros(_bucket_pow2(max(m, 1), 256), np.int32)
    order_pad[:m] = order
    tgt_pad = np.full((_bucket_pow2(max(m, 1), 256), 3), np.inf, np.float32)
    tgt_pad[:m] = target
    return GridNN(target=tgt_pad, order=order_pad, starts=starts,
                  gmin=gmin.astype(np.float32), dims=dims.astype(np.int32), cell=cell,
                  capacity=capacity, max_occ=max_occ, n_target=m)


def _d2(px, py, pz, t, ti):
    """Squared distance from (px, py, pz) to target points t[ti], as XLA's
    CPU code contracts dx^2 + dy^2 + dz^2 most often:
    fma(dz, dz, fma(dx, dx, dy * dy))."""
    dx, dy, dz = px - t[ti, 0], py - t[ti, 1], pz - t[ti, 2]
    return _fma(dz, dz, _fma(dx, dx, dy * dy))


def _query_cells(p, gmin, dims, cell):
    """The 8 cells around each point: yields (ok, lin) per cell, lin
    clamped to 0 where the cell lies outside the grid."""
    rel = (p - gmin) / cell
    base = _to_i32(torch.floor(rel - 0.5))
    n_cells = dims[0] * dims[1] * dims[2]
    for dx in range(2):
        for dy in range(2):
            for dz in range(2):
                c = base + torch.tensor([dx, dy, dz], dtype=torch.int32, device=p.device)
                ok = ((c >= 0) & (c < dims)).all(dim=-1)
                lin = (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]
                yield ok, torch.where(ok & (lin < n_cells), lin, 0)


def _nn_query(p, grid: GridNN):
    """Exact nearest target within the 2x2x2 cell neighbourhood of each
    transformed point p (..., 3).  Returns (idx (...,) int64, dist (...,));
    idx -1 and dist inf where there is none.  Candidates reduce one CSR
    slot at a time, so only (...,)-shaped tensors are live."""
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    starts, order, tgt = grid.starts, grid.order.long(), grid.target
    s_last = starts.shape[0] - 1
    m_ord = order.shape[0]
    best_d2 = torch.full(px.shape, torch.inf, dtype=torch.float32, device=p.device)
    best_i = torch.full(px.shape, -1, dtype=torch.int64, device=p.device)
    for ok, lin in _query_cells(p, grid.gmin, grid.dims, _cell(grid, p)):
        lin = lin.clamp(max=s_last - 1).long()
        s = torch.where(ok, starts[lin], 0)
        e = torch.where(ok, starts[lin + 1], 0)
        for k in range(grid.max_occ):
            pos = s + k
            ti = order[pos.clamp(max=m_ord - 1).long()]
            d2 = torch.where(pos < e, _d2(px, py, pz, tgt, ti), torch.inf)
            better = d2 < best_d2
            best_d2 = torch.where(better, d2, best_d2)
            best_i = torch.where(better, ti, best_i)
    return best_i, _sqrt(best_d2)


def _cell(grid, like: torch.Tensor) -> torch.Tensor:
    """The cell size as a float32 tensor on `like`'s device (a tensor
    divisor divides exactly on the card)."""
    return torch.tensor(grid.cell, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Discrete-Voronoi nearest-id field
# ---------------------------------------------------------------------------

@dataclass
class VoroNN:
    """Dense nearest-target-id field at cell size == the search radius: each
    cell holds the id of the target point nearest to the cell centre (-1
    when none lies within its 3x3x3 neighbourhood).  Every target within
    `radius` of a query lies in one of the 8 cells it reads; only a point
    nearer to that cell's centre can shadow it, and that point is itself a
    near-nearest correspondence."""

    target: np.ndarray  # (M_pad, 3) float32, padded with +inf
    ids: torch.Tensor  # (n_cells_pad,) int32 nearest id per cell, -1 empty
    gmin: np.ndarray  # (3,) float32
    dims: np.ndarray  # (3,) int32
    cell: float
    n_target: int

    def to(self, device) -> "VoroNN":
        for k in ("target", "ids", "gmin", "dims"):
            setattr(self, k, torch.as_tensor(getattr(self, k), device=device))
        return self


# Larger fields are not built: the builder returns the CSR grid instead.
_VORO_MAX_CELLS = 64 * 1024 * 1024

_NEIGH27 = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij"),
                    -1).reshape(-1, 3).astype(np.int32)

_INT64_MAX = torch.iinfo(torch.int64).max


def _voro_scatter(pts, gmin, dims, cell, n_cells_pad: int):
    """Scatter-min of (squared distance to the cell centre, id) over each
    point's 3x3x3 cell neighbourhood.  The float32 distance bits order
    like the floats for non-negative values, so one int64 key carries both
    and the result does not depend on the scatter order.  Cells past the
    field are dropped, as XLA drops them."""
    dev = pts.device
    keys = _to_i32(torch.floor((pts - gmin) / cell))
    cells = keys[:, None, :] + torch.from_numpy(_NEIGH27).to(dev)[None]  # (m, 27, 3)
    centers = _fma(cells.float() + 0.5, cell, gmin)
    d = pts[:, None, :] - centers
    d2 = _fma(d[..., 2], d[..., 2], _fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
    lin = ((cells[..., 0] * dims[1] + cells[..., 1]) * dims[2] + cells[..., 2]).long()
    m = pts.shape[0]
    ids = torch.arange(m, dtype=torch.int64, device=dev)[:, None].expand(m, 27)
    key = (d2.view(torch.int32).long() << 32) | ids
    keep = (lin >= 0) & (lin < n_cells_pad)
    field = torch.full((n_cells_pad,), _INT64_MAX, dtype=torch.int64, device=dev)
    field.scatter_reduce_(0, lin[keep], key[keep], reduce="amin")
    return torch.where(field == _INT64_MAX, -1, field & 0x7FFFFFFF).to(torch.int32)


def build_voronoi_nn(target: np.ndarray, radius: float, device="cuda") -> "VoroNN | GridNN":
    """Build the nearest-id field on `device` (one scatter-min), or the CSR
    grid (on the host) when the dense field would exceed _VORO_MAX_CELLS
    or the target is empty."""
    target = np.asarray(target, np.float32)
    m = len(target)
    cell = float(radius)
    if m == 0:
        return build_grid_nn(target, radius)
    tmin = target.min(axis=0)
    tmax = target.max(axis=0)
    # Two guard cells on each side: scatter cells (key +- 1) and query
    # cells (floor(rel - 0.5) + {0, 1}) stay in bounds for any point in
    # [tmin - cell, tmax + cell].
    gmin = tmin - 2.0 * cell
    dims = np.floor((tmax - gmin) / cell).astype(np.int64) + 3
    n_cells = int(np.prod(dims))
    if n_cells > _VORO_MAX_CELLS:
        return build_grid_nn(target, radius)

    pts = torch.from_numpy(target).to(device)
    ids = _voro_scatter(pts, torch.from_numpy(gmin.astype(np.float32)).to(device),
                        torch.from_numpy(dims.astype(np.int32)).to(device),
                        torch.tensor(cell, dtype=torch.float32, device=device),
                        _bucket_pow2(n_cells, 1024))
    tgt_pad = np.full((_bucket_pow2(max(m, 1), 256), 3), np.inf, np.float32)
    tgt_pad[:m] = target
    return VoroNN(target=tgt_pad, ids=ids, gmin=gmin.astype(np.float32),
                  dims=dims.astype(np.int32), cell=cell, n_target=m)


def _nn_query_voro(p, grid: VoroNN):
    """Approximate nearest neighbour through the Voronoi field: 8 id reads
    and 8 true distances per point.  Returns (idx, dist) as _nn_query."""
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    ids, tgt = grid.ids, grid.target
    i_last = ids.shape[0] - 1
    best_d2 = torch.full(px.shape, torch.inf, dtype=torch.float32, device=p.device)
    best_i = torch.full(px.shape, -1, dtype=torch.int64, device=p.device)
    for ok, lin in _query_cells(p, grid.gmin, grid.dims, _cell(grid, p)):
        ti = ids[lin.clamp(max=i_last).long()].long()
        ok = ok & (ti >= 0)
        tis = ti.clamp(min=0)
        d2 = torch.where(ok, _d2(px, py, pz, tgt, tis), torch.inf)
        better = d2 < best_d2
        best_d2 = torch.where(better, d2, best_d2)
        best_i = torch.where(better, tis, best_i)
    return best_i, _sqrt(best_d2)


def _query(p, grid):
    return _nn_query_voro(p, grid) if isinstance(grid, VoroNN) else _nn_query(p, grid)


def _on(grid, device):
    """`grid` with its arrays on `device` (no copy when they are there)."""
    if torch.is_tensor(grid.target) and grid.target.device == device:
        return grid
    return type(grid)(**vars(grid)).to(device)


# ---------------------------------------------------------------------------
# Point-to-point ICP
# ---------------------------------------------------------------------------

@dataclass
class RegistrationResult:
    transformation: np.ndarray
    fitness: float = 0.0
    inlier_rmse: float = 0.0
    n_correspondences: int = 0


@dataclass
class ICPConvergenceCriteria:
    max_iteration: int = 30
    relative_fitness: float = 1e-6
    relative_rmse: float = 1e-6


def _inliers(src, n_src, T, grid, max_corr):
    """Transformed sources p (B, N, 3), their correspondences q (B, N, 3)
    (zero outside the inliers), the inlier mask and the distances, for
    sources src (B, N, 3) with n_src (B,) real points, poses T (B, 4, 4)
    float64 and per-source max_corr (B,) float32."""
    p = _apply_pose(src, T.float()[:, None])
    idx, dist = _query(p, grid)
    n = src.shape[1]
    in_src = torch.arange(n, device=src.device)[None, :] < n_src[:, None]
    inlier = in_src & (dist <= max_corr[:, None]) & torch.isfinite(dist)
    q = grid.target[idx.clamp(min=0)]
    zero = torch.zeros((), dtype=torch.float32, device=src.device)
    return (torch.where(inlier[..., None], p, zero), torch.where(inlier[..., None], q, zero),
            inlier, dist)


def _corr_stats(src, n_src, T, grid, max_corr):
    """The masked correspondence moments Kabsch needs, per source: n_in
    (B,) int64, sse (B,), sum_p (B, 3), sum_q (B, 3), outer (B, 3, 3)
    float32, the JAX package's types (its convergence test compares
    float32 rmse values)."""
    p, q, inlier, dist = _inliers(src, n_src, T, grid, max_corr)
    sse = torch.where(inlier, dist ** 2, torch.zeros((), device=dist.device)).sum(1)
    return inlier.sum(1), sse, p.sum(1), q.sum(1), p.transpose(1, 2) @ q


def _horn_rotation(H):
    """Optimal rotations from cross-covariances H (B, 3, 3) float64 by
    Horn's quaternion method: the eigenvector of the largest eigenvalue of
    a symmetric 4x4 (its sign is free; q and -q give the same R)."""
    S = H
    tr = S[:, 0, 0] + S[:, 1, 1] + S[:, 2, 2]
    a, b, c = S[:, 1, 2] - S[:, 2, 1], S[:, 2, 0] - S[:, 0, 2], S[:, 0, 1] - S[:, 1, 0]
    d, e, f = S[:, 0, 1] + S[:, 1, 0], S[:, 0, 2] + S[:, 2, 0], S[:, 1, 2] + S[:, 2, 1]
    N = torch.stack([
        torch.stack([tr, a, b, c], -1),
        torch.stack([a, 2 * S[:, 0, 0] - tr, d, e], -1),
        torch.stack([b, d, 2 * S[:, 1, 1] - tr, f], -1),
        torch.stack([c, e, f, 2 * S[:, 2, 2] - tr], -1),
    ], -2)
    q = torch.linalg.eigh(N)[1][:, :, -1]  # (w, x, y, z)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _fitness_rmse(n_in, sse, n_src):
    fitness = (n_in.double() / n_src.clamp(min=1).double()).float()
    rmse = _sqrt(sse / n_in.clamp(min=1).float())
    return fitness, rmse


def _icp_batch(src, n_src, grid, max_corr, T0, rel_f, rel_r, max_iteration: int):
    """Point-to-point ICP of B sources against one target: {correspond ->
    Horn update -> convergence test} until each source has converged, lost
    its correspondences (n_in < 3) or run max_iteration iterations, then a
    last stats pass at the final poses.  Returns (T (B, 4, 4) float64,
    fitness (B,), rmse (B,) float32, n_in (B,) int64)."""
    B = src.shape[0]
    dev = src.device
    T = T0.clone()
    prev_f = torch.zeros(B, dtype=torch.float32, device=dev)
    prev_r = torch.zeros(B, dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    eye = torch.eye(4, dtype=torch.float64, device=dev)
    for it in range(max_iteration):
        if it % _ACTIVE_CHECK_EVERY == 0 and bool(done.all()):
            break
        n_in, sse, sum_p, sum_q, outer = _corr_stats(src, n_src, T, grid, max_corr)
        nf = n_in.clamp(min=1).float()[:, None]
        fitness, rmse = _fitness_rmse(n_in, sse, n_src)
        cp = sum_p / nf
        cq = sum_q / nf
        H = outer / nf[..., None] - cp[:, :, None] * cq[:, None, :]
        R = _horn_rotation(H.double())
        t = cq.double() - (R @ cp.double()[..., None])[..., 0]
        delta = eye.repeat(B, 1, 1)
        delta[:, :3, :3] = R
        delta[:, :3, 3] = t
        T_new = torch.where((n_in >= 3)[:, None, None], delta @ T, T)
        converged = ((it > 0) & ((fitness - prev_f).abs() < rel_f)
                     & ((rmse - prev_r).abs() < rel_r))
        active = ~done
        T = torch.where(active[:, None, None], T_new, T)
        prev_f = torch.where(active, fitness, prev_f)
        prev_r = torch.where(active, rmse, prev_r)
        done = done | (active & (converged | (n_in < 3)))
    n_in, sse, *_ = _corr_stats(src, n_src, T, grid, max_corr)
    fitness, rmse = _fitness_rmse(n_in, sse, n_src)
    return T, fitness, rmse, n_in


def _stack_sources(sources, device):
    """Ragged (n_i, 3) sources -> (B, N, 3) float32 zero-padded, n_src (B,)."""
    n_src = [len(s) for s in sources]
    src = np.zeros((len(sources), max(max(n_src), 1), 3), np.float32)
    for j, s in enumerate(sources):
        src[j, :len(s)] = s
    return (torch.from_numpy(src).to(device),
            torch.as_tensor(n_src, dtype=torch.int64, device=device))


def _chunks(sources, max_stack_bytes: int):
    """Index ranges of sources whose stacked (count, max n, 3) float32
    array stays within max_stack_bytes (one source at least)."""
    per_src = max(max((len(s) for s in sources), default=1), 1) * 3 * 4
    step = max(int(max_stack_bytes // per_src), 1)
    return [range(i, min(i + step, len(sources))) for i in range(0, len(sources), step)]


def _grid_device(grid, device):
    """`device`, else where the grid's arrays are, else the card."""
    if device is not None:
        return torch.device(device)
    for a in (grid.target, getattr(grid, "ids", None)):
        if torch.is_tensor(a):
            return a.device
    return torch.device("cuda")


def registration_icp_batch_shared(sources, grid, max_corrs, inits=None, criteria=None,
                                  max_stack_bytes: int = _MAX_STACK_BYTES, device=None):
    """Point-to-point ICP of many sources against one target's grid (one
    copy of the grid for the whole batch).  Each source has its own
    max_corr, init and criteria; a batch runs max(max_iteration)
    iterations at most.  The device is the Voronoi field's, or `device`
    (default "cuda").  Returns one RegistrationResult per source."""
    B = len(sources)
    if B == 0:
        return []
    inits = inits if inits is not None else [None] * B
    criteria = criteria if criteria is not None else [ICPConvergenceCriteria()] * B
    dev = _grid_device(grid, device)
    if grid.n_target == 0:
        return [RegistrationResult(np.eye(4) if t is None else np.asarray(t, np.float64))
                for t in inits]
    grid = _on(grid, dev)
    out: List[RegistrationResult] = []
    for idxs in _chunks(sources, max_stack_bytes):
        src, n_src = _stack_sources([np.asarray(sources[i], np.float32) for i in idxs], dev)
        T0 = torch.from_numpy(np.stack([
            np.eye(4) if inits[i] is None else np.asarray(inits[i], np.float64)
            for i in idxs])).to(dev)

        def per_source(fn, dtype):
            return torch.as_tensor([fn(i) for i in idxs], dtype=dtype, device=dev)

        T, fitness, rmse, n_in = _icp_batch(
            src, n_src, grid, per_source(lambda i: max_corrs[i], torch.float32), T0,
            per_source(lambda i: criteria[i].relative_fitness, torch.float32),
            per_source(lambda i: criteria[i].relative_rmse, torch.float32),
            max(int(criteria[i].max_iteration) for i in idxs))
        T, fitness, rmse, n_in = (x.cpu().numpy() for x in (T, fitness, rmse, n_in))
        out.extend(RegistrationResult(T[j], float(fitness[j]), float(rmse[j]), int(n_in[j]))
                   for j in range(len(idxs)))
    return out


def registration_icp(source: np.ndarray, target: np.ndarray,
                     max_correspondence_distance: float,
                     init: Optional[np.ndarray] = None,
                     criteria: Optional[ICPConvergenceCriteria] = None,
                     grid=None, device=None) -> RegistrationResult:
    """Point-to-point ICP of one pair (TransformationEstimationPointToPoint),
    a batch of one; the exact CSR grid is built when none is given."""
    if grid is None:
        grid = build_grid_nn(target, max_correspondence_distance)
    return registration_icp_batch_shared(
        [source], grid, [max_correspondence_distance], [init],
        [criteria or ICPConvergenceCriteria()], device=device)[0]


def multi_scale_icp(source: np.ndarray, target: np.ndarray, voxel_sizes: List[float],
                    criteria_list: List[ICPConvergenceCriteria],
                    max_correspondence_distances: List[float],
                    init_source_to_target: Optional[np.ndarray] = None,
                    device=None) -> RegistrationResult:
    """Coarse-to-fine ICP over a voxel pyramid (o3d multi_scale_icp)."""
    T = np.eye(4) if init_source_to_target is None else np.asarray(init_source_to_target)
    result = RegistrationResult(T)
    for voxel, crit, max_corr in zip(voxel_sizes, criteria_list, max_correspondence_distances):
        src = voxel_down_sample(source, voxel) if voxel > 0 else source
        tgt = voxel_down_sample(target, voxel) if voxel > 0 else target
        result = registration_icp(src, tgt, max_corr, init=T, criteria=crit, device=device)
        T = result.transformation
    return result


def evaluate_registration(source: np.ndarray, target: np.ndarray,
                          max_correspondence_distance: float,
                          transformation: Optional[np.ndarray] = None,
                          device=None) -> RegistrationResult:
    """Fitness and inlier rmse of `transformation` over the exact grid."""
    T = np.eye(4) if transformation is None else np.asarray(transformation, np.float64)
    if len(source) == 0 or len(target) == 0:
        return RegistrationResult(T)
    dev = torch.device(device if device is not None else "cuda")
    grid = build_grid_nn(target, max_correspondence_distance).to(dev)
    src, n_src = _stack_sources([np.asarray(source, np.float32)], dev)
    n_in, sse, *_ = _corr_stats(
        src, n_src, torch.from_numpy(T[None]).to(dev), grid,
        torch.tensor([max_correspondence_distance], dtype=torch.float32, device=dev))
    n_in, sse = int(n_in[0]), float(sse[0])
    return RegistrationResult(T, n_in / len(source),
                              float(np.sqrt(sse / n_in)) if n_in else 0.0, n_in)


def _assemble_info(n: int, s: np.ndarray, S: np.ndarray) -> np.ndarray:
    """sum G^T G, G = [skew(q)^T | I], from n, s = sum q, S = sum q q^T."""
    if n == 0:
        return np.eye(6)
    skew_s = np.array([[0.0, -s[2], s[1]], [s[2], 0.0, -s[0]], [-s[1], s[0], 0.0]])
    info = np.zeros((6, 6))
    info[:3, :3] = np.trace(S) * np.eye(3) - S
    info[:3, 3:] = skew_s
    info[3:, :3] = skew_s.T
    info[3:, 3:] = float(n) * np.eye(3)
    return info


def get_information_matrix_batch(sources, grid, max_correspondence_distance: float,
                                 transformations, device=None) -> List[np.ndarray]:
    """Information matrices (o3d GetInformationMatrixFromPointClouds) of
    many sources against one target's grid, the exact CSR grid or the
    Voronoi field: n, sum q and sum q q^T over the inlier correspondences,
    reduced in float64.  Returns (6, 6) float64 arrays, the identity where
    there is no correspondence."""
    B = len(sources)
    if B == 0:
        return []
    if grid.n_target == 0:
        return [np.eye(6)] * B
    dev = _grid_device(grid, device)
    grid = _on(grid, dev)
    out = []
    for idxs in _chunks(sources, _MAX_STACK_BYTES):
        src, n_src = _stack_sources([np.asarray(sources[i], np.float32) for i in idxs], dev)
        T = torch.from_numpy(np.stack([np.asarray(transformations[i], np.float64)
                                       for i in idxs])).to(dev)
        mc = torch.full((len(idxs),), max_correspondence_distance, dtype=torch.float32,
                        device=dev)
        _, q, inlier, _ = _inliers(src, n_src, T, grid, mc)
        q = q.double()
        n = inlier.sum(1).cpu().numpy()
        s = q.sum(1).cpu().numpy()
        S = (q.transpose(1, 2) @ q).cpu().numpy()
        out.extend(_assemble_info(int(n[j]), s[j], S[j]) for j in range(len(idxs)))
    return out


def get_information_matrix(source: np.ndarray, target: np.ndarray,
                           max_correspondence_distance: float, transformation: np.ndarray,
                           grid=None, device=None) -> np.ndarray:
    """One pair's information matrix; the exact CSR grid is built when none
    is given."""
    if grid is None:
        grid = build_grid_nn(target, max_correspondence_distance)
    if len(source) == 0:
        return np.eye(6)
    return get_information_matrix_batch([source], grid, max_correspondence_distance,
                                        [transformation], device=device)[0]
