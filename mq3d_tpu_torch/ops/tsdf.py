"""TSDF voxel-block grid on tensors: counterpart of mq3d_tpu/ops/tsdf.py.

Same data structure and semantics as the JAX build (see its module
docstring): a dense block slot table over a bounded world extent replaces
Open3D's hash map, frames fuse in chunks, and the tsdf update is Open3D's
running weighted average tsdf' = (tsdf*w + obs)/(w+1), w' = w + 1.

  Phase A  allocation: candidate block keys of every strided depth sample's
           +-trunc cube, a per-frame touch grid, slot allocation in
           ascending grid-key order, a capacity window of touched blocks,
           and the compacted (block, frame) pairs, block-major.
  Phase B  integration: per tile of `integrate_tile` pairs, project the
           block's R^3 voxels, fetch the depth (flat gather, or the
           per-pair depth patch through K1, ops/tsdf_patch.py), sum the
           observations per block in frame order, then merge.  On the card
           with depth_lookup "auto", all of it is one launch of K5 a
           capacity window (ops/tsdf_window.py, csrc/tsdf_window.cu): one
           thread block per window block reads the block's frames from the
           touch grid, projects, fetches, sums in frame order and merges in
           place, with no host sync; it equals the tile loop bit for bit.
  Extract  zero-crossing point cloud along +x/+y/+z, and marching cubes with
           lattice-edge-keyed vertex welding (`_extract_mesh`).

Phase A and extraction are plain PyTorch here.  Phase B is K5 on the card
("auto"); the tile loop, plain PyTorch with K1 as the depth fetch of
`depth_lookup="pallas"`, runs for CPU tensors and the explicit modes.

One chunk path serves every caller, the sharded step of
parallel/sharded.py included: `_stage_chunk` is the only place a chunk is
staged on the device and its poses inverted (`camera_to_world`), and
Phase B's form is chosen only in `_window_sums` (a window's sums) and
`_fuse_window` (sums and merge).  The arithmetic is XLA's CPU build's bit
for bit: fused multiply-adds in its order, from ops/fma.py.

Sums per block are taken in frame order without atomics (see
`_accumulate_tile`, and K5's thread block per window block), so results do
not change from run to run.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from scipy.linalg import blas, lapack

from mq3d_tpu_torch.dataio.ply import PointCloud, TriangleMesh
from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.ops.fma import f32_scalar, fma, rotate_add
from mq3d_tpu_torch.ops.mc_tables import CORNERS, build_tables, edge_owner
from mq3d_tpu_torch.ops.tsdf_patch import patch_lookup, patch_lookup_plain
from mq3d_tpu_torch.ops.tsdf_window import integrate_window, window_sums
from mq3d_tpu_torch.utils.log import substep


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    voxel_size: float = 0.01
    block_resolution: int = 16
    block_count: int = 50_000
    grid_dim: int = 160  # dense slot-table extent (blocks/axis), world-centered
    depth_max: float = 4.0
    trunc_voxel_multiplier: float = 10.0
    alloc_pixel_stride: int = 2  # pixel subsampling for block allocation
    chunk_active_capacity: int = 12_288  # max blocks touched per chunk
    integrate_tile: int = 512  # (block, frame) pairs per integration tile
    tile_loop: str = "grouped"  # loop form of the JAX build; no effect here
    # Depth-lookup form of Phase B:
    #   "flat"    per-voxel gather from the whole depth frame;
    #   "pallas"  per-pair PSxPS depth patch anchored at the projected block
    #             centre, fetched by K1 (ops/tsdf_patch.py) on the card;
    #   "onehot"  the same patch fetch with the plain PyTorch gather (the JAX
    #             build's one-hot matmul form computes this function);
    #   "auto"    K5 on the card (ops/tsdf_window.py: Phase B of a window in
    #             one launch, the patch fetch and the flat one per voxel),
    #             "flat" on the CPU.
    # Every form gives identical results: a tile whose in-image voxels do
    # not all fall inside their pair's patch takes the flat gather.
    depth_lookup: str = "auto"
    onehot_patch: int = 64  # patch size PS

    @property
    def trunc(self) -> float:
        return self.voxel_size * self.trunc_voxel_multiplier

    @property
    def block_size(self) -> float:
        return self.voxel_size * self.block_resolution

    @property
    def r3(self) -> int:
        return self.block_resolution ** 3


@dataclasses.dataclass
class TSDFState:
    """Volume state on one device.  Arrays have one sentinel row at index
    `block_count` that stays zero.  The counters live on the host."""

    slot_table: torch.Tensor  # (grid_dim^3,) int32, -1 = unallocated
    block_coords: torch.Tensor  # (block_count+1, 3) int32
    tsdf: torch.Tensor  # (block_count+1, R^3) float32
    weight: torch.Tensor  # (block_count+1, R^3) float32
    n_active: int = 0
    overflow: int = 0  # dropped block allocations (pool exhausted)
    dropped_active: int = 0  # block-chunk integrations skipped because a
    #   chunk touched more than chunk_active_capacity blocks

    @property
    def device(self) -> torch.device:
        return self.tsdf.device


def create_state(cfg: TSDFConfig, device="cuda") -> TSDFState:
    dev = resolve_device(device)
    return TSDFState(
        slot_table=torch.full((cfg.grid_dim ** 3,), -1, dtype=torch.int32, device=dev),
        block_coords=torch.zeros((cfg.block_count + 1, 3), dtype=torch.int32, device=dev),
        tsdf=torch.zeros((cfg.block_count + 1, cfg.r3), dtype=torch.float32, device=dev),
        weight=torch.zeros((cfg.block_count + 1, cfg.r3), dtype=torch.float32, device=dev),
    )


_STATE_ARRAYS = ("slot_table", "block_coords", "tsdf", "weight")
_STATE_COUNTERS = ("n_active", "overflow", "dropped_active")


def state_to_numpy(state: TSDFState) -> dict:
    """The JAX build's TSDFState fields as numpy arrays (counters as 0-d
    int32 arrays)."""
    out = {k: getattr(state, k).cpu().numpy() for k in _STATE_ARRAYS}
    out.update({k: np.asarray(getattr(state, k), np.int32) for k in _STATE_COUNTERS})
    return out


def state_from_numpy(cfg: TSDFConfig, arrays, device="cuda") -> TSDFState:
    """Inverse of state_to_numpy (copies); takes any mapping with the JAX
    TSDFState field names, e.g. a JAX state's `_asdict()` as numpy."""
    dev = resolve_device(device)
    expect = {
        "slot_table": ((cfg.grid_dim ** 3,), np.int32),
        "block_coords": ((cfg.block_count + 1, 3), np.int32),
        "tsdf": ((cfg.block_count + 1, cfg.r3), np.float32),
        "weight": ((cfg.block_count + 1, cfg.r3), np.float32),
    }
    fields = {}
    for k, (shape, dtype) in expect.items():
        a = np.asarray(arrays[k])
        if a.shape != shape:
            raise ValueError(f"{k}: shape {a.shape} != {shape} for {cfg}")
        # A copy: the input may alias another framework's buffers, and the
        # port updates its state in place.
        fields[k] = torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(dev)
    for k in _STATE_COUNTERS:
        fields[k] = int(np.asarray(arrays[k]))
    return TSDFState(**fields)


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------


def camera_to_world(extrinsics_wc: np.ndarray) -> np.ndarray:
    """(C, 4, 4) float32 inverse of world-to-camera poses, on the host.

    The reference inverts with jnp.linalg.inv, an LU solve (LAPACK getrf,
    then unit-lower and upper triangular solves).  The same three LAPACK
    and BLAS calls here give its bits, and one answer for every device;
    Phase A takes floor() of block coordinates computed from this matrix,
    so an inverse that differs in the last bit can move a candidate block.
    """
    a = np.asarray(extrinsics_wc, np.float32)
    n = a.shape[-1]
    out = np.empty_like(a)
    for i in range(a.shape[0]):
        lu, piv, info = lapack.sgetrf(a[i])
        if info > 0:
            raise np.linalg.LinAlgError(f"singular extrinsics matrix {i}")
        perm = np.arange(n)
        for k, p in enumerate(piv):
            perm[k], perm[p] = perm[p], perm[k]
        x = np.eye(n, dtype=np.float32)[perm]
        x = blas.strsm(1.0, lu, x, side=0, lower=1, diag=1)
        out[i] = blas.strsm(1.0, lu, x, side=0, lower=0, diag=0)
    return out


def _as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy array or tensor -> tensor of `dtype` on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def _stage_chunk(depth, intrinsics, extrinsics_wc, frame_valid, device):
    """(depth, K, T_wc, valid, T_cw) of a chunk on `device`, from numpy
    arrays or tensors: float32 (C, H, W) depth, (C, 3, 3) intrinsics and
    (C, 4, 4) world-to-camera poses, (C,) bool validity, and T_cw the
    float32 inverse of the poses (`camera_to_world`, on the host).  Every
    path of step 3 stages its chunks here (the uint16 stream dequantizes
    its depth on the device first); a tensor already on `device` in its
    dtype is taken as it is."""
    if isinstance(extrinsics_wc, torch.Tensor):
        T_wc_host = extrinsics_wc.detach().cpu().numpy()
    else:
        T_wc_host = extrinsics_wc = np.asarray(extrinsics_wc, np.float32)
    return (_as_tensor(depth, torch.float32, device),
            _as_tensor(intrinsics, torch.float32, device),
            _as_tensor(extrinsics_wc, torch.float32, device),
            _as_tensor(frame_valid, torch.bool, device),
            torch.from_numpy(camera_to_world(T_wc_host)).to(device))


# The 7 positive-neighbour block offsets whose faces, edges and corner
# extend a block by one voxel.
_NEIGHBOR_OFFSETS = ((1, 0, 0), (0, 1, 0), (0, 0, 1),
                     (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _voxel_offsets(R: int) -> np.ndarray:
    """(R^3, 3) local voxel integer offsets, x-major to match flat index
    flat = x*R^2 + y*R + z."""
    idx = np.arange(R ** 3)
    x = idx // (R * R)
    y = (idx // R) % R
    z = idx % R
    return np.stack([x, y, z], axis=-1).astype(np.int32)


def _block_keys(coords: torch.Tensor, G: int) -> torch.Tensor:
    """Block coords in [-G/2, G/2)^3 -> int64 key in [0, G^3); out-of-range
    -> sentinel G^3."""
    shifted = coords.long() + G // 2
    in_range = ((shifted >= 0) & (shifted < G)).all(dim=-1)
    key = (shifted[..., 0] * G + shifted[..., 1]) * G + shifted[..., 2]
    return torch.where(in_range, key, torch.full_like(key, G ** 3))


def _keys_to_coords(keys: torch.Tensor, G: int) -> torch.Tensor:
    h = G // 2
    x = keys // (G * G) - h
    y = (keys // G) % G - h
    z = keys % G - h
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def _resolve_lookup(cfg: TSDFConfig, device: torch.device) -> str:
    """Phase B's form on `device`: "window" (K5, one launch a capacity
    window) for "auto" on the card, else the tile loop's depth lookup."""
    if cfg.depth_lookup == "auto":
        return "window" if device.type == "cuda" else "flat"
    if cfg.depth_lookup not in ("flat", "onehot", "pallas"):
        raise ValueError(f"unknown depth_lookup {cfg.depth_lookup!r}")
    return cfg.depth_lookup


# ---------------------------------------------------------------------------
# Phase A: allocation (chunk-level set union)
# ---------------------------------------------------------------------------


def _candidate_keys(cfg: TSDFConfig, depth, intrinsics, T_cw, frame_valid):
    """(C, hs, ws, 27) int64 candidate block keys (sentinel G^3 = invalid):
    blocks overlapping the +-trunc cube around each strided unprojected
    depth sample (Open3D's DepthTouch)."""
    C, H, W = depth.shape
    G = cfg.grid_dim
    ds = cfg.alloc_pixel_stride
    dev = depth.device
    fx = intrinsics[:, 0, 0][:, None, None]
    fy = intrinsics[:, 1, 1][:, None, None]
    cx = intrinsics[:, 0, 2][:, None, None]
    cy = intrinsics[:, 1, 2][:, None, None]

    d_sub = depth[:, ::ds, ::ds]
    u = torch.arange(0, W, ds, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(0, H, ds, dtype=torch.float32, device=dev)[None, :, None]
    valid_px = (d_sub > 0) & (d_sub <= cfg.depth_max) & frame_valid[:, None, None]

    px = (u - cx) / fx * d_sub
    py = (v - cy) / fy * d_sub
    pz = d_sub
    # The reference's einsum over j lowers to fma(R2, z, fma(R1, y, R0*x)).
    pw = []
    for i in range(3):
        Ri = [T_cw[:, i, j][:, None, None] for j in range(3)]
        acc = fma(Ri[2], pz, fma(Ri[1], py, Ri[0] * px))
        pw.append(acc + T_cw[:, i, 3][:, None, None])
    pw = torch.stack(pw, dim=-1)  # (C, hs, ws, 3)

    offs = (np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1], indexing="ij"), -1)
            .reshape(-1, 3).astype(np.float32) * cfg.trunc)
    cand = pw[:, :, :, None, :] + torch.from_numpy(offs).to(dev)
    bcoord = torch.floor(cand / f32_scalar(cfg.block_size, cand)).to(torch.int32)
    keys = _block_keys(bcoord, G)
    return torch.where(valid_px[..., None], keys, torch.full_like(keys, G ** 3))


def _frame_touch_grid(cfg: TSDFConfig, depth, intrinsics, T_cw, frame_valid):
    """(C, G^3 + 1) bool per-frame touched-block grid; column G^3 absorbs
    invalid candidates."""
    C = depth.shape[0]
    G3 = cfg.grid_dim ** 3
    keys = _candidate_keys(cfg, depth, intrinsics, T_cw, frame_valid)
    flat = (keys + (torch.arange(C, device=keys.device) * (G3 + 1))[:, None, None, None])
    grid = torch.zeros(C * (G3 + 1), dtype=torch.bool, device=keys.device)
    grid[flat.reshape(-1)] = True
    return grid.view(C, G3 + 1)


def _alloc_and_window(cfg: TSDFConfig, state: TSDFState, touched, block_skip: int):
    """Allocate new touched blocks (in place) and return the chunk's window:
    (wkeys, active_slots), the keys and slots of the touched blocks with
    rank in (skip, skip + capacity], in ascending key order."""
    cap = cfg.block_count
    M = cfg.chunk_active_capacity
    G = cfg.grid_dim

    new_keys = torch.nonzero(touched & (state.slot_table < 0)).squeeze(1)
    total_new = int(new_keys.numel())
    n_fit = max(0, min(total_new, cap - state.n_active))
    if n_fit:
        fit = new_keys[:n_fit]
        slots = torch.arange(state.n_active, state.n_active + n_fit,
                             dtype=torch.int32, device=touched.device)
        state.slot_table[fit] = slots
        state.block_coords[state.n_active:state.n_active + n_fit] = _keys_to_coords(fit, G)
    state.overflow += max(state.n_active + total_new - cap, 0)
    state.n_active = min(state.n_active + total_new, cap)

    active_keys = torch.nonzero(touched & (state.slot_table >= 0)).squeeze(1)
    n_touch = int(active_keys.numel())
    wkeys = active_keys[block_skip:block_skip + M]
    state.dropped_active += max(n_touch - block_skip - M, 0)
    return wkeys, state.slot_table[wkeys].long()


def _pairs_from_grid(frame_touched, wkeys):
    """Compacted (window-block, frame) pairs, block-major and frame-minor,
    so each block's observations accumulate in frame order."""
    bits = frame_touched[:, wkeys].T  # (n_window, C)
    widx, f = torch.nonzero(bits, as_tuple=True)
    return widx, f


# ---------------------------------------------------------------------------
# Phase B: integration over pair tiles
# ---------------------------------------------------------------------------


# Tiles of the patch lookup ("pallas"/"onehot") that fetched from the patch,
# and those that took the flat gather because a voxel fell outside its
# pair's patch (`over`).  Read by chip_smoke.py to show K1's share; K5
# counts its pairs on the card (`ops.tsdf_window.window_pair_count`).
_lookup_tiles = {"patch": 0, "over": 0}


def reset_lookup_tile_counts() -> None:
    for k in _lookup_tiles:
        _lookup_tiles[k] = 0


def lookup_tile_counts() -> dict:
    return dict(_lookup_tiles)


def _depth_patches(depth, f, y0, x0, PS: int):
    """(TP, PS, PS) depth patches: depth[f, y0:y0+PS, x0:x0+PS] per pair."""
    ar = torch.arange(PS, device=depth.device)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    return depth[f[:, None, None], rows, cols]


def _tile_observations(cfg: TSDFConfig, depth, intrinsics, Rwc, twc, bc, f,
                       lookup: str):
    """(obs, ok) of shape (TP, R^3) for one tile of pairs with block coords
    `bc` (TP, 3) and frames `f` (TP,)."""
    C, H, W = depth.shape
    R = cfg.block_resolution
    PS = cfg.onehot_patch
    dev = depth.device
    voxel_offs = torch.from_numpy(_voxel_offsets(R)).to(dev)
    p = ((bc * R)[:, None, :] + voxel_offs[None, :, :]).float() * cfg.voxel_size
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]

    Rp = Rwc[f]  # (TP, 3, 3)
    tp_ = twc[f]
    rows = [[Rp[:, i, j, None] for j in range(3)] for i in range(3)]
    xw = rotate_add(rows[0], px, py, pz, tp_[:, 0, None])
    yw = rotate_add(rows[1], px, py, pz, tp_[:, 1, None])
    z = rotate_add(rows[2], px, py, pz, tp_[:, 2, None])
    one = torch.ones((), dtype=torch.float32, device=dev)
    rz = torch.reciprocal(torch.where(z > 0, z, one))
    fx, fy = intrinsics[f, 0, 0][:, None], intrinsics[f, 1, 1][:, None]
    cx, cy = intrinsics[f, 0, 2][:, None], intrinsics[f, 1, 2][:, None]
    ui = torch.floor(fma(fx * xw, rz, cx) + 0.5).to(torch.int32)
    vi = torch.floor(fma(fy * yw, rz, cy) + 0.5).to(torch.int32)
    in_img = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 0)

    def flat_lookup():
        flat = (f[:, None] * (H * W) + vi.clamp(0, H - 1).long() * W
                + ui.clamp(0, W - 1).long())
        return depth.reshape(-1)[flat]

    if lookup == "flat" or min(H, W) < PS:  # image smaller than a patch
        d = flat_lookup()
    else:
        # Patch anchored at the projected block centre.  If any in-image
        # voxel of the tile falls outside its pair's patch, the tile takes
        # the flat gather (`over`); otherwise voxels outside their patch
        # read 0.0, and those are exactly the voxels `ok` discards.
        ctr = (bc.float() + 0.5) * (R * cfg.voxel_size)
        c_rows = [[Rp[:, i, j] for j in range(3)] for i in range(3)]
        cxw = rotate_add(c_rows[0], ctr[:, 0], ctr[:, 1], ctr[:, 2], tp_[:, 0])
        cyw = rotate_add(c_rows[1], ctr[:, 0], ctr[:, 1], ctr[:, 2], tp_[:, 1])
        czw = rotate_add(c_rows[2], ctr[:, 0], ctr[:, 1], ctr[:, 2], tp_[:, 2])
        crz = torch.reciprocal(torch.where(czw > 0, czw, one))
        cu = torch.floor(fma(fx[:, 0] * cxw, crz, cx[:, 0]) + 0.5).to(torch.int32)
        cv = torch.floor(fma(fy[:, 0] * cyw, crz, cy[:, 0]) + 0.5).to(torch.int32)
        y0 = torch.clamp(cv - PS // 2, 0, H - PS)
        x0 = torch.clamp(cu - PS // 2, 0, W - PS)
        in_patch = ((vi >= y0[:, None]) & (vi < y0[:, None] + PS)
                    & (ui >= x0[:, None]) & (ui < x0[:, None] + PS))
        if bool(torch.any(in_img & ~in_patch)):
            _lookup_tiles["over"] += 1
            d = flat_lookup()
        else:
            _lookup_tiles["patch"] += 1
            patch = _depth_patches(depth, f, y0.long(), x0.long(), PS)
            fetch = patch_lookup if lookup == "pallas" else patch_lookup_plain
            d = fetch(patch, vi - y0[:, None], ui - x0[:, None])

    ok = in_img & (d > 0) & (d <= cfg.depth_max)
    sdf = d - z
    ok &= sdf >= -cfg.trunc
    inv_trunc = np.float32(1.0 / cfg.trunc)
    obs = torch.clamp(sdf, max=cfg.trunc) * float(inv_trunc)
    return torch.where(ok, obs, torch.zeros((), dtype=obs.dtype, device=dev)), ok


def _accumulate_tile(sums, cnts, obs, ok, w0: int, nb: int, n_rank: int, local):
    """Add a tile's per-pair observations into the window accumulators in
    frame order, with no atomics.

    Pairs are block-major and every window block has at least one pair, so
    a tile's blocks are the `nb` window rows from `w0` on.  Observations are
    laid out densely as (block, local rank) at flat index `local` and added
    rank by rank: each block's sum is ((s + o_0) + o_1) ... in frame order,
    the order of the reference's sequential scatter-add; an absent rank
    adds an exact 0.0."""
    V = obs.shape[1]
    dense_o = obs.new_zeros((nb * n_rank, V))
    dense_c = obs.new_zeros((nb * n_rank, V))
    dense_o[local] = obs
    dense_c[local] = ok.float()
    dense_o = dense_o.view(nb, n_rank, V)
    dense_c = dense_c.view(nb, n_rank, V)
    for r in range(n_rank):
        sums[w0:w0 + nb] += dense_o[:, r]
        cnts[w0:w0 + nb] += dense_c[:, r]


def _integrate_pairs(cfg: TSDFConfig, depth, intrinsics, extrinsics_wc,
                     block_coords, active_slots, widx, f, lookup: str):
    """(sums, cnts) of shape (n_window, R^3) over the compacted pairs, in
    tiles of cfg.integrate_tile pairs."""
    dev = depth.device
    n_window = active_slots.numel()
    sums = depth.new_zeros((n_window, cfg.r3))
    cnts = depth.new_zeros((n_window, cfg.r3))
    P = widx.numel()
    if P == 0:
        return sums, cnts
    Rwc = extrinsics_wc[:, :3, :3]
    twc = extrinsics_wc[:, :3, 3]
    # Tile layout on the host (one transfer per window): each pair's rank
    # within its block's run, counted from the tile start.
    w_host = widx.cpu().numpy()
    start = np.searchsorted(w_host, w_host, side="left")
    TP = cfg.integrate_tile
    for t0 in range(0, P, TP):
        t1 = min(t0 + TP, P)
        w = w_host[t0:t1]
        lrank = np.arange(t0, t1) - np.maximum(start[t0:t1], t0)
        w0, nb, n_rank = int(w[0]), int(w[-1] - w[0]) + 1, int(lrank.max()) + 1
        local = torch.from_numpy((w - w0) * n_rank + lrank).to(dev)
        bc = block_coords[active_slots[widx[t0:t1]]]
        obs, ok = _tile_observations(cfg, depth, intrinsics, Rwc, twc, bc,
                                     f[t0:t1], lookup)
        _accumulate_tile(sums, cnts, obs, ok, w0, nb, n_rank, local)
    return sums, cnts


def _merge_window(state: TSDFState, active_slots, sums, cnts):
    """Fold the window sums into the voxel tables (in place): Open3D's
    running average tsdf' = (tsdf*w + sum)/(w + cnt), w' = w + cnt."""
    t_old = state.tsdf[active_slots]
    w_old = state.weight[active_slots]
    new_w = w_old + cnts
    merged = fma(t_old, w_old, sums) / torch.clamp(new_w, min=1.0)
    state.tsdf[active_slots] = torch.where(cnts > 0, merged, t_old)
    state.weight[active_slots] = new_w


def _window_sums(cfg: TSDFConfig, state: TSDFState, depth, intrinsics, extrinsics_wc,
                 frame_touched, wkeys, active_slots):
    """(sums, cnts), each (n_window, R^3), of a capacity window's
    observations over the chunk's frames, in frame order: K5's sums form
    on the card ("auto"), else the tile loop.  Of the state it reads only
    the block coordinates."""
    lookup = _resolve_lookup(cfg, state.device)
    if lookup == "window":
        return window_sums(cfg, state.block_coords, depth, intrinsics, extrinsics_wc,
                           frame_touched, wkeys, active_slots)
    widx, f = _pairs_from_grid(frame_touched, wkeys)
    return _integrate_pairs(cfg, depth, intrinsics, extrinsics_wc, state.block_coords,
                            active_slots, widx, f, lookup)


def _fuse_window(cfg: TSDFConfig, state: TSDFState, depth, intrinsics, extrinsics_wc,
                 frame_touched, wkeys, active_slots) -> None:
    """Fuse a capacity window into the state's voxel tables (in place): K5
    in one launch on the card ("auto"), else `_window_sums`, then
    `_merge_window`."""
    if _resolve_lookup(cfg, state.device) == "window":
        integrate_window(cfg, state.tsdf, state.weight, state.block_coords, depth,
                         intrinsics, extrinsics_wc, frame_touched, wkeys, active_slots)
        return
    _merge_window(state, active_slots, *_window_sums(
        cfg, state, depth, intrinsics, extrinsics_wc, frame_touched, wkeys, active_slots))


def integrate_chunk(cfg: TSDFConfig, state: TSDFState, depth, intrinsics,
                    extrinsics_wc, frame_valid, block_skip: int = 0,
                    T_cw=None) -> TSDFState:
    """Fuse a chunk of depth frames into `state` (updated in place, which
    saves a second copy of the voxel tables; the state is also returned).

    depth (C, H, W) float32 metric depth (0 = invalid), intrinsics (C, 3, 3)
    float32 with cx mirror-flipped, extrinsics_wc (C, 4, 4) float32
    world-to-camera, frame_valid (C,) bool.  Without `T_cw` (the float32
    inverse of extrinsics_wc) `_stage_chunk` stages them on the state's
    device and inverts the poses; with it they must lie there already.

    A block integrates against frame f iff f's depth touched it, which is
    Open3D's allocate-then-integrate per frame.  `block_skip` selects the
    capacity window of touched blocks (rank in (skip, skip + capacity]);
    windows over disjoint block ranges compose bit-identically to one
    unbounded pass, which TSDFVolume.integrate's auto-split relies on."""
    if T_cw is None:
        depth, intrinsics, extrinsics_wc, frame_valid, T_cw = _stage_chunk(
            depth, intrinsics, extrinsics_wc, frame_valid, state.device)
    G3 = cfg.grid_dim ** 3
    frame_touched = _frame_touch_grid(cfg, depth, intrinsics, T_cw, frame_valid)
    touched = frame_touched[:, :G3].any(dim=0)
    wkeys, active_slots = _alloc_and_window(cfg, state, touched, block_skip)
    _fuse_window(cfg, state, depth, intrinsics, extrinsics_wc, frame_touched, wkeys,
                 active_slots)
    return state


def integrate_windows(cfg: TSDFConfig, state: TSDFState, one_pass) -> None:
    """Run `one_pass(block_skip)` over a chunk's capacity windows until
    every touched block is integrated: when a pass drops blocks past
    cfg.chunk_active_capacity, the next pass takes the next window.  The
    windows are disjoint block sets, so the result is bit-identical to one
    unbounded pass and no observations are dropped."""
    d_before = state.dropped_active
    one_pass(0)
    o_first = None
    d_prev, skip = d_before, 0
    while state.dropped_active != d_prev:
        if o_first is None:
            # Pool overflow after the FIRST pass: retry passes see the
            # same still-unallocatable blocks and would re-add it.
            o_first = state.overflow
        d_prev = state.dropped_active
        skip += cfg.chunk_active_capacity
        one_pass(skip)
    if d_prev != d_before:
        # Every window was drained: the per-pass remainders were
        # bookkeeping, not lost observations.
        state.dropped_active = d_before
        state.overflow = o_first


def integrate_chunks(cfg: TSDFConfig, state: TSDFState, depth, intrinsics,
                     extrinsics_wc, frame_valid) -> TSDFState:
    """S chunks of C frames ((S, C, H, W) depth; numpy arrays or tensors),
    one after another; identical to S integrate_chunk calls (no
    auto-split: blocks past cfg.chunk_active_capacity are counted in
    state.dropped_active)."""
    for s in range(depth.shape[0]):
        integrate_chunk(cfg, state, depth[s], intrinsics[s], extrinsics_wc[s],
                        frame_valid[s])
    return state


def quantize_depth_u16(depth: np.ndarray, depth_max: float):
    """Host uint16 fixed-point encoding of metric depth for streaming:
    scale = 65534/depth_max (0.061 mm step at 4 m).  0 stays the invalid
    code; valid depths clamp to [1, 65535].  Returns (uint16 array, scale),
    the JAX build's bytes: numpy 2 keeps `float32 array * Python float` in
    float32."""
    scale = 65534.0 / float(depth_max)
    q = np.rint(np.asarray(depth, np.float32) * scale)
    q = np.where(np.asarray(depth) > 0, np.clip(q, 1, 65535), 0)
    return q.astype(np.uint16), scale


def integrate_chunks_u16(cfg: TSDFConfig, state: TSDFState, depth_q, scale,
                         intrinsics, extrinsics_wc, frame_valid) -> TSDFState:
    """integrate_chunks on an (S, C, H, W) uint16 depth stack from
    quantize_depth_u16, dequantized on the state's device, so the stream
    crosses to the card at half the float32 bytes.

    The dequantization is the JAX build's float32 expression
    q * (1 / float32(scale)): the reciprocal is one float32 division of
    tensors, then one multiply per element, so the result is bit-identical
    to integrate_chunks on the same stack dequantized on the host."""
    dev = state.device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    inv = torch.ones((), dtype=torch.float32, device=dev) / scale
    depth = _as_tensor(depth_q, torch.uint16, dev).to(torch.float32) * inv
    return integrate_chunks(cfg, state, depth, intrinsics, extrinsics_wc,
                            frame_valid)


# ---------------------------------------------------------------------------
# Point extraction
# ---------------------------------------------------------------------------


def _extract_points(cfg: TSDFConfig, state: TSDFState, weight_threshold: float,
                    n_bucket: int):
    """Zero-crossing points and in-block central-difference normals, as
    float32 (N, 3) tensors, over blocks [0, n_bucket).

    Output order is the reference's: tiles of 512 blocks, then axis, then
    (block, voxel).  A crossing needs weight > threshold on both sides; the
    neighbour block's face comes through the slot table."""
    R = cfg.block_resolution
    G = cfg.grid_dim
    cap = cfg.block_count
    vs = cfg.voxel_size
    dev = state.device
    TB = min(512, n_bucket)
    n_tiles = (n_bucket + TB - 1) // TB
    lx = torch.from_numpy(_voxel_offsets(R)).to(dev)  # (R^3, 3)
    axes_e = torch.eye(3, dtype=torch.int32, device=dev)
    half = torch.full((), 0.5, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    pts, nrms = [], []
    for t in range(n_tiles):
        slots = torch.arange(t * TB, (t + 1) * TB, device=dev)
        block_ok = slots < state.n_active
        slots_safe = torch.clamp(slots, max=cap)
        coords = state.block_coords[slots_safe]
        t0 = state.tsdf[slots_safe].view(TB, R, R, R)
        w0 = state.weight[slots_safe].view(TB, R, R, R)
        bok = block_ok[:, None, None, None]
        v0 = (w0 > weight_threshold) & bok

        grads = []
        for axis in range(3):
            d = axis + 1
            up = torch.cat([t0.narrow(d, 1, R - 1), t0.narrow(d, R - 1, 1)], dim=d)
            dn = torch.cat([t0.narrow(d, 0, 1), t0.narrow(d, 0, R - 1)], dim=d)
            grads.append((up - dn).reshape(TB, -1))

        for axis in range(3):
            d = axis + 1
            nb_key = _block_keys(coords + axes_e[axis], G)
            nb_slot = state.slot_table[torch.clamp(nb_key, max=G ** 3 - 1)]
            nb_ok = (nb_key < G ** 3) & (nb_slot >= 0)
            nb_slot_safe = torch.where(nb_ok, nb_slot.long(), torch.full_like(nb_key, cap))
            nb_t = state.tsdf[nb_slot_safe].view(TB, R, R, R)
            nb_w = state.weight[nb_slot_safe].view(TB, R, R, R)
            nb_face_t = nb_t.narrow(d, 0, 1)
            nb_face_v = (nb_w.narrow(d, 0, 1) > weight_threshold) & nb_ok[:, None, None, None]
            t1 = torch.cat([t0.narrow(d, 1, R - 1), nb_face_t], dim=d)
            v1 = torch.cat([v0.narrow(d, 1, R - 1), nb_face_v], dim=d)
            cross = v0 & v1 & (t0 * t1 < 0) & bok
            b_idx, v_idx = torch.nonzero(cross.reshape(TB, -1), as_tuple=True)
            if b_idx.numel() == 0:
                continue
            a = t0.reshape(TB, -1)[b_idx, v_idx]
            b = t1.reshape(TB, -1)[b_idx, v_idx]
            denom = a - b
            frac = torch.where(denom.abs() > 1e-20,
                               a / torch.where(denom == 0, one, denom), half)
            frac = torch.clamp(frac, 0.0, 1.0)
            comps = []
            for c in range(3):
                comp = (coords[b_idx, c] * R + lx[v_idx, c]).float()
                if c == axis:
                    comp = comp + frac
                comps.append(comp * vs)
            pts.append(torch.stack(comps, dim=-1))
            nrms.append(torch.stack([g[b_idx, v_idx] for g in grads], dim=-1))
    if not pts:
        empty = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        return empty, empty
    return torch.cat(pts), torch.cat(nrms)


def _to_point_cloud(points: torch.Tensor, normals: torch.Tensor,
                    max_points: int) -> PointCloud:
    if len(points) > max_points:
        print(f"[Warning] point extraction truncated: {len(points)} > {max_points}")
        points, normals = points[:max_points], normals[:max_points]
    pts = points.cpu().numpy().astype(np.float64)
    nrm = normals.cpu().numpy().astype(np.float64)
    norm = np.linalg.norm(nrm, axis=-1, keepdims=True)
    return PointCloud(points=pts, normals=nrm / np.maximum(norm, 1e-12))


# ---------------------------------------------------------------------------
# Marching cubes
# ---------------------------------------------------------------------------


def _mesh_ext_fields(cfg: TSDFConfig, state: TSDFState, weight_threshold: float,
                     slots: torch.Tensor):
    """(TB, R+1, R+1, R+1) tsdf/valid fields of blocks `slots` with their +1
    faces, edges and corner from the 7 positive neighbours, and (TB, 8)
    slot ids: self, then the neighbours in `_NEIGHBOR_OFFSETS` order
    (-1 = none)."""
    R = cfg.block_resolution
    G = cfg.grid_dim
    cap = cfg.block_count
    TB = slots.numel()
    dev = state.device
    in_range = slots < state.n_active
    slots_safe = torch.clamp(slots, max=cap).long()  # sentinel row = zeros
    coords = state.block_coords[slots_safe]
    ext_t = torch.zeros((TB, R + 1, R + 1, R + 1), dtype=torch.float32, device=dev)
    ext_v = torch.zeros((TB, R + 1, R + 1, R + 1), dtype=torch.bool, device=dev)
    ext_t[:, :R, :R, :R] = state.tsdf[slots_safe].view(TB, R, R, R)
    ext_v[:, :R, :R, :R] = ((state.weight[slots_safe].view(TB, R, R, R) > weight_threshold)
                            & in_range[:, None, None, None])
    minus1 = torch.full_like(slots, -1)
    nb_slots = [torch.where(in_range, slots, minus1)]
    for off in _NEIGHBOR_OFFSETS:
        nb_key = _block_keys(coords + torch.tensor(off, dtype=torch.int32, device=dev), G)
        nb_slot = state.slot_table[torch.clamp(nb_key, max=G ** 3 - 1)]
        nb_ok = (nb_key < G ** 3) & (nb_slot >= 0)
        nb_slots.append(torch.where(nb_ok, nb_slot, minus1))
        nb_safe = torch.where(nb_ok, nb_slot.long(), torch.full_like(nb_key, cap))
        src = (slice(None),) + tuple(slice(0, 1) if o else slice(0, R) for o in off)
        dst = (slice(None),) + tuple(slice(R, R + 1) if o else slice(0, R) for o in off)
        ext_t[dst] = state.tsdf[nb_safe].view(TB, R, R, R)[src]
        ext_v[dst] = ((state.weight[nb_safe].view(TB, R, R, R)[src] > weight_threshold)
                      & nb_ok[:, None, None, None])
    return coords, ext_t, ext_v, torch.stack(nb_slots, dim=1)


def _extract_mesh(cfg: TSDFConfig, state: TSDFState, weight_threshold: float,
                  n_bucket: int, max_verts: int, max_tris: int):
    """Marching cubes with edge-key welding over blocks [0, n_bucket), the
    JAX build's _extract_mesh_jit.

    Per tile of TB = min(128, n_bucket) blocks: build the extended fields,
    emit (a) crossing-edge vertices with int32 keys
    (owner_slot * R^3 + voxel) * 4 + axis and (b) triangles as key triples
    from the MC table.  Both are compacted in the reference's rank order
    (tile, then axis or triangle slot, then block and voxel) into
    fixed-capacity buffers; entries past a capacity are dropped, and the
    counts go on past it, which the caller's retry reads.  Keys resolve to
    vertex ids with one stable sort and searchsorted.  Returns (verts
    (3*max_verts,) f32, tri_idx (3*max_tris,) int64 with -1 for unresolved
    triangles, nv, nt).

    The vertex interpolation is (g + frac) * voxel, which XLA does not
    contract into a fused multiply-add, so the vertices are the
    reference's bit for bit."""
    R = cfg.block_resolution
    R3 = cfg.r3
    vs = cfg.voxel_size
    dev = state.device
    TB = min(128, n_bucket)
    n_tiles = (n_bucket + TB - 1) // TB

    tri_table, _ = build_tables()
    tri15 = torch.from_numpy(tri_table[:, :15].astype(np.int64)).to(dev)  # (256, 15)
    owner = torch.from_numpy(edge_owner().astype(np.int64)).to(dev)  # (12, 4)
    lx = torch.from_numpy(_voxel_offsets(R).astype(np.int64)).to(dev)  # (R^3, 3)
    # over_x*4 + over_y*2 + over_z -> nb_slots column (0 = self).
    nb_code = torch.tensor(
        [0 if o == (0, 0, 0) else 1 + _NEIGHBOR_OFFSETS.index(o)
         for o in ((x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1))],
        dtype=torch.int64, device=dev)

    out_v = torch.zeros((max_verts, 3), dtype=torch.float32, device=dev)
    out_vk = torch.full((max_verts,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                        device=dev)
    out_tk = torch.zeros((max_tris, 3), dtype=torch.int32, device=dev)
    nv = nt = 0
    half = torch.full((), 0.5, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    for t in range(n_tiles):
        slots = torch.arange(t * TB, (t + 1) * TB, dtype=torch.int32, device=dev)
        block_ok = (slots < state.n_active)[:, None, None, None]
        coords, ext_t, ext_v, nb_slots = _mesh_ext_fields(
            cfg, state, weight_threshold, slots)

        # -- vertices: crossings along each axis, in (block, voxel) order ------
        t0 = ext_t[:, :R, :R, :R]
        v0 = ext_v[:, :R, :R, :R]
        for axis in range(3):
            sl = [slice(0, R)] * 3
            sl[axis] = slice(1, R + 1)
            t1 = ext_t[(slice(None),) + tuple(sl)]
            v1 = ext_v[(slice(None),) + tuple(sl)]
            cross = v0 & v1 & (t0 * t1 < 0) & block_ok
            b, v = torch.nonzero(cross.reshape(TB, R3), as_tuple=True)
            count = b.numel()
            k = min(count, max(max_verts - nv, 0))
            if k:
                b, v = b[:k], v[:k]
                a = t0.reshape(TB, R3)[b, v]
                denom = a - t1.reshape(TB, R3)[b, v]
                frac = torch.where(denom.abs() > 1e-20,
                                   a / torch.where(denom == 0, one, denom), half)
                comps = []
                for c in range(3):
                    comp = (coords[b, c].long() * R + lx[v, c]).float()
                    if c == axis:
                        comp = comp + torch.clamp(frac, 0.0, 1.0)
                    comps.append(comp * vs)
                out_v[nv:nv + k] = torch.stack(comps, dim=-1)
                out_vk[nv:nv + k] = (((slots[b].long() * R3 + v) << 2) | axis).to(torch.int32)
            nv += count

        # -- triangles: cube configs + MC table ---------------------------------
        config = torch.zeros((TB, R, R, R), dtype=torch.int64, device=dev)
        cube_ok = block_ok
        for c in range(8):
            dx, dy, dz = (int(x) for x in CORNERS[c])
            corner = (slice(None), slice(dx, dx + R), slice(dy, dy + R), slice(dz, dz + R))
            cube_ok = cube_ok & ext_v[corner]
            config |= (ext_t[corner] < 0).long() << c
        config = config.reshape(-1)
        # Configs 0 and 255 (and cubes that are not ok) have no triangle.
        cube = torch.nonzero(cube_ok.reshape(-1) & (config != 0) & (config != 255),
                             as_tuple=True)[0]
        # (5, 3, A) edge ids per triangle slot and corner; the owner of an
        # edge is the cube voxel plus the edge's start offset, which lives in
        # a face/edge/corner neighbour when it passes R-1.
        e = tri15[config[cube]].T.reshape(5, 3, -1)
        oc = owner[torch.clamp(e, min=0)]  # (5, 3, A, 4)
        vox = lx[cube % R3]  # (A, 3)
        over_code = torch.zeros_like(e)
        local = torch.zeros_like(e)
        for c in range(3):
            ov = vox[:, c] + oc[..., c]
            over = (ov >= R).long()
            over_code = over_code * 2 + over
            local = local * R + (ov - over * R)
        owner_slot = nb_slots.reshape(-1)[(cube // R3) * 8 + nb_code[over_code]].long()
        tri_keys = ((owner_slot * R3 + local) << 2) | oc[..., 3]  # (5, 3, A)
        valid = (e[:, 0] >= 0) & (owner_slot >= 0).all(dim=1)  # (5, A), s-major
        sel = torch.nonzero(valid.reshape(-1), as_tuple=True)[0]
        k = min(sel.numel(), max(max_tris - nt, 0))
        if k:
            keys = tri_keys.permute(0, 2, 1).reshape(-1, 3)[sel[:k]]
            out_tk[nt:nt + k] = keys.to(torch.int32)
        nt += sel.numel()

    # -- resolve triangle edge keys -> vertex indices ---------------------------
    out_tk = out_tk.reshape(-1)
    keys_sorted, order = torch.sort(out_vk, stable=True)
    pos = torch.clamp(torch.searchsorted(keys_sorted, out_tk), max=max_verts - 1)
    found = keys_sorted[pos] == out_tk
    tri_idx = torch.where(found, order[pos], torch.zeros_like(pos))
    tri_ok = (found[0::3] & found[1::3] & found[2::3]).repeat_interleave(3)
    tri_idx = torch.where(tri_ok, tri_idx, torch.full_like(tri_idx, -1))
    return out_v.reshape(-1), tri_idx, nv, nt


def _mesh_vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (host, float64, in triangle order)."""
    if len(tris) == 0:
        return np.zeros_like(verts)
    p0 = verts[tris[:, 0]]
    p1 = verts[tris[:, 1]]
    p2 = verts[tris[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    normals = np.zeros_like(verts)
    for k in range(3):
        np.add.at(normals, tris[:, k], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)


def fresh_integrate_extract(cfg: TSDFConfig, depth, intrinsics, extrinsics_wc,
                            frame_valid, weight_threshold: float = 3.0,
                            max_points: int = 2_097_152, device="cuda"):
    """Fresh volume + one chunk (auto-split) + point extraction over
    n_bucket = block_count, behind the JAX build's return contract
    `(TSDFVolume, PointCloud, overflow)`.  The caller owns pool growth."""
    vol = TSDFVolume(cfg, device=device)
    vol.integrate(depth, intrinsics, extrinsics_wc, frame_valid)
    if vol.n_active == 0:
        return vol, PointCloud(points=np.zeros((0, 3))), vol.state.overflow
    pts, nrm = _extract_points(cfg, vol.state, weight_threshold, cfg.block_count)
    return vol, _to_point_cloud(pts, nrm, max_points), vol.state.overflow


# ---------------------------------------------------------------------------
# Host handle with persistence + extraction
# ---------------------------------------------------------------------------


class TSDFVolume:
    """Handle around (TSDFConfig, TSDFState) with save/load/extraction.

    npz schema (reconstruction/colorless_vbg.npz), shared with the JAX
    build so either package loads the other's file:
      block_coords (N,3) i32, tsdf (N,R^3) f32, weight (N,R^3) f32,
      voxel_size f64, block_resolution i64, grid_dim i64, depth_max f64,
      trunc_voxel_multiplier f64
    """

    def __init__(self, cfg: TSDFConfig, state: Optional[TSDFState] = None,
                 device="cuda"):
        self.cfg = cfg
        self._state_version = 0
        self.state = state if state is not None else create_state(cfg, device)

    @property
    def state(self) -> TSDFState:
        return self._state

    @state.setter
    def state(self, value: TSDFState):
        # Revision for caches keyed on the volume's contents (the raycast
        # scene prep); integrate() and reset() bump it too, since they
        # update the state in place.
        self._state = value
        self._state_version += 1

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def n_active(self) -> int:
        return self.state.n_active

    def reset(self) -> "TSDFVolume":
        """Zero the volume in place (no new allocation)."""
        st = self.state
        st.slot_table.fill_(-1)
        st.block_coords.zero_()
        st.tsdf.zero_()
        st.weight.zero_()
        st.n_active = st.overflow = st.dropped_active = 0
        self._state_version += 1
        return self

    # -- integration ------------------------------------------------------------

    def integrate(self, depth, intrinsics, extrinsics_wc, frame_valid=None,
                  auto_split=True):
        """Fuse a (C, H, W) chunk (numpy arrays or tensors).

        auto_split=True (default): when the chunk touches more blocks than
        cfg.chunk_active_capacity, re-run it over the next capacity
        window(s) until every touched block is integrated; the windows are
        disjoint block sets, so the result is bit-identical to a single
        unbounded pass and no observations are dropped."""
        if frame_valid is None:
            frame_valid = np.ones(depth.shape[0], dtype=bool)
        *chunk, T_cw = _stage_chunk(depth, intrinsics, extrinsics_wc, frame_valid,
                                    self.device)
        st = self.state
        self._state_version += 1
        if not auto_split:
            integrate_chunk(self.cfg, st, *chunk, 0, T_cw)
            return self
        integrate_windows(self.cfg, st,
                          lambda skip: integrate_chunk(self.cfg, st, *chunk, skip, T_cw))
        return self

    def integrate_scan(self, depth, intrinsics, extrinsics_wc, frame_valid):
        """Fuse an (S, C, H, W) group of S chunks (numpy arrays or tensors)
        by `integrate_chunks`, as S integrate(..., auto_split=False) calls
        would.  No auto-split: blocks a chunk touches past
        cfg.chunk_active_capacity are dropped and counted in
        state.dropped_active, for the caller to check once per group."""
        self._state_version += 1
        integrate_chunks(self.cfg, self.state, depth, intrinsics, extrinsics_wc, frame_valid)
        return self

    # -- persistence ---------------------------------------------------------------

    def _fetch_active(self):
        n = self.n_active
        st = self.state
        return (st.block_coords[:n].cpu().numpy(), st.tsdf[:n].cpu().numpy(),
                st.weight[:n].cpu().numpy())

    def save(self, path: Path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        coords, tsdf, weight = self._fetch_active()
        np.savez_compressed(
            path,
            block_coords=coords,
            tsdf=tsdf,
            weight=weight,
            voxel_size=self.cfg.voxel_size,
            block_resolution=self.cfg.block_resolution,
            grid_dim=self.cfg.grid_dim,
            depth_max=self.cfg.depth_max,
            trunc_voxel_multiplier=self.cfg.trunc_voxel_multiplier,
        )

    # Open3D VoxelBlockGrid npz interop (the reference's cache format): key
    # (N,3) i32, attr_tsdf / attr_weight (N,R,R,R,1) indexed [z][y][x],
    # voxel_size (1,) f64, block_resolution (1,) i64.  Our layout is
    # x-slowest, so axes transpose on the way through.

    def save_open3d_npz(self, path: Path):
        """Write the volume in Open3D VoxelBlockGrid.save schema."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        n = self.n_active
        R = self.cfg.block_resolution
        coords, tsdf, weight = self._fetch_active()
        tsdf = tsdf.reshape(n, R, R, R)
        weight = weight.reshape(n, R, R, R)
        np.savez_compressed(
            path,
            key=np.asarray(coords, np.int32),
            attr_tsdf=tsdf.transpose(0, 3, 2, 1)[..., None].astype(np.float32),
            attr_weight=weight.transpose(0, 3, 2, 1)[..., None].astype(np.float32),
            voxel_size=np.asarray([self.cfg.voxel_size], np.float64),
            block_resolution=np.asarray([self.cfg.block_resolution], np.int64),
        )

    @staticmethod
    def _o3d_field(data, name):
        for key in (f"attr_{name}", f"value_{name}", name):
            if key in data:
                return data[key]
        return None

    @classmethod
    def _from_blocks(cls, cfg: TSDFConfig, coords, tsdf, weight, device):
        n = coords.shape[0]
        G = cfg.grid_dim
        h = G // 2
        keys = (((coords[:, 0].astype(np.int64) + h) * G + coords[:, 1] + h) * G
                + coords[:, 2] + h)
        if n and (keys.min() < 0 or keys.max() >= G ** 3):
            raise ValueError(
                f"block coords exceed grid_dim={G} "
                f"(range {coords.min()}..{coords.max()})")
        slot_table = np.full((G ** 3,), -1, np.int32)
        slot_table[keys] = np.arange(n, dtype=np.int32)
        zero_row = np.zeros((1, cfg.r3), np.float32)
        arrays = {
            "slot_table": slot_table,
            "block_coords": np.concatenate([coords, np.zeros((1, 3), np.int32)]),
            "tsdf": np.concatenate([np.asarray(tsdf, np.float32), zero_row]),
            "weight": np.concatenate([np.asarray(weight, np.float32), zero_row]),
            "n_active": n, "overflow": 0, "dropped_active": 0,
        }
        return cls(cfg, state_from_numpy(cfg, arrays, device))

    @classmethod
    def load_open3d_npz(cls, path: Path, grid_dim: int = 160,
                        depth_max: float = 4.0,
                        trunc_voxel_multiplier: float = 10.0,
                        device="cuda") -> "TSDFVolume":
        """Load an Open3D-written VBG npz.  Open3D does not persist
        depth_max / truncation, so those come from the caller."""
        data = np.load(path)
        coords = np.asarray(data["key"] if "key" in data else data["keys"], np.int32)
        R = int(np.ravel(data["block_resolution"])[0])
        voxel = float(np.ravel(data["voxel_size"])[0])
        tsdf = cls._o3d_field(data, "tsdf")
        weight = cls._o3d_field(data, "weight")
        if tsdf is None or weight is None:
            raise ValueError(
                f"{path}: no tsdf/weight attributes in VBG npz "
                f"(keys: {sorted(data.keys())})")
        n = coords.shape[0]

        def to_blocks(a):
            a = np.asarray(a).reshape(n, R, R, R)
            return a.transpose(0, 3, 2, 1).reshape(n, R ** 3).astype(np.float32)

        cfg = TSDFConfig(voxel_size=voxel, block_resolution=R,
                         block_count=max(n, 1), grid_dim=grid_dim,
                         depth_max=depth_max,
                         trunc_voxel_multiplier=trunc_voxel_multiplier)
        return cls._from_blocks(cfg, coords, to_blocks(tsdf), to_blocks(weight), device)

    @classmethod
    def load(cls, path: Path, device="cuda") -> "TSDFVolume":
        data = np.load(path)
        if "block_coords" not in data and ("key" in data or "keys" in data):
            return cls.load_open3d_npz(path, device=device)
        coords = np.asarray(data["block_coords"], np.int32)
        cfg = TSDFConfig(
            voxel_size=float(data["voxel_size"]),
            block_resolution=int(data["block_resolution"]),
            block_count=max(int(coords.shape[0]), 1),
            grid_dim=int(data["grid_dim"]),
            depth_max=float(data["depth_max"]),
            trunc_voxel_multiplier=float(data["trunc_voxel_multiplier"]),
        )
        return cls._from_blocks(cfg, coords, data["tsdf"], data["weight"], device)

    # -- extraction ----------------------------------------------------------------------

    def extract_point_cloud(self, weight_threshold: float = 3.0,
                            device: bool = True,
                            max_points: int = 2_097_152) -> PointCloud:
        """Surface points at tsdf zero crossings along +x/+y/+z voxel edges
        (Open3D VBG.extract_point_cloud semantics).

        device=True computes on the volume's device (plain PyTorch);
        device=False runs the numpy host path.  Neither falls back to the
        other."""
        if self.n_active == 0:
            return PointCloud(points=np.zeros((0, 3)))
        if device:
            n_bucket = 256
            while n_bucket < self.n_active:
                n_bucket *= 2
            n_bucket = min(n_bucket, self.cfg.block_count)
            pts, nrm = _extract_points(self.cfg, self.state, weight_threshold, n_bucket)
            return _to_point_cloud(pts, nrm, max_points)
        return self._extract_point_cloud_host(weight_threshold)

    def extract_triangle_mesh(self, weight_threshold: float = 3.0,
                              estimated_vertex_number: int = -1,
                              device: bool = True, max_verts: int = 4_194_304,
                              max_tris: int = 8_388_608) -> TriangleMesh:
        """Marching cubes over valid voxels with lattice-edge-keyed vertex
        welding (crack-free across block boundaries).

        device=True runs the tables, crossing interpolation and key
        resolution on the volume's device (`_extract_mesh`, plain PyTorch);
        device=False runs the numpy host path, the parity oracle.  Neither
        falls back to the other."""
        del estimated_vertex_number  # capacity hint irrelevant here
        if self.n_active == 0:
            return TriangleMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        if device:
            return self._extract_triangle_mesh_device(weight_threshold, max_verts, max_tris)
        return self._extract_triangle_mesh_host(weight_threshold)

    def _extract_triangle_mesh_device(self, weight_threshold: float, max_verts: int,
                                      max_tris: int) -> TriangleMesh:
        n_bucket = 128
        while n_bucket < self.n_active:
            n_bucket *= 2
        n_bucket = min(n_bucket, self.cfg.block_count)
        # Occupancy-proportional buffers: a surface block contributes ~3*R^2
        # welded vertices and ~2x that in triangles; retry at the ceiling if
        # the estimate truncates.
        R = self.cfg.block_resolution
        v_ceil, t_ceil = max_verts, max_tris
        cap_v = 4096
        while cap_v < 8 * R * R * max(self.n_active, 1):
            cap_v *= 2
        max_verts = min(cap_v, v_ceil)
        max_tris = min(2 * max_verts, t_ceil)

        def run(max_verts, max_tris):
            return _extract_mesh(self.cfg, self.state, weight_threshold, n_bucket,
                                 max_verts, max_tris)

        # The device part, its readback included (the host waits for it).
        with substep("extract_triangle_mesh.device"):
            verts, tri_idx, nv, nt = run(max_verts, max_tris)
            if ((nv > max_verts and max_verts < v_ceil)
                    or (nt > max_tris and max_tris < t_ceil)):
                while max_verts < min(nv, v_ceil) or max_tris < min(nt, t_ceil):
                    max_verts = min(2 * max_verts, v_ceil)
                    max_tris = min(2 * max_tris, t_ceil)
                verts, tri_idx, nv, nt = run(max_verts, max_tris)
            if nv > max_verts or nt > max_tris:
                print(f"[Warning] device mesh extraction truncated "
                      f"({nv}/{max_verts} verts, {nt}/{max_tris} tris)")
                nv = min(nv, max_verts)
                nt = min(nt, max_tris)
            verts = verts[: nv * 3].cpu().numpy()
            tris = tri_idx[: nt * 3].cpu().numpy().reshape(-1, 3)
        verts = verts.astype(np.float64).reshape(-1, 3)
        tris = tris[(tris >= 0).all(axis=1) & (tris < nv).all(axis=1)]
        # Drop unreferenced vertices (edges valid between voxel pairs that
        # belong to no fully valid cube).
        used = np.zeros(nv, bool)
        if len(tris):
            used[tris.reshape(-1)] = True
        remap = np.full(nv, -1, np.int64)
        remap[used] = np.arange(used.sum())
        mesh = TriangleMesh(
            vertices=verts[used],
            triangles=remap[tris] if len(tris) else np.zeros((0, 3), np.int64))
        mesh.vertex_normals = _mesh_vertex_normals(mesh.vertices, mesh.triangles)
        return mesh

    def _extract_triangle_mesh_host(self, weight_threshold: float) -> TriangleMesh:
        """The numpy marching cubes of the JAX build's host path: welds
        vertices by 64-bit lattice-edge keys and interpolates in float64."""
        R = self.cfg.block_resolution
        empty = TriangleMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        tri_table, _ = build_tables()
        coords, ext_t, ext_v = self._extended_fields(weight_threshold)
        n = len(coords)
        corner_t = np.empty((n, R, R, R, 8), np.float32)
        corner_v = np.empty((n, R, R, R, 8), bool)
        for k in range(8):
            dx, dy, dz = CORNERS[k]
            corner_t[..., k] = ext_t[:, dx:dx + R, dy:dy + R, dz:dz + R]
            corner_v[..., k] = ext_v[:, dx:dx + R, dy:dy + R, dz:dz + R]
        config = np.zeros((n, R, R, R), np.int32)
        for k in range(8):
            config |= (corner_t[..., k] < 0).astype(np.int32) << k
        config = np.where(corner_v.all(axis=-1), config, 0)
        active = np.nonzero((config != 0) & (config != 255))
        if len(active[0]) == 0:
            return empty
        cfgs = config[active]
        cube_g = coords[active[0]] * R + np.stack(active[1:], -1)  # (A, 3)
        owner = edge_owner()
        te = tri_table[cfgs][:, :15].reshape(-1, 5, 3)
        A = len(cfgs)
        tsel = np.nonzero(te[..., 0] >= 0)
        tri_e = te[tsel]  # (T, 3) cube-local edge ids
        tri_cube = np.repeat(np.arange(A), 5).reshape(A, 5)[tsel]
        g = cube_g[tri_cube][:, None, :] + owner[tri_e][..., :3]  # (T, 3, 3)
        OFF = 1 << 14
        key = (((g[..., 0] + OFF).astype(np.int64) << 34)
               | ((g[..., 1] + OFF).astype(np.int64) << 19)
               | ((g[..., 2] + OFF).astype(np.int64) << 4)
               | owner[tri_e][..., 3].astype(np.int64))
        uniq, inverse = np.unique(key.reshape(-1), return_inverse=True)
        triangles = inverse.reshape(-1, 3).astype(np.int64)
        ug = np.stack([(uniq >> 34) - OFF, ((uniq >> 19) & 0x7FFF) - OFF,
                       ((uniq >> 4) & 0x7FFF) - OFF], -1).astype(np.int64)
        uaxis = (uniq & 0xF).astype(np.int64)
        t_start, t_end = self._sample_tsdf_pairs(ug, uaxis)
        denom = t_start - t_end
        frac = np.where(np.abs(denom) > 1e-12,
                        t_start / np.where(denom == 0, 1, denom), 0.5)
        verts = ug.astype(np.float64)
        verts[np.arange(len(uniq)), uaxis] += np.clip(frac, 0.0, 1.0)
        verts *= self.cfg.voxel_size
        good = ((triangles[:, 0] != triangles[:, 1]) & (triangles[:, 1] != triangles[:, 2])
                & (triangles[:, 0] != triangles[:, 2]))
        mesh = TriangleMesh(vertices=verts, triangles=triangles[good])
        mesh.vertex_normals = _mesh_vertex_normals(verts, mesh.triangles)
        return mesh

    def _sample_tsdf_pairs(self, g: np.ndarray, axis: np.ndarray):
        """tsdf values at lattice voxel g and its +1 neighbour along axis."""
        R = self.cfg.block_resolution
        G = self.cfg.grid_dim
        coords, tsdf, _, slot_table = self._host_fields()
        n = len(coords)
        flat_t = np.concatenate([tsdf.reshape(n, -1), np.zeros((1, R ** 3), np.float32)])

        def sample(gv):
            b = np.floor_divide(gv, R)
            local = gv - b * R
            shifted = b + G // 2
            ok = np.all((shifted >= 0) & (shifted < G), axis=-1)
            key = (shifted[:, 0] * G + shifted[:, 1]) * G + shifted[:, 2]
            slot = np.where(ok, slot_table[np.clip(key, 0, G ** 3 - 1)], -1)
            slot = np.where(slot >= 0, slot, n)
            return flat_t[slot, (local[:, 0] * R + local[:, 1]) * R + local[:, 2]]

        g2 = g.copy()
        g2[np.arange(len(g)), axis] += 1
        return sample(g), sample(g2)

    def _host_fields(self):
        n = self.n_active
        R = self.cfg.block_resolution
        coords, tsdf, weight = self._fetch_active()
        return (coords, tsdf.reshape(n, R, R, R), weight.reshape(n, R, R, R),
                self.state.slot_table.cpu().numpy())

    def _extended_fields(self, weight_threshold: float):
        """(n, R+1, R+1, R+1) tsdf/valid fields with +1 voxel margins
        gathered from the 7 positive-neighbour blocks."""
        cfg = self.cfg
        R = cfg.block_resolution
        G = cfg.grid_dim
        coords, tsdf, weight, slot_table = self._host_fields()
        n = len(coords)

        ext_t = np.zeros((n, R + 1, R + 1, R + 1), np.float32)
        ext_v = np.zeros((n, R + 1, R + 1, R + 1), bool)
        ext_t[:, :R, :R, :R] = tsdf
        ext_v[:, :R, :R, :R] = weight > weight_threshold
        h = G // 2

        def slots_of(nb_coords):
            shifted = nb_coords + h
            ok = np.all((shifted >= 0) & (shifted < G), axis=-1)
            key = (shifted[:, 0] * G + shifted[:, 1]) * G + shifted[:, 2]
            return np.where(ok, slot_table[np.clip(key, 0, G ** 3 - 1)], -1)

        for off in _NEIGHBOR_OFFSETS:
            nb = slots_of(coords + np.asarray(off, np.int32))
            has = nb >= 0
            src = np.clip(nb, 0, max(n - 1, 0))
            dst = tuple(slice(R, R + 1) if o else slice(0, R) for o in off)
            srcreg = tuple(slice(0, 1) if o else slice(0, R) for o in off)
            t_nb = tsdf[src][(slice(None),) + srcreg]
            v_nb = (weight[src][(slice(None),) + srcreg]) > weight_threshold
            ext_t[(slice(None),) + dst] = np.where(has[:, None, None, None], t_nb, 0.0)
            ext_v[(slice(None),) + dst] = v_nb & has[:, None, None, None]
        return coords, ext_t, ext_v

    def _extract_point_cloud_host(self, weight_threshold: float) -> PointCloud:
        cfg = self.cfg
        R = cfg.block_resolution
        coords, ext_t, ext_v = self._extended_fields(weight_threshold)
        t0 = ext_t[:, :R, :R, :R]
        v0 = ext_v[:, :R, :R, :R]
        pts, nrms = [], []
        for axis in range(3):
            sl = [slice(0, R)] * 3
            sl[axis] = slice(1, R + 1)
            t1 = ext_t[(slice(None),) + tuple(sl)]
            v1 = ext_v[(slice(None),) + tuple(sl)]
            cross = v0 & v1 & (t0 * t1 < 0)
            if not cross.any():
                continue
            idx = np.nonzero(cross)
            a = t0[idx]
            b = t1[idx]
            frac = a / (a - b)
            p = (coords[idx[0]] * R + np.stack(idx[1:], axis=-1)).astype(np.float64)
            p[:, axis] += frac
            pts.append(p * cfg.voxel_size)
            nrms.append(_gradient_normals(ext_t, idx))
        if not pts:
            return PointCloud(points=np.zeros((0, 3)))
        points = np.concatenate(pts)
        normals = np.concatenate(nrms)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        return PointCloud(points=points, normals=normals / np.maximum(norm, 1e-12))


def _gradient_normals(ext_t, idx):
    """Central-difference tsdf gradients at crossing voxels."""
    R = ext_t.shape[1] - 1
    b, x, y, z = idx
    grads = []
    for a in range(3):
        hi = [x.copy(), y.copy(), z.copy()]
        lo = [x.copy(), y.copy(), z.copy()]
        hi[a] = np.minimum(hi[a] + 1, R)
        lo[a] = np.maximum(lo[a] - 1, 0)
        grads.append(ext_t[b, hi[0], hi[1], hi[2]] - ext_t[b, lo[0], lo[1], lo[2]])
    return np.stack(grads, -1)
