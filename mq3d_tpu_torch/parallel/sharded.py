"""Multi-device TSDF integration, confidence and raycast over a process group.

Counterpart of mq3d_tpu/parallel/sharded.py, with a `torch.distributed`
group (parallel/dist.py) in the place of the JAX package's `Mesh`: every
rank is a process that holds the whole chunk's inputs and works on its own
contiguous slice of the frames, as `PartitionSpec(axis)` gives a device.

TSDF fusion is an exact data-parallel reduction, since Open3D's update
tsdf' = (tsdf*w + obs)/(w+1) is a running mean of observations:

  * allocation: each rank's touched-block grid is sum-all-reduced before
    allocation, so every rank allocates the same blocks in the same slots
    from the same prior state (the host syncs of `_alloc_and_window` see
    identical inputs on every rank);
  * integration: each rank sums (obs, count) over its frames' pairs in the
    window of touched blocks (`ops.tsdf._window_sums`: K5's sums form on
    the card), and one sum-all-reduce merges the windows before the shared
    merge formula.

Each rank stages its slice of the chunk as the single-process path does
(`ops.tsdf._stage_chunk`).

The window sums are added across ranks in the backend's order, not in
frame order, so a sharded volume matches a single-process one with
weights exact and tsdf to ~1e-5 (the JAX package's bound); at world size 1
the all-reduce is the identity and the result is bit for bit
`TSDFVolume.integrate` of the same chunks.  Unlike the JAX step, a chunk
that touches more than cfg.chunk_active_capacity blocks runs further
capacity windows (`integrate_windows`), as `TSDFVolume.integrate` does.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import torch

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.ops.tsdf import (
    TSDFConfig,
    TSDFState,
    _alloc_and_window,
    _frame_touch_grid,
    _merge_window,
    _stage_chunk,
    _window_sums,
    create_state,
    integrate_windows,
)
from mq3d_tpu_torch.parallel.dist import (
    all_gather,
    all_reduce_,
    rank_of,
    rank_slice,
    sum_scalar,
    world_of,
)


def padded_rows(cfg: TSDFConfig, n_ranks: int) -> int:
    """Voxel-table row count of the partitioned state: cap+1 (sentinel)
    rounded up to a rank multiple so the block axis divides evenly."""
    cap1 = cfg.block_count + 1
    return ((cap1 + n_ranks - 1) // n_ranks) * n_ranks


def create_state_partitioned(cfg: TSDFConfig, group, device="cuda") -> TSDFState:
    """A TSDFState whose tsdf/weight hold only this rank's rows of the
    padded voxel tables (rows [rank * n, (rank + 1) * n) for
    n = padded_rows / world); slot table, block coordinates and counters are
    whole on every rank.  Pad rows past the sentinel are never addressed."""
    dev = resolve_device(device)
    rows_local = padded_rows(cfg, world_of(group)) // world_of(group)
    return TSDFState(
        slot_table=torch.full((cfg.grid_dim ** 3,), -1, dtype=torch.int32, device=dev),
        block_coords=torch.zeros((cfg.block_count + 1, 3), dtype=torch.int32, device=dev),
        tsdf=torch.zeros((rows_local, cfg.r3), dtype=torch.float32, device=dev),
        weight=torch.zeros((rows_local, cfg.r3), dtype=torch.float32, device=dev),
    )


def gather_partitioned(cfg: TSDFConfig, state: TSDFState, group) -> TSDFState:
    """The whole (replicated) state from a partitioned one, on every rank."""
    cap1 = cfg.block_count + 1
    return TSDFState(
        slot_table=state.slot_table, block_coords=state.block_coords,
        tsdf=all_gather(state.tsdf, group)[:cap1],
        weight=all_gather(state.weight, group)[:cap1],
        n_active=state.n_active, overflow=state.overflow,
        dropped_active=state.dropped_active)


def sharded_integrate_step(cfg: TSDFConfig, group, partition_state: bool = False):
    """One-chunk integration step over the group: step(state, depth (C, H,
    W), intrinsics (C, 3, 3), extrinsics_wc (C, 4, 4), frame_valid (C,))
    -> state, updated in place.  Every rank passes the whole chunk (numpy
    or tensors; C divisible by the world size) and integrates its own
    slice of it.

    With partition_state=False the state is replicated (`create_state`).
    With partition_state=True the voxel tables are split over the ranks
    (`create_state_partitioned`): each rank folds only the window rows it
    owns, by the same merge formula, so the rows equal the replicated
    state's bit for bit at 1/world of its memory."""
    G3 = cfg.grid_dim ** 3
    world = world_of(group)
    rows_local = padded_rows(cfg, world) // world
    row0 = rank_of(group) * rows_local

    def step(state: TSDFState, depth, intrinsics, extrinsics_wc, frame_valid) -> TSDFState:
        sl = rank_slice(depth.shape[0], group)
        depth_l, K_l, T_wc, valid_l, T_cw = _stage_chunk(
            depth[sl], intrinsics[sl], extrinsics_wc[sl], frame_valid[sl], state.device)
        frame_touched = _frame_touch_grid(cfg, depth_l, K_l, T_cw, valid_l)
        touched = frame_touched[:, :G3].any(dim=0).to(torch.int32)
        touched = all_reduce_(touched, group) > 0  # union: count > 0 == any

        def one_pass(block_skip: int) -> None:
            wkeys, active_slots = _alloc_and_window(cfg, state, touched, block_skip)
            if active_slots.numel() == 0:  # the same on every rank
                return
            sums, cnts = _window_sums(cfg, state, depth_l, K_l, T_wc, frame_touched, wkeys,
                                      active_slots)
            all_reduce_(sums, group)
            all_reduce_(cnts, group)
            if partition_state:
                own = (active_slots >= row0) & (active_slots < row0 + rows_local)
                _merge_window(state, active_slots[own] - row0, sums[own], cnts[own])
            else:
                _merge_window(state, active_slots, sums, cnts)

        integrate_windows(cfg, state, one_pass)
        return state

    return step


def sharded_confidence_step(group):
    """Confidence estimation with the reference frames sharded over the
    group: build(depth_max, error_threshold, window) returns fn(depth, K,
    T_cw, T_wc, valid, refs) -> (confidence, valid_count) of all refs, on
    every rank.  Each rank runs `confidence_for_refs` on its slice of refs
    against the whole frame stack; len(refs) must divide by the world."""
    from mq3d_tpu_torch.recon.confidence import confidence_for_refs

    def build(depth_max: float, error_threshold: float, window: int):
        local = partial(confidence_for_refs, depth_max=depth_max,
                        error_threshold=error_threshold, window=window)

        def fn(depth, K, T_cw, T_wc, valid, refs):
            conf, cnt = local(depth, K, T_cw, T_wc, valid, refs[rank_slice(len(refs), group)])
            return all_gather(conf, group), all_gather(cnt, group)

        return fn

    return build


def sharded_raycast_batch(volume, group, intrinsics: np.ndarray, extrinsics_wc: np.ndarray,
                          width: int, height: int) -> Tuple[np.ndarray, int]:
    """Color-aligned depth of F frames with the frames sharded over the
    group: ((F, height, width) z-depth on every rank, the summed edge
    overflow).  Every rank holds the same volume and renders its frames
    with its own edge cap, max((F / world) * w * h / 16, 4096) (the JAX
    package's per-device cap), so each pixel's march is the single-process
    render's wherever neither overflows.  F must divide by the world."""
    from mq3d_tpu_torch.ops.raycast import _render_frames_device

    world = world_of(group)
    F = intrinsics.shape[0]
    if F % world:
        raise ValueError(f"frame count {F} not divisible by the world size {world}")
    sl = rank_slice(F, group)
    edge_cap = max((F // world) * width * height // 16, 4096)
    z, overflow = _render_frames_device(volume, np.asarray(intrinsics)[sl],
                                        np.asarray(extrinsics_wc)[sl], width, height,
                                        edge_cap)
    return all_gather(z, group).cpu().numpy(), sum_scalar(int(overflow), group)


def integrate_dataset_sharded(cfg: TSDFConfig, group, depth: np.ndarray,
                              intrinsics: np.ndarray, extrinsics_wc: np.ndarray,
                              frame_valid: np.ndarray, frames_per_rank_chunk: int = 8,
                              partition_state: bool = False, device="cuda") -> TSDFState:
    """A whole dataset through the sharded step, in chunks of world *
    frames_per_rank_chunk frames (the tail padded with invalid frames).
    Equals a single-process run chunked the same way (see module doc)."""
    world = world_of(group)
    step = sharded_integrate_step(cfg, group, partition_state)
    state = (create_state_partitioned(cfg, group, device) if partition_state
             else create_state(cfg, device))
    chunk = world * frames_per_rank_chunk
    n = depth.shape[0]
    pad = -n % chunk
    if pad:
        depth = np.concatenate([depth, np.zeros((pad,) + depth.shape[1:], np.float32)])
        intrinsics = np.concatenate([intrinsics, np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
        extrinsics_wc = np.concatenate(
            [extrinsics_wc, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        frame_valid = np.concatenate([frame_valid, np.zeros(pad, bool)])
    for s in range(0, n + pad, chunk):
        step(state, depth[s:s + chunk], intrinsics[s:s + chunk],
             extrinsics_wc[s:s + chunk], frame_valid[s:s + chunk])
    return state
