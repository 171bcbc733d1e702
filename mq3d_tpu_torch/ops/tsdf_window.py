"""K5: Phase B of TSDF integration for one capacity window, in one launch.

`ops.tsdf._fuse_window` hands each capacity window to `integrate_window`
when the volume lies on the card and `depth_lookup` is "auto": the
hand-written kernel csrc/tsdf_window.cu projects every voxel of every
window block into each frame that touched the block, in frame order,
fetches the depth, sums the truncated signed distances and merges them
into the voxel tables in place.  It equals the tile loop of
`ops.tsdf._integrate_pairs` and `_merge_window` bit for bit (that loop is
its reference, as `ops.fma.fma_plain` is K4's), with one launch where the loop
makes about 220 host-launched operations a tile of 512 pairs, and with no
host sync, host-built index or `(n_window, R^3)` buffer.

The kernel reads the window's pairs from the chunk's touch grid
(`frame_touched`, one row a frame), so no pair list is compacted first.
`window_sums` is its other form, which `ops.tsdf._window_sums` gives a
rank of the sharded step (parallel/sharded.py): the window's (sums,
counts) over the rank's frames, which the ranks all-reduce before
`_merge_window`.

Engagement counter: the (block, frame) pairs K5 integrated, every one
through the flat fetch (K5 anchors no patch), are counted on the card.
`window_pair_count()` reads them (a device sync: not for a timed path);
`reset_window_pair_count()` zeroes them.

OPS_PAIR_VOXEL and OPS_MERGE_VOXEL are K5's float32 operations per pair
and voxel and per merged voxel, as counted for its roofline bound.
"""

from __future__ import annotations

import numpy as np
import torch

from mq3d_tpu_torch.kernels import _build

_MAX_R = 1023  # the kernel packs a voxel's local offsets in 10 bits an axis
_INT32 = 2 ** 31

# Per pair and voxel: the voxel's position 3, the pose 18, the projection 9
# (the reciprocal of z, per axis two multiplies and two adds), the tests 9,
# sdf, its clamp and scale 3, the sum and count 2.  Per merged voxel:
# tsdf * w + sum 2, the weight's sum 1, the quotient 1.
OPS_PAIR_VOXEL = 44
OPS_MERGE_VOXEL = 4

# Per card: the int64 count of pairs K5 integrated.
_pair_counts: dict = {}


def reset_window_pair_count() -> None:
    for c in _pair_counts.values():
        c.zero_()


def window_pair_count() -> int:
    """The (block, frame) pairs K5 integrated on every card since the
    last reset (reads the card)."""
    return sum(int(c.item()) for c in _pair_counts.values())


def _counter(device: torch.device) -> torch.Tensor:
    c = _pair_counts.get(device)
    if c is None:
        c = _pair_counts[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return c


def _check(named: dict, R: int) -> None:
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"integrate_window: {name} must be a tensor, got {type(t).__name__}")
    dtypes = {"tsdf": torch.float32, "weight": torch.float32, "block_coords": torch.int32,
              "depth": torch.float32, "intrinsics": torch.float32,
              "extrinsics_wc": torch.float32, "frame_touched": torch.bool,
              "wkeys": torch.int64, "slots": torch.int64}
    for name, dtype in dtypes.items():
        if name in named and named[name].dtype != dtype:
            raise TypeError(f"integrate_window: {name} must be {dtype}, got "
                            f"{named[name].dtype}")
    depth, block_coords = named["depth"], named["block_coords"]
    frame_touched, wkeys, slots = named["frame_touched"], named["wkeys"], named["slots"]
    if depth.ndim != 3:
        raise ValueError(f"integrate_window: depth must be (C, H, W), got {tuple(depth.shape)}")
    C, H, W = depth.shape
    N = block_coords.shape[0]
    shapes = {"tsdf": (N, R ** 3), "weight": (N, R ** 3), "block_coords": (N, 3),
              "intrinsics": (C, 3, 3), "extrinsics_wc": (C, 4, 4)}
    for name, shape in shapes.items():
        if name in named and tuple(named[name].shape) != shape:
            raise ValueError(f"integrate_window: {name} must be {shape}, got "
                             f"{tuple(named[name].shape)}")
    if frame_touched.ndim != 2 or frame_touched.shape[0] != C:
        raise ValueError(f"integrate_window: frame_touched must be ({C}, keys), got "
                         f"{tuple(frame_touched.shape)}")
    if wkeys.ndim != 1 or wkeys.shape != slots.shape:
        raise ValueError(f"integrate_window: wkeys and slots must be one (n,) shape, got "
                         f"{tuple(wkeys.shape)} and {tuple(slots.shape)}")
    if not 1 <= R <= _MAX_R:
        raise ValueError(f"integrate_window: block_resolution {R} outside [1, {_MAX_R}]")
    if H * W >= _INT32 or wkeys.shape[0] >= _INT32 or C >= _INT32:
        raise ValueError(f"integrate_window: shape too large (C={C}, H={H}, W={W}, "
                         f"n={wkeys.shape[0]})")
    if "tsdf" in named and not (named["tsdf"].is_contiguous()
                                and named["weight"].is_contiguous()):
        raise ValueError("integrate_window: tsdf and weight are updated in place and must "
                         "be contiguous")
    devices = {t.device for t in named.values()}
    if len(devices) != 1 or devices.pop().type != "cuda":
        raise ValueError(f"integrate_window: K5 takes CUDA tensors on one card, got "
                         f"{sorted(str(t.device) for t in named.values())}")


def integrate_window(cfg, tsdf, weight, block_coords, depth, intrinsics, extrinsics_wc,
                     frame_touched, wkeys, slots) -> None:
    """Fuse one capacity window into the voxel tables `tsdf` and `weight`
    (updated in place) by K5.

    cfg: the volume's TSDFConfig.  depth (C, H, W), intrinsics (C, 3, 3)
    and extrinsics_wc (C, 4, 4, world-to-camera) float32; frame_touched
    (C, keys) bool, the chunk's touch grid; wkeys and slots (n,) int64, the
    window's grid keys and their distinct slots; block_coords (N, 3) int32,
    tsdf and weight (N, R^3) float32.  All on one card; anything else
    raises before a launch.  An empty window launches nothing."""
    _launch(cfg, dict(tsdf=tsdf, weight=weight, block_coords=block_coords, depth=depth,
                      intrinsics=intrinsics, extrinsics_wc=extrinsics_wc,
                      frame_touched=frame_touched, wkeys=wkeys, slots=slots), False)


def window_sums(cfg, block_coords, depth, intrinsics, extrinsics_wc, frame_touched, wkeys,
                slots):
    """(sums, cnts), each (n, R^3) float32, of the window's observations
    over the chunk's frames, in frame order, by K5's other form: the tile
    loop's `_integrate_pairs` without its merge (operands as
    `integrate_window`'s; the tables are not read)."""
    out = _launch(cfg, dict(block_coords=block_coords, depth=depth, intrinsics=intrinsics,
                            extrinsics_wc=extrinsics_wc, frame_touched=frame_touched,
                            wkeys=wkeys, slots=slots), True)
    return out[0], out[1]


def _launch(cfg, named: dict, sums_form: bool):
    """Check, then launch K5 once (nothing for an empty window); returns
    the (2, n, R^3) sums and counts of the sums form, else None."""
    R = cfg.block_resolution
    _check(named, R)
    n = named["wkeys"].shape[0]
    out = (torch.empty((2, n, R ** 3), dtype=torch.float32, device=named["depth"].device)
           if sums_form else None)
    if n == 0:
        return out
    C, H, W = named["depth"].shape
    t = {k: (v if k in ("tsdf", "weight") else v.contiguous()) for k, v in named.items()}
    # The Python scalars as PyTorch rounds them to float32 in the tile path.
    f32 = np.float32
    scalars = (f32(cfg.voxel_size), f32(cfg.depth_max), f32(-cfg.trunc), f32(cfg.trunc),
               f32(1.0 / cfg.trunc))
    dev = t["depth"].device
    tables = (None, None) if sums_form else (t["tsdf"].data_ptr(), t["weight"].data_ptr())
    sums = (out[0].data_ptr(), out[1].data_ptr()) if sums_form else (None, None)
    _build.launch(
        "tsdf_window", dev, t["depth"].data_ptr(), t["intrinsics"].data_ptr(),
        t["extrinsics_wc"].data_ptr(), t["frame_touched"].data_ptr(),
        t["frame_touched"].stride(0), t["wkeys"].data_ptr(), t["slots"].data_ptr(),
        t["block_coords"].data_ptr(), *tables, *sums, _counter(dev).data_ptr(), n, C, H, W, R,
        *map(float, scalars))
    return out
