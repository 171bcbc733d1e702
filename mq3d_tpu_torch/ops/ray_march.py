"""K6: step 6's march and refine for one pyramid level, in one launch.

`ops.raycast._render_frames` hands each level's lanes to K6 when the
volume lies on the card: `march_base` for the base level (every pixel),
`march_fine` for a fine level's compacted edge lanes.  The hand-written
kernel csrc/ray_march.cu runs one thread a lane: its ray, its span in the
volume's AABB and its parent's window, the march, the refine, and the write
of its depth.  It equals the plain path of `ops.raycast` (`_march`,
`_refine` and the tensors around them) bit for bit; that path is its
reference, as `ops.fma.fma_plain` is K4's, and the CPU path.  Where the
plain path makes about 1 100 host-launched operations a level and reads
`active.any()` from the card every few march steps, K6 is one launch and
no host read.

Engagement counters: per card, on the card, the lanes K6 ran, those that
found a bracket (the hit share) and the march steps they took, the base
level apart from the fine levels.  `ray_march_counts()` reads them (a
device sync: not for a timed path); `reset_ray_march_counts()` zeroes them.

SECTOR_BYTES is what a gather moves from HBM when no cache serves it (one
32-byte sector), GATHERS_PER_STEP and GATHERS_PER_SAMPLE how many a march
step and a refine sample make: chip_smoke's sector time of K6.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mq3d_tpu_torch.kernels import _build

_EXT = 17  # the z-pair table's extended block side
_MAX_SAMPLES = 3  # kMaxSamples of csrc/ray_march.cu
_INT32 = 2 ** 31
SECTOR_BYTES = 32
GATHERS_PER_STEP = 2
GATHERS_PER_SAMPLE = 5

_LEVELS = ("base", "fine")
_KINDS = ("lanes", "hits", "steps")
# Per card: int64 (lanes, hits, steps) of the base level, then the fine levels'.
_counts: dict = {}


def reset_ray_march_counts() -> None:
    for c in _counts.values():
        c.zero_()


def ray_march_counts() -> dict:
    """{"base" | "fine": {"lanes", "hits", "steps"}} summed over every card
    since the last reset (reads the card)."""
    total = [0] * (len(_LEVELS) * len(_KINDS))
    for c in _counts.values():
        total = [a + int(b) for a, b in zip(total, c.tolist())]
    return {lv: dict(zip(_KINDS, total[i * len(_KINDS):(i + 1) * len(_KINDS)]))
            for i, lv in enumerate(_LEVELS)}


def _counter(device: torch.device) -> torch.Tensor:
    c = _counts.get(device)
    if c is None:
        c = _counts[device] = torch.zeros(len(_LEVELS) * len(_KINDS), dtype=torch.int64,
                                          device=device)
    return c


def _check(named: dict, cfg, n_bucket: int, n_samples: int, f=None) -> None:
    """Raise unless the operands are contiguous tensors of K6's dtypes and
    shapes on one card, and the volume, budgets and upsample factor `f` (a
    fine level's) are K6's."""
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ray_march: {name} must be a tensor, got {type(t).__name__}")
    dtypes = {"slot_dist": torch.int32, "ext": torch.int32, "ids_p": torch.int64}
    for name, t in named.items():
        want = dtypes.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"ray_march: {name} must be {want}, got {t.dtype}")
    F = (named["K"].shape or (-1,))[0]
    shapes = {"slot_dist": (cfg.grid_dim ** 3,), "ext": (n_bucket * _EXT ** 3 + 1,),
              "aabb": (2, 3), "K": (F, 3, 3), "Rcw": (F, 3, 3), "origin": (F, 3)}
    if "depth" in named:
        cap_p = (named["ids_p"].shape or (-1,))[0]
        shapes.update(ids_p=(cap_p,), t0_p=(cap_p,), t_hi_p=(cap_p,),
                      depth=(F,) + tuple(named["depth"].shape[1:]))
        if named["depth"].ndim != 3:
            raise ValueError(f"ray_march: depth must be (F, h, w), got "
                             f"{tuple(named['depth'].shape)}")
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"ray_march: {name} must be {shape}, got "
                             f"{tuple(named[name].shape)}")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"ray_march: {name} must be contiguous")
    if cfg.block_resolution != _EXT - 1:
        raise ValueError(f"ray_march: block_resolution must be {_EXT - 1}, got "
                         f"{cfg.block_resolution}")
    if not 2 <= n_samples <= _MAX_SAMPLES:
        raise ValueError(f"ray_march: {n_samples} refine samples outside [2, {_MAX_SAMPLES}]")
    if f is not None:
        h, w = named["depth"].shape[1:]
        if f < 2 or h % f or w % f:
            raise ValueError(f"ray_march: upsample factor {f} does not divide the {h}x{w} map")
    devices = {t.device for t in named.values()}
    if len(devices) != 1 or devices.pop().type != "cuda":
        raise ValueError(f"ray_march: K6 takes CUDA tensors on one card, got "
                         f"{sorted(str(t.device) for t in named.values())}")


def march_base(cfg, scene, K, Rcw, origin, t_min: float, t_max: float, s: int, h: int,
               w: int, march_iters: int, n_samples: int, n_iters: int) -> torch.Tensor:
    """The base level's (F, h, w) z-depth (inf: miss) by K6, one lane a
    pixel at scale s.

    cfg: the volume's TSDFConfig; scene: `raycast.prepare_scene`'s
    (slot_dist (G^3,) int32, ext (n_bucket*17^3+1,) int32, aabb (2, 3)
    float32) and n_bucket; K (F, 3, 3), Rcw (F, 3, 3) camera-to-world
    rotations and origin (F, 3) float32; t_min and t_max float32 values;
    the march's steps and the refine's samples and iterations.  Contiguous
    tensors on one card; anything else raises before a launch."""
    slot_dist, ext, aabb, n_bucket = scene
    named = dict(slot_dist=slot_dist, ext=ext, aabb=aabb, K=K, Rcw=Rcw, origin=origin)
    _check(named, cfg, n_bucket, n_samples)
    F = K.shape[0]
    depth = torch.empty((F, h, w), dtype=torch.float32, device=K.device)
    _launch(cfg, named, n_bucket, depth, F * h * w, 0, (0, 0), s, 0, t_min, t_max,
            march_iters, n_samples, n_iters)
    return depth


def march_fine(cfg, scene, K, Rcw, origin, t_min: float, t_max: float, s: int, f: int,
               ids_p, t0_p, t_hi_p, depth, march_iters: int, n_samples: int,
               n_iters: int) -> None:
    """A fine level's edge lanes by K6, written into its upsampled map
    `depth` (F, h, w) float32 in place.

    Lane phase * cap_p + j is child `phase` (of f*f) of parent pixel
    ids_p[j] of the (F, h // f, w // f) parent map (F * h * w // f^2 for a
    dead lane, which writes nothing), marched inside [t0_p[j], t_hi_p[j]]
    and the AABB span; ids_p (cap_p,) int64, t0_p and t_hi_p (cap_p,)
    float32.  Other operands as `march_base`'s."""
    slot_dist, ext, aabb, n_bucket = scene
    named = dict(slot_dist=slot_dist, ext=ext, aabb=aabb, K=K, Rcw=Rcw, origin=origin,
                 ids_p=ids_p, t0_p=t0_p, t_hi_p=t_hi_p, depth=depth)
    _check(named, cfg, n_bucket, n_samples, f)
    h, w = depth.shape[1], depth.shape[2]
    cap_p = ids_p.shape[0]
    _launch(cfg, named, n_bucket, depth, cap_p * f * f, cap_p, (h // f, w // f), s, f, t_min,
            t_max, march_iters, n_samples, n_iters)


def _launch(cfg, named, n_bucket, depth, n_lanes, cap_p, parent_hw, s, f, t_min, t_max,
            march_iters, n_samples, n_iters) -> None:
    F, h, w = depth.shape
    if max(F, h, w, s, cfg.grid_dim) >= _INT32:
        raise ValueError(f"ray_march: shape too large (F={F}, h={h}, w={w})")
    if n_lanes == 0:
        return
    f32 = np.float32
    vs = f32(cfg.voxel_size)
    # The Python scalars as PyTorch rounds them to float32 in the plain
    # path, and `raycast._inv`'s reciprocal of the voxel size.
    scalars = (vs, f32(1.0) / vs, f32(cfg.block_size), f32(cfg.trunc),
               f32(cfg.voxel_size * 0.75), f32(t_min), f32(t_max))
    weights = np.zeros(_MAX_SAMPLES, np.float32)
    weights[:n_samples] = np.linspace(0.0, 1.0, n_samples).astype(np.float32)
    fine = [named[k].data_ptr() if k in named else None for k in ("ids_p", "t0_p", "t_hi_p")]
    dev = depth.device
    _build.launch(
        "ray_march", dev, named["slot_dist"].data_ptr(), named["ext"].data_ptr(),
        named["aabb"].data_ptr(), named["K"].data_ptr(), named["Rcw"].data_ptr(),
        named["origin"].data_ptr(), *fine, depth.data_ptr(), _counter(dev).data_ptr(),
        n_lanes, cap_p, n_bucket, F, h, w, *parent_hw, s, f, cfg.block_resolution,
        cfg.grid_dim, march_iters, n_samples, n_iters,
        (ctypes.c_float * _MAX_SAMPLES)(*map(float, weights)), *map(float, scalars))
