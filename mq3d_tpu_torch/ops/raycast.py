"""TSDF raycasting: color-aligned depth rendering, the counterpart of
mq3d_tpu/ops/raycast.py.

The reference renders color-aligned depth by casting pinhole rays at the
extracted mesh with Embree (o3d_utils.py:324-341).  Like the JAX build,
this sphere-traces the TSDF volume directly, with the same stages and
budgets (see that module's docstring for the design and its measurements):

  prep    per volume revision, cached (`_ScenePrep`): the slot-distance
          field `slot_dist` (G^3,) int32 (>= 0: block slot; < 0: minus the
          Chebyshev block distance to the nearest allocated block, from
          `_DIST_MAX` rolled min-dilations), and the extended 17^3 block
          table of f16 z-pairs packed into int32 (low half v[z], high half
          v[z+1]), so a trilinear cell's 8 corners are 4 gathers.
  march   2 gathers per step: tsdf-proportional steps in the truncation
          band, Chebyshev block skips in empty space; returns a bracketing
          sample pair around the first + -> - crossing.
  refine  bracket widened by a voxel, re-bracketed on the trilinear field,
          false-position iterations and a closing secant.
  pyramid the 1/8 level is marched in full; every finer level upsamples
          1/z bilinearly and re-marches only edge pixels, compacted by
          cumsum rank into static per-level caps; overflow pixels keep the
          upsampled depth.

Open3D's conventions hold: ray directions are the unnormalized
K^-1 (u, v, 1), so t_hit is camera z-depth, and misses are inf.

Each level's per-ray work, the march and the refine, runs by device:
on a card it is one launch of K6 (`ops.ray_march`, csrc/ray_march.cu, one
thread a lane); on the CPU it is plain PyTorch, which is K6's reference
(`_plain_path` runs it on a card too).  Scene preparation, edge detection,
upsampling and compaction are plain PyTorch on the volume's device.  In
the plain path XLA's `lax.while_loop` becomes a Python loop whose retired
lanes freeze exactly as under XLA; the loop tests `active.any()` every
`_LIVE_CHECK` steps, which ends it at the same state, since a step with no
active lane changes nothing.  Arithmetic follows the XLA CPU build where it
decides a sample: XLA turns x / c for a constant c into x * (1/c), so this
module multiplies by float32 reciprocals, and the fused multiply-adds of
the ray positions, secants and edge tests go through `ops.fma.fma`.  Elsewhere the two builds may differ
in the last bit (tests/test_torch_raycast.py states the tolerances).
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Optional

import numpy as np
import torch

from mq3d_tpu_torch.ops.fma import fma
from mq3d_tpu_torch.ops.ray_march import march_base, march_fine
from mq3d_tpu_torch.ops.tsdf import (
    _NEIGHBOR_OFFSETS,
    TSDFConfig,
    TSDFState,
    TSDFVolume,
    _block_keys,
)

_SENTINEL = 2.0  # ext-table value for unobserved voxels (tsdf in [-1, 1])
_DIST_MAX = 15  # Chebyshev distance-field saturation (blocks)
_EXT = 17  # extended block side (R + 1)
_EXT3 = _EXT * _EXT * _EXT
_LIVE_CHECK = 4  # march steps between host reads of `active.any()`
# The JAX build's shipped budgets: march steps and refine samples/iterations
# at the base (coarsest) level and at the fine levels; per-frame edge caps
# as multiples of sqrt(h*w) at full resolution and at the middle levels; the
# edge test's |second difference of 1/z| threshold at a 1280-wide render.
_BASE_MARCH_ITERS = 24
_REFINE_SAMPLES_BASE, _REFINE_ITERS_BASE = 3, 1
_FINE_MARCH_ITERS = 8
_REFINE_SAMPLES_FINE, _REFINE_ITERS_FINE = 2, 1
_EDGE_MULT_FULL, _EDGE_MULT_MID = 6, 34
_EDGE_EPS = 1e-3
_T_MIN = 0.05  # near bound of every ray (m); the far bound is 1.5 x depth_max


def _inv(c: float) -> float:
    """float32 1/c as XLA folds it for x / c (a float exactly representable
    in float32, so `x * _inv(c)` multiplies by that float32)."""
    return float(np.float32(1.0) / np.float32(c))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def prepare_scene(cfg: TSDFConfig, state: TSDFState, n_bucket: int):
    """(slot_dist (G^3,) int32, ext (n_bucket*17^3+1,) int32 packed f16
    z-pairs, aabb (2, 3) f32) for blocks [0, n_bucket).

    n_bucket is a power-of-two bucket >= n_active, so the table is sized by
    occupancy, not by the pool."""
    if cfg.block_resolution != _EXT - 1:
        raise ValueError(f"raycast needs block_resolution {_EXT - 1}, "
                         f"got {cfg.block_resolution}")
    G = cfg.grid_dim
    R = cfg.block_resolution
    cap = cfg.block_count
    dev = state.device

    occupied = state.slot_table >= 0
    # Chebyshev distance to the nearest allocated block, saturated at
    # _DIST_MAX: separable 3-window min-dilations (K rounds = exact up to
    # K).  roll wraps at the borders, which only shrinks steps.
    dist = torch.where(occupied, 0, _DIST_MAX).to(torch.int32).view(G, G, G)
    for _ in range(_DIST_MAX):
        m = dist
        for axis in range(3):
            m = torch.minimum(m, torch.minimum(torch.roll(m, 1, axis),
                                               torch.roll(m, -1, axis)))
        dist = torch.minimum(dist, m + 1)
    slot_dist = torch.where(occupied, state.slot_table, -dist.reshape(-1)).to(torch.int32)

    sentinel = _f32(_SENTINEL, state.tsdf)
    packed = torch.where(state.weight > 0, state.tsdf, sentinel)
    packed[cap] = _SENTINEL  # sentinel row

    slots = torch.arange(n_bucket, dtype=torch.int32, device=dev)
    in_range = slots < state.n_active
    slots_safe = torch.clamp(slots, max=cap).long()
    coords = state.block_coords[slots_safe]
    ext = torch.full((n_bucket, _EXT, _EXT, _EXT), _SENTINEL, dtype=torch.float32,
                     device=dev)
    ext[:, :R, :R, :R] = torch.where(in_range[:, None, None, None],
                                     packed[slots_safe].view(n_bucket, R, R, R), sentinel)
    for off in _NEIGHBOR_OFFSETS:
        nb_key = _block_keys(coords + torch.tensor(off, dtype=torch.int32, device=dev), G)
        nb_slot = state.slot_table[torch.clamp(nb_key, max=G ** 3 - 1)]
        nb_ok = (nb_key < G ** 3) & (nb_slot >= 0) & in_range
        nb = packed[torch.where(nb_ok, nb_slot.long(), torch.full_like(nb_key, cap))]
        src = (slice(None),) + tuple(slice(0, 1) if o else slice(0, R) for o in off)
        dst = (slice(None),) + tuple(slice(R, R + 1) if o else slice(0, R) for o in off)
        ext[dst] = torch.where(nb_ok[:, None, None, None],
                               nb.view(n_bucket, R, R, R)[src], sentinel)

    # Overlapping z-pairs: entry (b, x, y, z) holds f16(v[z]) in its low
    # half and f16(v[z+1]) in its high half (z+1 == 17 reads the sentinel);
    # little-endian, so an int32 viewed as two f16 is (low, high).
    nxt = torch.cat([ext[..., 1:], torch.full_like(ext[..., :1], _SENTINEL)], dim=-1)
    pair = torch.stack([ext.half(), nxt.half()], dim=-1).view(torch.int32)
    sent = torch.full((1, 2), _SENTINEL, dtype=torch.float16, device=dev).view(torch.int32)
    ext_flat = torch.cat([pair.reshape(-1), sent.reshape(-1)])

    # World-space AABB of the active blocks (one voxel of pad): rays are
    # clipped to their [entry, exit] span.
    vs = cfg.voxel_size
    big = 1 << 28
    c_lo = torch.where(in_range[:, None], coords, big).amin(0)
    c_hi = torch.where(in_range[:, None], coords, -big).amax(0) + 1
    bs, lo_pad, hi_pad = (torch.full((3,), x, dtype=torch.float32, device=dev)
                          for x in (R * vs, -vs, vs))
    aabb = torch.stack([fma(c_lo.float(), bs, lo_pad), fma(c_hi.float(), bs, hi_pad)])
    return slot_dist, ext_flat, aabb


def _sample_ids(cfg: TSDFConfig, n_bucket: int, slot_dist, g):
    """Integer lattice coords g (..., 3) -> (ext index, slot_dist value)."""
    R = cfg.block_resolution
    G = cfg.grid_dim
    b = torch.div(g, R, rounding_mode="floor")
    local = g - b * R
    key = _block_keys(b, G)
    sd = torch.where(key < G ** 3, slot_dist[torch.clamp(key, max=G ** 3 - 1)],
                     -_DIST_MAX)
    li = (local[..., 0] * _EXT + local[..., 1]) * _EXT + local[..., 2]
    idx = torch.where(sd >= 0, sd.long() * _EXT3 + li, n_bucket * _EXT3)
    return idx, sd


def _unpack(u):
    """Packed z-pairs (...) int32 -> (low, high) f32."""
    h = u.unsqueeze(-1).view(torch.float16).float()
    return h[..., 0], h[..., 1]


def _trilinear(cfg: TSDFConfig, n_bucket: int, slot_dist, ext, p):
    """Trilinear tsdf at world points (..., 3): 1 slot + 4 z-pair gathers.
    Returns (value, valid)."""
    gf = p * _inv(cfg.voxel_size)
    g0 = torch.floor(gf).to(torch.int32)
    frac = gf - g0.float()
    idx0, sd = _sample_ids(cfg, n_bucket, slot_dist, g0)
    last = ext.numel() - 1  # the sentinel pair; XLA clamps gathers onto it

    acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    valid = sd >= 0
    wz1 = frac[..., 2]
    wz0 = 1 - wz1
    for c in range(4):
        dx, dy = (c >> 1) & 1, c & 1
        off = (dx * _EXT + dy) * _EXT
        v0, v1 = _unpack(ext[torch.clamp(idx0 + off, max=last)])
        valid = valid & (v0 < 1.5) & (v1 < 1.5)
        wx = frac[..., 0] if dx else 1 - frac[..., 0]
        wy = frac[..., 1] if dy else 1 - frac[..., 1]
        acc = acc + (wx * wy) * (wz0 * torch.where(v0 < 1.5, v0, zero)
                                 + wz1 * torch.where(v1 < 1.5, v1, zero))
    return acc, valid


def _secant(ta, va, tb, vb):
    denom = va - vb
    one = torch.ones((), dtype=torch.float32, device=va.device)
    f = torch.where(denom.abs() > 1e-12, va / torch.where(denom == 0, one, denom),
                    torch.full((), 0.5, dtype=torch.float32, device=va.device))
    return fma(torch.clamp(f, 0.0, 1.0), tb - ta, ta)


def _inv_norm(dirs):
    """1 / max(|dirs|, 1e-9), summed in a fixed order on every device."""
    n = torch.sqrt(dirs[..., 0] * dirs[..., 0] + dirs[..., 1] * dirs[..., 1]
                   + dirs[..., 2] * dirs[..., 2])
    return 1.0 / torch.clamp(n, min=1e-9)


def _at(origins, dirs, t):
    """origins + dirs * t (t broadcast over the last axis), fused."""
    return fma(dirs, t[..., None].expand_as(dirs), origins)


def _march(cfg: TSDFConfig, slot_dist, ext, n_bucket: int, origins, dirs, t_init,
           t_min: float, t_max, max_iter: int):
    """Unified sphere march.  Returns (found, ta, tb, va, vb): a bracketing
    pair of consecutive nearest-voxel samples around the first + -> -
    crossing.  2 gathers per step."""
    n = origins.shape[0]
    dev = origins.device
    vs = cfg.voxel_size
    bs = cfg.block_size
    trunc = cfg.trunc
    inv_vs = _inv(vs)
    inv_dn = _inv_norm(dirs)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    vs_t = _f32(vs, origins)
    band_min = _f32(vs * 0.75, origins)
    half = _f32(0.5, origins)

    z = torch.zeros((n,), dtype=torch.float32, device=dev)
    t = torch.maximum(t_init, torch.as_tensor(t_min, dtype=torch.float32, device=dev))
    ta, tb, va, vb = z, z, z, z
    prev_t, prev_v = t, z
    prev_ok = torch.zeros((n,), dtype=torch.bool, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    active = t <= t_max
    for it in range(max_iter):
        if it % _LIVE_CHECK == 0 and not bool(active.any()):
            break
        p = _at(origins, dirs, t)
        g = torch.round(p * inv_vs).to(torch.int32)
        idx, sd = _sample_ids(cfg, n_bucket, slot_dist, g)
        v = _unpack(ext[idx])[0]
        valid = (sd >= 0) & (v < 1.5)

        crossed = active & valid & prev_ok & (prev_v > 0) & (v <= 0)
        ta = torch.where(crossed, prev_t, ta)
        tb = torch.where(crossed, t, tb)
        va = torch.where(crossed, prev_v, va)
        vb = torch.where(crossed, v, vb)
        found = found | crossed
        active = active & ~crossed

        # In the band: tsdf-proportional; unobserved voxel inside an
        # allocated block: one voxel; empty space: Chebyshev block skip.
        step_band = torch.maximum(v * trunc * 0.7, band_min)
        step_empty = torch.maximum((-sd).float() - 1.0, half) * bs
        step = torch.where(sd >= 0, torch.where(valid, step_band, vs_t), step_empty)

        prev_t = torch.where(active, t, prev_t)
        prev_v = torch.where(active, v, prev_v)
        prev_ok = torch.where(active, valid, prev_ok)
        t = t + torch.where(active, step * inv_dn, zero)
        active = active & (t <= t_max)
    return found, ta, tb, va, vb


def _refine(cfg: TSDFConfig, slot_dist, ext, n_bucket: int, origins, dirs, found,
            ta, tb, va, vb, n_samples: int, n_iters: int):
    """Bracket -> t_hit on the trilinear field (the field marching cubes
    extracts): widen the bracket by one voxel both ways, take the first
    + -> - transition among `n_samples` dense trilinear samples, then
    `n_iters` false-position iterations and a closing secant.  inf where
    the march found nothing."""
    dev = origins.device
    vt = cfg.voxel_size * _inv_norm(dirs)  # one voxel, in t units
    lo = torch.clamp(ta - vt, min=0.0)
    hi = tb + vt
    w = torch.from_numpy(np.linspace(0.0, 1.0, n_samples).astype(np.float32)).to(dev)
    ts = fma((hi - lo)[:, None].expand(-1, n_samples), w[None, :].expand(len(lo), -1),
              lo[:, None].expand(-1, n_samples))  # (n, M)
    p = fma(dirs[:, None, :].expand(-1, n_samples, -1),
             ts[..., None].expand(-1, -1, 3), origins[:, None, :].expand(-1, n_samples, -1))
    v, ok = _trilinear(cfg, n_bucket, slot_dist, ext, p)  # (n, M)

    pair_ok = ok[:, :-1] & ok[:, 1:]
    cross = pair_ok & (v[:, :-1] > 0) & (v[:, 1:] <= 0)
    has = cross.any(dim=1)
    first = torch.argmax(cross.to(torch.uint8), dim=1)
    rows = torch.arange(ts.shape[0], device=dev)
    ta2 = torch.where(has, ts[rows, first], ta)
    tb2 = torch.where(has, ts[rows, first + 1], tb)
    va2 = torch.where(has, v[rows, first], va)
    vb2 = torch.where(has, v[rows, first + 1], vb)

    for _ in range(n_iters):
        tm = _secant(ta2, va2, tb2, vb2)
        vm, ok_m = _trilinear(cfg, n_bucket, slot_dist, ext, _at(origins, dirs, tm))
        pos = ok_m & (vm > 0)
        neg = ok_m & (vm <= 0)
        ta2 = torch.where(pos, tm, ta2)
        va2 = torch.where(pos, vm, va2)
        tb2 = torch.where(neg, tm, tb2)
        vb2 = torch.where(neg, vm, vb2)
    t_hit = _secant(ta2, va2, tb2, vb2)
    return torch.where(found, t_hit, torch.full_like(t_hit, math.inf))


def _min_pool3(x):
    """3x3 min filter with edge replication over the last two axes of a
    (F, h, w) stack."""
    for axis in (1, 2):
        n_ax = x.shape[axis]
        lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n_ax - 1)], dim=axis)
        hi = torch.cat([x.narrow(axis, 1, n_ax - 1), x.narrow(axis, n_ax - 1, 1)], dim=axis)
        x = torch.minimum(x, torch.minimum(lo, hi))
    return x


def _max_pool3(x):
    return -_min_pool3(-x)


def _shift_clamped(x, d: int, axis: int):
    """Edge-replicated shift by d (+1 = toward higher indices)."""
    n_ax = x.shape[axis]
    if d > 0:
        parts = [x.narrow(axis, 0, 1)] * d + [x.narrow(axis, 0, n_ax - d)]
    else:
        parts = [x.narrow(axis, -d, n_ax + d)] + [x.narrow(axis, n_ax - 1, 1)] * (-d)
    return torch.cat(parts, dim=axis)


def _upsample_bilinear(x, f: int, axis: int):
    """Half-pixel-centre bilinear upsample by integer factor f along axis
    with edge clamping (jax.image.resize(method='linear') for integer
    factors): output phase p of input i sits at i*f + p."""
    if f == 1:
        return x
    left = _shift_clamped(x, 1, axis)
    right = _shift_clamped(x, -1, axis)
    phases = []
    for p in range(f):
        c = (p + 0.5) / f - 0.5  # offset of output phase p from input i
        if c < 0:
            phases.append((1.0 + c) * x + (-c) * left)
        else:
            phases.append((1.0 - c) * x + c * right)
    y = torch.stack(phases, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] *= f
    return y.reshape(shape)


def _rotate(Rm, d0, d1, d2):
    """Rm @ (d0, d1, d2) with Rm (..., 3, 3) and d* (...): (..., 3)."""
    return torch.stack([Rm[..., i, 0] * d0 + Rm[..., i, 1] * d1 + Rm[..., i, 2] * d2
                        for i in range(3)], dim=-1)


def _ray_dirs(K, Rcw, s: int, h_l: int, w_l: int):
    """(F, h_l, w_l, 3) world ray directions for pyramid scale s (z-depth
    parameterization: the camera-frame z component is 1)."""
    F = K.shape[0]
    dev = K.device
    u = (torch.arange(w_l, dtype=torch.float32, device=dev) + 0.5) * s - 0.5
    v = (torch.arange(h_l, dtype=torch.float32, device=dev) + 0.5) * s - 0.5
    fx = K[:, 0, 0][:, None, None]
    fy = K[:, 1, 1][:, None, None]
    cx = K[:, 0, 2][:, None, None]
    cy = K[:, 1, 2][:, None, None]
    one = torch.ones((F, h_l, w_l), dtype=torch.float32, device=dev)
    dx = (u[None, None, :] - cx) / fx * one
    dy = (v[None, :, None] - cy) / fy * one
    return _rotate(Rcw[:, None, None], dx, dy, one)


def _pyramid_scales(width: int, height: int) -> list:
    """Levels 8, 4, 2, 1 from the largest power of two up to 8 that divides
    both sides (just [1] for an odd side)."""
    scales = []
    s = 8
    while s > 1 and (width % s or height % s):
        s //= 2
    while s >= 1:
        scales.append(s)
        s //= 2
    return scales


def _ray_aabb_span(aabb, origins, dirs):
    """Slab test against the active-block AABB in t units (t == z-depth).
    t_exit < t_enter means the ray misses the volume."""
    tiny = torch.where(dirs >= 0, _f32(1e-12, dirs), _f32(-1e-12, dirs))
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, tiny, dirs)
    t1 = (aabb[0][None] - origins) * inv
    t2 = (aabb[1][None] - origins) * inv
    return (torch.minimum(t1, t2).amax(dim=-1), torch.maximum(t1, t2).amin(dim=-1))


def _base_level_plain(cfg: TSDFConfig, scene, K, Rcw, origin, t_min: float, t_max: float,
                      s0: int, h0: int, w0: int):
    """The base level's (F, h0, w0) z-depth by the plain march and refine
    (K6's reference; `ray_march.march_base` is its kernel)."""
    slot_dist, ext, aabb, n_bucket = scene
    F = K.shape[0]
    vs = cfg.voxel_size
    dirs = _ray_dirs(K, Rcw, s0, h0, w0).reshape(-1, 3)
    origins = origin[:, None, None, :].expand(F, h0, w0, 3).reshape(-1, 3)
    t_en, t_ex = _ray_aabb_span(aabb, origins, dirs)
    t0 = torch.clamp(t_en - vs, min=t_min)
    t_hi = torch.clamp(t_ex + vs, max=t_max)
    found, ta, tb, va, vb = _march(cfg, slot_dist, ext, n_bucket, origins, dirs, t0,
                                   t_min, t_hi, _BASE_MARCH_ITERS)
    return _refine(cfg, slot_dist, ext, n_bucket, origins, dirs, found, ta, tb, va, vb,
                   n_samples=_REFINE_SAMPLES_BASE,
                   n_iters=_REFINE_ITERS_BASE).reshape(F, h0, w0)


def _fine_level_plain(cfg: TSDFConfig, scene, K, Rcw, origin, t_min: float, t_max: float,
                      s: int, f: int, ids_p, t0_p, t_hi_p, z_up):
    """A fine level's edge lanes by the plain march and refine, written
    into the upsampled map z_up (F, h_l, w_l); returns the level's map (K6's
    reference; `ray_march.march_fine` is its kernel).  Lane l = phase *
    cap_p + j is child `phase` of parent pixel ids_p[j] (n_pp: dead)."""
    slot_dist, ext, aabb, n_bucket = scene
    F, h_l, w_l = z_up.shape
    h_p, w_p = h_l // f, w_l // f
    n_pp = F * h_p * w_p
    cap_p = ids_p.shape[0]
    dev = z_up.device
    vs = cfg.voxel_size
    t_min_t = _f32(t_min, z_up)
    ids_safe_p = torch.clamp(ids_p, max=n_pp - 1)
    live_p = ids_p < n_pp

    # f^2 child lanes, phase-major: lane l = phase * cap_p + j.
    n_lanes = cap_p * f * f
    lane = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    phase = lane // cap_p
    j = lane % cap_p
    idp = ids_safe_p[j]
    live = live_p[j]
    fidx = idp // (h_p * w_p)
    pp = idp % (h_p * w_p)
    py = (pp // w_p) * f + phase // f  # this level's pixel row
    px = (pp % w_p) * f + phase % f
    pyf = py.float() * s + (0.5 * s - 0.5)  # full-resolution coords
    pxf = px.float() * s + (0.5 * s - 0.5)
    Kf = K[fidx]
    one = torch.ones((n_lanes,), dtype=torch.float32, device=dev)
    dirs_e = _rotate(Rcw[fidx], (pxf - Kf[:, 0, 2]) / Kf[:, 0, 0],
                     (pyf - Kf[:, 1, 2]) / Kf[:, 1, 1], one)
    origins_e = origin[fidx]
    # Dead lanes get a far bound below their start and retire at once;
    # live lanes also clip to the AABB span.
    t_en_e, t_ex_e = _ray_aabb_span(aabb, origins_e, dirs_e)
    t0_e = torch.where(live, torch.maximum(t0_p[j], torch.maximum(t_en_e - vs, t_min_t)),
                       t_min_t)
    t_hi_e = torch.where(live, torch.minimum(t_hi_p[j], t_ex_e + vs),
                         _f32(t_min - 1.0, z_up))
    found, ta, tb, va, vb = _march(cfg, slot_dist, ext, n_bucket, origins_e, dirs_e,
                                   t0_e, t_min, t_hi_e, _FINE_MARCH_ITERS)
    t_hit_e = _refine(cfg, slot_dist, ext, n_bucket, origins_e, dirs_e, found, ta, tb,
                      va, vb, n_samples=_REFINE_SAMPLES_FINE,
                      n_iters=_REFINE_ITERS_FINE)
    n_px = F * h_l * w_l
    ids_full = (fidx * h_l + py) * w_l + px
    zb = torch.cat([z_up.reshape(-1), z_up.new_zeros(1)])
    zb[torch.where(live, ids_full, n_px)] = torch.where(live, t_hit_e, 0.0)
    return zb[:n_px].view(F, h_l, w_l)


# Set by `_plain_path`: the plain march and refine on every device.
_plain_on_card = False


@contextlib.contextmanager
def _plain_path():
    """Within it, every render runs the plain march and refine, on the card
    too: K6's reference there (tests and chip_smoke)."""
    global _plain_on_card
    before, _plain_on_card = _plain_on_card, True
    try:
        yield
    finally:
        _plain_on_card = before


def _render_frames(
    cfg: TSDFConfig, slot_dist, ext, aabb, n_bucket: int,
    K,  # (F, 3, 3) f32
    Rcw,  # (F, 3, 3) f32 camera-to-world rotations
    origin,  # (F, 3) f32 camera centres
    t_min: float, t_max: float, width: int, height: int, edge_cap: int,
):
    """The coarse-to-fine pyramid for a batch of frames.  Returns
    ((F, height, width) z-depth with inf misses, edge overflow count as a
    0-d tensor).

    Each level's per-ray work (march and refine) is one launch of K6
    (`ops.ray_march`) for a volume on the card, and the plain PyTorch march
    and refine for a CPU volume; everything around it is the same."""
    F = K.shape[0]
    dev = K.device
    k6 = dev.type == "cuda" and not _plain_on_card
    scene = (slot_dist, ext, aabb, n_bucket)
    level = (K, Rcw, origin, t_min, t_max)
    pad = 3.0 * cfg.voxel_size
    t_min_t = _f32(t_min, K)
    # |second difference of 1/z| scales with the square of the angular
    # pixel pitch; the default is calibrated at a 1280-wide render.
    edge_eps = float(np.float32(_EDGE_EPS) * np.float32((1280.0 / width) ** 2))

    scales = _pyramid_scales(width, height)

    # ---- base level: full march + refine -------------------------------------
    s0 = scales[0]
    h0, w0 = height // s0, width // s0
    if k6:
        z = march_base(cfg, scene, *level, s0, h0, w0, _BASE_MARCH_ITERS,
                       _REFINE_SAMPLES_BASE, _REFINE_ITERS_BASE)
    else:
        z = _base_level_plain(cfg, scene, *level, s0, h0, w0)

    # ---- fine levels: dense 1/z upsampling + compacted edge re-march ---------
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    fine_scales = scales[1:]
    s_prev = s0
    for s in fine_scales:
        h_l, w_l = height // s, width // s
        f = s_prev // s  # parent -> this level upsample factor
        s_prev = s
        # Caps are per-frame multiples of the edge-curve length sqrt(h*w):
        # loosest at the first fine level, tightest at full resolution.
        per = int(math.isqrt(h_l * w_l))
        if s == 1:
            mult = _EDGE_MULT_FULL
        elif s == fine_scales[0]:
            mult = _EDGE_MULT_MID + _EDGE_MULT_MID // 4
        else:
            mult = _EDGE_MULT_MID
        cap_l = min(max(F * mult * per, 4096), F * h_l * w_l, edge_cap)

        # Edge pixels on the parent: a 3x3 neighbour misses, or 1/z is
        # locally non-planar (|second difference| > edge_eps).
        finite = torch.isfinite(z)
        invz = torch.where(finite, 1.0 / z, torch.zeros((), dtype=z.dtype, device=dev))
        m_half = torch.full_like(invz, -0.5)
        d2u = fma(m_half, _shift_clamped(invz, 1, 2) + _shift_clamped(invz, -1, 2),
                   invz).abs()
        d2v = fma(m_half, _shift_clamped(invz, 1, 1) + _shift_clamped(invz, -1, 1),
                   invz).abs()
        miss = (~finite).float()
        edge_p = (~finite) | (_max_pool3(miss) > 0) | (torch.maximum(d2u, d2v) > edge_eps)
        if s > 1:
            # Dilate once so the next level's detection sees marched values
            # around the band (not at full resolution: no next level).
            edge_p = _max_pool3(edge_p.float()) > 0

        invz_up = _upsample_bilinear(_upsample_bilinear(invz, f, axis=1), f, axis=2)
        z_up = torch.where(invz_up > 1e-9, 1.0 / invz_up,
                           torch.full((), math.inf, dtype=torch.float32, device=dev))

        # ---- compact edge ids at PARENT resolution (first cap_p by flat
        # index); each expands into its f x f children arithmetically.
        h_p, w_p = z.shape[1], z.shape[2]
        n_pp = F * h_p * w_p
        ff = f * f
        cap_p = max(cap_l // ff, 1)
        flat_edge = edge_p.reshape(-1)
        rank = torch.cumsum(flat_edge, 0)
        overflow = overflow + torch.clamp(rank[-1] * ff - cap_p * ff, min=0)
        slot = torch.clamp(torch.where(flat_edge, rank - 1, cap_p), max=cap_p)
        ids_p = torch.full((cap_p + 1,), n_pp, dtype=torch.int64, device=dev)
        ids_p[slot] = torch.arange(n_pp, dtype=torch.int64, device=dev)
        ids_p = ids_p[:cap_p]
        ids_safe_p = torch.clamp(ids_p, max=n_pp - 1)

        # Per-parent march window from the parent's 3x3 depth range +- pad.
        zmin_p = _min_pool3(z).reshape(-1)[ids_safe_p]
        t0_p = torch.where(torch.isfinite(zmin_p), torch.clamp(zmin_p - pad, min=t_min),
                           t_min_t)
        zmax_p = _max_pool3(z).reshape(-1)[ids_safe_p]
        t_hi_p = torch.where(torch.isfinite(zmax_p), zmax_p + pad, _f32(t_max, z))

        if k6:
            march_fine(cfg, scene, *level, s, f, ids_p, t0_p, t_hi_p, z_up,
                       _FINE_MARCH_ITERS, _REFINE_SAMPLES_FINE, _REFINE_ITERS_FINE)
            z = z_up
        else:
            z = _fine_level_plain(cfg, scene, *level, s, f, ids_p, t0_p, t_hi_p, z_up)
    return z, overflow


class _ScenePrep:
    """Cache of prepare_scene outputs keyed on (volume identity, revision).

    The volume is held by weakref, so the key cannot alias a new object
    after collection, and TSDFVolume bumps `_state_version` on every state
    change."""

    def __init__(self):
        self._vol_ref = None
        self._version = None
        self._value = None

    def get(self, volume: TSDFVolume):
        cached = self._vol_ref() if self._vol_ref is not None else None
        if cached is not volume or self._version != volume._state_version:
            n_bucket = 256
            while n_bucket < volume.n_active:
                n_bucket *= 2
            n_bucket = min(n_bucket, volume.cfg.block_count)
            self._value = prepare_scene(volume.cfg, volume.state, n_bucket) + (n_bucket,)
            self._vol_ref = weakref.ref(volume)
            self._version = volume._state_version
        return self._value


_prep_cache = _ScenePrep()


def _render_frames_device(volume: TSDFVolume, intrinsics: np.ndarray,
                          extrinsics_wc: np.ndarray, width: int, height: int,
                          edge_cap: Optional[int] = None):
    """Queue one batch render on the volume's device; returns device
    tensors ((F, H, W) z-depth, overflow) without waiting for them.
    intrinsics (F, 3, 3) with cx already mirror-flipped, extrinsics_wc
    (F, 4, 4).  `edge_cap` bounds the edge pixels re-marched (default: 1/16
    of the batch's pixels, at least 4096); overflowed pixels keep the dense
    1/z-upsampled value."""
    cfg = volume.cfg
    dev = volume.device
    t_max = cfg.depth_max * 1.5
    slot_dist, ext, aabb, n_bucket = _prep_cache.get(volume)
    T_cw = np.linalg.inv(np.asarray(extrinsics_wc, np.float64)).astype(np.float32)
    F = intrinsics.shape[0]
    if edge_cap is None:
        edge_cap = max(F * width * height // 16, 4096)
    return _render_frames(
        cfg, slot_dist, ext, aabb, n_bucket,
        torch.from_numpy(np.asarray(intrinsics, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(T_cw[:, :3, :3])).to(dev),
        torch.from_numpy(np.ascontiguousarray(T_cw[:, :3, 3])).to(dev),
        float(np.float32(_T_MIN)), float(np.float32(t_max)), width, height, edge_cap)


def _warn_overflow(overflow) -> None:
    n_over = int(overflow)
    if n_over > 0:
        print(f"[Warning] raycast edge budget exceeded by {n_over} px; "
              "they keep interpolated depth")


def raycast_depth_batch(volume: TSDFVolume, intrinsics: np.ndarray,
                        extrinsics_wc: np.ndarray, width: int, height: int) -> np.ndarray:
    """Render (F, H, W) z-depth maps from the TSDF volume; inf = miss."""
    z, overflow = _render_frames_device(volume, intrinsics, extrinsics_wc, width, height)
    out = z.cpu().numpy()
    _warn_overflow(overflow)
    return out


def raycast_depth(volume: TSDFVolume, intrinsic: np.ndarray, extrinsic_wc: np.ndarray,
                  width: int, height: int) -> np.ndarray:
    """Render one z-depth map from the TSDF volume; inf = miss."""
    return raycast_depth_batch(volume, np.asarray(intrinsic, np.float32)[None],
                               np.asarray(extrinsic_wc, np.float64)[None], width, height)[0]


def _quantize_u16(z: torch.Tensor, scale: float) -> torch.Tensor:
    """Depth -> uint16 fixed point round(z*scale) on the device, returned
    as the int16 tensor with the same bits; misses (inf or out of range)
    -> 0."""
    q = torch.round(z * scale)
    ok = torch.isfinite(z) & (q >= 1.0) & (q <= 65535.0)
    qi = torch.where(ok, q, torch.zeros((), dtype=q.dtype, device=q.device)).to(torch.int32)
    return (qi - 65536 * (qi >= 32768).to(torch.int32)).to(torch.int16)


def _dequantize_u16_host(q: np.ndarray, scale: float) -> np.ndarray:
    out = q.astype(np.float32) / np.float32(scale)
    out[q == 0] = np.inf
    return out


def raycast_in_color_view(volume: TSDFVolume, dataset, frames_per_batch: int = 8,
                          transfer_u16: bool = False):
    """Generator over per-frame z-depth maps for a camera dataset (transforms
    in the OPEN3D camera frame), `frames_per_batch` frames of one size per
    render, the next batch queued on the device before the previous one is
    read back.  Frames are yielded one by one, as float32.

    transfer_u16: quantize depth to uint16 fixed point on the device and
    dequantize after readback (step t_max/65534, 0.061 mm at 4 m; misses
    encode as 0), which halves the bytes read back."""
    K = dataset.get_render_intrinsic_matrices()
    T_wc = dataset.transforms.extrinsics_wc
    n = len(dataset)
    widths = np.asarray(dataset.widths)
    heights = np.asarray(dataset.heights)

    def spans():
        i = 0
        while i < n:
            j = i + 1
            while (j < n and j - i < frames_per_batch and widths[j] == widths[i]
                   and heights[j] == heights[i]):
                j += 1
            yield i, j
            i = j

    q_scale = 65534.0 / (float(volume.cfg.depth_max) * 1.5)

    def dispatch(i, j):
        z, overflow = _render_frames_device(
            volume, np.asarray(K[i:j], np.float32), np.asarray(T_wc[i:j], np.float64),
            int(widths[i]), int(heights[i]))
        return (_quantize_u16(z, q_scale) if transfer_u16 else z), overflow

    def drain(batch_z, overflow):
        _warn_overflow(overflow)
        batch = batch_z.cpu().numpy()
        if transfer_u16:
            batch = _dequantize_u16_host(batch.view(np.uint16), q_scale)
        for k in range(batch.shape[0]):
            yield batch[k]

    pending = None
    for span in spans():
        prev, pending = pending, dispatch(*span)
        if prev is not None:
            yield from drain(*prev)
    if pending is not None:
        yield from drain(*pending)
