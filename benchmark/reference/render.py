"""The check of step 6: plain ray casting of the session's volume into its
colour keyframes, computed again from the inputs the program was handed.

The volume is the reference's own: step 3's plain pass
(reference/integrate.py::integrate) over the session's depth frames, both
sides in sequence, unfiltered as the entry hands them to the program.  The
program's volume is its state, so the reference works it out again;
`default.integrate` holds the program's step 3 against the same pass.  Its
active blocks are laid into one dense grid of tsdf and weight over their
bounding box (0.31 GB for the room at 1 cm).

The semantics are those of Open3D's VoxelBlockGrid.ray_cast, which renders
depth from the volume upstream builds, with rays through pixel centres
(pixel (u, v) casts (u - cx')/fx, (v - cy)/fy, 1), cx' mirror-flipped, so
that the ray parameter t is camera z-depth:

- The field.  The tsdf at a point is the trilinear interpolation of the
  eight voxels of its cell (voxel g of the lattice lies at g * voxel_size);
  it is defined where all eight were observed (weight > 0).
- The march.  From where the ray enters the grid's box (or the camera,
  inside it) to where it leaves it or reaches 1.5 * depth_max, samples at a
  fixed step of half a voxel of arc length.  The hit is the first pair of
  consecutive samples, both defined, whose tsdf goes from positive to
  non-positive.
- The refinement.  BISECT_ITERS bisections of that pair's bracket on the
  field (a midpoint where it is undefined ends them), then a secant over
  the bracket that is left.  A ray with no such pair misses: inf.

Departures from Open3D: Open3D steps by the tsdf itself (a truncation's
worth times the tsdf, at least a voxel) and interpolates the hit once
between its last two samples; this steps at half a voxel, which no surface
of the room is thinner than, and refines to the field's own crossing, so
that the result depends on the volume and the ray alone.  Open3D reads the
hash map block by block; this reads one dense grid.  Rays are taken in
blocks and in runs of samples so that it fits on the card.

`check` compares the program's maps of every view of a pass with this
render, on one pixel in PIXEL_SHARE of each view, drawn from the seed:
`depth_mismatch_share`, the sampled pixels where one map hits and the other
misses, or both hit and differ by more than DEPTH_TOL voxels.  Every view
is sampled, not a few whole ones: what a view sees, and where it sits in
its render call, moves its share several-fold, while a sample of a few
million pixels reads within 1e-4 of the whole pass.

`control` is the same render in bfloat16 (the grid and every ray
quantity), put in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core import setting
from benchmark.reference.integrate import integrate, settings

DEPTH_TOL = 0.1  # voxels
BISECT_ITERS = 20  # a half-voxel bracket to under 1e-8 m
STEP_VOXELS = 0.5
RAYS_PER_BLOCK = 1 << 18
SAMPLES_PER_RUN = 32
PIXEL_SHARE = 8  # the check renders one pixel in PIXEL_SHARE of each view


def render_settings(config: dict) -> dict:
    """Step 6's settings: keyframe interval, views per render call and the
    read-back's format."""
    cadr = "reconstruction.color_aligned_depth_rendering."
    return dict(interval=int(setting(config, "reconstruction.color_optimization.interval")),
                batch=int(setting(config, cadr + "frames_per_batch")),
                transfer_u16=bool(setting(config, cadr + "transfer_u16")))


def keyframes(session, config: dict) -> list:
    """Per side, the session's frame indices of its colour keyframes: every
    `interval`-th frame of the side, from its first."""
    step = render_settings(config)["interval"]
    return [list(range(session.side_slice(s).start, session.side_slice(s).stop, step))
            for s in range(int(session.side.max()) + 1)]


def batches(n: int, batch: int) -> list:
    """(first, end) of each render call over n views of one size."""
    return [(i, min(i + batch, n)) for i in range(0, n, batch)]


def checked_pixels(n_views: int, width: int, height: int, seed: int) -> list:
    """Per view, the sorted flat indices of the pixels the check renders:
    a share 1 / PIXEL_SHARE of the view's, drawn from the seed."""
    rng = np.random.default_rng(int(seed))
    n = width * height
    return [np.sort(rng.choice(n, n // PIXEL_SHARE, replace=False)) for _ in range(n_views)]


def volume(session, config: dict, device) -> dict:
    """The reference's volume of the session: step 3's plain pass over both
    sides' depth frames in sequence, as the entry integrates them."""
    inp = {"depth": session.depth.cpu().numpy(),
           "K": np.asarray(session.K_depth, np.float32),
           "T_wc": np.linalg.inv(session.T_cw).astype(np.float32),
           "valid": np.ones(len(session.T_cw), dtype=bool)}
    return integrate(inp, config, device)


def dense_grid(vol: dict, config: dict, dtype=torch.float32) -> dict:
    """The volume's blocks laid into one grid over their bounding box:
    "tsdf" (X, Y, Z) of `dtype`, "weight" (X, Y, Z) float32, and "base",
    the global voxel index of grid voxel (0, 0, 0)."""
    R = settings(config)["R"]
    coords = vol["coords"].long()
    dev = coords.device
    lo = coords.amin(0)
    dims = ((coords.amax(0) + 1 - lo) * R).tolist()
    tsdf = torch.zeros(dims, dtype=dtype, device=dev)
    weight = torch.zeros(dims, dtype=torch.float32, device=dev)
    i = torch.arange(R, device=dev)
    off = torch.stack(torch.meshgrid(i, i, i, indexing="ij"), -1).reshape(-1, 3)  # x-major
    for b0 in range(0, len(coords), 4096):
        g = ((coords[b0:b0 + 4096] - lo) * R)[:, None, :] + off[None]
        lin = ((g[..., 0] * dims[1] + g[..., 1]) * dims[2] + g[..., 2]).reshape(-1)
        tsdf.view(-1)[lin] = vol["tsdf"][b0:b0 + 4096].reshape(-1).to(dtype)
        weight.view(-1)[lin] = vol["weight"][b0:b0 + 4096].reshape(-1).float()
    return {"tsdf": tsdf, "weight": weight, "base": lo * R}


def trilinear(grid: dict, p: torch.Tensor, voxel_size: float):
    """(value, defined) of the field at points p (..., 3) of the grid's
    dtype."""
    tsdf, weight = grid["tsdf"], grid["weight"]
    dims = torch.tensor(tsdf.shape, device=p.device)
    g = p / voxel_size - grid["base"].to(p.dtype)
    g0 = torch.floor(g)
    f = g - g0
    i0 = g0.long()
    ok = ((i0 >= 0) & (i0 + 1 < dims)).all(-1)
    i0 = torch.minimum(torch.clamp(i0, min=0), dims - 2)
    flat_t, flat_w = tsdf.view(-1), weight.view(-1)
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for c in range(8):
        d = [(c >> 2) & 1, (c >> 1) & 1, c & 1]
        lin = ((i0[..., 0] + d[0]) * tsdf.shape[1] + i0[..., 1] + d[1]) * tsdf.shape[2] \
            + i0[..., 2] + d[2]
        ok = ok & (flat_w[lin] > 0)
        w = None
        for a in range(3):
            wa = f[..., a] if d[a] else 1 - f[..., a]
            w = wa if w is None else w * wa
        acc = acc + w * flat_t[lin].to(p.dtype)
    return acc, ok


def _box_span(grid: dict, origins, dirs, voxel_size: float):
    """(t_enter, t_exit) of each ray through the box of the grid's lattice
    points (where a cell's eight voxels all lie in the grid)."""
    dt = dirs.dtype
    lo = grid["base"].to(dt) * voxel_size
    hi = (grid["base"] + torch.tensor(grid["tsdf"].shape, device=dirs.device) - 1).to(dt) \
        * voxel_size
    tiny = torch.where(dirs >= 0, 1e-12, -1e-12).to(dt)
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, tiny, dirs)
    t1, t2 = (lo - origins) * inv, (hi - origins) * inv
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def _cast(grid: dict, origins, dirs, t_max: float, voxel_size: float):
    """z-depth (n,) float32 of rays (n, 3) of the grid's dtype; inf = miss."""
    n, dev, dt = len(dirs), dirs.device, dirs.dtype
    t_en, t_ex = _box_span(grid, origins, dirs, voxel_size)
    t0 = torch.clamp(t_en, min=0.0)
    t1 = torch.clamp(t_ex, max=t_max)
    h = STEP_VOXELS * voxel_size / torch.linalg.vector_norm(dirs, dim=-1)
    ta = torch.zeros(n, dtype=dt, device=dev)
    tb, va, vb = ta.clone(), ta.clone(), ta.clone()
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    live = torch.nonzero(t0 <= t1).squeeze(1)
    k0 = torch.zeros(len(live), dtype=torch.long, device=dev)
    run = torch.arange(SAMPLES_PER_RUN + 1, device=dev)
    while len(live):
        ks = (k0[:, None] + run[None]).to(dt)
        t = t0[live, None] + ks * h[live, None]  # (m, S + 1)
        p = origins[live, None] + dirs[live, None] * t[..., None]
        v, ok = trilinear(grid, p, voxel_size)
        ok = ok & (t <= t1[live, None])
        cross = ok[:, :-1] & ok[:, 1:] & (v[:, :-1] > 0) & (v[:, 1:] <= 0)
        found = cross.any(1)
        first = torch.argmax(cross.to(torch.uint8), 1)[found]
        rows = live[found]
        fr = torch.nonzero(found).squeeze(1)
        ta[rows], tb[rows] = t[fr, first], t[fr, first + 1]
        va[rows], vb[rows] = v[fr, first], v[fr, first + 1]
        hit[rows] = True
        keep = ~found & (t[:, -1] < t1[live])
        live, k0 = live[keep], k0[keep] + SAMPLES_PER_RUN
    rows = torch.nonzero(hit).squeeze(1)
    a, b, fa, fb = ta[rows], tb[rows], va[rows], vb[rows]
    going = torch.ones(len(rows), dtype=torch.bool, device=dev)
    o, d = origins[rows], dirs[rows]
    for _ in range(BISECT_ITERS):
        m = (a + b) / 2
        fm, okm = trilinear(grid, o + d * m[:, None], voxel_size)
        going = going & okm
        pos = going & (fm > 0)
        neg = going & (fm <= 0)
        a, fa = torch.where(pos, m, a), torch.where(pos, fm, fa)
        b, fb = torch.where(neg, m, b), torch.where(neg, fm, fb)
    z = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    z[rows] = (a + (b - a) * (fa / (fa - fb))).float()
    return z


def render(grid: dict, K: np.ndarray, T_cw: np.ndarray, width: int, pixels,
           config: dict) -> torch.Tensor:
    """(n,) float32 z-depth at the flat indices `pixels` (n,) of a view
    `width` pixels wide, K (3, 3) with cx mirror-flipped and T_cw (4, 4)
    camera-to-world, in the grid's dtype."""
    s = settings(config)
    dt, dev = grid["tsdf"].dtype, grid["tsdf"].device
    K = torch.as_tensor(np.asarray(K, np.float64), device=dev).to(dt)
    T = torch.as_tensor(np.asarray(T_cw, np.float64), device=dev).to(dt)
    p = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    u, v = (p % width).to(dt), (p // width).to(dt)
    cam = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], torch.ones_like(u)], -1)
    dirs = (cam[:, None, :] * T[None, :3, :3]).sum(-1)
    origins = T[:3, 3].expand_as(dirs)
    return torch.cat([_cast(grid, origins[r:r + RAYS_PER_BLOCK], dirs[r:r + RAYS_PER_BLOCK],
                            1.5 * s["depth_max"], s["voxel_size"])
                      for r in range(0, len(dirs), RAYS_PER_BLOCK)])


def compare(prog, ref: torch.Tensor, config: dict) -> dict:
    """The mismatch share of maps `prog` (V, H, W) against `ref`."""
    vs = settings(config)["voxel_size"]
    prog = torch.as_tensor(prog).to(ref.device).float()
    pf, rf = torch.isfinite(prog), torch.isfinite(ref)
    gap = torch.where(pf & rf, (prog - ref).abs(), torch.zeros_like(ref))
    bad = (pf != rf) | (gap > DEPTH_TOL * vs)
    return {"depth_mismatch_share": float(bad.sum()) / bad.numel()}


def _render_pixels(session, config: dict, grid: dict, views: list, pixels: list):
    """(V * n,) z-depth of each of the session's keyframe views (side,
    view) at its checked pixels, view after view."""
    kf = keyframes(session, config)
    T_cw = session.T_cw[[kf[s][i] for s, i in views]]
    return torch.cat([render(grid, session.K_color, T, session.color_width, pix, config)
                      for T, pix in zip(T_cw, pixels)])


def check(session, config, outputs, device, seed: int) -> dict:
    """The program's maps (`outputs`: "views", the (side, view) of each,
    and "depth" (V, H, W) as read back) against the reference's render of
    the same views, at the pixels drawn from the seed."""
    depth = outputs["depth"]
    pixels = checked_pixels(len(depth), session.color_width, session.color_height, seed)
    grid = dense_grid(volume(session, config, device), config)
    ref = _render_pixels(session, config, grid, outputs["views"], pixels)
    prog = np.concatenate([np.asarray(d).reshape(-1)[p] for d, p in zip(depth, pixels)])
    return compare(prog, ref, config)


def control(session, config, device, seed: int) -> dict:
    """The reference in bfloat16, put in the program's place, over the
    views and pixels a run with this seed checks."""
    kf = keyframes(session, config)
    views = [(s, i) for s in range(len(kf)) for i in range(len(kf[s]))]
    pixels = checked_pixels(len(views), session.color_width, session.color_height, seed)
    vol = volume(session, config, device)
    ref = _render_pixels(session, config, dense_grid(vol, config), views, pixels)
    low = _render_pixels(session, config, dense_grid(vol, config, torch.bfloat16), views, pixels)
    return compare(low, ref, config)
