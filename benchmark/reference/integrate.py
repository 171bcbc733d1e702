"""The check of step 3's volume: plain TSDF integration of a whole pass,
computed again from the inputs the program was handed.

The inputs are the benchmark's own (`inputs`): the session's depth frames,
filtered by the benchmark's plain step 1 (reference/confidence.py) with the
rule of the pipeline's `load_filtered_depth_stack` (a pixel whose
confidence is under `confidence_threshold` or whose valid count is under
`valid_count_threshold` is zeroed), the intrinsics, and the float32
world-to-camera poses.

The semantics are those of Open3D's VoxelBlockGrid integration, which
upstream step 3 runs, over a fresh volume:

- Touch.  Frame f touches the blocks that the +-trunc cube around each of
  its depth samples overlaps: every `alloc_pixel_stride`-th pixel in each
  direction, with a depth in (0, depth_max], unprojected to the world.
  A block is integrated against frame f iff f touched it.
- Project.  Each of a touched block's R^3 voxels (voxel (i, j, k) of block
  b lies at (b * R + (i, j, k)) * voxel_size) goes into the camera and to
  its nearest pixel, floor(fx * x / z + cx + 0.5) and likewise for v.
- Observe.  sdf = depth - z, kept where the pixel lies in the image, z > 0,
  the depth is in (0, depth_max] and sdf >= -trunc; tsdf = min(sdf, trunc)
  / trunc.
- Average.  Each voxel's tsdf is the running weighted average of its
  observations, each of weight 1, and its weight is their number.

Departures, none of which changes the result beyond rounding: the average
is taken once at the end of the pass (the sum of the observations in
frame order, over their count), which from a fresh volume is what the
running average computes; the touch uses the overlap of the cube, which
the program's 27 corner samples cover whenever trunc < block size (as in
every configuration of the benchmark); no hash map, no block capacity and
no chunks: the volume holds every touched block, and frames are taken one
at a time, in order, so that it fits.

`check` compares the program's pass (its active blocks' coordinates, tsdf
and weight) with this one's:

- `block_mismatch_share`: blocks in one volume and not the other, over the
  reference's blocks;
- `weight_mismatch_share`: voxels of the blocks both hold whose weights
  differ by more than one observation (a voxel that projects onto a pixel
  edge may round to the other pixel), over those voxels;
- `tsdf_mismatch_share`: voxels that both volumes observed whose tsdf
  differs by more than TSDF_TOL, over those voxels.

`control` is the same computation in bfloat16, put in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.core import setting
from benchmark.reference.confidence import maps

# tsdf values lie in [-1, 1]; one float32 rounding of an observation or of
# the average moves them by about 1e-7.
TSDF_TOL = 1e-5
WEIGHT_TOL = 1.0
MAPS_PER_CALL = 50  # reference frames per call of the plain step 1
_KEY_BITS = 16  # per block coordinate: +-32768 blocks


def settings(config: dict) -> dict:
    """The volume and filter settings of step 3, from the configuration."""
    di = "reconstruction.depth_integration."
    vs = float(setting(config, di + "voxel_size"))
    R = int(setting(config, di + "block_resolution"))
    return dict(voxel_size=vs, R=R, block_size=vs * R,
                trunc=vs * float(setting(config, di + "trunc_voxel_multiplier")),
                depth_max=float(setting(config, di + "depth_max")),
                stride=int(setting(config, di + "alloc_pixel_stride")),
                chunk=int(setting(config, di + "frames_per_batch")))


def inputs(session, config: dict, device) -> dict:
    """What step 3 is handed for the session's frames, side-major: "depth"
    (N, H, W) float32 filtered, "K" (N, 3, 3) float32, "T_wc" (N, 4, 4)
    float32 world-to-camera, "valid" (N,) bool; host numpy arrays, as the
    pipeline loads them."""
    di = config["reconstruction"]["depth_integration"]
    n = session.frames_per_side
    depth = session.depth.cpu().numpy().copy()
    if di["use_confidence_filtered_depth"]:
        for s in range(int(session.side.max()) + 1):
            groups = [(s, list(range(b, min(b + MAPS_PER_CALL, n))))
                      for b in range(0, n, MAPS_PER_CALL)]
            conf, cnt = maps(session, config, groups, device)
            kill = (conf < float(di["confidence_threshold"])) | (cnt < int(di["valid_count_threshold"]))
            depth[session.side_slice(s)][kill] = 0.0
    return {"depth": depth, "K": np.asarray(session.K_depth, np.float32),
            "T_wc": np.linalg.inv(session.T_cw).astype(np.float32),
            "valid": np.ones(len(depth), dtype=bool)}


def _pose(T, x, y, z):
    """T[:3, :3] @ (x, y, z) + T[:3, 3], summed left to right, for a pose
    T (4, 4) and coordinate arrays of any one shape."""
    return [T[i, 0] * x + T[i, 1] * y + T[i, 2] * z + T[i, 3] for i in range(3)]


def block_keys(b: torch.Tensor) -> torch.Tensor:
    """int64 keys of integer block coordinates (..., 3), in ascending
    (x, y, z) order."""
    off = 1 << (_KEY_BITS - 1)
    b = b.long() + off
    return (b[..., 0] << (2 * _KEY_BITS)) | (b[..., 1] << _KEY_BITS) | b[..., 2]


def key_coords(keys: torch.Tensor) -> torch.Tensor:
    mask = (1 << _KEY_BITS) - 1
    off = 1 << (_KEY_BITS - 1)
    return torch.stack([(keys >> (2 * _KEY_BITS)) & mask, (keys >> _KEY_BITS) & mask,
                        keys & mask], -1) - off


def touched(depth, K, T_cw, s: dict, dtype=torch.float32) -> torch.Tensor:
    """Sorted unique keys of the blocks that one frame touches: depth (H, W),
    K (3, 3), T_cw (4, 4) camera-to-world, on one device."""
    dev = depth.device
    d = depth[::s["stride"], ::s["stride"]].to(dtype)
    H, W = depth.shape
    u = torch.arange(0, W, s["stride"], device=dev).to(dtype)[None, :]
    v = torch.arange(0, H, s["stride"], device=dev).to(dtype)[:, None]
    ok = (d > 0) & (d <= s["depth_max"])
    K = K.to(dtype)
    x = (u - K[0, 2]) / K[0, 0] * d
    y = (v - K[1, 2]) / K[1, 1] * d
    p = torch.stack(_pose(T_cw.to(dtype), x, y, d), -1)[ok]  # (S, 3)
    bs = torch.tensor(s["block_size"], dtype=dtype, device=dev)
    lo = torch.floor((p - s["trunc"]) / bs).long()
    hi = torch.floor((p + s["trunc"]) / bs).long()
    steps = torch.arange(3, device=dev)
    off = torch.stack(torch.meshgrid(steps, steps, steps, indexing="ij"), -1).reshape(-1, 3)
    cand = lo[:, None, :] + off[None]  # (S, 27, 3)
    keep = (cand <= hi[:, None, :]).all(-1)
    return torch.unique(block_keys(cand[keep]))


def voxel_offsets(R: int, device) -> torch.Tensor:
    """(R^3, 3) voxel indices inside a block, x-major."""
    i = torch.arange(R, device=device)
    return torch.stack(torch.meshgrid(i, i, i, indexing="ij"), -1).reshape(-1, 3)


def observe(depth, K, T_wc, coords, s: dict, dtype=torch.float32):
    """(obs, ok), each (B, R^3), of one frame at the voxels of blocks
    `coords` (B, 3)."""
    H, W = depth.shape
    dev = depth.device
    vox = (coords[:, None, :] * s["R"] + voxel_offsets(s["R"], dev)[None]).to(dtype)
    p = vox * torch.tensor(s["voxel_size"], dtype=dtype, device=dev)
    x, y, z = _pose(T_wc.to(dtype), p[..., 0], p[..., 1], p[..., 2])
    K = K.to(dtype)
    zs = torch.where(z > 0, z, torch.ones((), dtype=dtype, device=dev))
    u = torch.floor(K[0, 0] * x / zs + K[0, 2] + 0.5)
    v = torch.floor(K[1, 1] * y / zs + K[1, 2] + 0.5)
    ok = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    # Pixels outside the image read pixel (0, 0); `ok` drops them.  (A
    # clamp to W - 1 would round up in bfloat16.)
    zero = torch.zeros((), dtype=dtype, device=dev)
    d = depth.to(dtype)[torch.where(ok, v, zero).long(), torch.where(ok, u, zero).long()]
    sdf = d - z
    ok &= (d > 0) & (d <= s["depth_max"]) & (sdf >= -s["trunc"])
    obs = torch.clamp(sdf, max=s["trunc"]) / s["trunc"]
    return torch.where(ok, obs, torch.zeros((), dtype=dtype, device=dev)), ok


def integrate(inp: dict, config: dict, device, dtype=torch.float32) -> dict:
    """The pass over every frame of inputs `inp` into a fresh volume:
    {"keys" (B,) sorted, "coords" (B, 3), "tsdf" (B, R^3), "weight"
    (B, R^3)} on `device`."""
    s = settings(config)
    frames = range(len(inp["depth"]))
    depth = torch.from_numpy(inp["depth"]).to(device)
    K = torch.from_numpy(inp["K"]).to(device)
    T_wc = torch.from_numpy(inp["T_wc"]).to(device)
    T_cw = torch.linalg.inv(T_wc.double()).float()
    per_frame = [touched(depth[f], K[f], T_cw[f], s, dtype) if inp["valid"][f] else None
                 for f in frames]
    keys = torch.unique(torch.cat([k for k in per_frame if k is not None]
                                  or [torch.zeros(0, dtype=torch.long, device=device)]))
    coords = key_coords(keys)
    sums = torch.zeros((len(keys), s["R"] ** 3), dtype=dtype, device=device)
    cnts = torch.zeros_like(sums)
    for f, fk in zip(frames, per_frame):
        if fk is None:
            continue
        rows = torch.searchsorted(keys, fk)  # unique within a frame
        obs, ok = observe(depth[f], K[f], T_wc[f], coords[rows], s, dtype)
        sums[rows] += obs
        cnts[rows] += ok.to(dtype)
    tsdf = torch.where(cnts > 0, sums / cnts.clamp(min=1), torch.zeros((), dtype=dtype,
                                                                        device=device))
    return {"keys": keys, "coords": coords, "tsdf": tsdf, "weight": cnts}


def compare(prog: dict, ref: dict, device) -> dict:
    """The three mismatch shares of volume `prog` ("coords", "tsdf",
    "weight" as numpy or tensors) against `ref` (as `integrate` returns)."""
    keys = block_keys(torch.as_tensor(prog["coords"], device=device))
    order = torch.argsort(keys)
    keys = keys[order]
    if len(torch.unique(keys)) != len(keys):
        raise ValueError("the program's volume holds a block twice")
    common_p = torch.isin(keys, ref["keys"])
    common_r = torch.isin(ref["keys"], keys)
    n_ref = max(len(ref["keys"]), 1)
    block = float((~common_p).sum() + (~common_r).sum()) / n_ref
    rows_p = order[common_p]
    w_p = torch.as_tensor(prog["weight"], device=device)[rows_p].float()
    t_p = torch.as_tensor(prog["tsdf"], device=device)[rows_p].float()
    w_r = ref["weight"][common_r].float()
    t_r = ref["tsdf"][common_r].float()
    both = (w_p > 0) & (w_r > 0)
    n_vox = max(w_r.numel(), 1)
    return {
        "block_mismatch_share": block,
        "weight_mismatch_share": float(((w_p - w_r).abs() > WEIGHT_TOL).sum()) / n_vox,
        "tsdf_mismatch_share": float((both & ((t_p - t_r).abs() > TSDF_TOL)).sum())
        / max(int(both.sum()), 1),
    }


def check(session, config, outputs, device, seed: int) -> dict:
    """The program's last pass (`outputs`: "coords", "tsdf", "weight" of
    its active blocks, and "inputs", what it was handed) against the
    reference's pass over the same inputs."""
    ref = integrate(outputs["inputs"], config, device)
    return compare(outputs, ref, device)


def control(session, config, device, seed: int) -> dict:
    """The reference in bfloat16, put in the program's place, over the pass
    a run with this seed checks."""
    inp = inputs(session, config, device)
    ref = integrate(inp, config, device)
    return compare(integrate(inp, config, device, dtype=torch.bfloat16), ref, device)
