"""The work of step 3's traced chunks, whatever implements it: float32
operations, and bytes of device memory.  Counted from the inputs the
benchmark made (each traced chunk's frames, as the entry's `last` holds
them) and from the blocks the plain reference finds each frame touches
(reference/integrate.py::touched), never from a counter of the program, so
a change of the program's tiling, windows or kernels cannot move it.

Operations per (block, frame) pair and voxel, the arithmetic of the plain
semantics counted by hand: the voxel's position 3 (one multiply an axis),
the pose 18 (three rows of three multiplies and three adds), the
projection 9 (one reciprocal of z, then per axis a multiply by the focal
length, one by the reciprocal, the centre added and the half added, the
floor left uncounted), the tests 9 (z > 0, four image bounds, the depth in
(0, depth_max], sdf >= -trunc), sdf 1, its clamp 1 and scale 1, and the sum
and count 2 = 44.  Per voxel of each block a chunk touches, the merge into
the running average: the product and sum tsdf * w + s 2, the weight's sum
1, the quotient 1 = 4.

Bytes: each chunk's depth frames and poses once, and each block the chunk
touches has its tsdf and weight read and written once (4 bytes each).
"""

from __future__ import annotations

import torch

from benchmark.reference.integrate import settings, touched

OPS_PAIR_VOXEL = 44
OPS_MERGE_VOXEL = 4
F32 = 4


def count(session, config, traced) -> tuple:
    """(ops, bytes) of the traced chunks, each as the entry's `last`
    ("depth" (C, H, W), "K", "T_wc", "valid")."""
    s = settings(config)
    r3 = s["R"] ** 3
    dev = session.depth.device
    ops = nbytes = 0.0
    for c in traced:
        T_cw = torch.linalg.inv(torch.from_numpy(c["T_wc"]).to(dev).double()).float()
        K = torch.from_numpy(c["K"]).to(dev)
        depth = torch.from_numpy(c["depth"]).to(dev)
        keys = [touched(depth[f], K[f], T_cw[f], s) for f in range(len(depth))
                if c["valid"][f]]
        pairs = sum(len(k) for k in keys)
        blocks = len(torch.unique(torch.cat(keys))) if keys else 0
        ops += pairs * r3 * OPS_PAIR_VOXEL + blocks * r3 * OPS_MERGE_VOXEL
        nbytes += (depth.numel() * F32 + len(depth) * (16 + 9) * F32
                   + blocks * r3 * 2 * 2 * F32)
    return ops, nbytes
