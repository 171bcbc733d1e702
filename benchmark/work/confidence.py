"""The work of step 1's traced batches, whatever implements it: float32
operations, and bytes of device memory with each input byte read once and
each output byte written once per launch group.  Counted from the session
alone, never from a counter of the program, so a change of the program's
tiling or kernels cannot move it.

Operations per (reference, neighbour, pixel) triple of a valid reference
depth, the arithmetic of the plain semantics (reference/confidence.py)
counted by hand: unprojection 6, two poses 36, projection 6, bilinear
taps 16, back-projection 18, distance 6 = 88.
"""

from __future__ import annotations

OPS_TRIPLE = 88
F32 = 4


def count(session, config, traced) -> tuple:
    """(ops, bytes) of the traced batches, each (side, references)."""
    ce = config["reconstruction"]["confidence_estimation"]
    window = int(ce["target_frame_range"])
    dmax = float(ce["depth_max"])
    n = session.frames_per_side
    H, W = session.depth.shape[1:]
    ops = nbytes = 0.0
    for side, refs in traced:
        base = side * n
        frames = set()
        for r in refs:
            nbrs = [t for t in range(r - window, r + window + 1) if t != r and 0 <= t < n]
            frames.update(nbrs)
            frames.add(r)
            d = session.depth[base + r]
            ops += len(nbrs) * int(((d > 0) & (d <= dmax)).sum()) * OPS_TRIPLE
        nbytes += len(frames) * H * W * F32 + len(refs) * H * W * (F32 + 8)
    return ops, nbytes
