"""The CPU pieces of the `render` kind of work (step 6), found by the
entry's name: the cut, the limits at that size and the faults of its timed
path.

At this size a check compares an eighth of the pixels of each of 34 views
of 320x240 rendered from a volume of 4.5 cm voxels made of 66 frames of
80x72 a side: the program reads 0.102, the fault `coarse_only` 0.203,
`half` 0.514, the others 0.99 and more, the control 0.440.
"""

from __future__ import annotations

import torch

LIMITS = {"depth_mismatch_share": 0.13}


def cut(config: dict, traffic: dict) -> None:
    """Small frames and views; a keyframe every 4 frames of 66 a side, so
    that each side renders 17 views in calls of 16 + 1 as the cell does;
    a volume of 4.5 cm voxels in the blocks of 16 the raycast needs (0.72 m,
    a truncation of 0.18 m) with room for 1 024 blocks."""
    rc = config["reconstruction"]
    rc["color_optimization"]["interval"] = 4
    rc["depth_integration"].update(voxel_size=0.045, trunc_voxel_multiplier=4.0,
                                   block_count=1024)
    config["assumed"]["reconstruction.depth_integration.grid_dim"]["value"] = 64
    traffic.update(frames_per_side=66, depth_width=80, depth_height=72, color_width=320,
                   color_height=240)


def _patch(monkeypatch, fault: str) -> None:
    """Breaks the program's render of each call underneath the entry."""
    from mq3d_tpu_torch.ops import raycast

    original = raycast._render_frames

    def broken(cfg, *args):
        if fault == "coarse_only":
            # An edge budget of one pixel: every finer level keeps the
            # upsampled depth, as if its re-march were skipped.
            return original(cfg, *args[:-1], 1)
        z, overflow = original(cfg, *args)
        if fault == "unchanged":
            z = torch.zeros_like(z)
        elif fault == "half":
            # The second half of the call's views copied from the first.
            z = z.clone()
            h = len(z) // 2
            z[len(z) - h:] = z[:h]
        elif fault == "altered":
            z = torch.where(torch.isfinite(z), z + cfg.voxel_size, z)
        return z, overflow

    monkeypatch.setattr(raycast, "_render_frames", broken)


FAULTS = {f: (lambda monkeypatch, f=f: _patch(monkeypatch, f))
          for f in ("unchanged", "half", "coarse_only", "altered")}
