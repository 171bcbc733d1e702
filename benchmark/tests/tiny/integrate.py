"""The CPU pieces of the `integrate` kind of work (step 3), found by the
entry's name: the cut, the limits at that size and the faults of its timed
path.

At this size a volume holds about a thousand blocks of 512 voxels, so one
voxel that rounds the other way moves a larger share than at the cells'
size.
"""

from __future__ import annotations

from mq3d_tpu_torch.ops.tsdf import TSDFVolume

LIMITS = {"block_mismatch_share": 1e-3, "weight_mismatch_share": 1e-3,
          "tsdf_mismatch_share": 1e-2}


def cut(config: dict, traffic: dict) -> None:
    """Small frames and the plain step 1's short window; a volume of 4.5 cm
    voxels in blocks of 8 (blocks of 0.36 m, a truncation of 0.18 m, so
    that no face of the room lies on a block boundary) with room for 4 096
    blocks."""
    config["reconstruction"]["confidence_estimation"]["target_frame_range"] = 3
    config["reconstruction"]["depth_integration"].update(
        voxel_size=0.045, block_resolution=8, trunc_voxel_multiplier=4.0, block_count=4096)
    config["assumed"]["reconstruction.depth_integration.grid_dim"]["value"] = 64
    traffic.update(frames_per_side=76, depth_width=80, depth_height=72)


def _break(monkeypatch, fault: str) -> None:
    """Breaks the program's volume underneath the entry.  A tiny run calls
    `integrate` four times: the warm chunk, the window's chunk 0, then
    chunks 1 and 2 as the pass is completed."""
    integrate, calls = TSDFVolume.integrate, []

    def broken(self, depth, K, T_wc, valid, **kw):
        calls.append(1)
        if fault == "unchanged" or (fault == "skipped" and len(calls) == 3):
            return self
        if fault == "half":
            # The first half of each chunk's frames; the volume averages
            # over the rest.
            h = len(depth) // 2
            depth, K, T_wc, valid = depth[:h], K[:h], T_wc[:h], valid[:h]
        integrate(self, depth, K, T_wc, valid, **kw)
        if fault == "twice" and len(calls) == 3:
            integrate(self, depth, K, T_wc, valid, **kw)
        if fault == "altered":
            self.state.weight[self.state.weight > 0] += 2.0
        return self

    monkeypatch.setattr(TSDFVolume, "integrate", broken)
    if fault == "not_reset":
        monkeypatch.setattr(TSDFVolume, "reset", lambda self: self)


FAULTS = {f: (lambda monkeypatch, f=f: _break(monkeypatch, f))
          for f in ("unchanged", "half", "skipped", "twice", "not_reset", "altered")}
