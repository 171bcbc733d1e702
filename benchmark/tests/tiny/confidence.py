"""The CPU pieces of the `confidence` kind of work (step 1), found by the
entry's name: the cut, the limits at that size and the faults of its timed
path.

At this size a capture of 76 frames a side at 80x72 checks about a hundred
thousand pixels, so one pixel that rounds the other way moves a larger
share than at the cells' size.
"""

from __future__ import annotations

import torch

LIMITS = {"count_mismatch_share": 0.01, "conf_mismatch_share": 0.01}


def cut(config: dict, traffic: dict) -> None:
    """Small frames and a short confidence window; enough frames for the
    check to sample more than one call per side."""
    config["reconstruction"]["confidence_estimation"]["target_frame_range"] = 3
    traffic.update(frames_per_side=76, depth_width=80, depth_height=72)


def _break(monkeypatch, fault: str) -> None:
    import benchmark.entries.confidence as entry

    original = entry.confidence_for_refs

    def broken(depth, K, T_cw, T_wc, valid, refs, **kw):
        if fault == "unchanged":
            n = len(refs)
            return (torch.zeros((n,) + depth.shape[1:]),
                    torch.zeros((n,) + depth.shape[1:], dtype=torch.int64))
        if fault == "half":
            # The first half: the second may be the last call's padding.
            conf, cnt = original(depth, K, T_cw, T_wc, valid, refs, **kw)
            conf[:len(refs) // 2] = 0
            cnt[:len(refs) // 2] = 0
            return conf, cnt
        conf, cnt = original(depth, K, T_cw, T_wc, valid, refs, **kw)
        return conf, cnt + 1

    monkeypatch.setattr(entry, "confidence_for_refs", broken)


FAULTS = {f: (lambda monkeypatch, f=f: _break(monkeypatch, f))
          for f in ("unchanged", "half", "altered")}
