"""The generator of a Quest session with colour views, named
`quest_session_color` by a traffic file: the session of `quest_session`
(the same depth frames and poses for the same seed), and for its colour
camera the traffic's `color_width` x `color_height` and
`color_fov_tangents`, with cx mirror-flipped as every projection and render
of the pipeline uses it.  A colour view is seen from its frame's pose.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.generators import quest_session


@dataclass
class ColorSession(quest_session.Session):
    K_color: np.ndarray = None  # (3, 3) float32, cx mirror-flipped
    color_width: int = 0
    color_height: int = 0


def make(traffic: dict, seed: int, device) -> ColorSession:
    s = quest_session.make(traffic, seed, device)
    w, h = int(traffic["color_width"]), int(traffic["color_height"])
    return ColorSession(
        depth=s.depth, K_depth=s.K_depth, T_cw=s.T_cw, side=s.side,
        frames_per_side=s.frames_per_side,
        K_color=quest_session.flipped_intrinsics(traffic["color_fov_tangents"], w, h),
        color_width=w, color_height=h)
