"""Step 3's frames per second fused into the volume: every frame of the
window's chunks over its whole length (host clock, the window closed by a
synchronize)."""


def read(run):
    return run["units"] / run["window_s"] if run["units"] else None
