"""Step 1's reference frames per second whose confidence and valid-count
maps reached the host: every frame of the window over its whole length
(host clock, the window closed by a synchronize)."""


def read(run):
    return run["units"] / run["window_s"] if run["units"] else None
