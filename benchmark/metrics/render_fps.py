"""Step 6's colour-aligned depth maps per second that reached the host as
numpy: every view of the window's sides over its whole length (host clock,
the window closed by a synchronize)."""


def read(run):
    return run["units"] / run["window_s"] if run["units"] else None
