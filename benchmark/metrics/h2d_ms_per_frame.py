"""Device milliseconds of host-to-card copies per frame of the traced
chunks (torch.profiler's device trace): each chunk's frames, poses and
intrinsics crossing to the card."""

from benchmark.trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "h2d")
