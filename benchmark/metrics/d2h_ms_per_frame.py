"""Device milliseconds of card-to-host copies per frame of the traced
steps (torch.profiler's device trace)."""

from benchmark.trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "d2h")
