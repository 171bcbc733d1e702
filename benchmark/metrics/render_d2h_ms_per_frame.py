"""Device milliseconds of card-to-host copies per view of the traced sides
(torch.profiler's device trace): each render call's maps read back to
host numpy."""

from benchmark.trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "d2h")
