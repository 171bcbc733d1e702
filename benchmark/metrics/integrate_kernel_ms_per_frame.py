"""Device milliseconds of kernels per frame of the traced chunks
(torch.profiler's device trace): the card's own work in step 3, which a
kernel-side change moves even where the host's time hides it end to end."""

from benchmark.trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "kernel")
