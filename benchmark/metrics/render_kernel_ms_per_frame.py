"""Device milliseconds of kernels per view of the traced sides
(torch.profiler's device trace): the card's own work in step 6, scene
preparation included, which a kernel-side change moves even where the
read-back and the host hide it end to end."""

from benchmark.trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "kernel")
