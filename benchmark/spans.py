"""Device time by program span: each device operation of a host-and-device
torch.profiler trace is charged to the record_function range that was
innermost on the host when the host operation that launched it began.

The link is the profiler's own: a device event's linked correlation id is
the correlation id of the host operator that launched it (as
`torch.autograd.profiler.profile._parse_kineto_results` pairs them); an
event with no such operator falls back to its runtime call (the same
correlation id on the host's `cudaLaunchKernel` or `cudaMemcpyAsync`).  The
device timeline is never used to attribute: the card runs behind the host,
so a kernel often runs under a range the host opened later.

Events are plain tuples (Event: name, kind, start_ns, end_ns, thread,
corr, linked); kinds as in trace.py ("range", "host", or a device kind).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

from benchmark.trace import _device_kind

UNATTRIBUTED = "(none)"  # device events launched outside every range
_HOST_KINDS = ("range", "host")


class Event(NamedTuple):
    name: str
    kind: str
    start_ns: int
    end_ns: int
    thread: int
    corr: int
    linked: int


def collect_linked(prof) -> list:
    """Every event of a finished torch.profiler.profile as an Event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() == cuda
        if on_device and e.is_user_annotation():  # a range's copy on the device timeline
            continue
        kind = _device_kind(name) if on_device else "range" if e.is_user_annotation() else "host"
        start = int(e.start_ns())
        out.append(Event(name, kind, start, start + int(e.duration_ns()), int(e.start_thread_id()),
                         int(e.correlation_id()), int(e.linked_correlation_id())))
    return out


class _Ranges:
    """One thread's ranges as a nested forest, for innermost-range lookups."""

    def __init__(self, ranges):
        self.r = sorted(ranges, key=lambda e: (e.start_ns, -e.end_ns))
        self.starts = [e.start_ns for e in self.r]
        self.parent = []
        stack = []
        for i, e in enumerate(self.r):
            while stack and not e.end_ns <= self.r[stack[-1]].end_ns:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def chain(self, t: int) -> list:
        """Names of the ranges open at t, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0 and self.r[i].end_ns < t:
            i = self.parent[i]
        names = []
        while i is not None and i >= 0:
            names.append(self.r[i].name)
            i = self.parent[i]
        return names


def attribute(events: list) -> dict:
    """Per range name: device seconds of the events launched inside it,
    with its child ranges (`total_s`) and without (`self_s`), the count of
    those events (`events`, with child ranges) and the times it was
    opened (`opened`).  Events launched outside every range are charged to
    UNATTRIBUTED."""
    by_thread = defaultdict(list)
    ops, runtime = {}, {}
    for e in events:
        if e.kind == "range":
            by_thread[e.thread].append(e)
        if e.kind in _HOST_KINDS:
            (ops if e.linked == 0 else runtime)[e.corr] = e
    forests = {t: _Ranges(r) for t, r in by_thread.items()}
    stats = defaultdict(lambda: {"total_s": 0.0, "self_s": 0.0, "events": 0, "opened": 0})
    for r in by_thread.values():
        for e in r:
            stats[e.name]["opened"] += 1
    for e in events:
        if e.kind in _HOST_KINDS:
            continue
        host = ops.get(e.linked) if e.linked else None
        host = host or runtime.get(e.corr)
        forest = forests.get(host.thread) if host else None
        chain = (forest.chain(host.start_ns) if forest else []) or [UNATTRIBUTED]
        s = (e.end_ns - e.start_ns) / 1e9
        stats[chain[0]]["self_s"] += s
        for name in dict.fromkeys(chain):  # a name nested in itself counts once
            stats[name]["total_s"] += s
            stats[name]["events"] += 1
    return dict(stats)

