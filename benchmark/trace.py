"""Reduction of torch.profiler traces of the traced steps to the numbers
the per-layer metrics and the breakdown read.  A traced run traces twice:
first the device alone, whose busy time, kernel time and copies the
metrics read (recording host operations as well would slow the host, and
the card would read idler than it is); then host and device, whose idle
gaps are named by what the host was doing.

Events are reduced as plain tuples (name, kind, start_ns, end_ns), kind
one of "kernel", "h2d", "d2h", "copy", "memset" (device) and "range"
(a record_function range: the benchmark's spans, the program's stages)
or "host" (an operator or runtime call on the host).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

TRACE_SPAN = "bench.traced"  # the range around the traced steps
_NAME_CHARS = 64


def _device_kind(name: str) -> str:
    n = name.lower()
    if n.startswith("memcpy"):
        if "htod" in n or "h2d" in n:
            return "h2d"
        if "dtoh" in n or "d2h" in n:
            return "d2h"
        return "copy"
    if n.startswith("memset"):
        return "memset"
    return "kernel"


def collect(prof) -> list:
    """(name, kind, start_ns, end_ns) of every event of a finished
    torch.profiler.profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    out = []
    for e in raw:
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        name = e.name()
        if e.is_user_annotation():
            if e.device_type() != cuda:  # a range's copy on the device timeline is no work
                out.append((name, "range", start, end))
        elif e.device_type() == cuda:
            out.append((name, _device_kind(name), start, end))
        else:
            out.append((name, "host", start, end))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(starts, spans, t):
    """The latest-starting span of `spans` (sorted by start) that holds t."""
    i = bisect.bisect_right(starts, t) - 1
    best = None
    for j in range(i, max(i - 256, -1), -1):
        s, e, name = spans[j]
        if s <= t <= e:
            best = name
            break
    return best


def device_time(events: list, window_s: float) -> dict:
    """Busy seconds (the union of every device operation), seconds by kind,
    and the ten operations that took most time, of a trace of the device
    alone over a window of `window_s` seconds (host clock)."""
    dev = [(n, k, s, e) for n, k, s, e in events if k not in ("range", "host")]
    busy = _merge([(s, e) for _, _, s, e in dev])
    by_kind = defaultdict(float)
    by_name = defaultdict(float)
    for n, k, s, e in dev:
        by_kind[k] += (e - s) / 1e9
        by_name[n[:_NAME_CHARS]] += (e - s) / 1e9
    return {
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "by_kind": dict(by_kind),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
    }


def idle_gaps(events: list) -> list:
    """The ten largest sums of idle device time inside the TRACE_SPAN
    range, each gap named by the innermost range open over its middle and
    the innermost host operation there."""
    window = [(s, e) for name, kind, s, e in events if kind == "range" and name == TRACE_SPAN]
    if not window:
        raise ValueError(f"the trace holds no {TRACE_SPAN!r} range")
    w0, w1 = window[0]
    busy = _merge([(max(s, w0), min(e, w1)) for n, k, s, e in events
                   if k not in ("range", "host") and e > w0 and s < w1])
    ranges = sorted((s, e, n) for n, k, s, e in events
                    if k == "range" and n != TRACE_SPAN and e > w0 and s < w1)
    hosts = sorted((s, e, n) for n, k, s, e in events if k == "host" and e > w0 and s < w1)
    r_starts = [s for s, _, _ in ranges]
    h_starts = [s for s, _, _ in hosts]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        span = _innermost(r_starts, ranges, mid) or "window"
        op = _innermost(h_starts, hosts, mid)
        name = f"{span} > {op}" if op else span
        gaps[name[:_NAME_CHARS]] += (b - a) / 1e9
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
