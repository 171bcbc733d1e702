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


def _innermost(spans, points):
    """For each of the sorted `points`, the latest-starting span of `spans`
    (sorted by start) that holds it, or None.  Spans nest, as the ranges
    and operators of one thread do, so the spans open at a point form a
    stack: however many closed spans lie between a point and the span
    that holds it."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


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


def idle_pct(run: dict):
    """The card's idle share of the traced steps, in %: the traced window
    less the union of every device operation in it, over the window."""
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def ms_per_unit(run: dict, kind: str):
    """Device milliseconds of the operations of `kind` ("kernel", "h2d",
    "d2h", ...) per unit of the traced steps."""
    s = ((run["trace"] or {}).get("by_kind") or {}).get(kind)
    if not s or not run["traced_units"]:
        return None
    return 1000.0 * s / run["traced_units"]


def roofline_pct(run: dict):
    """The traced steps' share of their roofline, in %: the least time the
    card needs for their work (work/<entry>.py, peaks.py) over the summed
    device time of every kernel in the traced window."""
    kernel_s = ((run["trace"] or {}).get("by_kind") or {}).get("kernel", 0.0)
    if not kernel_s or run["least_s"] is None:
        return None
    return 100.0 * run["least_s"] / kernel_s


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
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) // 2 for a, b in idle]
    gaps = defaultdict(float)
    for (a, b), span, op in zip(idle, _innermost(ranges, mids), _innermost(hosts, mids)):
        span = span or "window"
        name = f"{span} > {op}" if op else span
        gaps[name[:_NAME_CHARS]] += (b - a) / 1e9
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
