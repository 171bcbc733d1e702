"""Logging and timing helpers (reference:
scripts/processing/reconstruction/utils/log_utils.py).

`span` opens a profiler range while a profiler runs, so a torch.profiler
trace attributes host operations, and through them device time, to it;
stages and substeps open theirs through it.  The range is the user-scope
range of `torch.profiler.record_function`, opened through the binding
torch.profiler itself uses, at under half its host cost: on an H100
machine's host 3.5-3.7 us a range under a profiler of the device alone
(which records no range) and 4.9-5.6 us under one that records the host
too, against 8.7-10.5 and 9.6-13.3 us.  While no profiler runs, `span`
opens none and costs a flag check, under a microsecond.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager, nullcontext

import torch
from torch.autograd import _record_function_with_args_enter, _record_function_with_args_exit

_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_RANGE = nullcontext()


def log_step(title: str):
    print("\n" + "=" * 70)
    print(f"= {title}")
    print("=" * 70)


class _Range:
    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = _record_function_with_args_enter(self.name)

    def __exit__(self, *exc):
        _record_function_with_args_exit(self.handle)


def span(name: str):
    """A context manager: a profiler range named `name` while a profiler
    runs, and nothing otherwise.  It never prints."""
    return _Range(name) if _profiler_enabled() else _NO_RANGE


@contextmanager
def substep(name: str):
    """Fine-grained wall-clock probe inside a pipeline stage; prints only
    when MQ3D_SUBSTEP_TIMING is set (host clock: work queued on the card
    is counted where the host next waits for it)."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        if os.environ.get("MQ3D_SUBSTEP_TIMING"):
            print(f"[Substep] {name}: {time.perf_counter() - t0:.3f}s", flush=True)


class StageTimer:
    """Per-stage wall-clock accounting; feeds pipeline_runtime.txt
    (reference: scripts/run_full_pipeline.py:301-339)."""

    def __init__(self):
        self.records: list[tuple[str, float]] = []

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.records.append((name, dt))
            print(f"[Timing] {name}: {dt:.2f}s", file=sys.stderr)

    @property
    def total(self) -> float:
        return sum(dt for _, dt in self.records)

    def summary(self) -> str:
        lines = [f"{name}: {dt:.2f} s" for name, dt in self.records]
        lines.append(f"total: {self.total:.2f} s")
        return "\n".join(lines)
