"""Logging and timing helpers (reference:
scripts/processing/reconstruction/utils/log_utils.py).

Stages and substeps also open a `torch.profiler.record_function` range, so
a torch.profiler trace attributes device time to them; outside a profiler the range costs about a
microsecond.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

from torch.profiler import record_function


def log_step(title: str):
    print("\n" + "=" * 70)
    print(f"= {title}")
    print("=" * 70)


@contextmanager
def substep(name: str):
    """Fine-grained wall-clock probe inside a pipeline stage; prints only
    when MQ3D_SUBSTEP_TIMING is set (host clock: work queued on the card
    is counted where the host next waits for it)."""
    t0 = time.perf_counter()
    try:
        with record_function(name):
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
            with record_function(name):
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
