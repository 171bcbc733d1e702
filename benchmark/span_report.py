"""Device time of a cell's traced steps by program span:

    python3 -m benchmark.span_report --workload <cell> --seed <n> [--steps <k>]

Sets the cell up as benchmark.run does, warms one step, then traces `k`
steps (the entry's `trace_steps` by default) of the device alone and `k`
more of host and device, as a `--trace 1` run does, and prints one JSON
line: each segment's frames, host seconds and kernel seconds, and for the
second the device time of each range (spans.attribute), of all its device
events and of its kernels alone.  No check is made and no metric is
written; this reads what a `--trace 1` run would give its readers if the
harness handed them the second segment's spans.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import core, spans
from benchmark.run import cache_env
from benchmark.trace import TRACE_SPAN, collect, device_time


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _segment(entry, name: str, dev, steps: int, host: bool) -> tuple:
    """(profile, frames, host seconds) of `steps` traced steps."""
    acts = [torch.profiler.ProfilerActivity.CUDA if dev.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    if host and dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CPU)
    _sync(dev)
    units = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()  # after the profiler's start, as in core.run
        window = torch.profiler.record_function(TRACE_SPAN) if host else None
        if window is not None:
            window.__enter__()
        for _ in range(steps):
            with torch.profiler.record_function(f"bench.{name}.step"):
                units += entry.step()
        _sync(dev)
        host_s = time.perf_counter() - t0
        if window is not None:
            window.__exit__(None, None, None)
    return prof, units, host_s


def report(cell_name: str, seed: int, steps: int | None = None, device: str = "cuda",
           config: dict | None = None, traffic: dict | None = None) -> dict:
    manifest = core.load_manifest()
    cell = core.find_cell(manifest, cell_name)
    config = config or core.load_config(manifest, cell["config"])
    traffic = traffic or core.load_traffic(cell["traffic"])
    dev = torch.device(device)
    name = traffic["entry"]
    session = core.load_part("generators", traffic["generator"]).make(traffic, seed, dev)
    entry = core.load_part("entries", name).Entry(session, config, dev, seed)
    entry.warm()
    steps = steps or entry.trace_steps

    prof, units, host_s = _segment(entry, name, dev, steps, host=False)
    alone = device_time(collect(prof), host_s)
    alone.update(units=units, host_s=host_s, steps=steps)
    prof, units, host_s = _segment(entry, name, dev, steps, host=True)
    events = spans.collect_linked(prof)
    kernels = [e for e in events if e.kind in ("range", "host", "kernel")]
    entry.free()
    return {
        "cell": cell_name, "seed": seed,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "device_alone": {k: alone[k] for k in ("steps", "units", "host_s", "busy_s", "by_kind")},
        "host_and_device": {"steps": steps, "units": units, "host_s": host_s,
                            "kernel_s": sum(e.end_ns - e.start_ns for e in events
                                            if e.kind == "kernel") / 1e9,
                            "spans": spans.attribute(events),
                            "kernel_spans": spans.attribute(kernels)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    cache_env()
    if not torch.cuda.is_available():
        print("no result: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(report(args.workload, args.seed, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
