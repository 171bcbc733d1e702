"""The harness: finds a cell's pieces by name, runs set-up, the measured
window and the check, and builds the result line.

Everything that belongs to one configuration, traffic mix, entry or metric
sits in files of its own, found by the names in BENCHMARK.json:

  configuration   the `file` of its entry in `configs`
  traffic         traffic/<name>.json, whose "generator" and "entry" name the rest:
  generator       generators/<generator>.py  (make(traffic, seed, device) -> session)
  entry           entries/<entry>.py    (the calls into the program)
  reference       reference/<entry>.py  (the plain check)
  work            work/<entry>.py       (count(...): operations and bytes)
  limits          limits/<cell>.json    (each compared number's limit)
  metric          metrics/<metric>.py   (a reader: read(run) -> number or None)
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from benchmark.peaks import least_seconds
from benchmark.trace import TRACE_SPAN, collect, device_time, idle_gaps

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mq3d_tpu")


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


def load_manifest(path: Path = CHECKOUT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def find_cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((CHECKOUT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def setting(config: dict, key: str):
    """The value of the dotted `key` in a configuration file: its own
    section, or else its entry under `assumed`."""
    node = config
    for part in key.split("."):
        if not isinstance(node, dict) or part not in node:
            return config["assumed"][key]["value"]
        node = node[part]
    return node


def load_part(kind: str, name: str):
    """The module `name` of the harness's package `kind` (generators,
    entries, reference, work)."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def load_limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def metrics_for(manifest: dict, cell: str, section: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that `cell`
    reports."""
    return [m for m in manifest[section] if "workloads" not in m or cell in m["workloads"]]


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, manifest: dict | None = None,
        config: dict | None = None, traffic: dict | None = None,
        limits: dict | None = None, log=sys.stderr) -> dict:
    """One run of a cell; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or load_manifest()
    cell = find_cell(manifest, cell_name)
    config = config or load_config(manifest, cell["config"])
    traffic = traffic or load_traffic(cell["traffic"])
    limits = limits or load_limits(cell_name)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise NoDevice(f"{cell_name} needs {cell['chips']} CUDA device(s); "
                           f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    name = traffic["entry"]
    reference = load_part("reference", name)

    # ---- set-up: the session from the seed, the program, one warm step ----
    session = load_part("generators", traffic["generator"]).make(traffic, seed, dev)
    entry = load_part("entries", name).Entry(session, config, dev, seed)
    entry.warm()
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    # ---- the measured window -------------------------------------------------
    # A traced run traces `trace_steps` steps of the device alone, then as
    # many of host and device (trace.py); the window runs on until both
    # are done and `seconds` have passed.
    units = traced_units = steps = 0
    traced, profs, prof, span = [], [], None, None
    segment_s = 0.0
    t0 = time.perf_counter()
    while True:
        if trace and len(profs) < 2 and prof is None:
            _sync(dev)
            acts = [torch.profiler.ProfilerActivity.CUDA if dev.type == "cuda"
                    else torch.profiler.ProfilerActivity.CPU]
            if profs and dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CPU)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            if profs:
                span = torch.profiler.record_function(TRACE_SPAN)
                span.__enter__()
            seg_steps, t_seg = 0, time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}.step"):
            n = entry.step()
        units += n
        steps += 1
        if prof is not None:
            seg_steps += 1
            if not profs:
                traced.append(entry.last)
                traced_units += n
            if seg_steps == entry.trace_steps:
                _sync(dev)
                if not profs:
                    segment_s = time.perf_counter() - t_seg
                if span is not None:
                    span.__exit__(None, None, None)
                    span = None
                prof.__exit__(None, None, None)
                profs.append(prof)
                prof = None
        if time.perf_counter() - t0 >= seconds and (not trace or len(profs) == 2):
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # ---- the check, with the program's state freed ---------------------------
    entry.finish()
    outputs = entry.outputs()
    entry.free()
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    numbers = reference.check(session, config, outputs, dev, seed)
    check_s = time.perf_counter() - t_check
    checks = {}
    for key, value in numbers.items():
        if key not in limits:
            raise KeyError(f"no limit for {key!r} in limits/{cell_name}.json")
        checks[key] = {"value": value, "limit": limits[key]["limit"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    # ---- metrics ----------------------------------------------------------------
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    record = {"entry": name, "units": units, "window_s": window_s, "setup_s": setup_s,
              "trace": None, "traced_units": traced_units, "least_s": None}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": units, "failed": 0 if correct else units}
    if trace:
        summary = device_time(collect(profs[0]), segment_s)
        summary["idle_gaps"] = idle_gaps(collect(profs[1]))
        ops, nbytes = load_part("work", name).count(session, config, traced)
        record["trace"] = summary
        record["least_s"] = least_seconds(ops, nbytes, kind)
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(manifest, cell_name, section):
        value = load_reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    if trace:
        result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                               "idle_gaps": [list(x) for x in summary["idle_gaps"]]}
    result["checks"] = checks
    print(f"setup_s {setup_s!r} window_s {window_s!r} units {units} check_s {check_s!r}",
          file=log)
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=log)
    return result
