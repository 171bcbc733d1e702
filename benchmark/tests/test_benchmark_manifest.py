"""BENCHMARK.json against its format rules, and every piece a cell
names found by that name."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
M = core.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) for p in M["paths"])
    assert all(".." not in p and not p.startswith("/") for p in M["paths"])
    assert len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) <= 64 * 1024


def test_run_length_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in M[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        own = {m["name"] for m in core.metrics_for(M, cell, "end_to_end")}
        assert "setup_s" in own and len(own) >= 2
        layers = core.metrics_for(M, cell, "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in own


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(cell):
    w = core.find_cell(M, cell)
    config = core.load_config(M, w["config"])
    assert config["reduced"] == next(c for c in M["configs"] if c["name"] == w["config"])["reduced"]
    assert all(set(v) == {"value", "origin"} for v in config["assumed"].values())
    traffic = core.load_traffic(w["traffic"])
    assert callable(core.load_part("generators", traffic["generator"]).make)
    entry = traffic["entry"]
    assert hasattr(core.load_part("entries", entry), "Entry")
    ref = core.load_part("reference", entry)
    assert callable(ref.check) and callable(ref.control)
    assert callable(core.load_part("work", entry).count)
    limits = core.load_limits(cell)
    assert limits and all(set(v) >= {"limit", "lower", "upper"} for v in limits.values())
    for v in limits.values():
        assert v["lower"] < v["limit"] < v["upper"]
    for section in ("end_to_end", "per_layer"):
        for metric in core.metrics_for(M, cell, section):
            assert callable(core.load_reader(metric["name"]).read)


def test_metric_workloads_name_cells():
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_harness_loads_nothing_of_jax():
    """Import every module a run loads, in a fresh interpreter, and look
    for JAX or the JAX package by whole top-level name."""
    traffics = [core.load_traffic(w["traffic"]) for w in M["workloads"]]
    mods = ["benchmark.run", "benchmark.core", "benchmark.calibrate"]
    mods += [f"benchmark.{k}.{t['entry']}" for t in traffics
             for k in ("entries", "reference", "work")]
    mods += [f"benchmark.generators.{t['generator']}" for t in traffics]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "from benchmark import core\n"
            + "m = core.load_manifest()\n"
            + "[core.load_reader(x['name']) for x in m['end_to_end'] + m['per_layer']]\n"
            + "print(','.join(core.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(core.CHECKOUT), check=True)
    assert out.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mq3d_tpu_torch_fake", object())
    assert "mq3d_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mq3d_tpu", object())
    assert "mq3d_tpu" in core.forbidden_modules()
