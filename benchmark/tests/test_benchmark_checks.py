"""The check that decides `correct`, driven through a whole run of each
cell cut to a CPU size: the program agrees with the plain reference, the
reference in bfloat16 does not, and a run whose timed path is broken
underneath comes out not correct, once for each fault its entry's timed
path can have.

Each kind of work brings its cut, its limits at that size and its faults
in tiny/<entry>.py (conftest.py::tiny), found by the cell's entry.
"""

from __future__ import annotations

import pytest
import torch
from conftest import tiny, tiny_cell

from benchmark import core

SEED = 2 ** 31 + 977
ENTRY = {w["name"]: core.load_traffic(w["traffic"])["entry"]
         for w in core.load_manifest()["workloads"]}
CELLS = list(ENTRY)


def _run(cell, **kw):
    config, traffic = tiny_cell(cell)
    limits = {k: {"limit": v} for k, v in tiny(ENTRY[cell]).LIMITS.items()}
    return core.run(cell, SEED, 0.0, False, device="cpu", config=config, traffic=traffic,
                    limits=limits, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(tiny(ENTRY[cell]).LIMITS)
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    config, traffic = tiny_cell(cell)
    session = core.load_part("generators", traffic["generator"]).make(traffic, SEED, "cpu")
    ref = core.load_part("reference", traffic["entry"])
    numbers = ref.control(session, config, torch.device("cpu"), SEED)
    limits = tiny(ENTRY[cell]).LIMITS
    assert set(numbers) == set(limits)
    assert any(v > limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in tiny(ENTRY[c]).FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    tiny(ENTRY[cell]).FAULTS[fault](monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] == r["attempted"]
