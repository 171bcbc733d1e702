"""The check that decides `correct`, driven through a whole run of each
cell cut to a CPU size: the program agrees with the plain reference, the
reference in bfloat16 does not, and a run whose timed path is broken
underneath comes out not correct.

At this size the limits are the tests' own (TINY_LIMITS): a capture of
76 frames a side at 80x72 checks about a hundred thousand pixels, so one
pixel that rounds the other way moves a larger share than at the cells'
size.
"""

from __future__ import annotations

import pytest
import torch
from conftest import tiny_cell

from benchmark import core

SEED = 2 ** 31 + 977
TINY_LIMITS = {"count_mismatch_share": 0.01, "conf_mismatch_share": 0.01}
CELLS = [w["name"] for w in core.load_manifest()["workloads"]]


def _run(cell, **kw):
    config, traffic = tiny_cell(cell)
    limits = {k: {"limit": v} for k, v in TINY_LIMITS.items()}
    return core.run(cell, SEED, 0.0, False, device="cpu", config=config, traffic=traffic,
                    limits=limits, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    config, traffic = tiny_cell(cell)
    session = core.load_part("generators", traffic["generator"]).make(traffic, SEED, "cpu")
    ref = core.load_part("reference", traffic["entry"])
    numbers = ref.control(session, config, torch.device("cpu"), SEED)
    assert any(v > TINY_LIMITS[k] for k, v in numbers.items()), numbers


def _break_confidence(monkeypatch, fault):
    import benchmark.entries.confidence as entry

    original = entry.confidence_for_refs

    def broken(depth, K, T_cw, T_wc, valid, refs, **kw):
        if fault == "unchanged":
            n = len(refs)
            return (torch.zeros((n,) + depth.shape[1:]),
                    torch.zeros((n,) + depth.shape[1:], dtype=torch.int64))
        if fault == "half":
            # The first half: the second may be the last call's padding.
            conf, cnt = original(depth, K, T_cw, T_wc, valid, refs, **kw)
            conf[:len(refs) // 2] = 0
            cnt[:len(refs) // 2] = 0
            return conf, cnt
        conf, cnt = original(depth, K, T_cw, T_wc, valid, refs, **kw)
        return conf, cnt + 1

    monkeypatch.setattr(entry, "confidence_for_refs", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    _break_confidence(monkeypatch, fault)
    r = _run(cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] == r["attempted"]
