"""The check that decides `correct`, driven through a whole run of each
cell cut to a CPU size: the program agrees with the plain reference, the
reference in bfloat16 does not, and a run whose timed path is broken
underneath comes out not correct, once for each fault its entry's timed
path can have.

At this size the limits are the tests' own (TINY_LIMITS, by entry): a
capture of 76 frames a side at 80x72 checks about a hundred thousand
pixels, and a volume of about a thousand blocks of 512 voxels, so one
pixel or voxel that rounds the other way moves a larger share than at the
cells' size.
"""

from __future__ import annotations

import pytest
import torch
from conftest import tiny_cell

from benchmark import core
from mq3d_tpu_torch.ops.tsdf import TSDFVolume

SEED = 2 ** 31 + 977
TINY_LIMITS = {
    "confidence": {"count_mismatch_share": 0.01, "conf_mismatch_share": 0.01},
    "integrate": {"block_mismatch_share": 1e-3, "weight_mismatch_share": 1e-3,
                  "tsdf_mismatch_share": 1e-2},
}
ENTRY = {w["name"]: core.load_traffic(w["traffic"])["entry"]
         for w in core.load_manifest()["workloads"]}
CELLS = list(ENTRY)


def _run(cell, **kw):
    config, traffic = tiny_cell(cell)
    limits = {k: {"limit": v} for k, v in TINY_LIMITS[ENTRY[cell]].items()}
    return core.run(cell, SEED, 0.0, False, device="cpu", config=config, traffic=traffic,
                    limits=limits, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(TINY_LIMITS[ENTRY[cell]])
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    config, traffic = tiny_cell(cell)
    session = core.load_part("generators", traffic["generator"]).make(traffic, SEED, "cpu")
    ref = core.load_part("reference", traffic["entry"])
    numbers = ref.control(session, config, torch.device("cpu"), SEED)
    limits = TINY_LIMITS[ENTRY[cell]]
    assert set(numbers) == set(limits)
    assert any(v > limits[k] for k, v in numbers.items()), numbers


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


def _break_integrate(monkeypatch, fault):
    """Breaks the program's volume underneath the entry.  A tiny run calls
    `integrate` four times: the warm chunk, the window's chunk 0, then
    chunks 1 and 2 as the pass is completed."""
    integrate, calls = TSDFVolume.integrate, []

    def broken(self, depth, K, T_wc, valid, **kw):
        calls.append(1)
        if fault == "unchanged" or (fault == "skipped" and len(calls) == 3):
            return self
        if fault == "half":
            # The first half of each chunk's frames; the volume averages
            # over the rest.
            h = len(depth) // 2
            depth, K, T_wc, valid = depth[:h], K[:h], T_wc[:h], valid[:h]
        integrate(self, depth, K, T_wc, valid, **kw)
        if fault == "twice" and len(calls) == 3:
            integrate(self, depth, K, T_wc, valid, **kw)
        if fault == "altered":
            self.state.weight[self.state.weight > 0] += 2.0
        return self

    monkeypatch.setattr(TSDFVolume, "integrate", broken)
    if fault == "not_reset":
        monkeypatch.setattr(TSDFVolume, "reset", lambda self: self)


FAULTS = {
    "confidence": (_break_confidence, ("unchanged", "half", "altered")),
    "integrate": (_break_integrate, ("unchanged", "half", "skipped", "twice", "not_reset",
                                     "altered")),
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[ENTRY[c]][1]])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[ENTRY[cell]][0](monkeypatch, fault)
    r = _run(cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] == r["attempted"]

