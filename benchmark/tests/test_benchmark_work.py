"""The work counts behind the roofline share, the check's sample, the
configuration lookup and the trace reduction, on inputs small enough to
count by hand; and one cell run on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import core, trace
from benchmark.generators.quest_session import Session
from benchmark.reference.confidence import checked_batches
from benchmark.work.confidence import count


def _session(depth, n_side):
    n = depth.shape[0]
    K = np.array([[2.0, 0, 2.0], [0, 2.0, 2.0], [0, 0, 1]], np.float32)
    return Session(depth=torch.as_tensor(depth), K_depth=np.broadcast_to(K, (n, 3, 3)).copy(),
                   T_cw=np.tile(np.eye(4), (n, 1, 1)), side=np.repeat(np.arange(n // n_side), n_side),
                   frames_per_side=n_side)


def _config(window=1):
    return {"reconstruction": {"confidence_estimation": {"target_frame_range": window,
                                                         "depth_max": 4.0}}}


def test_confidence_work_by_hand():
    # Three frames a side, window 1: reference 0 has neighbour 1, reference 1
    # has 0 and 2; 10 of 16 pixels valid in each reference.
    depth = np.zeros((3, 4, 4), np.float32)
    depth[:, :, :2] = 1.0
    depth[:, 0, 2:] = 2.0
    s = _session(depth, 3)
    ops, nbytes = count(s, _config(), [(0, [0, 1])])
    assert ops == (1 + 2) * 10 * 88
    assert nbytes == 3 * 16 * 4 + 2 * 16 * 12


def test_checked_calls_are_drawn_from_the_seed():
    # 500 frames a side in calls of 16: 32 calls, the last one padded; a
    # quarter of them, 8, per side, each side's last among them.
    a = checked_batches(2, 500, 16, 2 ** 31 + 5)
    assert a == checked_batches(2, 500, 16, 2 ** 31 + 5)
    assert a != checked_batches(2, 500, 16, 2 ** 31 + 6)
    for side in (0, 1):
        starts = [b for s, b in a if s == side]
        assert len(starts) == 8 and len(set(starts)) == 8 and starts[-1] == 496
        assert all(b % 16 == 0 and 0 <= b < 500 for b in starts)
    assert checked_batches(1, 4, 16, 3) == [(0, 0)]


def test_setting_reads_the_section_then_assumed():
    config = {"a": {"b": 1}, "assumed": {"a.c": {"value": 2, "origin": "x"}}}
    assert core.setting(config, "a.b") == 1
    assert core.setting(config, "a.c") == 2
    with pytest.raises(KeyError):
        core.setting(config, "a.d")


def test_trace_reduction():
    ms = 1_000_000
    ev = [("k1", "kernel", 0, 2 * ms), ("k2", "kernel", 1 * ms, 3 * ms),
          ("Memcpy HtoD (Pageable -> Device)", "h2d", 5 * ms, 6 * ms)]
    d = trace.device_time(ev, 0.010)
    assert d["busy_s"] == pytest.approx(0.004)
    assert d["by_kind"] == {"kernel": pytest.approx(0.004), "h2d": pytest.approx(0.001)}
    assert d["device_ops"][0] == ("k1", pytest.approx(0.002))
    ev = [(trace.TRACE_SPAN, "range", 0, 10 * ms), ("bench.step", "range", 0, 10 * ms),
          ("aten::nonzero", "host", 3 * ms, 5 * ms), ("k", "kernel", 0, 3 * ms),
          ("k", "kernel", 5 * ms, 6 * ms)]
    gaps = dict(trace.idle_gaps(ev))
    assert gaps == {"bench.step > aten::nonzero": pytest.approx(0.002),
                    "bench.step": pytest.approx(0.004)}
    assert trace._device_kind("Memcpy DtoH (Device -> Pageable)") == "d2h"


def test_idle_gaps_find_the_open_range_behind_many_closed_ones():
    # A step opens 1 000 short ranges, as a step-3 chunk opens its `fma`s;
    # a gap after them still lies in the step's range and its operator.
    ms = 1_000_000
    ev = [(trace.TRACE_SPAN, "range", 0, 2000 * ms), ("bench.step", "range", 0, 2000 * ms),
          ("aten::index", "host", 0, 2000 * ms)]
    ev += [("fma", "range", i * ms, i * ms + 1) for i in range(1000)]
    ev += [("aten::mul", "host", i * ms, i * ms + 1) for i in range(1000)]
    ev += [("k", "kernel", 0, 1500 * ms), ("k", "kernel", 1501 * ms, 2000 * ms)]
    gaps = dict(trace.idle_gaps(ev))
    assert gaps == {"bench.step > aten::index": pytest.approx(0.001)}


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_device):
    from conftest import tiny_cell

    config, traffic = tiny_cell("default.confidence")
    limits = {k: {"limit": 0.01} for k in ("count_mismatch_share", "conf_mismatch_share")}
    r = core.run("default.confidence", 5, 0.5, True, device="cuda", config=config,
                 traffic=traffic, limits=limits)
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
