"""Device time by program span (spans.py) on synthetic traces, on a CPU
trace of the program, and through the span report and a traced run of a
cell cut for the CPU."""

from __future__ import annotations

import pytest
import torch
from conftest import tiny_cell

from benchmark import core, span_report, spans
from benchmark.spans import Event

US = 1_000


def _range(name, a, b, corr, thread=1):
    return Event(name, "range", a * US, b * US, thread, corr, 0)


def _op(name, a, b, corr, thread=1):
    return Event(name, "host", a * US, b * US, thread, corr, 0)


def _kernel(a, b, linked, corr=0, kind="kernel"):
    return Event("k", kind, a * US, b * US, 7, corr, linked)


def test_nested_ranges_give_self_and_total_time():
    ev = [_range("call", 0, 100, 1), _range("sample", 10, 60, 2), _range("fma", 20, 30, 3),
          _op("aten::mul", 21, 22, 4), _op("aten::gather", 40, 41, 5), _op("aten::sum", 70, 71, 6),
          _kernel(100, 110, 4), _kernel(110, 130, 5), _kernel(130, 170, 6),
          _kernel(170, 171, 5, kind="d2h")]
    s = spans.attribute(ev)
    assert s["fma"] == {"total_s": pytest.approx(10e-6), "self_s": pytest.approx(10e-6),
                        "events": 1, "opened": 1}
    assert s["sample"]["total_s"] == pytest.approx(31e-6)
    assert s["sample"]["self_s"] == pytest.approx(21e-6)
    assert s["sample"]["events"] == 3
    assert s["call"]["total_s"] == pytest.approx(71e-6)
    assert s["call"]["self_s"] == pytest.approx(40e-6)
    assert s["call"]["events"] == 4 and s["call"]["opened"] == 1


def test_a_kernel_goes_to_the_range_open_at_its_launch_not_under_its_run():
    # The host leaves "project" and opens "sample" before the card runs the
    # kernel that "project" launched.
    ev = [_range("project", 0, 50, 1), _op("aten::add", 10, 12, 2),
          _range("sample", 50, 150, 3), _op("aten::gather", 60, 61, 4),
          _kernel(120, 140, 2), _kernel(140, 145, 4)]
    s = spans.attribute(ev)
    assert s["project"]["total_s"] == pytest.approx(20e-6) and s["project"]["events"] == 1
    assert s["sample"]["total_s"] == pytest.approx(5e-6) and s["sample"]["events"] == 1


def test_launches_outside_program_ranges_go_to_the_benchmark_range():
    ev = [_range("bench.traced", 0, 1000, 1), _range("bench.confidence.step", 5, 500, 2),
          _op("aten::copy_", 6, 8, 3), _range("confidence.call", 10, 400, 4),
          _op("aten::mul", 20, 21, 5), _kernel(30, 40, 3, kind="h2d"), _kernel(40, 50, 5)]
    s = spans.attribute(ev)
    assert s["bench.confidence.step"]["self_s"] == pytest.approx(10e-6)
    assert s["bench.confidence.step"]["total_s"] == pytest.approx(20e-6)
    assert s["bench.traced"]["total_s"] == pytest.approx(20e-6)
    assert s["confidence.call"]["total_s"] == pytest.approx(10e-6)
    assert spans.UNATTRIBUTED not in s


def test_unlinked_events_fall_back_to_their_runtime_call_or_to_none():
    runtime = Event("cudaLaunchKernel", "host", 30 * US, 31 * US, 1, 900, 77)
    ev = [_range("call", 0, 100, 1), runtime, _kernel(200, 210, 0, corr=900),
          _kernel(210, 215, 0, corr=901), _kernel(215, 216, 55)]
    s = spans.attribute(ev)
    assert s["call"]["total_s"] == pytest.approx(10e-6)
    assert s[spans.UNATTRIBUTED]["events"] == 2 and s[spans.UNATTRIBUTED]["opened"] == 0


def test_ranges_on_another_thread_do_not_take_a_launch():
    ev = [_range("other", 0, 100, 1, thread=2), _range("mine", 0, 100, 2, thread=1),
          _op("aten::mul", 10, 11, 3, thread=1), _kernel(20, 30, 3)]
    s = spans.attribute(ev)
    assert s["mine"]["events"] == 1 and s["other"]["events"] == 0


def test_a_cpu_trace_of_the_program_counts_its_ranges():
    from mq3d_tpu_torch.recon.confidence import confidence_for_refs

    g = torch.Generator().manual_seed(0)
    depth = 1.0 + 0.1 * torch.rand(5, 8, 10, generator=g)
    K = torch.tensor([[9.0, 0, 5], [0, 9.0, 4], [0, 0, 1]]).expand(5, 3, 3).contiguous()
    T = torch.eye(4).expand(5, 4, 4).contiguous()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        confidence_for_refs(depth, K, T, T, torch.ones(5, dtype=torch.bool),
                            torch.tensor([1, 3]), 4.0, 0.05, 1)
    ev = spans.collect_linked(prof)
    s = spans.attribute(ev)
    assert s["confidence.call"]["opened"] == 1 and s["fma"]["opened"] == 23
    assert all(s[p]["opened"] == 1 for p in ("confidence.inputs", "confidence.project",
                                             "confidence.sample", "confidence.error",
                                             "confidence.count"))
    assert any(e.kind == "host" and e.name.startswith("aten::") for e in ev)
    assert all(v["events"] == 0 for v in s.values())  # nothing ran on a device


def test_span_report_runs_a_cell_cut_for_the_cpu():
    config, traffic = tiny_cell("sharp.confidence")
    r = span_report.report("sharp.confidence", 2 ** 31 + 11, steps=2, device="cpu",
                           config=config, traffic=traffic)
    hd = r["host_and_device"]
    assert r["device_alone"]["units"] == hd["units"] == 16
    assert hd["spans"]["fma"]["opened"] == 2 * 23
    assert hd["spans"]["bench.confidence.step"]["opened"] == 2
    assert hd["spans"]["bench.traced"]["opened"] == 1


def test_a_traced_run_still_reports_the_accepted_metrics():
    config, traffic = tiny_cell("default.confidence")
    limits = {k: {"limit": 0.01} for k in ("count_mismatch_share", "conf_mismatch_share")}
    r = core.run("default.confidence", 2 ** 31 + 3, 0.0, True, device="cpu", config=config,
                 traffic=traffic, limits=limits)
    assert r["correct"]
    assert r["metrics"]["device_idle_pct.confidence"]["unit"] == "%"
    assert "idle_gaps" in r["breakdown"]
