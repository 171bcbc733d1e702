"""Fixtures of the benchmark's tests: each kind of work's CPU pieces
(tiny/<entry>.py), cells cut by them to a size the CPU runs in seconds,
and the card for the tests that need one."""

from __future__ import annotations

import copy
import functools
import importlib.util
from pathlib import Path

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@functools.cache
def tiny(entry: str):
    """The CPU pieces of the kind of work `entry`, found by its name in
    tiny/<entry>.py: `cut(config, traffic)`, the cut for the CPU;
    `LIMITS`, each compared number's limit at that size; `FAULTS`, each
    fault of the entry's timed path by name, a function of `monkeypatch`
    that breaks the path underneath."""
    path = Path(__file__).resolve().parent / "tiny" / f"{entry}.py"
    spec = importlib.util.spec_from_file_location(f"tiny_{entry}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_cell(cell: str):
    """(config, traffic) of `cell` cut for the CPU by its entry's tiny
    piece."""
    from benchmark import core

    m = core.load_manifest()
    entry = core.find_cell(m, cell)
    config = copy.deepcopy(core.load_config(m, entry["config"]))
    traffic = copy.deepcopy(core.load_traffic(entry["traffic"]))
    tiny(traffic["entry"]).cut(config, traffic)
    return config, traffic


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
