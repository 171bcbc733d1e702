"""Fixtures of the benchmark's tests: cells cut to a size the CPU runs in
seconds, and the card for the tests that need one."""

from __future__ import annotations

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def tiny_cell(cell: str):
    """(config, traffic) of `cell` cut for the CPU: small frames and a
    short confidence window; enough frames for the check to sample more
    than one call per side."""
    from benchmark import core

    m = core.load_manifest()
    entry = core.find_cell(m, cell)
    config = copy.deepcopy(core.load_config(m, entry["config"]))
    traffic = copy.deepcopy(core.load_traffic(entry["traffic"]))
    config["reconstruction"]["confidence_estimation"]["target_frame_range"] = 3
    traffic.update(frames_per_side=76, depth_width=80, depth_height=72)
    return config, traffic


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
