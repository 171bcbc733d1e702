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
    than one call per side.  Step 3's volume has 4.5 cm voxels in blocks
    of 8 (blocks of 0.36 m, a truncation of 0.18 m, so that no face of the
    room lies on a block boundary) and room for 4 096 blocks."""
    from benchmark import core

    m = core.load_manifest()
    entry = core.find_cell(m, cell)
    config = copy.deepcopy(core.load_config(m, entry["config"]))
    traffic = copy.deepcopy(core.load_traffic(entry["traffic"]))
    config["reconstruction"]["confidence_estimation"]["target_frame_range"] = 3
    config["reconstruction"]["depth_integration"].update(
        voxel_size=0.045, block_resolution=8, trunc_voxel_multiplier=4.0, block_count=4096)
    config["assumed"]["reconstruction.depth_integration.grid_dim"]["value"] = 64
    traffic.update(frames_per_side=76, depth_width=80, depth_height=72)
    return config, traffic


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
