"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  They run on the CPU
only when the caller asks for ``"cpu"``; a request for the card on a machine
without one raises instead of falling back.
"""

from __future__ import annotations

import torch

# Device strings of the reference YAMLs.  The JAX package maps every one of
# them to its accelerator (mq3d_tpu/config/configs.py get_available_device);
# here the accelerator is the CUDA card.
_ACCELERATOR_ALIASES = ("tpu", "gpu", "cuda", "cpu", "auto", "any", "default")


def resolve_device(device) -> torch.device:
    """``"cpu"`` -> CPU; ``"cuda"``/``"cuda:N"`` -> that card, or raise when
    CUDA is unavailable.  Anything else raises."""
    dev = torch.device(device) if not isinstance(device, torch.device) else device
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def config_device(device_str: str) -> torch.device:
    """Map a YAML ``device`` value to the card.

    The reference's strings ("tpu", "CPU:0", "CUDA:0", "auto", ...) all name
    the default compute device, which for this package is the CUDA card.  The
    result is not checked for availability here: the entry point that uses it
    does (resolve_device), so a config parses on any machine.
    """
    s = str(device_str).strip().lower()
    plat, _, idx = s.partition(":")
    if plat not in _ACCELERATOR_ALIASES:
        raise ValueError(f"unknown device {device_str!r} in config")
    index = int(idx) if idx.isdigit() and plat in ("cuda", "gpu") else 0
    return torch.device("cuda", index)
