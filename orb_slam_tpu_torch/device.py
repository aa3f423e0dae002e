"""The device of the port's entry points.

Every entry point that builds tensors (ORBExtractor, KeypointSelector,
DetectCellsFused, empty_map, map_state_from_numpy, seed_map) takes
`device=` and builds them on the CUDA card unless the caller names another
device. Without a card it raises: it never falls back to the CPU. The CPU
tests pass `device="cpu"` explicitly.
"""

from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """`torch.device(device)`; raises RuntimeError for a CUDA device when
    no CUDA device is visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the card by default; "
            "pass device='cpu' to run its plain PyTorch path on the CPU")
    return device
