"""Where an entry point puts the tensors it creates.

The port runs on the GPU. An entry point that creates tensors places them on
`cuda` unless the caller asks for another device; without a GPU it raises
rather than carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (default `cuda`) as a `torch.device`; raises on `cuda`
    when no GPU is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device
