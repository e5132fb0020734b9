"""Where an entry point puts the tensors it creates.

The port runs on the GPU. An entry point that creates tensors places them on
`cuda` unless the caller asks for another device; without a GPU it raises
rather than carrying on quietly on the CPU. The underscored helpers turn
host data or tensors into tensors placed by that rule.
"""

from __future__ import annotations

import numpy as np
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


def to_tensor(array, device=None, dtype=torch.float32):
    """One numpy array (or tensor) -> a tensor on `device` in `dtype`."""
    if isinstance(array, torch.Tensor):
        return array.to(device=resolve_device(device), dtype=dtype)
    return torch.tensor(np.asarray(array), dtype=dtype, device=resolve_device(device))


def _placement(x, device):
    """The device for tensors made from `x`: a tensor's own unless `device`
    is given; host data goes to `device` (default `cuda`)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.device
    return resolve_device(device)


def _bool_on(x, device=None):
    """x as a bool tensor placed by `_placement`."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # torch warns on a read-only array
    return torch.as_tensor(x, device=_placement(x, device)).to(torch.bool)


def _float_on(x, device=None, dtype=torch.float32):
    """x as a `dtype` tensor placed by `_placement`; host numbers pass
    through float64 (a Python list would otherwise round to float32)."""
    device = _placement(x, device)
    if not isinstance(x, torch.Tensor):
        x = np.array(x, dtype=np.float64)
    return torch.as_tensor(x, device=device).to(dtype)


def _host_bool(x):
    """x as a host NumPy bool array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(bool)
    return np.asarray(x, bool)
