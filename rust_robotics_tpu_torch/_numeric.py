"""Small numeric helpers that keep the port's arithmetic the same on every
device.

- `linspace` builds `jnp.linspace`'s values from a zero start bit for
  bit: XLA computes them as iota × (stop/div) and puts the stop itself at
  the end, where `torch.linspace` fills from both ends.
- `true_div` divides by a Python number. CUDA's `tensor / number`
  multiplies by the number's reciprocal, which may round differently from
  the CPU's division; dividing by a 0-d tensor of the same dtype on the
  same device (made by a fill, not copied from the host) divides on both.
- `sqrt_rn` is a correctly rounded square root on every device. CUDA's
  `sqrt` is; torch's CPU `sqrt` goes through MKL's vector math, which may
  round the last bit the other way (sqrt(2.0) in float64 with torch
  2.13), so on the CPU it takes numpy's.
"""

from __future__ import annotations

import numpy as np
import torch


def linspace(stop: float, num: int, endpoint: bool = True, dtype=torch.float32, device=None):
    """`jnp.linspace(0.0, stop, num, endpoint)` in `dtype` on `device`."""
    div = num - 1 if endpoint else num
    if num <= 1:
        return torch.zeros(num, dtype=dtype, device=device)
    f = np.float64 if dtype == torch.float64 else np.float32
    # XLA folds 0·(1 − step) + stop·step, step = iota·(1/div), to
    # iota·(stop·(1/div)), the reciprocal in the working precision
    out = torch.arange(div, dtype=dtype, device=device) * float(f(stop) * (f(1.0) / f(div)))
    if endpoint:
        out = torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])
    return out


def true_div(a, value: float):
    """a / value, a true division on CPU and CUDA alike."""
    return a / torch.full((), value, dtype=a.dtype, device=a.device)


def sqrt_rn(x):
    """The correctly rounded square root of x, on CPU and CUDA alike."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy(force=True)))
    return torch.sqrt(x)
