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
- `fma(a, b, c)` is a·b + c rounded once. XLA on the CPU contracts a
  product and a sum into one fused multiply-add inside a jitted function,
  and `jnp.hypot` and `jnp.linalg.norm` are jitted functions, so the
  reference rounds such sums once; torch rounds each op.
- `hypot` is `jnp.hypot`: max · sqrt(fma(q, q, 1)), q = min/max
  (`torch.hypot` calls the C library's, which rounds otherwise).
- `norm2` is `jnp.linalg.norm` over the last axis of [..., 2] vectors:
  sqrt(fma(y, y, x·x)).
- `filled` builds a small constant vector on the device by fills, with no
  copy from host memory (torch's sync debug mode counts such a copy).
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
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy(force=True))))
    return torch.sqrt(x)


def _split(a):
    """Veltkamp's split of float64 a into hi + lo, 26 bits each."""
    t = a * 134217729.0  # 2**27 + 1
    hi = t - (t - a)
    return hi, a - hi


def fma(a, b, c):
    """a·b + c rounded once (a, b, c broadcastable, float32 or float64).

    float32: the product is exact in float64 and the sum rounds there
    before the float32 rounding. float64: a·b = p + e exactly (Dekker's
    product on Veltkamp's split; each op is its own rounding, so nothing
    contracts it), p + c = s + t exactly (Knuth's sum), and the result is
    s + (t + e)."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def hypot(a, b):
    """`jnp.hypot(a, b)` for real tensors of one dtype and device."""
    a, b = torch.abs(a), torch.abs(b)
    inf = torch.isposinf(a) | torch.isposinf(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0
    q = lo / torch.where(zero, torch.ones_like(hi), hi)
    out = torch.where(zero, hi, hi * sqrt_rn(fma(q, q, torch.ones_like(q))))
    return torch.where(inf, torch.inf, out)


def norm2(v):
    """|v| over the last axis of [..., 2] vectors, as `jnp.linalg.norm`."""
    x, y = v[..., 0], v[..., 1]
    return sqrt_rn(fma(y, y, x * x))


def filled(values, dtype, device):
    """[len(values)] tensor of host numbers, one fill each on `device`."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])
