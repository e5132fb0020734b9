"""Small constant 2-D convolutions as shifted multiply-adds.

`conv2d_same` is `scipy.signal.convolve2d(img, kernel, mode="same")` (a
true convolution, zeros padded, the centre of the full result) over any
leading batch dims. The kernel is a few host numbers; each non-zero tap is
one scaled, shifted slice of the padded image, added in row-major tap
order. Nothing goes through cuDNN, so a float32 result is full float32
whatever `torch.backends.cudnn.allow_tf32` holds (the default, True, would
round a cuDNN convolution's inputs to TF32), and the arithmetic is
elementwise, so it does not depend on the batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def conv2d_same(img, kernel):
    """img [..., H, W] convolved with kernel [kh, kw] (host numbers);
    returns [..., H, W] in img's dtype."""
    k = np.asarray(kernel, dtype=np.float64)
    kh, kw = k.shape
    h, w = img.shape[-2:]
    top, left = (kh - 1) // 2, (kw - 1) // 2
    # out[i, j] = Σ k[a, b] · img[i + top - a, j + left - b]
    padded = F.pad(img, (kw - 1 - left, left, kh - 1 - top, top))
    out = None
    for a in range(kh):
        for b in range(kw):
            if k[a, b] == 0.0:
                continue
            r, c = kh - 1 - a, kw - 1 - b
            term = float(k[a, b]) * padded[..., r:r + h, c:c + w]
            out = term if out is None else out + term
    return torch.zeros_like(img) if out is None else out
