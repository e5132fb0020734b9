"""Small constant 2-D convolutions as shifted multiply-adds.

`conv2d_same` is `scipy.signal.convolve2d(img, kernel, mode="same")` (a
true convolution, zeros padded, the centre of the full result) over any
leading batch dims. The kernel is a few host numbers; each non-zero tap is
one scaled, shifted slice of the padded image, added in row-major tap
order. Nothing goes through cuDNN, so a float32 result is full float32
whatever `torch.backends.cudnn.allow_tf32` holds (the default, True, would
round a cuDNN convolution's inputs to TF32), and the arithmetic is
elementwise, so it does not depend on the batch.

The grid motion model the wavefront planners and kernel B2 share lives
here too: `MOTIONS_8`/`MOTIONS_4`, `_shift` (a slice moved by (dx, dy),
borders filled) and `_incoming_masks` (which moves each cell may be
relaxed from).
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


SQRT2 = 1.4142135623730951

# 8-connected motion model, matching grid.rs:29-44 ordering
MOTIONS_8 = (
    (1, 0, 1.0),
    (0, 1, 1.0),
    (-1, 0, 1.0),
    (0, -1, 1.0),
    (-1, -1, SQRT2),
    (-1, 1, SQRT2),
    (1, -1, SQRT2),
    (1, 1, SQRT2),
)
MOTIONS_4 = ((1, 0, 1.0), (0, 1, 1.0), (-1, 0, 1.0), (0, -1, 1.0))


def _motions(connectivity, diag_cost):
    motions = MOTIONS_8 if connectivity == 8 else MOTIONS_4
    return tuple((dx, dy, diag_cost if (dx != 0 and dy != 0) else c) for dx, dy, c in motions)


def _shift(a, dx, dy, fill):
    """shifted[x, y] = a[x+dx, y+dy], out-of-bounds -> fill."""
    w, h = a.shape[-2], a.shape[-1]
    out = torch.full_like(a, fill)
    if abs(dx) < w and abs(dy) < h:
        out[..., max(0, -dx):w - max(0, dx), max(0, -dy):h - max(0, dy)] = \
            a[..., max(0, dx):w + min(0, dx), max(0, dy):h + min(0, dy)]
    return out


def _incoming_masks(free, motions, corner_cutting):
    """allowed[d][x,y]: may cell (x,y) be relaxed from neighbour (x+dx,y+dy)?

    Encodes grid.rs:206-236 `is_valid_step` for the incoming move
    (x+dx,y+dy) -> (x,y): both endpoints free; a diagonal move also needs
    the two orthogonal side cells free (no corner cutting) unless
    `corner_cutting` is True.
    """
    masks = []
    for dx, dy, _ in motions:
        m = free & _shift(free, dx, dy, False)
        if dx != 0 and dy != 0 and not corner_cutting:
            m = m & _shift(free, dx, 0, False) & _shift(free, 0, dy, False)
        masks.append(m)
    return masks
