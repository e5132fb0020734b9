"""Small dense algebra for the controllers, written as elementwise ops.

A controller's lanes (a fleet of vehicles, a batch of problems, MPPI's
samples) run in lock-step, and a lane must equal its solo run bit for bit.
A batched cuBLAS product or a reduction kernel may pick another summation
order for another batch size, so the products and sums here are explicit
adds of whole slices: `mm`/`mv` sum over k left to right, `rsum` adds
left to right up to 8 terms and pairwise (padded with zeros) beyond, and
`solve_small` is Gaussian elimination with partial pivoting (the first
largest pivot, as LAPACK's `getrf`) unrolled over n. None of them reads
the device, and none goes through a matmul, so TF32 cannot touch them.
"""

from __future__ import annotations

import collections

import torch

from rust_robotics_tpu_torch._device import _float_on
from rust_robotics_tpu_torch._graphs import Graphed

# a fixpoint loop reads its lanes' done flags once every this many steps
READ_EVERY = 8


def mm(a, b):
    """a [..., m, k] @ b [..., k, n] as an explicit sum over k, left to right."""
    terms = (a[..., :, :, None] * b[..., None, :, :]).unbind(-2)
    out = terms[0]
    for term in terms[1:]:
        out = out + term
    return out


def mv(a, v):
    """a [..., m, k] @ v [..., k]."""
    return mm(a, v[..., None])[..., 0]


def mt(a):
    """The transpose of the last two axes."""
    return a.transpose(-1, -2)


def rsum(x, dim=-1):
    """Σ over `dim`: left to right up to 8 terms, else pairwise halves
    (padded with zeros to even lengths)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    if n <= 8:
        terms = x.unbind(0)
        out = terms[0]
        for term in terms[1:]:
            out = out + term
        return out
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def dot(a, b):
    """Σ a·b over the last axis."""
    return rsum(a * b, -1)


def solve_small(a, b):
    """a [..., n, n] x = b ([..., n] or [..., n, k]) by elimination with
    partial pivoting; n = 1 is the division LU's solve reduces to."""
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    n = a.shape[-1]
    if n == 1:
        x = b / a[..., :1, :1]
        return x[..., 0] if vec else x
    rows = [torch.cat([a[..., i, :], b[..., i, :]], -1) for i in range(n)]
    for k in range(n):
        piv_val, piv_idx = rows[k][..., k].abs(), torch.zeros_like(rows[k][..., k], dtype=torch.int8)
        for i in range(k + 1, n):
            v = rows[i][..., k].abs()
            better = v > piv_val
            piv_val = torch.where(better, v, piv_val)
            piv_idx = torch.where(better, torch.full_like(piv_idx, i - k), piv_idx)
        pivot = rows[k]
        for i in range(k + 1, n):
            here = (piv_idx == i - k)[..., None]
            pivot, rows[i] = torch.where(here, rows[i], pivot), torch.where(here, rows[k], rows[i])
        rows[k] = pivot
        for i in range(k + 1, n):
            f = rows[i][..., k] / pivot[..., k]
            rows[i] = rows[i] - f[..., None] * pivot
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = rows[i][..., n:]
        for j in range(i + 1, n):
            acc = acc - rows[i][..., j, None] * xs[j]
        xs[i] = acc / rows[i][..., i, None]
    x = torch.stack(xs, -2)
    return x[..., 0] if vec else x


def inv_small(a):
    """a⁻¹ for small a [..., n, n] (`solve_small` against the identity)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    return solve_small(a, eye)


def take_rows(points, idx):
    """points [..., N, d] at idx [...] → [..., d], with the batch dims of
    `points` and `idx` broadcast (a path shared by a fleet)."""
    batch = torch.broadcast_shapes(points.shape[:-2], idx.shape)
    pts = points.expand(batch + points.shape[-2:])
    i = idx.expand(batch)[..., None, None].expand(batch + (1, points.shape[-1]))
    return torch.gather(pts, -2, i)[..., 0, :]


def take(values, idx):
    """values [..., N] at idx [...] → [...], batch dims broadcast."""
    batch = torch.broadcast_shapes(values.shape[:-1], idx.shape)
    return torch.gather(values.expand(batch + values.shape[-1:]), -1,
                        idx.expand(batch)[..., None])[..., 0]


def at(x, i):
    """x[i] for an index tensor i of any shape (0-d too), gathered on the
    device with no read."""
    return x.index_select(0, i.reshape(-1)).reshape(i.shape + x.shape[1:])


def sqrt_sum(x):
    """sqrt(Σ x) over the last axis (a norm when x holds squares)."""
    return torch.sqrt(rsum(x, -1))


def set_last(x, i, value):
    """x with x[..., i] replaced by value [...] (no in-place write)."""
    return torch.cat([x[..., :i], value[..., None].to(x.dtype), x[..., i + 1:]], -1)


def _masked_block(step, x, done, iterations, tol):
    """`iterations` masked steps with no read: a lane's flag is set by the
    step that converges it (which still applies) and freezes it after."""
    for _ in range(iterations):
        xn = step(x)
        conv = torch.amax(torch.abs(xn - x), dim=(-2, -1)) < tol
        x = torch.where(done[..., None, None], x, xn)
        done = done | conv
    return x, done


def masked_fixpoint(step, x0, iterations, tol):
    """x ← step(x) over leading batch dims until max|step(x) − x| < tol
    or `iterations`; each lane stops at its own flag (the step that sets
    it still applies, as in JAX's `while_loop`), and the flags are read
    once every READ_EVERY iterations."""
    x = x0
    done = torch.zeros(x0.shape[:-2], dtype=torch.bool, device=x0.device)
    for _ in range(iterations // READ_EVERY):
        x, done = _masked_block(step, x, done, READ_EVERY, tol)
        if bool(done.all()):
            return x
    return _masked_block(step, x, done, iterations % READ_EVERY, tol)[0]


# the CUDA graphs of graphed_fixpoint's blocks, least recently used first
_BLOCKS = collections.OrderedDict()
BLOCKS_KEPT = 8


def graphed_fixpoint(make_step, inputs, x0, iterations, tol):
    """masked_fixpoint(make_step(*inputs), x0, iterations, tol). On CUDA
    tensors each block of READ_EVERY iterations is one replay of a CUDA
    graph of that block (the same kernels in the same order, so bitwise
    the eager loop); the graphs of the last BLOCKS_KEPT keys (make_step,
    tol, and the shapes, dtypes and devices of inputs and x0) are kept."""
    if not x0.is_cuda:
        return masked_fixpoint(make_step(*inputs), x0, iterations, tol)
    key = (make_step, tol, *((t.shape, t.dtype, t.device) for t in (*inputs, x0)))
    done = torch.zeros(x0.shape[:-2], dtype=torch.bool, device=x0.device)
    block = _BLOCKS.pop(key, None)
    if block is None:
        block = Graphed(lambda *a: _masked_block(make_step(*a[:-2]), a[-2], a[-1], READ_EVERY,
                                                 tol), *inputs, x0, done)
    _BLOCKS[key] = block
    while len(_BLOCKS) > BLOCKS_KEPT:
        _BLOCKS.popitem(last=False)
    x = x0
    for _ in range(iterations // READ_EVERY):
        x, done = block(*inputs, x, done)
        if bool(done.all()):
            return x.clone()
    return _masked_block(make_step(*inputs), x.clone(), done.clone(), iterations % READ_EVERY,
                         tol)[0]


def as_float(x, dtype=None, device=None):
    """x as a float tensor: on `device` (default cuda; a tensor's own
    unless `device` is given), in `dtype` (default a float tensor's own,
    else torch's default dtype). Host numbers pass through float64."""
    if dtype is None:
        floating = isinstance(x, torch.Tensor) and x.is_floating_point()
        dtype = x.dtype if floating else torch.get_default_dtype()
    return _float_on(x, device, dtype)
