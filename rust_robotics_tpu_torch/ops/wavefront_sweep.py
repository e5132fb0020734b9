"""Batched wavefront relaxation sweeps: kernel B2 and its twin.

The port of rust_robotics_tpu/ops/wavefront_pallas.py. `wavefront_sweeps`
runs K Jacobi min-plus sweeps over B cost fields [B, W, H] and reports, per
map, whether any cell got cheaper:

- on CUDA tensors it launches the hand-written kernel
  `csrc/wavefront_sweep.cu`, or raises. A map whose field and bit plane fit
  one block's shared memory is swept by one block for all K sweeps (the
  resident variant); a larger one is swept once per launch in 2-D tiles
  (the tiled variant, K launches);
- on CPU tensors it runs `wavefront_sweeps_plain`, the twin: the arithmetic
  of planning/wavefront.py's sweep, direction by direction.

The only arithmetic is `d[neighbour] + c` and `min`, so the kernel, the twin
and the JAX path give bitwise the same field.

Which moves are allowed is one uint8 plane: bit i of a cell is
`_incoming_masks(...)[i]`, direction i being `OFFSETS[i]`
(planning/wavefront.py's MOTIONS_8 order; 4-connectivity uses bits 0-3).

`relax_wavefront` is the convergence loop around the sweeps, shared by
`planning.wavefront.wavefront_costs` and `wavefront_costs_fused`, the
counterpart of `wavefront_costs_pallas`. `wavefront_sweeps.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from rust_robotics_tpu_torch.ops import _build
from rust_robotics_tpu_torch.planning.wavefront import (
    SQRT2,
    _incoming_masks,
    _motions,
    _shift,
)

OFFSETS = ((1, 0), (0, 1), (-1, 0), (0, -1), (-1, -1), (-1, 1), (1, -1), (1, 1))
# The resident variant: 1024 threads, each holding at most 16 cells' new
# values in registers (kThreads, kPerThread in csrc/wavefront_sweep.cu), and
# the field plus the bit plane in one block's shared memory.
RESIDENT_MAX_CELLS = 1024 * 16
MAX_TILED_MAPS = 65535  # gridDim.z of the tiled variant

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURE = ([_P] * 5 + [_I] * 5 + [_D] * 3 + [_P], ctypes.c_int)
_ENTRIES = {
    (torch.float32, "resident"): "wavefront_resident_f32",
    (torch.float64, "resident"): "wavefront_resident_f64",
    (torch.float32, "tiled"): "wavefront_tiled_f32",
    (torch.float64, "tiled"): "wavefront_tiled_f64",
}


def sentinel(dtype) -> float:
    """The 'unreached' value, finfo.max/4 (so that sentinel + c stays finite)."""
    return torch.finfo(dtype).max / 4


def incoming_bits(masks):
    """Pack the direction masks (bool, one per direction) into one uint8
    plane, bit i = masks[i]."""
    bits = torch.zeros(masks[0].shape, dtype=torch.uint8, device=masks[0].device)
    for i, m in enumerate(masks):
        bits |= m.to(torch.uint8) << i
    return bits


def resident_fits(w: int, h: int, dtype) -> bool:
    """Whether a [W, H] map is swept by the resident variant."""
    cells = w * h
    itemsize = torch.empty((), dtype=dtype).element_size()
    return cells <= RESIDENT_MAX_CELLS and cells * (itemsize + 1) <= _build.SHARED_BYTES_PER_BLOCK


def _check(d, bits, k, costs):
    for name, x in (("d", d), ("bits", bits)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d.ndim != 3 or bits.shape != d.shape:
        raise ValueError(f"d and bits must both be [B, W, H]; got {tuple(d.shape)}, "
                         f"{tuple(bits.shape)}")
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"d must be float32 or float64, got {d.dtype}")
    if bits.dtype != torch.uint8:
        raise TypeError(f"bits must be uint8, got {bits.dtype}")
    if d.device != bits.device:
        raise ValueError(f"mixed devices: d on {d.device}, bits on {bits.device}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if len(costs) not in (4, 8):
        raise ValueError(f"costs must hold 4 or 8 direction costs, got {len(costs)}")


def wavefront_sweeps(d, bits, k: int, costs):
    """K Jacobi relaxation sweeps of B cost fields; returns (new d [B, W, H],
    changed [B] bool: some cell of the map got cheaper).

    d [B, W, H] float32 or float64 (the sentinel where unreached); bits
    [B, W, H] uint8 (bit i: the move from OFFSETS[i] into the cell is
    allowed); costs: one cost per direction, 4 or 8 of them, the first four
    equal and the rest equal. On CUDA a map that fits one block's shared
    memory (`resident_fits`) takes the resident kernel, a larger one the
    tiled kernel.
    """
    _check(d, bits, k, costs)
    if d.device.type == "cpu":
        return wavefront_sweeps_plain(d, bits, k, costs)
    if d.device.type != "cuda":
        raise ValueError(f"wavefront_sweeps runs on cuda or cpu, not {d.device}")
    straight, diagonal = float(costs[0]), float(costs[-1])
    if any(float(c) != straight for c in costs[:4]) or any(float(c) != diagonal for c in costs[4:]):
        raise ValueError(f"the kernel takes one straight and one diagonal cost, got {tuple(costs)}")
    b, w, h = d.shape
    variant = "resident" if resident_fits(w, h, d.dtype) else "tiled"
    if variant == "tiled" and b > MAX_TILED_MAPS:
        raise ValueError(f"the tiled variant takes at most {MAX_TILED_MAPS} maps, got {b}")
    out = torch.empty_like(d)
    changed = torch.zeros(b, dtype=torch.uint8, device=d.device)
    if d.numel() == 0:
        return out, changed.bool()
    scratch = torch.empty_like(d) if variant == "tiled" and k > 1 else None
    lib = _build.load("wavefront_sweep", {name: _SIGNATURE for name in _ENTRIES.values()})
    kernel = getattr(lib, _ENTRIES[(d.dtype, variant)])
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(
            d.data_ptr(), bits.data_ptr(), out.data_ptr(), changed.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, w, h, k, len(costs), straight, diagonal, sentinel(d.dtype), stream,
        )
    if err != 0:
        raise RuntimeError(f"wavefront_sweep kernel launch failed with CUDA error {err}")
    wavefront_sweeps.launches += 1 if variant == "resident" else k
    return out, changed.bool()


wavefront_sweeps.launches = 0


def wavefront_sweeps_plain(d, bits, k: int, costs):
    """The kernel's plain-PyTorch twin, the sweep of planning/wavefront.py:
    best = min(best, where(allowed, shift(d) + c, sentinel)) over the
    directions, K times. Same arguments and results as `wavefront_sweeps`."""
    big = sentinel(d.dtype)
    masks = [((bits >> i) & 1).bool() for i in range(len(costs))]
    new = d
    for _ in range(k):
        best = new
        for (dx, dy), c, m in zip(OFFSETS, costs, masks):
            cand = _shift(new, dx, dy, big) + c
            best = torch.minimum(best, torch.where(m, cand, big))
        new = best
    return new, (new < d).flatten(1).any(1)


def relax_wavefront(free, goals, motions, corner_cutting, max_iters, k, dtype):
    """Cost-to-go fields [..., W, H] (inf where unreachable) by K-sweep
    blocks of `wavefront_sweeps` until a block changes nothing or
    `max_iters` sweeps have run (the JAX `while_loop`: the test reads every
    map's flag after each block, one small copy to the host)."""
    free, goals = torch.broadcast_tensors(free.to(torch.bool), goals.to(torch.bool))
    shape = free.shape
    w, h = shape[-2], shape[-1]
    big = sentinel(dtype)
    bits = incoming_bits(_incoming_masks(free, motions, corner_cutting))
    bits = bits.reshape(-1, w, h).contiguous()
    d = torch.full(shape, big, dtype=dtype, device=free.device).masked_fill_(goals & free, 0.0)
    d = d.reshape(-1, w, h)
    if max_iters is None:
        max_iters = w * h  # worst-case path length bound
    costs = tuple(c for _, _, c in motions)
    changed, it = True, 0
    while changed and it < max_iters:
        d, flags = wavefront_sweeps(d, bits, k, costs)
        changed = bool(flags.any())
        it += k
    return torch.where(d >= big, torch.inf, d).reshape(shape)


def wavefront_costs_fused(free, goals, connectivity: int = 8, corner_cutting: bool = False,
                          max_iters: int | None = None, diag_cost: float | None = None,
                          k_sweeps: int = 16, dtype=torch.float32):
    """The counterpart of `wavefront_costs_pallas`: `wavefront_costs` with
    K = `k_sweeps` sweeps per launch. free, goals [B, W, H] or [W, H] bool;
    returns the cost-to-go field of the same shape, inf where unreachable."""
    motions = _motions(connectivity, SQRT2 if diag_cost is None else diag_cost)
    return relax_wavefront(free, goals, motions, corner_cutting, max_iters, k_sweeps, dtype)
