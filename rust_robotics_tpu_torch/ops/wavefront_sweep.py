"""Batched wavefront relaxation sweeps: kernel B2 and its twins.

The port of rust_robotics_tpu/ops/wavefront_pallas.py. Two entries launch
the hand-written kernel `csrc/wavefront_sweep.cu` on CUDA tensors (or
raise), once per call:

- `wavefront_relax` sweeps each of B cost fields [B, W, H] until one sweep
  lowers none of its cells or a cap is reached, and reports the sweeps each
  map ran. Its twin is `wavefront_relax_plain`.
- `wavefront_sweeps` runs K sweeps and reports, per map, whether any cell
  got cheaper: the same launch with the cap at K. Its twin is
  `wavefront_sweeps_plain`, the arithmetic of planning/wavefront.py's
  sweep, direction by direction.

On CPU tensors each entry runs its twin. A map whose field and bit plane
fit one block's shared memory is swept by one block (the resident
variant): in f32, where the map fits 32 warps of 32 rows x 16 columns
(`registers_fit`), with the field in registers (the register body), else
in shared memory. A larger map is swept in 2-D tiles by one persistent
cooperative launch (the tiled variant).

The only arithmetic is adds and mins. The twins add each direction's cost
to its neighbour, as the JAX path does; the kernel adds each cost once, to
the least allowed neighbour of its kind (straight or diagonal), which
rounds to the same value (csrc/wavefront_sweep.cu). So all give bitwise
the same field on fields whose values are at most the sentinel, none NaN
or -0: what `relax_wavefront` builds (0 and the sentinel).

Which moves are allowed is one uint8 plane: bit i of a cell is
`_incoming_masks(...)[i]`, direction i being `OFFSETS[i]`
(the MOTIONS_8 order of ops/stencil.py; 4-connectivity uses bits 0-3).

`relax_wavefront` is the convergence loop, shared by
`planning.wavefront.wavefront_costs` and `wavefront_costs_fused`, the
counterpart of `wavefront_costs_pallas`. `<entry>.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from rust_robotics_tpu_torch.ops import _build
from rust_robotics_tpu_torch.ops.stencil import (
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
# The register body: one warp per 32 rows (y) x 16 columns (x), at most 32
# warps (kStrip, kWarps in csrc/wavefront_sweep.cu)
REGISTER_STRIP, REGISTER_MAX_WARPS = 16, 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURE = ([_P] * 7 + [_I] * 5 + [_D] * 3 + [_P], ctypes.c_int)
_ENTRIES = {
    (torch.float32, "registers"): "wavefront_registers_f32",
    (torch.float32, "resident"): "wavefront_resident_f32",
    (torch.float64, "resident"): "wavefront_resident_f64",
    (torch.float32, "tiled"): "wavefront_tiled_f32",
    (torch.float64, "tiled"): "wavefront_tiled_f64",
}
_SIGNATURES = {name: _SIGNATURE for name in _ENTRIES.values()} | {
    "wavefront_error_name": ([_I], ctypes.c_char_p)}


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


def registers_fit(w: int, h: int, dtype) -> bool:
    """Whether a [W, H] map takes the resident variant's register body: f32
    (f64's 32 field registers a thread would spill), and at most
    REGISTER_MAX_WARPS warps of 32 rows x REGISTER_STRIP columns."""
    return (dtype == torch.float32
            and -(-h // 32) * -(-w // REGISTER_STRIP) <= REGISTER_MAX_WARPS)


def body(w: int, h: int, dtype) -> str:
    """Which kernel body sweeps a [W, H] map: "registers", "resident"
    (shared memory) or "tiled"."""
    if registers_fit(w, h, dtype):
        return "registers"
    return "resident" if resident_fits(w, h, dtype) else "tiled"


def sweep_cap(max_iters: int, k: int) -> int:
    """The sweeps the JAX loop runs on a map that never converges: K-sweep
    blocks while fewer than `max_iters` sweeps have run, K·⌈max_iters/K⌉,
    and none when max_iters <= 0."""
    return k * -(-max_iters // k) if max_iters > 0 else 0


def _check(d, bits, costs):
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
    if d.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the wavefront sweeps run on cuda or cpu, not {d.device}")
    if len(costs) not in (4, 8):
        raise ValueError(f"costs must hold 4 or 8 direction costs, got {len(costs)}")


def _launch(d, bits, costs, cap: int):
    """One launch of the kernel body `body` names, on CUDA tensors, each
    map swept until a sweep lowers none of its cells or `cap` (>= 1) sweeps
    have run: (field, changed [B] bool, sweeps [B] int32). Raises on a
    refused launch; reads nothing back."""
    straight, diagonal = float(costs[0]), float(costs[-1])
    if any(float(c) != straight for c in costs[:4]) or any(float(c) != diagonal for c in costs[4:]):
        raise ValueError(f"the kernel takes one straight and one diagonal cost, got {tuple(costs)}")
    # the kernel adds each cost once to the least allowed neighbour, where a
    # direction that is not allowed offers the sentinel: exact only if the
    # sentinel plus a cost rounds back to the sentinel
    big = torch.tensor(sentinel(d.dtype), dtype=d.dtype)
    if any(not bool(big + c == big) for c in {straight, diagonal}):
        raise ValueError(f"costs {tuple(costs)} do not vanish beside the sentinel {float(big)!r} "
                         f"in {d.dtype}")
    b, w, h = d.shape
    variant = body(w, h, d.dtype)
    out = torch.empty_like(d)
    changed = torch.empty(b, dtype=torch.uint8, device=d.device)
    sweeps = torch.empty(b, dtype=torch.int32, device=d.device)
    # the tiled variant's ping-pong buffer, and per map (and over all maps)
    # the last sweep that lowered a cell
    scratch = torch.empty_like(d) if variant == "tiled" else None
    state = torch.empty(b + 1, dtype=torch.int32, device=d.device) if variant == "tiled" else None
    lib = _build.load("wavefront_sweep", _SIGNATURES)
    with torch.cuda.device(d.device):
        err = getattr(lib, _ENTRIES[(d.dtype, variant)])(
            d.data_ptr(), bits.data_ptr(), out.data_ptr(), changed.data_ptr(),
            sweeps.data_ptr(), None if scratch is None else scratch.data_ptr(),
            None if state is None else state.data_ptr(), b, w, h, cap, len(costs),
            straight, diagonal, sentinel(d.dtype), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"wavefront_sweep kernel launch failed with CUDA error {err} "
                           f"({lib.wavefront_error_name(err).decode()})")
    return out, changed.bool(), sweeps


def wavefront_relax(d, bits, costs, max_sweeps: int):
    """Relax each of B cost fields until one sweep lowers none of its cells,
    or until it has run `max_sweeps` sweeps; returns (new d [B, W, H],
    sweeps [B] int32: the sweeps each map ran).

    d [B, W, H] float32 or float64, every value at most the sentinel (the
    sentinel where unreached), none NaN or -0; bits
    [B, W, H] uint8 (bit i: the move from OFFSETS[i] into the cell is
    allowed); costs: one cost per direction, 4 or 8 of them, the first four
    equal and the rest equal. On CUDA one launch, with nothing read back, of
    the kernel body `body` names. With max_sweeps =
    `sweep_cap(max_iters, K)` the field is bitwise that of the JAX loop of
    K-sweep blocks (see csrc/wavefront_sweep.cu).
    """
    _check(d, bits, costs)
    if max_sweeps < 0:
        raise ValueError(f"max_sweeps must be at least 0, got {max_sweeps}")
    if d.device.type == "cpu":
        return wavefront_relax_plain(d, bits, costs, max_sweeps)
    if max_sweeps == 0 or d.numel() == 0:
        return d.clone(), torch.zeros(d.shape[0], dtype=torch.int32, device=d.device)
    out, _, sweeps = _launch(d, bits, costs, max_sweeps)
    wavefront_relax.launches += 1
    return out, sweeps


wavefront_relax.launches = 0


def wavefront_relax_plain(d, bits, costs, max_sweeps: int):
    """The twin of `wavefront_relax`: one sweep of `wavefront_sweeps_plain`
    at a time over the maps still lowering a cell. Same arguments and
    results."""
    sweeps = torch.zeros(d.shape[0], dtype=torch.int32, device=d.device)
    live = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    for _ in range(max_sweeps):
        new, lowered = wavefront_sweeps_plain(d, bits, 1, costs)
        d = torch.where(live[:, None, None], new, d)
        sweeps += live.to(torch.int32)
        live &= lowered
        if not bool(live.any()):
            break
    return d, sweeps


def wavefront_sweeps(d, bits, k: int, costs):
    """K Jacobi relaxation sweeps of B cost fields; returns (new d [B, W, H],
    changed [B] bool: some cell of the map got cheaper).

    Arguments as for `wavefront_relax`. On CUDA it is that launch with the
    cap at K: a map that stops early already holds what K sweeps give.
    """
    _check(d, bits, costs)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if d.device.type == "cpu":
        return wavefront_sweeps_plain(d, bits, k, costs)
    if d.numel() == 0:
        return d.clone(), torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
    out, changed, _ = _launch(d, bits, costs, k)
    wavefront_sweeps.launches += 1
    return out, changed


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
    """Cost-to-go fields [..., W, H] (inf where unreachable), as the JAX
    `while_loop` of K-sweep blocks computes them: until a block changes
    nothing or `max_iters` sweeps have run.

    On CUDA one `wavefront_relax` launch, each map stopping on its own,
    with nothing read back; on the CPU the JAX loop itself, reading the
    flags after each block."""
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
    if d.device.type == "cuda":
        d, _ = wavefront_relax(d, bits, costs, sweep_cap(max_iters, k))
    else:
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
    K = `k_sweeps` sweeps per convergence check. free, goals [B, W, H] or
    [W, H] bool; returns the cost-to-go field of the same shape, inf where
    unreachable."""
    motions = _motions(connectivity, SQRT2 if diag_cost is None else diag_cost)
    return relax_wavefront(free, goals, motions, corner_cutting, max_iters, k_sweeps, dtype)
