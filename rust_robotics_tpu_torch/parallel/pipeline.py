"""Pipeline parallelism: GPipe-style microbatch schedules over devices.

The port of rust_robotics_tpu/parallel/pipeline.py (reference surface: the
VIO pipeline's strictly sequential stage composition, slam/src/
vio_pipeline.rs:176 — preintegration → BA → state refinement → pose-graph
fusion, over keyframe windows :296-316).

`run_pipelined` is the host-orchestrated GPipe schedule for heterogeneous
stages, each pinned to its own device: the host launches work in diagonal
tick order (window i enters stage s at tick i + s); CUDA launches are
asynchronous, so stage s of window i can run on device s while stage s − 1
of window i + 1 runs on device s − 1. Chain stages (carrying state across
windows, e.g. pose-graph fusion) serialize only along their own stage row.
The result is the sequential composition's: the same calls in the same
order per dependency chain, so bitwise equal to `run_sequential`.

`pipeline_shard_map` is the systolic pipeline for homogeneous stages: S
ranks on a 'pipe' mesh axis, microbatches streaming through ring shifts
(`parallel/mesh.py::ppermute` on `torch.distributed`), with no host
schedule between the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch.parallel.mesh import axis_index, axis_size, broadcast, ppermute


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage.

    fn: `fn(x) -> y` when chain=False; `fn(carry, x) -> (carry, y)` when
    chain=True (state threads across windows in order — the fusion stage).
    """

    fn: Callable
    chain: bool = False
    init_carry: Any = None


def pipeline_schedule(num_windows: int, num_stages: int):
    """[(tick, stage, window)] of the GPipe diagonal: window i runs stage s
    at tick i + s. Total ticks = W + S - 1 vs W·S sequential slots."""
    out = []
    for t in range(num_windows + num_stages - 1):
        for s in range(num_stages):
            w = t - s
            if 0 <= w < num_windows:
                out.append((t, s, w))
    return out


def _to_device(x, device):
    """x moved to `device`: a tensor by `.to`, a dict, list or tuple item by
    item, a dataclass field by field; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, device) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _to_device(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x)})
    return x


def run_pipelined(stages: Sequence[Stage], windows: List[Any],
                  devices: Optional[Sequence[torch.device]] = None,
                  record: Optional[list] = None):
    """Run every window through all stages on the GPipe schedule.

    devices: one per stage, cycled (default: the one card, cuda). Inputs
    to stage s, and its carry, are moved onto its device, so each stage
    runs where its operands live. `record` (if given) collects the launch
    order [(tick, stage, window)].

    Returns the list of final-stage outputs per window (the values of the
    sequential loop `for w: for s: ...`)."""
    n_w = len(windows)
    n_s = len(stages)
    if devices is None:
        devices = [resolve_device()]
    devices = [devices[s % len(devices)] for s in range(n_s)]

    vals = {s: [None] * n_w for s in range(1, n_s + 1)}  # stage-input buffers
    carries = [st.init_carry for st in stages]
    for t, s, w in pipeline_schedule(n_w, n_s):
        x = _to_device(windows[w] if s == 0 else vals[s][w], devices[s])
        st = stages[s]
        if st.chain:
            carries[s], y = st.fn(_to_device(carries[s], devices[s]), x)
        else:
            y = st.fn(x)
        vals[s + 1][w] = y
        if record is not None:
            record.append((t, s, w))
    return vals[n_s]


def run_sequential(stages: Sequence[Stage], windows: List[Any]):
    """Plain window-major composition — the oracle the pipeline must match
    (vio_pipeline.rs's stage order)."""
    carries = [st.init_carry for st in stages]
    outs = []
    for x in windows:
        for s, st in enumerate(stages):
            if st.chain:
                carries[s], x = st.fn(carries[s], x)
            else:
                x = st.fn(x)
        outs.append(x)
    return outs


# ---------------------------------------------------------------------------
# the systolic pipeline (ring shifts over a mesh axis)
# ---------------------------------------------------------------------------

def pipeline_shard_map(stage_fn: Callable, xs, mesh, axis_name: str = "pipe"):
    """Stream microbatches through the S ranks of `axis_name`.

    stage_fn(stage_index, x) -> y must keep x's shape and dtype. xs [W, ...]
    (the same on every rank) enter at stage 0. Each rank runs W + S − 1
    ticks of (inject → its stage → shift one rank right along the ring);
    window i leaves the last stage at tick i + S − 1, and the last stage's
    outputs are broadcast, so every rank returns [W, ...]:
    stage_{S-1}(...stage_0(x)) per microbatch (JAX `pipeline_shard_map`)."""
    s = axis_size(mesh, axis_name)
    stage = axis_index(mesh, axis_name)
    w = xs.shape[0]
    ring = [(i, (i + 1) % s) for i in range(s)]
    h = torch.zeros_like(xs[0])
    outs = []
    for t in range(w + s - 1):
        x = xs[t if t < w else 0] if stage == 0 else h
        y = stage_fn(stage, x)
        h = ppermute(y, mesh, axis_name, ring)
        if t >= s - 1:
            outs.append(y)
    return broadcast(torch.stack(outs), mesh, axis_name, src=s - 1)
