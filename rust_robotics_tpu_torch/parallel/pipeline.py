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

The JAX package's second mechanism, `pipeline_shard_map` (a systolic ring
of `ppermute` shifts inside one compiled program), is a multi-device
collective; it belongs with the port's distributed code, on
`torch.distributed`, and is not here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch

from rust_robotics_tpu_torch._device import resolve_device


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
