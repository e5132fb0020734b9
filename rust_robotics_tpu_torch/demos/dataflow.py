"""Deterministic dataflow runtime + the path-planning/EKF node family.

The port of rust_robotics_tpu/demos/dataflow.py. Reference: the dora-rs
dataflow examples (crates/rust_robotics/examples/
dora_path_planning_dataflow.yml:1-22 and dora_path_planning_node.rs /
dora_path_metrics_node.rs / dora_path_planning_sink.rs / dora_ekf_node.rs):
nodes declare named inputs (timer ticks or upstream outputs) and outputs;
the runtime routes events; the planner node emits a structured JSON
path-report on every tick, the metrics node derives path statistics, the
sink collects reports, and the EKF node publishes state estimates.

The dataflow graph is host-side orchestration (like dora itself — it never
touches the device), synchronous and deterministic (events process in
topological order per tick), so dataflow runs are reproducible — the
property the reference's CI smoke tests rely on. Each node's compute is a
plain function on the device: the planner node one `wavefront_costs` call
(B2) and `extract_path` a tick, the EKF node one `ekf_step` a tick. A node
reads back only what its JSON report holds.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from rust_robotics_tpu_torch._device import _float_on, resolve_device

__all__ = [
    "DataflowSpec", "Dataflow", "Event",
    "build_path_planning_dataflow", "run_path_planning_dataflow",
    "build_ekf_dataflow",
]


@dataclasses.dataclass(frozen=True)
class Event:
    """One routed message (dora_node_api::Event::Input analog)."""

    input_id: str
    data: Any
    tick: int


@dataclasses.dataclass
class NodeSpec:
    """One `nodes:` entry of the dataflow YAML: named inputs map to either
    `timer/millis/<period>` or `<node>/<output>`."""

    node_id: str
    inputs: Dict[str, str]
    outputs: List[str]
    handler: Callable[[Event], Optional[Dict[str, Any]]]


@dataclasses.dataclass
class DataflowSpec:
    nodes: List[NodeSpec]

    def validate(self):
        ids = [n.node_id for n in self.nodes]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate node ids in {ids}")
        produced = {f"{n.node_id}/{o}" for n in self.nodes for o in n.outputs}
        for n in self.nodes:
            for name, src in n.inputs.items():
                if src.startswith("timer/millis/"):
                    int(src.rsplit("/", 1)[1])
                elif src not in produced:
                    raise ValueError(f"{n.node_id}.{name} reads unknown source {src!r}")
        return self


class Dataflow:
    """Synchronous deterministic executor for a DataflowSpec.

    Each `step()` advances virtual time by `base_millis`; timer inputs
    whose period divides the elapsed time fire, node handlers run in spec
    order, and emitted outputs route to downstream inputs within the SAME
    step (single-pass topological delivery, matching the yml's
    planner→metrics/sink chain)."""

    def __init__(self, spec: DataflowSpec, base_millis: int = 100):
        self.spec = spec.validate()
        self.base_millis = base_millis
        self.tick = 0
        self.log: List[Dict[str, Any]] = []

    def step(self):
        self.tick += 1
        elapsed = self.tick * self.base_millis
        pending: List[tuple] = []  # (dst_node, Event)
        for node in self.spec.nodes:
            for name, src in node.inputs.items():
                if src.startswith("timer/millis/"):
                    period = int(src.rsplit("/", 1)[1])
                    if elapsed % period == 0:
                        pending.append((node.node_id, Event(name, None, self.tick)))
        # deliver in spec order; outputs fan out to later deliveries
        by_id = {n.node_id: n for n in self.spec.nodes}
        while pending:
            dst, event = pending.pop(0)
            node = by_id[dst]
            out = node.handler(event) or {}
            for out_name, payload in out.items():
                if out_name not in node.outputs:
                    raise ValueError(f"{dst} emitted undeclared output {out_name!r}")
                self.log.append({"tick": self.tick, "node": dst, "output": out_name,
                                 "data": payload})
                src_key = f"{dst}/{out_name}"
                for other in self.spec.nodes:
                    for in_name, src in other.inputs.items():
                        if src == src_key:
                            pending.append((other.node_id, Event(in_name, payload, self.tick)))

    def run(self, steps: int):
        for _ in range(steps):
            self.step()
        return self.log


# ---------------------------------------------------------------------------
# The reference node family
# ---------------------------------------------------------------------------

def _planner_node(device=None, dtype=torch.float32) -> NodeSpec:
    """dora_path_planning_node.rs: on every tick, plan on a fixed grid
    world and emit a JSON path report."""
    from rust_robotics_tpu_torch.planning.wavefront import (
        extract_path, goal_raster, wavefront_costs)

    dev = resolve_device(device)
    blocked = np.zeros((32, 32), bool)
    blocked[16, 4:28] = True
    free = torch.tensor(~blocked, device=dev)
    goal = torch.tensor([30, 30], device=dev)
    start = torch.tensor([2, 2], device=dev)

    def plan():
        costs = wavefront_costs(free, goal_raster((32, 32), goal), dtype=dtype)
        return extract_path(costs, free, start, max_len=128)

    def handler(event: Event):
        idx, mask, cost = plan()
        cost = float(cost)
        report = {
            "tick": event.tick,
            "found": bool(np.isfinite(cost)),
            "cost": cost,
            "waypoints": idx.cpu().numpy()[mask.cpu().numpy()].tolist(),
        }
        return {"path-report": json.dumps(report)}

    return NodeSpec("rust-robotics-planner", {"tick": "timer/millis/100"}, ["path-report"],
                    handler)


def _metrics_node() -> NodeSpec:
    """dora_path_metrics_node.rs: derive path statistics from reports."""

    def handler(event: Event):
        report = json.loads(event.data)
        wps = np.asarray(report["waypoints"], float)
        seg = (np.linalg.norm(np.diff(wps, axis=0), axis=1) if len(wps) > 1 else np.zeros((0,)))
        metrics = {
            "tick": report["tick"],
            "waypoint_count": int(len(wps)),
            "euclidean_length": float(seg.sum()),
            "max_segment": float(seg.max()) if len(seg) else 0.0,
            "cost": report["cost"],
        }
        return {"path-metrics": json.dumps(metrics)}

    return NodeSpec("rust-robotics-metrics", {"path": "rust-robotics-planner/path-report"},
                    ["path-metrics"], handler)


def _sink_node(collected: List[dict]) -> NodeSpec:
    """dora_path_planning_sink.rs: collect every report."""

    def handler(event: Event):
        collected.append(json.loads(event.data))
        return None

    return NodeSpec("rust-robotics-sink", {"path": "rust-robotics-planner/path-report"}, [],
                    handler)


def build_path_planning_dataflow(device=None, dtype=torch.float32):
    """The dora_path_planning_dataflow.yml graph: planner → metrics,
    planner → sink, the planner on `device` (default cuda) in `dtype`.
    Returns (Dataflow, sink_collected_list)."""
    collected: List[dict] = []
    spec = DataflowSpec([_planner_node(device, dtype), _metrics_node(), _sink_node(collected)])
    return Dataflow(spec, base_millis=100), collected


def run_path_planning_dataflow(steps: int = 5, device=None, dtype=torch.float32):
    """Run the reference dataflow headlessly; returns (sink reports,
    metrics messages)."""
    flow, collected = build_path_planning_dataflow(device, dtype)
    log = flow.run(steps)
    metrics = [json.loads(e["data"]) for e in log if e["output"] == "path-metrics"]
    return collected, metrics


def build_ekf_dataflow(steps_hint: int = 50, device=None, dtype=torch.float32, draws=None,
                       generator=None):
    """dora_ekf_node.rs: a tick-driven EKF localizer publishing state
    estimates from simulated odometry+GPS, on `device` (default cuda) in
    `dtype`. Tick i's noise is draws[i] (standard normals [4]: the GPS
    pair, then the control pair; JAX's key 7 split in three each tick),
    else drawn from `generator` (a generator on the device seeded 7
    without one). Returns (Dataflow, estimates)."""
    from rust_robotics_tpu_torch.core.types import GaussianBelief
    from rust_robotics_tpu_torch.filters.kalman import ekf_step, unicycle_position_model

    dev = resolve_device(device)
    f = dtype
    model = unicycle_position_model()
    q = torch.diag(_float_on([0.1, 0.1, np.deg2rad(1.0), 1.0], dev, f)) ** 2
    r = torch.eye(2, dtype=f, device=dev)
    dt = 0.1
    control = _float_on([1.0, 0.1], dev, f)
    ctrl_std = _float_on([0.05, 0.01], dev, f)
    if generator is None and draws is None:
        generator = torch.Generator(device=dev).manual_seed(7)
    state = {
        "belief": GaussianBelief(torch.zeros(4, dtype=f, device=dev),
                                 torch.eye(4, dtype=f, device=dev)),
        "truth": torch.zeros(4, dtype=f, device=dev),
        "tick": 0,
    }
    estimates: List[dict] = []

    def tick(belief, truth, i):
        if draws is not None:
            d = torch.as_tensor(draws[i], device=dev).to(f)
        else:
            d = torch.randn(4, generator=generator, dtype=f, device=dev)
        truth = model.propagate(truth, control, dt)
        gps = truth[:2] + 0.1 * d[:2]
        ctrl = control + ctrl_std * d[2:]
        return ekf_step(belief, gps, ctrl, dt, q, r, model), truth

    def handler(event: Event):
        state["belief"], state["truth"] = tick(state["belief"], state["truth"], state["tick"])
        state["tick"] += 1
        mean = state["belief"].mean
        d = mean[:2] - state["truth"][:2]
        # one read: the mean and the position error together
        host = torch.cat([mean, torch.sqrt(torch.sum(d * d))[None]]).cpu().numpy()
        est = {"tick": event.tick, "mean": host[:4].tolist(), "position_error": float(host[4])}
        estimates.append(est)
        return {"ekf-state": json.dumps(est)}

    node = NodeSpec("rust-robotics-ekf", {"tick": "timer/millis/100"}, ["ekf-state"], handler)
    return Dataflow(DataflowSpec([node]), base_millis=100), estimates
