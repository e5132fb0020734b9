"""Mission-level logic: behavior trees + finite state machines.

The port's own copy of rust_robotics_tpu/control/mission.py (which imports
no JAX): the same host Python. Reference:
crates/rust_robotics_control/src/behavior_tree.rs (386 LoC:
Sequence/Selector/Condition/Action nodes over a Blackboard) and
state_machine.rs (677 LoC: states/transitions/guards); the
waypoint-navigator mission FSM with stuck-recovery
(ros2_nodes/waypoint_navigator, mirrored by
examples/headless_mission_recovery.rs).

These are host-side orchestration (they decide which device program to
call; they are not the compute path), so they are plain Python over
blackboard dicts — the same split the reference makes between nodes and
algorithms. A blackboard's 'position' may be a numpy array or a tensor on
any device; the navigator reads it to the host once a tick.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Status(enum.Enum):
    SUCCESS = "success"
    FAILURE = "failure"
    RUNNING = "running"


class Node:
    def tick(self, blackboard: Dict[str, Any]) -> Status:
        raise NotImplementedError


@dataclasses.dataclass
class Action(Node):
    """Leaf executing a callable(blackboard) -> Status."""

    fn: Callable[[Dict[str, Any]], Status]
    name: str = "action"

    def tick(self, blackboard):
        return self.fn(blackboard)


@dataclasses.dataclass
class Condition(Node):
    """Leaf mapping a predicate(blackboard) -> SUCCESS/FAILURE."""

    fn: Callable[[Dict[str, Any]], bool]
    name: str = "condition"

    def tick(self, blackboard):
        return Status.SUCCESS if self.fn(blackboard) else Status.FAILURE


@dataclasses.dataclass
class Sequence(Node):
    """Ticks children in order; fails/returns-running on the first
    non-success (behavior_tree.rs Sequence)."""

    children: List[Node]
    name: str = "sequence"

    def tick(self, blackboard):
        for child in self.children:
            status = child.tick(blackboard)
            if status != Status.SUCCESS:
                return status
        return Status.SUCCESS


@dataclasses.dataclass
class Selector(Node):
    """Ticks children until one succeeds or is running (Selector)."""

    children: List[Node]
    name: str = "selector"

    def tick(self, blackboard):
        for child in self.children:
            status = child.tick(blackboard)
            if status != Status.FAILURE:
                return status
        return Status.FAILURE


@dataclasses.dataclass
class Inverter(Node):
    child: Node
    name: str = "inverter"

    def tick(self, blackboard):
        status = self.child.tick(blackboard)
        if status == Status.SUCCESS:
            return Status.FAILURE
        if status == Status.FAILURE:
            return Status.SUCCESS
        return status


# ---------------------------------------------------------------------------
# State machine (state_machine.rs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Transition:
    source: str
    target: str
    guard: Callable[[Dict[str, Any]], bool]
    on_transition: Optional[Callable[[Dict[str, Any]], None]] = None


class StateMachine:
    """Named states + guarded transitions; per-state update callbacks
    (state_machine.rs states/transitions/guards)."""

    def __init__(self, initial: str):
        self.state = initial
        self.updates: Dict[str, Callable[[Dict[str, Any]], None]] = {}
        self.transitions: List[Transition] = []
        self.history: List[str] = [initial]

    def add_state(self, name: str,
                  update: Optional[Callable[[Dict[str, Any]], None]] = None):
        self.updates[name] = update or (lambda bb: None)
        return self

    def add_transition(self, source, target, guard, on_transition=None):
        self.transitions.append(Transition(source, target, guard, on_transition))
        return self

    def step(self, blackboard: Dict[str, Any]) -> str:
        self.updates.get(self.state, lambda bb: None)(blackboard)
        for tr in self.transitions:
            if tr.source == self.state and tr.guard(blackboard):
                if tr.on_transition:
                    tr.on_transition(blackboard)
                self.state = tr.target
                self.history.append(tr.target)
                break
        return self.state


def _host(x):
    """A numpy array of a position given as numpy data or a tensor."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_waypoint_mission(waypoints, goal_tolerance=0.5, stuck_window=10,
                          stuck_min_progress=0.05, recovery_steps=8):
    """Mission FSM mirroring headless_mission_recovery.rs / the
    waypoint_navigator node (README.md:330-339): navigate → (stuck?) →
    recover (rotate/backoff) → navigate → ... → done.

    Returns a StateMachine operating on a blackboard with keys:
    'position' (numpy or tensor [2]), 'distance_history' (list), 'wp_index',
    'recovery_count', 'recovery_timer'.
    """
    sm = StateMachine("navigate")

    def nav_update(bb):
        pos = _host(bb["position"])
        wp = _host(waypoints[bb["wp_index"]])
        d = float(np.linalg.norm(pos - wp))
        bb.setdefault("distance_history", []).append(d)
        bb["at_waypoint"] = d < goal_tolerance
        hist = bb["distance_history"]
        bb["stuck"] = (
            len(hist) >= stuck_window
            and hist[-stuck_window] - d < stuck_min_progress
            and not bb["at_waypoint"]
        )

    def recover_update(bb):
        bb["recovery_timer"] = bb.get("recovery_timer", 0) + 1

    sm.add_state("navigate", nav_update)
    sm.add_state("recover", recover_update)
    sm.add_state("done")

    def to_next_wp(bb):
        bb["wp_index"] += 1
        bb["distance_history"] = []

    sm.add_transition(
        "navigate", "done",
        lambda bb: bb.get("at_waypoint") and bb["wp_index"] == len(waypoints) - 1,
    )
    sm.add_transition(
        "navigate", "navigate",
        lambda bb: bb.get("at_waypoint") and bb["wp_index"] < len(waypoints) - 1,
        on_transition=to_next_wp,
    )
    sm.add_transition(
        "navigate", "recover", lambda bb: bb.get("stuck", False),
        on_transition=lambda bb: (
            bb.__setitem__("recovery_timer", 0),
            bb.__setitem__("recovery_count", bb.get("recovery_count", 0) + 1),
            bb.__setitem__("distance_history", []),
        ),
    )
    sm.add_transition(
        "recover", "navigate",
        lambda bb: bb.get("recovery_timer", 0) >= recovery_steps,
    )
    return sm
