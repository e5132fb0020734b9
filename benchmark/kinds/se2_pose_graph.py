"""SE(2) pose-graph cells: the reference crate's chain problem, solved by the port.

A request is `graphs_per_request` graphs of one configuration's chain, each
with its own initial guess: the generator's initial guess plus a wobble
whose phase is drawn from the seed (stratified, so that every block of
`phase_strata` graphs holds the same spread of phases and every run the
same work), the first pose at its truth. It goes host → device → host
through the entry that the traffic names, `entries/<entry>.py`, which the
harness loads and hands in. An item is one graph solved to the LM's
stopping rule with its poses on the host; a graph that the LM stopped on a
numerical failure is no item.

The check solves the same requests by the plain reference
(`benchmark/reference/se2_lm.py`) in float64 and compares every graph's
poses; the control puts that reference, in TF32, in the program's place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import problems, workmodel
from benchmark.reference import se2_lm

# graphs the reference solves at once, by the bytes of their block systems
REFERENCE_BLOCK_BYTES = 2 << 30


def _worst(so_far: float, values) -> float:
    """The larger of so_far and the values' largest, inf for a value that is
    not finite."""
    values = np.asarray(values, dtype=np.float64)
    if not np.all(np.isfinite(values)):
        return math.inf
    return max(so_far, float(values.max()))


class Answer(NamedTuple):
    poses: np.ndarray   # [G, n, 3], as read back
    iterations: int     # LM steps the request ran (lock-step: the batch's)
    stopped: int        # graphs whose LM stopped on a numerical failure


class Cell:
    """One cell's requests, its entry into the program, and its check.
    `entry` is the module `entries/<traffic's entry>.py`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, entry):
        self.config, self.traffic, self.entry_module = config, traffic, entry
        self.n = int(config["poses"])
        self.graphs = int(traffic["graphs_per_request"])
        (self.truth, self.initial, self.ef, self.et, self.meas,
         self.info) = problems.synthesize_chain(
            self.n, int(config["loop_stride"]), float(config["odometry_information"]),
            float(config["loop_information"]))
        self.closures = len(self.ef) - (self.n - 1)
        self.seed = int(seed) & (2**64 - 1)
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        w = traffic["wobble"]
        self.wobbles = problems.Wobbles(self.n, w["amplitude"], w["frequency"], w["scale"],
                                        entry.HOST_DTYPE)
        self.initial_host = self.initial.astype(entry.HOST_DTYPE)
        self.entry = None

    def setup(self):
        """The entry's set-up: it imports the program (set-up, not the
        window)."""
        self.entry = self.entry_module.Entry(self)

    def request(self, index: int) -> np.ndarray:
        """The initial guesses [G, n, 3] of request `index` (−1: the warm-up),
        the same for the same seed, in the entry's HOST_DTYPE. Graph g of request i is
        item i·G + g of `problems.stratified_phases`."""
        g = self.graphs
        phase = problems.stratified_phases(self.seed, (index + 1) * g, g,
                                           int(self.traffic["phase_strata"]))
        x0 = self.wobbles(phase, self.initial_host)
        x0[:, 0] = self.truth[0]
        return x0

    def send(self, x0: np.ndarray, span) -> Answer:
        """One request through the program; done when its poses are on the
        host."""
        return Answer(*self.entry(x0, span))

    def items(self, answer: Answer) -> int:
        """The request's items: its graphs, but those stopped on a numerical
        failure."""
        return len(answer.poses) - answer.stopped

    def broken(self, answer: Answer) -> bool:
        """An answer that is no answer: a pose that is not finite."""
        return not np.all(np.isfinite(answer.poses))

    def summary(self, answers) -> dict:
        """What the run's result line reports of its answers beside the
        metrics: the graphs whose LM stopped on a numerical failure (no
        items)."""
        return {"lm_numerical_failures": sum(a.stopped for a in answers)}

    def work(self) -> dict:
        """The least work of one LM iteration of a request."""
        return workmodel.chain_lm_iteration(self.n, self.closures, self.graphs)

    def _reference(self, index: int, precision: str, max_iterations: int, tolerance: float):
        """The reference's poses [G, n, 3] (float64, host) for request
        `index`, solved in blocks of graphs."""
        x0 = torch.as_tensor(self.request(index), dtype=torch.float64)
        out = []
        for g0 in range(0, self.graphs, self._block()):
            poses, _ = se2_lm.solve(x0[g0:g0 + self._block()].to(self.device), self.ef, self.et,
                                    self.meas, self.info, max_iterations=max_iterations,
                                    tolerance=tolerance, precision=precision)
            out.append(poses.double().cpu().numpy())
        return np.concatenate(out)

    def _block(self) -> int:
        """Graphs the reference holds at once: its block systems (~3·2·n·9·span
        float64 numbers a graph) within REFERENCE_BLOCK_BYTES."""
        span = max(int(np.abs(self.et - self.ef).max()), 1)
        return max(1, REFERENCE_BLOCK_BYTES // (8 * 3 * 2 * self.n * 9 * span))

    def _cost(self, poses: np.ndarray) -> np.ndarray:
        """The float64 cost of poses [G, n, 3], in blocks of graphs."""
        x = torch.as_tensor(poses, dtype=torch.float64)
        return np.concatenate([
            se2_lm.cost(x[g0:g0 + self._block()].to(self.device), self.ef, self.et, self.meas,
                        self.info).cpu().numpy()
            for g0 in range(0, self.graphs, self._block())])

    def control(self, index: int) -> Answer:
        """The control in the program's place: the reference in TF32, run as
        the configuration states (its iterations and tolerance)."""
        poses = self._reference(index, "tf32", self.config["max_iterations"],
                                self.config["tolerance"])
        return Answer(poses, self.config["max_iterations"], 0)

    def check(self, answers: dict):
        """([(name, value, limit)], reported) over the graphs of the answered requests
        {index: Answer}, for each number the configuration gives a limit:
        against the reference's solution, the worst graph's RMSE, the
        largest gap of any pose component (yaw wrapped), and the worst
        graph's float64 cost above the reference's cost. `reported` holds
        the worst graph's RMSE against its truth beside the configuration's
        own gate, not compared: the reference ends at the truth, and
        `rmse_ref`'s limit lies under the gate."""
        ref = self.config["reference"]
        rmse_truth = rmse_ref = gap_ref = cost_gap = 0.0
        for index, answer in answers.items():
            got = np.asarray(answer.poses, dtype=np.float64)
            want = self._reference(index, "float64", ref["max_iterations"], ref["tolerance"])
            d = got - want
            d[..., 2] = (d[..., 2] + math.pi) % (2.0 * math.pi) - math.pi
            rmse_truth = _worst(rmse_truth, problems.rmse(got, self.truth))
            rmse_ref = _worst(rmse_ref, np.sqrt(np.mean(np.sum(d * d, -1), -1)))
            gap_ref = _worst(gap_ref, np.abs(d))
            cost_gap = _worst(cost_gap, self._cost(got) - self._cost(want))
        values = {"rmse_ref": rmse_ref, "gap_ref": gap_ref, "cost_gap": cost_gap}
        reported = {"rmse_truth": {"value": rmse_truth, "gate": self.config["rmse_gate"]}}
        return ([(name, values[name], limit) for name, limit in self.config["limits"].items()],
                reported)
