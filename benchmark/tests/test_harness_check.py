"""The comparison that decides `correct` passes the program and rejects the
control, the reference in TF32 put in the program's place, and a run whose
timed path is broken underneath by each fault these cells can have: a step
that returns its state unchanged, half of the batch left out, an answer
altered where it is produced. (The cells run on one card: no exchange
between cards to leave out.) At se2_chain_200's limits, on a few graphs on
the CPU; the control also at se2_chain_10k's size."""

import io
import json

import numpy as np
import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests import support
from rust_robotics_tpu_torch.nlls import tridiag
from rust_robotics_tpu_torch.slam import pose_graph

torch.set_num_threads(2)


def _limits(config):
    return json.loads((harness.BENCH_DIR / "configs" / f"{config}.json").read_text())["limits"]


def _over(row, limits):
    return [name for name, limit in limits.items() if not row[name] <= limit]


def test_program_passes_and_the_control_fails(tmp_path):
    bench_file, dirs = support.small_cell(tmp_path, "se2_chain_200", "fleet1024", graphs=4,
                                          check_requests=2)
    rows, _ = calibrate.readings("test.small", 1, 1, 2**31 + 3, device="cpu", data_dirs=dirs,
                                 bench_file=bench_file, out=io.StringIO())
    limits = _limits("se2_chain_200")
    assert _over(rows["program"][0], limits) == []
    assert _over(rows["control"][0], limits) != []


def test_control_fails_at_the_10k_size():
    """The control alone (no program run) on one 10k request."""
    sut = harness.load_cell("se2_chain_10k.solo", 2**31 + 9, torch.device("cpu")).sut
    checks, reported = sut.check({0: sut.control(0)})
    assert [name for name, value, limit in checks if not value <= limit] != []
    assert reported["rmse_truth"]["gate"] == 0.005


def test_a_graph_stopped_on_a_numerical_failure_is_no_item():
    spec = harness.load_cell("se2_chain_200.fleet1024", 2**31 + 9, torch.device("cpu"))
    poses = np.zeros((4, 200, 3))
    kind = harness.load_module(harness.BENCH_DIR / "kinds" / "se2_pose_graph.py")
    assert spec.sut.items(kind.Answer(poses, 25, 0)) == 4
    assert spec.sut.items(kind.Answer(poses, 10, 3)) == 1


def _unchanged_step(*args, **kwargs):
    return lambda s: s


def _half_batch(solve):
    def solve_half(values0, *args, **kwargs):
        half = values0.shape[0] // 2
        out, summary = solve(values0[:half], *args, **kwargs)
        rest = values0.shape[0] - half
        summary = type(summary)(*(torch.cat([t, t[:1].expand(rest)]) for t in summary))
        return torch.cat([out, values0[half:]]), summary
    solve_half.calls = 0  # the entry counts its calls on its own name
    return solve_half


def _altered(solve):
    def solve_altered(*args, **kwargs):
        out, summary = solve(*args, **kwargs)
        out = out.clone()
        out[..., out.shape[-2] // 2, 0] += 0.01
        return out, summary
    solve_altered.calls = 0
    return solve_altered


FAULTS = {
    "unchanged_step": lambda mp: mp.setattr(tridiag, "lm_step", _unchanged_step),
    "half_batch": lambda mp: mp.setattr(tridiag, "solve_chain_lm",
                                        _half_batch(tridiag.solve_chain_lm)),
    "altered_answer": lambda mp: [mp.setattr(m, "solve_chain_lm", _altered(m.solve_chain_lm))
                                  for m in (tridiag, pose_graph)],
}


# a batch of one graph (solo) has no half to leave out
@pytest.mark.parametrize("traffic,graphs,fault", [
    (traffic, graphs, fault) for traffic, graphs in (("fleet1024", 4), ("solo", 1))
    for fault in (None, *FAULTS) if not (fault == "half_batch" and graphs == 1)])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, traffic, graphs, fault):
    bench_file, dirs = support.small_cell(tmp_path, "se2_chain_200", traffic, graphs=graphs,
                                          check_requests=2)
    if fault:
        FAULTS[fault](monkeypatch)
    result, _ = support.run(bench_file, dirs, seconds=0.2)
    assert result["correct"] is (fault is None), result["checks"]
