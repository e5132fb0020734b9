"""The benchmark's command on a card: each cell of BENCHMARK.json runs a
short window, traced and not, and ends correct with its metrics. Needs a
CUDA card: run on the card with
`python3 -m pytest benchmark/tests/test_harness_on_card.py -m cuda -n 0`."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

CELLS = [c["name"] for c in
         json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", str(2**31 + 17), "--seconds", "2", "--trace", str(trace)],
                         cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert list(result)[-1] == "checks"
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    assert set(result["metrics"]) == {m["name"] for m in bench[kind]}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["metrics"]["step_roofline"]["value"] <= 100
        assert 0 < result["metrics"]["device_idle_pct"]["value"] < 100


def test_no_card_no_result(monkeypatch):
    """Without the cards a cell asks for, the run prints no result and exits
    with another code than 0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = []
    monkeypatch.setattr(harness, "print_result", lambda *a, **k: out.append(a))
    assert harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                         "--trace", "0"], t0=0.0) == 2
    assert out == []
