"""A cell is data: a configuration, a traffic mix, an entry and a
per-layer metric, written only to a temporary directory, are found by name
and run on the CPU, and no file of the benchmark changes."""

import hashlib
import json

from benchmark import harness
from benchmark.tests import support

METRIC = '''"""tiny_requests: the requests of the window."""


def read(run):
    return float(len(run.requests))
'''


ENTRY = '''"""tiny_lockstep: the benchmark's solve_chain_lm entry, each request
inside a span of its own."""

from benchmark import harness

base = harness.load_module(harness.BENCH_DIR / "entries" / "solve_chain_lm.py")
HOST_DTYPE = base.HOST_DTYPE


class Entry(base.Entry):
    def __call__(self, x0, span):
        with span("tiny_lockstep"):
            return super().__call__(x0, span)
'''


def _digest():
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(harness.BENCH_DIR.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_added_as_data_runs(tmp_path):
    before = _digest()
    (tmp_path / "configs").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "entries").mkdir()
    config = json.loads((harness.BENCH_DIR / "configs" / "se2_chain_200.json").read_text())
    config.update(name="tiny_chain", poses=90, loop_stride=30)
    (tmp_path / "configs" / "tiny_chain.json").write_text(json.dumps(config))
    (tmp_path / "metrics" / "tiny_requests.py").write_text(METRIC)
    (tmp_path / "entries" / "tiny_lockstep.py").write_text(ENTRY)
    bench_file, dirs = support.small_cell(
        tmp_path, "tiny_chain", "fleet1024", graphs=2, check_requests=1, name="tiny_chain.pair",
        entry="tiny_lockstep",
        extra={"per_layer": [{"name": "tiny_requests", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "Harness",
                              "moves": "items_per_s"}]})
    result, record = support.run(bench_file, dirs, name="tiny_chain.pair", seconds=0.2,
                                 trace=True)
    assert result["metrics"]["tiny_requests"]["value"] == len(record.requests) >= 4
    assert result["metrics"]["lm_iterations"]["value"] > 0
    assert record.config["poses"] == 90 and record.traffic["graphs_per_request"] == 2
    assert {s.request for s in record.spans if s.name == "tiny_lockstep"} == {
        r.index for r in record.requests}
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    result, _ = support.run(bench_file, dirs, name="tiny_chain.pair", seconds=0.2)
    assert set(result["metrics"]) == {"items_per_s", "request_ms_p95", "setup_s"}
    assert _digest() == before
