"""A benchmark file and data directories in a temporary directory, so that a
test can run a cell at a size the CPU holds without touching the
benchmark's own files."""

from __future__ import annotations

import json
import time
from pathlib import Path

from benchmark import harness


def small_cell(tmp: Path, config: str, traffic: str, *, graphs=None, check_requests=None,
               name="test.small", extra=None, entry=None):
    """A benchmark file in tmp naming one cell `name` of `config` under a
    copy of traffic `traffic` (its graphs a request and its sampled requests
    cut to `graphs` and `check_requests`, its entry replaced by `entry`),
    every per-layer metric of the benchmark applying to it. Returns (the
    file, the data directories)."""
    (tmp / "traffic").mkdir(exist_ok=True)
    spec = json.loads((harness.BENCH_DIR / "traffic" / f"{traffic}.json").read_text())
    if graphs is not None:
        spec["graphs_per_request"] = graphs
    if check_requests is not None:
        spec["check_requests"] = check_requests
    if entry is not None:
        spec["entry"] = entry
    (tmp / "traffic" / "small.json").write_text(json.dumps(spec))
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": name, "config": config, "traffic": "small", "chips": 1,
                           "why": "a test's cell"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    for key, value in (extra or {}).items():
        bench[key] = bench[key] + value
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path, (tmp, harness.BENCH_DIR)


def run(bench_file, dirs, name="test.small", seconds=0.5, trace=False, seed=2**31 + 5):
    """One CPU run of the cell: (result, record)."""
    return harness.run_cell(name, seed, seconds, trace, t0=time.perf_counter(),
                            bench_file=bench_file, data_dirs=dirs, device="cpu")
