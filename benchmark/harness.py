"""Runs one cell of `BENCHMARK.json` once and prints its result line.

A cell names a configuration, a traffic mix and a chip count. The harness
finds each by name, as data: `configs/<config>.json` (sizes, source,
limits; its "kind" names `kinds/<kind>.py`, the module that makes the
requests and checks the answers), `traffic/<traffic>.json` (graphs a
request, the wobble, the loop; its "entry" names `entries/<entry>.py`, the
module that drives the program with a request), and one reader
`metrics/<name>.py` for each per-layer metric. A later cell, mix, entry or
metric is a new file and a new entry; no file here changes.

A run:
1. set-up: the program imported, the problem built from the seed, one
   untimed request of the cell's own shapes (it captures the chain step's
   CUDA graph); `setup_s` runs from process start to the first timed
   request;
2. the window: a closed loop of one client for `seconds`, each request
   timed from its send to its poses on the host; with `trace`, requests 2
   to 2 + trace_requests − 1 run under the profiler and the next one under
   sync debug mode;
3. after the window: the peak device memory, the guard against JAX, the
   per-layer or end-to-end metrics, then the check of a sample of the
   window's answers drawn from the seed against the plain reference.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rust_robotics_tpu")
TRACE_FIRST = 2          # the first profiled request of a traced window
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


class NoDevice(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def forbidden_modules() -> list[str]:
    """The top-level names in sys.modules that are JAX's or the JAX
    package's, each compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def find(dirs, sub: str, name: str, suffix: str) -> Path:
    """The first dirs[i]/sub/name+suffix that exists."""
    for d in dirs:
        path = Path(d) / sub / (name + suffix)
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {sub}/{name}{suffix} under {[str(d) for d in dirs]}")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(bench: dict, workload: str):
    """(cell, end-to-end metrics, per-layer metrics) of `workload`: the
    metrics whose "workloads" list names it, or that have none."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in the benchmark; it has {sorted(cells)}")

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return (cells[workload], [m for m in bench["end_to_end"] if applies(m)],
            [m for m in bench["per_layer"] if applies(m)])


def load_cell(workload: str, seed: int, device, *, bench_file: Path = CHECKOUT / "BENCHMARK.json",
              data_dirs=(BENCH_DIR,), check=lambda cell: None):
    """The cell `workload` found by name: its spec, end-to-end and per-layer
    metrics, configuration and traffic, and the system under test built
    from the seed (not yet set up). `check(cell)` runs before the build."""
    bench = json.loads(Path(bench_file).read_text())
    cell, end_to_end, per_layer = cell_spec(bench, workload)
    check(cell)
    config = json.loads(find(data_dirs, "configs", cell["config"], ".json").read_text())
    traffic = json.loads(find(data_dirs, "traffic", cell["traffic"], ".json").read_text())
    if traffic.get("loop", "closed") != "closed" or traffic.get("clients", 1) != 1:
        raise ValueError("the harness drives a closed loop of one client")
    kind = load_module(find(data_dirs, "kinds", config["kind"], ".py"))
    entry = load_module(find(data_dirs, "entries", traffic["entry"], ".py"))
    return SimpleNamespace(cell=cell, end_to_end=end_to_end, per_layer=per_layer, config=config,
                           traffic=traffic, sut=kind.Cell(config, traffic, seed, device, entry))


def warm_up(sut, spans):
    """Set the system up and send one untimed request of the cell's own
    shapes: every shape of the window."""
    sut.setup()
    sut.send(sut.request(-1), spans)


def percentile(values, q):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def power_limit():
    """nvidia-smi's name and power limit of the cards, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t0: float,
             bench_file: Path = CHECKOUT / "BENCHMARK.json", data_dirs=(BENCH_DIR,),
             device: str = "cuda", log=sys.stderr):
    """One run of one cell. Returns the result's dict (its "checks" last)
    and the run's record."""
    import torch

    from benchmark import tracing

    marks = {"import": time.perf_counter()}
    dev = torch.device(device)

    def claim(cell):
        if dev.type != "cuda":
            return
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA card(s); found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.cuda.reset_peak_memory_stats()
        torch.zeros(1, device=dev)

    spec = load_cell(workload, seed, dev, bench_file=bench_file, data_dirs=data_dirs,
                     check=claim)
    config, traffic, cell, sut = spec.config, spec.traffic, spec.cell, spec.sut
    end_to_end, per_layer = spec.end_to_end, spec.per_layer
    readers = {m["name"]: load_module(find(data_dirs, "metrics", m["name"], ".py"))
               for m in per_layer} if trace else {}
    marks["device"] = time.perf_counter()
    spans = tracing.Spans()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    warm_up(sut, spans)
    sync()
    spans.items.clear()
    # what set-up made lives for the whole run: keep the collector's full
    # passes, which would walk it, out of the window's latencies
    gc.collect()
    gc.freeze()
    trace_requests = int(traffic.get("trace_requests", 1)) if trace else 0
    read_request = TRACE_FIRST + trace_requests
    answers, requests, failed, prof, raised = {}, [], 0, None, False
    start = time.perf_counter()
    setup_s = start - t0
    marks["warm-up"] = start
    parts, last = {}, t0
    for name, at in marks.items():
        parts[name], last = at - last, at
    print("setup_s by part: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()), file=log)
    index = 0
    while True:
        x0 = sut.request(index)
        spans.request = index
        if trace and index == TRACE_FIRST:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
            spans.profiling = True
        sent = time.perf_counter()
        try:
            with spans("request"):
                if trace and index == read_request and dev.type == "cuda":
                    answer, reads = tracing.reads_in(lambda: sut.send(x0, spans))
                else:
                    answer, reads = sut.send(x0, spans), None
        except Exception:  # a request the program fails ends the window
            traceback.print_exc(file=log)
            failed += 1
            raised = True
            break
        done = time.perf_counter()
        if prof is not None and index == TRACE_FIRST + trace_requests - 1:
            prof.__exit__(None, None, None)
            spans.profiling = False
        answers[index] = answer
        requests.append(SimpleNamespace(index=index, sent=sent, done=done, reads=reads,
                                        iterations=answer.iterations,
                                        items=sut.items(answer)))
        index += 1
        if done - start >= seconds and (not trace or index > read_request):
            break
    end = time.perf_counter()
    if spans.profiling:
        prof.__exit__(None, None, None)
        spans.profiling = False
    memory_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise ImportError(f"the run loaded {found} after its window: the port must run "
                          f"without JAX or the JAX package")
    attempted = len(requests) + raised
    failed += sum(sut.broken(a) for a in answers.values())

    record = SimpleNamespace(config=config, traffic=traffic, cell=cell, requests=requests,
                             spans=spans.items, window_s=end - start, work=sut.work(),
                             device_name=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                          else "cpu"), trace=None, power=None, notes={})
    metrics, device, breakdown = {}, {}, None
    if trace:
        record.power = power_limit() if dev.type == "cuda" else None
        record.trace = _trace_record(prof, requests, trace_requests, tracing)
        for m in per_layer:
            value = readers[m["name"]].read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if record.trace.device:
            device = {"busy_s": record.trace.busy_s, "window_s": record.trace.window_s}
            breakdown = {"device_ops": tracing.top_device_ops(record.trace.device),
                         "idle_gaps": record.trace.gaps}
    else:
        latencies_ms = [(r.done - r.sent) * 1e3 for r in requests]
        values = {"items_per_s": sum(r.items for r in requests) / (end - start),
                  "request_ms_p95": percentile(latencies_ms, 95) if latencies_ms else math.inf,
                  "setup_s": setup_s}
        for m in end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    prof = None
    sync()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: a sample of the window's answers, drawn from the seed
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 2])
    k = min(int(traffic["check_requests"]), len(answers))
    sample = sorted(int(i) for i in rng.choice(sorted(answers), size=k, replace=False))
    check_start = time.perf_counter()
    checks, reported = sut.check({i: answers[i] for i in sample}) if sample else ([], {})
    check_s = time.perf_counter() - check_start
    correct = bool(sample) and failed == 0 and all(v <= limit for _, v, limit in checks)
    checks = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    checks["failed_requests"] = {"value": failed, "limit": 0}

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": record.device_name, "count": cell["chips"] if
                         dev.type == "cuda" else 0, "memory_peak_bytes": int(memory_peak),
                         **device}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["requests"] = len(requests)
    result["sampled_requests"] = sample
    if record.power:
        result["card"] = record.power
    result.update(sut.summary(answers.values()))
    result["check_s"] = check_s
    result["setup_parts_s"] = parts
    result.update(record.notes)
    result["reported"] = reported
    result["checks"] = checks
    return result, record


def _trace_record(prof, requests, trace_requests, tracing):
    """The profiled requests' device events, busy and window seconds, the
    idle gaps, and the one read-counted request's reads."""
    traced = [r for r in requests if TRACE_FIRST <= r.index < TRACE_FIRST + trace_requests]
    read = [r for r in requests if r.reads is not None]
    out = SimpleNamespace(requests=traced, device=[], busy_s=0.0, window_s=0.0, gaps=[],
                          reads=read[0].reads if read else None,
                          read_iterations=read[0].iterations if read else None)
    if prof is None or not traced:
        return out
    device, host = tracing.kineto_events(prof)
    marks = [h for h in host if h.name == "bench.request"]
    if not marks:
        return out
    lo, hi = min(h.start for h in marks), max(h.end for h in marks)
    out.device = [e for e in device if e.end > lo and e.start < hi]
    out.busy_s = tracing.union_ns(out.device) / 1e9
    out.window_s = sum(h.end - h.start for h in marks) / 1e9
    out.gaps = tracing.idle_gaps(out.device, host, lo, hi) if out.device else []
    return out


def print_result(result: dict, out=sys.stdout, err=sys.stderr):
    """The numbers reported beside a gate, not compared; each compared number
    beside its limit as the last lines on standard error; then the result
    as the last line of standard output."""
    for name, r in result.get("reported", {}).items():
        print(f"reported {name}: {r['value']!r} (gate {r['gate']!r}, not compared)", file=err)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()


def main(argv, t0: float) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ.setdefault(var, str(CHECKOUT / ".bench_cache" / sub))
    try:
        result, record = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t0=t0)
    except NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    from benchmark.tracing import write_spans

    out_dir = CHECKOUT / ".bench_out"
    out_dir.mkdir(exist_ok=True)
    write_spans(out_dir / f"spans-{args.workload}-{args.seed}-{args.trace}.jsonl",
                record.spans, t0)
    print_result(result)
    return 0
