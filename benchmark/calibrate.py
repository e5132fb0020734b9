"""The readings that a cell's limits are set from: the program's on many seeds,
the control's (the reference in TF32 in the program's place) on a few.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 --first-seed <n>

For each seed it sends the requests that a run compares (`check_requests`
of the cell's traffic, indices 0, 1, ...) through the program, one after
the other as the window does, and compares them with the reference as a
run does; then it puts the control in the program's place on the first
`--control-seeds` seeds. One process, one set-up. Prints a JSON line a
reading and, last, the summary: each number's lower reading (the largest
over the program's seeds) and upper reading (the smallest over the
control's). The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness, tracing  # noqa: E402


def readings(workload, seeds, control_seeds, first_seed, device="cuda", data_dirs=None,
             bench_file=None, out=sys.stdout):
    """{"program": [{seed: {name: value}}...], "control": [...]} and the
    summary, each reading printed as a JSON line as it comes."""
    import torch

    spec = harness.load_cell(workload, first_seed, torch.device(device),
                             bench_file=bench_file or harness.CHECKOUT / "BENCHMARK.json",
                             data_dirs=data_dirs or (harness.BENCH_DIR,))
    config, sut = spec.config, spec.sut
    k = int(spec.traffic["check_requests"])
    spans = tracing.Spans()
    harness.warm_up(sut, spans)
    rows = {"program": [], "control": []}
    for s in range(seeds):
        sut.seed = first_seed + s
        answers = {i: sut.send(sut.request(i), spans) for i in range(k)}
        start = time.perf_counter()
        checks, reported = sut.check(answers)
        row = {"seed": sut.seed, "side": "program", **{name: v for name, v, _ in checks},
               **{name: r["value"] for name, r in reported.items()},
               "check_s": time.perf_counter() - start,
               "iterations": [a.iterations for a in answers.values()],
               **sut.summary(answers.values())}
        rows["program"].append(row)
        print(json.dumps(row), file=out, flush=True)
    for s in range(control_seeds):
        sut.seed = first_seed + s
        start = time.perf_counter()
        answers = {i: sut.control(i) for i in range(k)}
        checks, reported = sut.check(answers)
        row = {"seed": sut.seed, "side": "control", **{name: v for name, v, _ in checks},
               **{name: r["value"] for name, r in reported.items()},
               "seconds": time.perf_counter() - start}
        rows["control"].append(row)
        print(json.dumps(row), file=out, flush=True)
    names = list(config["limits"])
    summary = {"workload": workload, "device": (torch.cuda.get_device_name() if
                                                device == "cuda" else device),
               "seconds": time.perf_counter() - T0}
    for n in names:
        lower = max(r[n] for r in rows["program"])
        upper = min((r[n] for r in rows["control"]), default=None)
        summary[n] = {"lower": lower, "upper": upper,
                      "ratio": None if upper is None else upper / lower,
                      "limit": config["limits"][n]}
    print(json.dumps(summary), file=out, flush=True)
    return rows, summary


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, required=True)
    args = parser.parse_args(argv)
    readings(args.workload, args.seeds, args.control_seeds, args.first_seed)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
