"""Deterministic benchmark regression gate (CSV contract).

The port's copy of rust_robotics_tpu/utils/bench_gate.py (plain Python).

Reference: scripts/check_benchmark_gate.py + BENCHMARKS.md:10-22 — header
names/order and row count must match exactly; numeric cells compare at
rtol=atol=1e-6; columns whose header ends in `_ms`/`_us`/`_ns` are ignored
as wall-clock noise; non-numeric cells compare exactly.
"""

from __future__ import annotations

import csv
import io

WALL_CLOCK_SUFFIXES = ("_ms", "_us", "_ns")


def _rows(text: str):
    return list(csv.reader(io.StringIO(text)))


def _is_wall_clock(header: str) -> bool:
    return header.endswith(WALL_CLOCK_SUFFIXES)


def compare_csv(baseline_text: str, generated_text: str, rtol=1e-6,
                atol=1e-6) -> list:
    """Returns a list of violation strings (empty = gate passes)."""
    base = _rows(baseline_text)
    gen = _rows(generated_text)
    problems = []
    if not base or not gen:
        return ["empty CSV"]
    if base[0] != gen[0]:
        return [f"header mismatch: baseline={base[0]} generated={gen[0]}"]
    if len(base) != len(gen):
        return [
            f"row count mismatch: baseline={len(base) - 1} "
            f"generated={len(gen) - 1}"
        ]
    header = base[0]
    ignored = {i for i, c in enumerate(header) if _is_wall_clock(c)}
    for r, (brow, grow) in enumerate(zip(base[1:], gen[1:]), start=2):
        if len(brow) != len(grow):
            problems.append(f"row {r}: cell count mismatch")
            continue
        for i, (bv, gv) in enumerate(zip(brow, grow)):
            if i in ignored:
                continue
            try:
                bf, gf = float(bv), float(gv)
                ok = abs(bf - gf) <= atol + rtol * abs(bf)
            except ValueError:
                ok = bv == gv
            if not ok:
                problems.append(
                    f"row {r} col {header[i]!r}: baseline={bv} generated={gv}"
                )
    return problems


def write_csv(path, header, rows):
    """Emit a gate-conformant CSV (deterministic float formatting)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for row in rows:
            w.writerow([_fmt(v) for v in row])
    return str(path)


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.9g}"
    return v
