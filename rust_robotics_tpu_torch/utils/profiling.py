"""Profiling, determinism, and NaN-guard utilities.

The port of rust_robotics_tpu/utils/profiling.py. Reference posture
(SURVEY.md §5): the reference has no tracing framework — wall-clock via
`std::time::Instant` in benchmark examples
(crates/rust_robotics/examples/speed_comparison.rs:8,:46), finiteness
validation at every API boundary (ekf.rs:318-:355), and determinism by
construction (single-threaded, seeded StdRng). Here:

- `trace(dir)` — a `torch.profiler` scope (CPU, and CUDA where a card is
  present) that writes a Chrome trace into `dir` (open it in
  chrome://tracing or Perfetto).
- `wall_time_ms(fn)` — marginal wall clock per call, with the device
  synchronised before the clock is read at either end (CUDA launches
  return before the work is done).
- `assert_deterministic(fn, *args)` — runs the function `runs` times and
  asserts every output leaf is bitwise identical (byte views): the
  reference's seeded-StdRng guarantee, checked.
- `nan_report(tree)` / `guard_finite(tree)` — the finiteness boundary over
  nested dicts, lists and tuples; leaves are keyed by path in the format of
  `jax.tree_util.keystr` (`['a'][0]`, `.field` for a named tuple).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["trace", "wall_time_ms", "assert_deterministic", "nan_report", "guard_finite"]


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope; on exit the device is synchronised and a Chrome
    trace is written to `log_dir/trace.json`. Usage:

        with trace("/tmp/trace"):
            out = step(x)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def wall_time_ms(fn: Callable[[], Any], runs: int = 10, warmup: int = 1) -> float:
    """Marginal per-call wall-clock ms, the device synchronised before each
    clock read; first-call latency excluded by `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    _sync()
    return (time.perf_counter() - t0) * 1000.0 / runs


def _leaves(tree, path=""):
    """(keystr path, leaf) pairs in JAX's flattening order: dict keys
    sorted, sequences in order, named tuples by field; None is empty."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _bytes_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    flat = lambda t: t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()  # noqa: E731
    return torch.equal(flat(a), flat(b))


def assert_deterministic(fn: Callable[..., Any], *args, runs: int = 2) -> Any:
    """Run `fn(*args)` `runs` times and assert every output leaf is BITWISE
    identical across runs (its bytes, dtype and shape). Returns the first
    output."""
    first = fn(*args)
    flat0 = list(_leaves(first))
    for r in range(1, runs):
        flat = list(_leaves(fn(*args)))
        if [p for p, _ in flat] != [p for p, _ in flat0]:
            raise AssertionError(f"run {r}: output structure changed: "
                                 f"{[p for p, _ in flat]} vs {[p for p, _ in flat0]}")
        for i, ((path, a), (_, b)) in enumerate(zip(flat0, flat)):
            if not isinstance(a, (torch.Tensor, np.ndarray, np.generic, int, float, bool)):
                if a != b:  # a string or another host object
                    raise AssertionError(f"run {r}: leaf {i} {path} changed: {b!r} vs {a!r}")
                continue
            ta, tb = (torch.as_tensor(x) for x in (a, b))
            if ta.dtype != tb.dtype or ta.shape != tb.shape or not _bytes_equal(ta, tb):
                raise AssertionError(f"run {r}: leaf {i} {path} not bitwise reproducible "
                                     f"(dtype {ta.dtype}, shape {tuple(ta.shape)})")
    return first


def nan_report(tree: Any) -> Dict[str, int]:
    """Count non-finite entries per leaf path; empty dict == all finite."""
    report: Dict[str, int] = {}
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = int((~torch.isfinite(leaf)).sum()) if leaf.is_floating_point() else 0
        else:
            arr = np.asarray(leaf)
            bad = int((~np.isfinite(arr)).sum()) if arr.dtype.kind == "f" else 0
        if bad:
            report[path] = bad
    return report


def guard_finite(tree: Any, name: str = "value") -> Any:
    """Raise FloatingPointError when any leaf holds NaN/Inf (the
    reference's boundary validation, ekf.rs:318-:355); returns `tree`."""
    report = nan_report(tree)
    if report:
        raise FloatingPointError(f"{name} contains non-finite values: {report}")
    return tree
