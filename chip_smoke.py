#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the root of a checkout with one CUDA card: `python3 chip_smoke.py`.
It imports only `rust_robotics_tpu_torch` (no JAX), builds every kernel from
`rust_robotics_tpu_torch/csrc/` with nvcc, and runs these phases in order;
any failure exits non-zero before the final line.

 1. print the card's name and power limit (nvidia-smi);
 2. fail without CUDA;
 3. turn TF32 off for matmuls and cuDNN;
 4. build the kernels, print the build time and ptxas's resource report;
 5. hold each kernel against its plain-PyTorch twin on the card;
 6. the main path at full width: bench.py's batched-EKF workload (B=131072
    filters, T=200 steps, f32), rebuilt from a numpy seed, through
    `ekf_scan_lanes` on cuda, with launch counts reset just before; then
    kernel and twin times (CUDA events, min over bursts) beside the bound;
 7. one batched `ekf_step` at B=1024 (dense Q and R) on cuda against CPU;
 8. the 330-step EKF localization demo on cuda at f64 against a numpy
    transcription of the reference semantics;
 9. one JSON line `{"kernels": [...]}`;
10. the last line, `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from rust_robotics_tpu_torch.core.types import GaussianBelief
from rust_robotics_tpu_torch.demos.ekf_localization import run_ekf_localization_demo
from rust_robotics_tpu_torch.filters.kalman import ekf_step
from rust_robotics_tpu_torch.ops import _build
from rust_robotics_tpu_torch.ops.ekf_scan import ekf_scan_lanes, ekf_scan_plain

SEED = 0
B, T, DT = 131072, 200, 0.1  # bench.py:34-51
Q = (0.01, 0.01, 3e-4, 0.01)
R = (1.0, 1.0)
RAGGED_B = 4099
ATOL_F64 = 1e-12
ATOL_F32_MEAN, ATOL_F32_COV = 1e-4, 1e-5

# Data-sheet peaks (dense, outside the tensor cores), by a fragment of
# torch.cuda.get_device_name(); the first match wins.
CARDS = (
    ("H100 PCIe", {"bytes_per_s": 2.0e12, "flops": {torch.float32: 51e12, torch.float64: 26e12}}),
    ("H100 NVL", {"bytes_per_s": 3.9e12, "flops": {torch.float32: 60e12, torch.float64: 30e12}}),
    ("H200", {"bytes_per_s": 4.8e12, "flops": {torch.float32: 67e12, torch.float64: 34e12}}),
    ("H100", {"bytes_per_s": 3.35e12, "flops": {torch.float32: 67e12, torch.float64: 34e12}}),
)
# Least arithmetic of one EKF step of the unicycle + GPS model, counting
# only terms the model's sparsity leaves non-zero: 118 adds/multiplies/
# divides plus 4 sin/cos counted as one operation each.
EKF_OPS_PER_STEP = 122


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_peaks(name: str) -> dict:
    for fragment, peaks in CARDS:
        if fragment in name:
            return peaks
    fail(f"no data-sheet peaks known for card {name!r}")


def ekf_scan_bound(t, b, dtype, peaks):
    """(bound_ms, bound_by): each input read once and each output written
    once over the memory rate, against the operations over the peak rate."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * (2 * t * 2 * b + 2 * (4 + 16) * b)
    ops = EKF_OPS_PER_STEP * t * b
    by_bytes = nbytes / peaks["bytes_per_s"] * 1e3
    by_ops = ops / peaks["flops"][dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_ms(fn, reps, bursts):
    """Device time of one call: CUDA events around `reps` back-to-back calls,
    the minimum over `bursts`, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(bursts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def scan_inputs(rng, t, b, dtype, device):
    """bench.py's workload: z ≈ 10 + 0.3·N, v ≈ 1 + 0.1·N, ω = 0.1,
    mean0 = (0, 0, π/2, 0), cov0 = I, lane-major."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    zs = 10.0 + 0.3 * rng.standard_normal((t, 2, b), dtype=npdt)
    us = np.empty((t, 2, b), npdt)
    us[:, 0] = 1.0 + 0.1 * rng.standard_normal((t, b), dtype=npdt)
    us[:, 1] = 0.1
    mean0 = np.zeros((4, b), npdt)
    mean0[2] = np.pi / 2
    cov0 = np.repeat(np.eye(4, dtype=npdt).reshape(16, 1), b, axis=1)
    return tuple(torch.from_numpy(a).to(device) for a in (zs, us, mean0, cov0))


def max_err(a, b):
    return float((a - b).abs().max())


def check_close(label, got, want, atol):
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{label}: non-finite values")
    err = max_err(got, want)
    print(f"{label}: max|diff| = {err!r} (atol {atol!r})")
    if not err <= atol:
        fail(f"{label}: max|diff| {err!r} > atol {atol!r}")
    return err


def numpy_demo_golden(steps=330, dt=0.1):
    """The reference demo semantics in plain numpy, f64
    (render_gif_ekf_localization.rs:35-76 + ekf.rs:248-278)."""

    def noise(k, scale, phase):
        return scale * np.sin(0.13 * k + phase) + 0.5 * scale * np.cos(0.07 * k + 1.3 * phase)

    q = np.diag([0.01, 0.01, np.deg2rad(1.0) ** 2, 0.01])
    r = np.eye(2)
    h = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0]])
    state = np.array([10.0, 0.0, np.pi / 2, 0.0])
    cov = np.eye(4)
    truth = state.copy()
    est = []
    for k in range(steps):
        truth[0] += 1.0 * np.cos(truth[2]) * dt
        truth[1] += 1.0 * np.sin(truth[2]) * dt
        truth[2] += 0.1 * dt
        u = np.array([1.0 + noise(k, 0.12, 0.2), 0.1 + noise(k, 0.04, 1.0)])
        z = np.array([truth[0] + noise(k, 0.6, 2.0), truth[1] + noise(k, 0.6, 2.7)])
        x_pred = np.array([
            state[0] + dt * u[0] * np.cos(state[2]),
            state[1] + dt * u[0] * np.sin(state[2]),
            state[2] + dt * u[1],
            u[0],
        ])
        f = np.eye(4)
        f[0, 2] = -dt * u[0] * np.sin(x_pred[2])
        f[1, 2] = dt * u[0] * np.cos(x_pred[2])
        f[3, 3] = 0.0
        p_pred = f @ cov @ f.T + q
        s = h @ p_pred @ h.T + r
        gain = p_pred @ h.T @ np.linalg.inv(s)
        state = x_pred + gain @ (z - h @ x_pred)
        cov = (np.eye(4) - gain @ h) @ p_pred
        est.append(state.copy())
    return np.array(est)


def main() -> int:
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "unknown"
    print(f"card: {card}")

    # 2. CUDA or nothing
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a CUDA card")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 3. full-precision float32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 4. build every kernel, one nvcc per source, all at once
    kernels = {"ekf_scan": ekf_scan_lanes}
    start = time.perf_counter()
    per_source = _build.build(list(kernels))
    print(f"build: {time.perf_counter() - start!r} s wall; per source {per_source}")
    for kname in kernels:
        for line in _build.build_log(kname).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {kname}: {line.strip()}")

    # 5. each kernel against its twin on the card
    rng = np.random.default_rng(SEED)
    args64 = scan_inputs(rng, T, RAGGED_B, torch.float64, device)
    got = ekf_scan_lanes(*args64, DT, Q, R)
    want = ekf_scan_plain(*args64, DT, Q, R)
    torch.cuda.synchronize()
    err64 = max(check_close(f"ekf_scan f64 T={T} B={RAGGED_B} {part}", g, w, ATOL_F64)
                for part, g, w in zip(("mean", "cov"), got, want))
    del args64, got, want

    args = scan_inputs(rng, T, B, torch.float32, device)
    got = ekf_scan_lanes(*args, DT, Q, R)
    want = ekf_scan_plain(*args, DT, Q, R)
    torch.cuda.synchronize()
    err32_mean = check_close(f"ekf_scan f32 T={T} B={B} mean", got[0], want[0], ATOL_F32_MEAN)
    err32_cov = check_close(f"ekf_scan f32 T={T} B={B} cov", got[1], want[1], ATOL_F32_COV)
    del got, want

    # 6. the main path at full width, counted
    for fn in kernels.values():
        fn.launches = 0
    mean, cov = ekf_scan_lanes(*args, DT, Q, R)
    torch.cuda.synchronize()
    launches = {kname: fn.launches for kname, fn in kernels.items()}
    print(f"main path launches: {launches}")
    for kname, count in launches.items():
        if count < 1:
            fail(f"kernel {kname} was not launched on the main path")
    if mean.shape != (4, B) or cov.shape != (16, B):
        fail(f"main path shapes {tuple(mean.shape)}, {tuple(cov.shape)}")
    if not (torch.isfinite(mean).all() and torch.isfinite(cov).all()):
        fail("main path produced non-finite values")

    kernel_ms = time_ms(lambda: ekf_scan_lanes(*args, DT, Q, R), reps=20, bursts=5)
    plain_ms = time_ms(lambda: ekf_scan_plain(*args, DT, Q, R), reps=1, bursts=3)
    bound_ms, bound_by = ekf_scan_bound(T, B, torch.float32, peaks)
    updates = B * T / (kernel_ms * 1e-3)
    print(
        f"ekf_scan B={B} T={T} f32 on {card}: kernel {kernel_ms!r} ms, twin "
        f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}), "
        f"{updates!r} updates/s, {bound_ms / kernel_ms:.4f} of the bound"
    )
    del args, mean, cov

    # 7. one batched ekf_step at the driver's compile-check shape
    nb = 1024
    mean = rng.standard_normal((nb, 4)).astype(np.float32)
    z = rng.standard_normal((nb, 2)).astype(np.float32)
    u = np.stack([1.0 + 0.1 * rng.standard_normal(nb), np.full(nb, 0.1)], -1).astype(np.float32)
    results = {}
    for dev in ("cpu", device):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        belief = GaussianBelief(t(mean), torch.eye(4, device=dev).expand(nb, 4, 4))
        q = 0.01 * torch.eye(4, device=dev)
        r = torch.eye(2, device=dev)
        results[str(dev)] = ekf_step(belief, t(z), t(u), DT, q, r)
    torch.cuda.synchronize()
    # f32 on both sides; the GPU's fused multiply-adds and reduction order
    # move the last bits of values of order 1
    for part in ("mean", "cov"):
        check_close(f"ekf_step B={nb} f32 cuda vs cpu {part}",
                    getattr(results[str(device)], part).cpu(), getattr(results["cpu"], part), 1e-5)

    # 8. the 330-step demo on the card at f64 against the numpy golden
    start = time.perf_counter()
    trace = run_ekf_localization_demo(steps=330, device=device, dtype=torch.float64)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - start
    estimate = trace["estimate"].cpu().numpy()
    golden = numpy_demo_golden()
    err = float(np.abs(estimate - golden).max())
    print(f"demo 330 steps f64 on cuda: {demo_s!r} s host clock, max|diff| vs numpy golden {err!r} (atol 1e-9)")
    if not err <= 1e-9:
        fail(f"demo differs from the numpy golden by {err!r}")

    # 9. the kernels line
    print(json.dumps({"kernels": [{
        "name": "ekf_scan",
        "route": "cuda",
        "source": "rust_robotics_tpu_torch/csrc/ekf_scan.cu",
        "replaces": "rust_robotics_tpu/ops/ekf_pallas.py:30",
        "launches": launches["ekf_scan"],
        "max_abs_err": max(err32_mean, err32_cov),
        "max_abs_err_f32": {"mean": err32_mean, "cov": err32_cov},
        "max_abs_err_f64": err64,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": {"B": B, "T": T, "dtype": "float32"},
        "updates_per_s": updates,
        "card": card,
    }]}))

    # 10. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
