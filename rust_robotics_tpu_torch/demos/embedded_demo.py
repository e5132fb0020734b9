"""Minimal-dependency closed-loop demo — the analog of the reference's
bare-metal no_std example (rust_robotics_embedded_demo/src/main.rs:1-150:
Pure Pursuit + PID speed control steering a bicycle plant while an EKF
fuses noisy positions; deterministic LCG noise; a final PASS/FAIL line).

The port's own copy of rust_robotics_tpu/demos/embedded_demo.py. The
constraint it mirrors: NO torch and NO JAX — pure NumPy (the
"constrained target" analog of no_std). The module prints the same style
of progress lines and returns/exits PASS exactly as the reference's
semihosted run does (CI greps the PASS line).
"""

from __future__ import annotations

import math

import numpy as np


class Lcg:
    """Deterministic LCG + Box-Muller (main.rs:43-66 constants)."""

    def __init__(self, seed=0x5EED_1234_DEAD_BEEF):
        self.state = seed & 0xFFFFFFFFFFFFFFFF

    def next_u64(self):
        self.state = (self.state * 6364136223846793005
                      + 1442695040888963407) & 0xFFFFFFFFFFFFFFFF
        return self.state

    def next_f64(self):
        return (self.next_u64() >> 11) * (1.0 / 9007199254740992.0)

    def next_gaussian(self):
        u1 = max(self.next_f64(), 1e-9)
        u2 = self.next_f64()
        return math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)


def _wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


def run_embedded_demo(steps=400, dt=0.1, target_speed=1.0, noise_std=0.08,
                      verbose=False):
    """Closed loop (main.rs:80-147): straight path, Pure Pursuit steering,
    PID speed, EKF position fusion. Returns a report dict with
    `passed` = final EKF position error < 0.5 m (the reference's gate)."""
    wheelbase = 0.5
    look_ahead_gain, look_ahead_dist = 0.5, 1.0
    kp_pid, ki_pid = 2.0, 0.2
    path = np.stack([np.arange(17) * 0.5, np.zeros(17)], axis=1)

    # vehicle truth [x, y, yaw, v]
    x = y = yaw = v = 0.0
    # EKF state [x, y, yaw, v]; motion/observation model of ekf.rs:203-245
    est = np.zeros(4)
    cov = np.eye(4)
    q = np.diag([0.1, 0.1, math.radians(1.0), 1.0]) ** 2
    r = np.eye(2)
    h = np.zeros((2, 4))
    h[0, 0] = h[1, 1] = 1.0

    rng = Lcg()
    integral = 0.0
    final_error = 0.0
    nearest = 0

    for step in range(steps):
        # --- pure pursuit steering (pure_pursuit.rs semantics)
        look = look_ahead_gain * v + look_ahead_dist
        d = np.hypot(path[:, 0] - x, path[:, 1] - y)
        nearest = max(nearest, int(np.argmin(d)))
        ti = nearest
        while ti + 1 < len(path) and d[ti] < look:
            ti += 1
        tx, ty = path[ti]
        alpha = _wrap(math.atan2(ty - y, tx - x) - yaw)
        steer = math.atan2(2.0 * wheelbase * math.sin(alpha), look)

        # --- PID speed
        err_v = target_speed - v
        integral += err_v * dt
        accel = kp_pid * err_v + ki_pid * integral

        # --- bicycle plant
        x += v * math.cos(yaw) * dt
        y += v * math.sin(yaw) * dt
        yaw = _wrap(yaw + v / wheelbase * math.tan(steer) * dt)
        v += accel * dt

        # --- noisy GPS
        mx = x + noise_std * rng.next_gaussian()
        my = y + noise_std * rng.next_gaussian()

        # --- EKF predict (unicycle, ekf.rs:203-212) + update
        yaw_rate = v / wheelbase * math.tan(steer)
        pe = est.copy()
        pe[0] += est[3] * math.cos(est[2]) * dt
        pe[1] += est[3] * math.sin(est[2]) * dt
        pe[2] = _wrap(est[2] + yaw_rate * dt)
        pe[3] = v
        f = np.eye(4)
        f[0, 2] = -est[3] * math.sin(est[2]) * dt
        f[0, 3] = math.cos(est[2]) * dt
        f[1, 2] = est[3] * math.cos(est[2]) * dt
        f[1, 3] = math.sin(est[2]) * dt
        cov = f @ cov @ f.T + q
        z = np.array([mx, my])
        s = h @ cov @ h.T + r
        k = cov @ h.T @ np.linalg.inv(s)
        est = pe + k @ (z - h @ pe)
        est[2] = _wrap(est[2])
        cov = (np.eye(4) - k @ h) @ cov

        final_error = math.hypot(est[0] - x, est[1] - y)
        if verbose and step % 100 == 0:
            print(f"step={step:3d} true=({x:+.2f},{y:+.2f}) "
                  f"est=({est[0]:+.2f},{est[1]:+.2f}) err={final_error:.3f}")

    passed = final_error < 0.5
    if verbose:
        print(f"final EKF position error = {final_error:.4f} m")
        print(f"embedded demo {'PASS' if passed else 'FAIL'}")
    return {
        "final_error": final_error,
        "final_position": (x, y),
        "final_speed": v,
        "passed": passed,
    }


if __name__ == "__main__":
    import sys

    report = run_embedded_demo(verbose=True)
    sys.exit(0 if report["passed"] else 1)
