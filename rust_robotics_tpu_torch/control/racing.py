"""Gate-racing MPPI stack: 3D gates, motor-level quadrotor, powertrain
(motor lag + battery sag), charge budgets.

The port of rust_robotics_tpu/control/racing.py. Reference:
crates/rust_robotics_control/src/ — racing_mppi_3d.rs (gate planes with an
orthonormal center/normal/up/right frame and half extents; the
reference-free gate lap objective :199-:380), racing_mppi_motor.rs (rotor
thrusts through an X mixer, quaternion attitude, per-rotor saturation,
rate damping, drag, speed clamp :199-:260), racing_mppi_powertrain.rs
(first-order motor lag, battery OCV/sag/relaxation, the battery-limited
rotor ceiling :193-:271; aware vs unaware controllers; the charge-budget
reserve penalty :350-:372).

The quad and powertrain steps are functions over leading dims, so MPPI's
samples roll out at once; the aware/unaware split is which step MPPI
rolls out. `simulate_gate_race` keeps its counters on the device and reads
the run back once at the end.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rust_robotics_tpu_torch._device import resolve_device
from rust_robotics_tpu_torch._numeric import filled, true_div
from rust_robotics_tpu_torch.control._small import at, rsum, set_last, sqrt_sum
from rust_robotics_tpu_torch.control.mppi import MPPIConfig, mppi_plan

__all__ = [
    "GatePlane",
    "make_gate_lap_costs",
    "MotorQuadParams",
    "motor_quad_step",
    "hover_state",
    "PowertrainParams",
    "powertrain_init",
    "powertrain_step",
    "effective_max_rotor",
    "simulate_gate_race",
]


# ---------------------------------------------------------------------------
# gates (racing_mppi_3d.rs)


@dataclasses.dataclass(frozen=True)
class GatePlane:
    center: tuple
    normal: tuple
    up_hint: tuple = (0.0, 0.0, 1.0)
    half_width: float = 1.0
    half_height: float = 1.0

    def frame(self):
        c = np.asarray(self.center, float)
        n = np.asarray(self.normal, float)
        n = n / np.linalg.norm(n)
        u = np.asarray(self.up_hint, float)
        u = u - (u @ n) * n
        u = u / max(np.linalg.norm(u), 1e-12)
        r = np.cross(n, u)
        return c, n, u, r


def _stack_gates(gates, dtype, device):
    frames = [g.frame() for g in gates]
    parts = [np.stack([fr[k] for fr in frames]) for k in range(4)]
    parts += [np.array([g.half_width for g in gates], float),
              np.array([g.half_height for g in gates], float)]
    return [torch.as_tensor(p, device=device).to(dtype) for p in parts]


def make_gate_lap_costs(gates, progress_weight=6.0, lateral_weight=0.4, control_weight=0.002,
                        hover_thrust=None, tilt_weight=8.0, rate_weight=0.05, dtype=None,
                        device=None):
    """Reference-free gate objective (RacingGateLap3D): the rollout state
    carries the active gate index last; the stage cost pulls toward the
    active gate plane along its normal and penalizes the lateral offset.
    Returns (stage, terminal, advance), where advance(pos_prev, pos, idx)
    moves the active gate on an in-aperture crossing. The gates' tensors
    live on `device` (default cuda) in `dtype` (default torch's)."""
    c, n, u, r, hw, hh = _stack_gates(gates, dtype or torch.get_default_dtype(),
                                      resolve_device(device))
    ng = c.shape[0]

    def gate_terms(pos, idx):
        rel = pos - at(c, idx)
        along = rsum(rel * at(n, idx), -1)
        lat = torch.abs(rsum(rel * at(r, idx), -1)) + torch.abs(rsum(rel * at(u, idx), -1))
        return along, lat

    def gate_of(state):
        return state[..., -1].to(torch.int64) % ng

    def stage(state, u_ctl):
        along, lat = gate_terms(state[..., :3], gate_of(state))
        eff = u_ctl - (hover_thrust if hover_thrust is not None else 0.0)
        cost = (progress_weight * torch.abs(along) + lateral_weight * lat
                + control_weight * rsum(eff * eff, -1))
        if state.shape[-1] >= 14:
            # keep the thrust axis near +z and the body rates bounded (an
            # explicit tilt term keeps the rollouts upright)
            qx, qy = state[..., 7], state[..., 8]
            tilt = 2.0 * (qx * qx + qy * qy)  # 1 − R₃₃
            rates = state[..., 10:13]
            cost = cost + tilt_weight * tilt + rate_weight * rsum(rates * rates, -1)
        return cost

    def terminal(state):
        along, lat = gate_terms(state[..., :3], gate_of(state))
        return 4.0 * progress_weight * torch.abs(along) + lateral_weight * lat

    def advance(pos_prev, pos, idx, tol=0.0):
        """Crossing check (racing_mppi_3d.rs GateTransition): the signed
        normal distance goes − → + with the crossing point inside the
        aperture."""
        i = idx.to(torch.int64) % ng
        gc, gn = at(c, i), at(n, i)
        s0 = rsum((pos_prev - gc) * gn, -1)
        s1 = rsum((pos - gc) * gn, -1)
        crossed = (s0 < 0) & (s1 >= 0)
        t = torch.where(torch.abs(s1 - s0) > 1e-12, -s0 / (s1 - s0), torch.zeros_like(s0))
        xp = pos_prev + torch.clamp(t, 0.0, 1.0)[..., None] * (pos - pos_prev)
        wr = torch.abs(rsum((xp - gc) * at(r, i), -1)) <= at(hw, i) + tol
        hr = torch.abs(rsum((xp - gc) * at(u, i), -1)) <= at(hh, i) + tol
        passed = crossed & wr & hr
        return torch.where(passed, idx + 1, idx), passed

    return stage, terminal, advance


# ---------------------------------------------------------------------------
# motor-level quadrotor (racing_mppi_motor.rs)


@dataclasses.dataclass(frozen=True)
class MotorQuadParams:
    gravity: float = 9.81
    drag: float = 0.3
    max_rotor_thrust: float = 6.0
    torque_gain: float = 9.0
    yaw_gain: float = 2.0
    rate_damping: float = 1.2
    max_speed: float = 7.0


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _quat_rotate(q, v):
    qv = q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + q[..., :1] * t + _cross(qv, t)


def _quat_integrate(q, w, dt):
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    dq = torch.stack([
        -(qx * wx + qy * wy + qz * wz),
        qw * wx + qy * wz - qz * wy,
        qw * wy + qz * wx - qx * wz,
        qw * wz + qx * wy - qy * wx,
    ], -1)
    q = q + (0.5 * dt) * dq
    return q / torch.clamp(sqrt_sum(q * q), min=1e-12)[..., None]


def hover_state(x, y, z, params: MotorQuadParams, gate_idx=0.0, dtype=None, device=None):
    """State layout [14]: pos 3, vel 3, quat 4, rates 3, active gate 1; on
    `device` (default cuda) in `dtype` (default torch's)."""
    return filled([x, y, z, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, gate_idx],
                  dtype or torch.get_default_dtype(), resolve_device(device))


def motor_quad_step(params: MotorQuadParams, state, rotors, dt, max_rotor=None):
    """One step of the rotor-mixing rigid body (racing_mppi_motor.rs:212).
    `max_rotor` overrides the saturation ceiling."""
    ceil = params.max_rotor_thrust if max_rotor is None else max_rotor
    f = torch.clamp(rotors, min=0.0)
    f = torch.minimum(f, ceil) if isinstance(ceil, torch.Tensor) else torch.clamp(f, max=ceil)
    f0, f1, f2, f3 = f[..., 0], f[..., 1], f[..., 2], f[..., 3]
    roll = params.torque_gain * ((f1 + f2) - (f0 + f3))
    pitch = params.torque_gain * ((f0 + f1) - (f2 + f3))
    yaw = params.yaw_gain * ((f0 + f2) - (f1 + f3))
    torque = torch.stack([roll, pitch, yaw], -1)

    pos, vel, quat = state[..., 0:3], state[..., 3:6], state[..., 6:10]
    rates, gate = state[..., 10:13], state[..., 13:14]

    rates = rates + (torque - params.rate_damping * rates) * dt
    quat = _quat_integrate(quat, rates, dt)
    thrust = rsum(f, -1)
    zero = torch.zeros_like(thrust)
    axis = _quat_rotate(quat, torch.stack([zero, zero, zero + 1.0], -1))
    acc = thrust[..., None] * axis - params.drag * vel
    acc = torch.stack([acc[..., 0], acc[..., 1], acc[..., 2] - params.gravity], -1)
    vel = vel + acc * dt
    speed = sqrt_sum(vel * vel)[..., None]
    vel = torch.where(speed > params.max_speed,
                      vel * params.max_speed / torch.clamp(speed, min=1e-9), vel)
    pos = pos + vel * dt
    return torch.cat([pos, vel, quat, rates, gate], -1)


# ---------------------------------------------------------------------------
# powertrain (racing_mppi_powertrain.rs)


@dataclasses.dataclass(frozen=True)
class PowertrainParams:
    base: MotorQuadParams = MotorQuadParams()
    motor_tau: float = 0.08
    discharge_rate: float = 0.02
    sag_coeff: float = 0.12
    min_voltage_scale: float = 0.7
    relax_build: float = 0.0
    relax_recover: float = 0.0
    relax_coeff: float = 0.0

    @staticmethod
    def ideal(base: MotorQuadParams = MotorQuadParams()):
        """Zero lag, no discharge, no sag — reduces exactly to the motor
        model (the benchmark baseline)."""
        return PowertrainParams(base, motor_tau=0.0, discharge_rate=0.0, sag_coeff=0.0,
                                min_voltage_scale=1.0)


def powertrain_init(quad_state, params: PowertrainParams, soc=1.0):
    """Augment the 14-state quad with [rotor_thrust 4, soc 1, relax 1], on
    the quad state's device."""
    hover = params.base.gravity / 4.0
    return torch.cat([quad_state, filled([hover] * 4 + [soc, 0.0], quad_state.dtype,
                                         quad_state.device)])


def _voltage_scale(p: PowertrainParams, soc, load, relaxation):
    soc = torch.clamp(soc, 0.0, 1.0)
    ocv = p.min_voltage_scale + (1.0 - p.min_voltage_scale) * soc
    v = torch.clamp(ocv - p.sag_coeff * load, 0.0, 1.0)
    return torch.clamp(v - p.relax_coeff * torch.clamp(relaxation, 0.0, 1.0), 0.0, 1.0)


def _load(p: PowertrainParams, rotors):
    return torch.clamp(true_div(rsum(rotors, -1), 4.0 * p.base.max_rotor_thrust), 0.0, 1.0)


def effective_max_rotor(p: PowertrainParams, state):
    return p.base.max_rotor_thrust * _voltage_scale(p, state[..., 18], _load(p, state[..., 14:18]),
                                                    state[..., 19])


def powertrain_step(params: PowertrainParams, state, command, dt):
    """Powertrain step (racing_mppi_powertrain.rs:235): a ceiling-clamped
    first-order lag on the rotor thrusts, the base physics on the actual
    thrusts, monotone discharge, relaxation build/recover."""
    p = params
    quad, rt = state[..., :14], state[..., 14:18]
    soc, relax = state[..., 18], state[..., 19]

    eff = effective_max_rotor(p, state)
    alpha = 1.0 - math.exp(-dt / p.motor_tau) if p.motor_tau > 0 else 1.0
    target = torch.minimum(torch.clamp(command, min=0.0), eff[..., None])
    rt = rt + (target - rt) * alpha

    quad = motor_quad_step(p.base, quad, rt, dt, max_rotor=p.base.max_rotor_thrust)
    load = _load(p, rt)
    soc = torch.clamp(soc - p.discharge_rate * load * dt, 0.0, 1.0)
    relax = torch.clamp(relax + (p.relax_build * load - p.relax_recover * relax) * dt, 0.0, 1.0)
    return torch.cat([quad, rt, soc[..., None], relax[..., None]], -1)


# ---------------------------------------------------------------------------
# closed loop


def simulate_gate_race(generator, gates, params: PowertrainParams, start=(0.0, 0.0, 1.5),
                       steps: int = 120, dt: float = 0.05, horizon: int = 18,
                       num_samples: int = 192, aware: bool = True, charge_weight: float = 0.0,
                       charge_reserve: float = 0.0, closed: bool = True, draws=None, dtype=None,
                       device=None):
    """Closed-loop race through `gates` (simulate_powertrain_race*):
    `aware=False` plans with ideal actuators but executes through the real
    powertrain; `aware=True` rolls MPPI candidates through the powertrain
    itself. ChargeBudget: penalize load when the SOC falls below
    `charge_reserve` with `charge_weight`. Step i's MPPI noise is
    `draws[i]` (standard normals [steps, K, H, 4]) or drawn from
    `generator`. On `device` (default cuda) in `dtype` (default torch's).

    Returns report dict(gates_passed, lap_fraction, laps_completed,
    mean_speed, max_speed, saturation_fraction, final_soc, min_soc,
    trajectory)."""
    f, dev = dtype or torch.get_default_dtype(), resolve_device(device)
    base = params.base
    hover = base.gravity / 4.0
    stage_g, term_g, advance = make_gate_lap_costs(gates, hover_thrust=hover, dtype=f, device=dev)
    ng = len(gates)

    def stage(state, u_ctl):
        c = stage_g(state, u_ctl)
        if charge_weight > 0.0 and state.shape[-1] >= 20:
            load = torch.clamp(true_div(rsum(u_ctl, -1), 4.0 * base.max_rotor_thrust), 0.0, 1.0)
            low = state[..., 18] < charge_reserve
            c = c + charge_weight * torch.where(low, load, torch.zeros_like(load))
        return c

    plan_params = params if aware else PowertrainParams.ideal(base)

    def plan_dyn(state, u_ctl, dtv):
        new = powertrain_step(plan_params, state, u_ctl, dtv)
        idx, _ = advance(state[..., 0:3], new[..., 0:3], state[..., 13])
        return set_last(new, 13, idx)

    mcfg = MPPIConfig(horizon=horizon, num_samples=num_samples, temperature=0.25,
                      noise_sigma=(0.2,) * 4, control_min=(0.0,) * 4,
                      control_max=(base.max_rotor_thrust,) * 4, dt=dt)
    state = powertrain_init(hover_state(*start, base, dtype=f, device=dev), params)
    u_nom = torch.full((horizon, 4), hover, dtype=f, device=dev)
    traj = [state]
    passed = torch.zeros((), dtype=torch.int64, device=dev)
    sat_steps = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(steps):
        u_nom, first, _ = mppi_plan(generator, plan_dyn, stage, term_g, state, u_nom, mcfg,
                                    draws=None if draws is None else draws[i])
        new = powertrain_step(params, state, first, dt)
        idx, hit = advance(state[0:3], new[0:3], state[13])
        if not closed:
            idx = torch.clamp(idx, max=ng)
        new = torch.cat([new[:13], idx[None], new[14:]])
        passed = passed + hit.to(passed.dtype)
        eff = effective_max_rotor(params, state)
        sat_steps = sat_steps + (torch.amax(first) >= eff - 1e-6).to(sat_steps.dtype)
        state = new
        traj.append(state)
        u_nom = torch.cat([u_nom[1:], u_nom[-1:]])
    traj = torch.stack(traj).cpu().numpy()
    passed, sat_steps = int(passed), int(sat_steps)
    speeds = np.linalg.norm(traj[:, 3:6], axis=1)
    return {
        "gates_passed": passed,
        "lap_fraction": passed / ng,
        "laps_completed": passed // ng,
        "mean_speed": float(speeds.mean()),
        "max_speed": float(speeds.max()),
        "saturation_fraction": sat_steps / steps,
        "final_soc": float(traj[-1, 18]),
        "min_soc": float(min(1.0, traj[1:, 18].min())) if steps else 1.0,
        "trajectory": traj,
    }
