"""Quasi-static planar pushing (pusher-slider) with contact modes and MPPI.

The port of rust_robotics_tpu/control/pusher_slider.py. Reference:
crates/rust_robotics_control/src/pusher_slider.rs — a point pusher on any
of a square slider's four faces, the ellipsoidal limit-surface model: the
contact-point velocity maps to the contact force through
M = (1/c²)[[c²+p_y², −p_x p_y], [−p_x p_y, c²+p_x²]] (:183-:199); the
contact sticks when |f_t| ≤ μ f_n, else it slides with the force on the
friction-cone edge, rescaled so that the commanded normal speed holds
(:205-:230). Per-face MPPI with the lowest-cost face and a closed loop
(:744-:860); `two_contact_twist` solves two simultaneous contacts by
enumerating per-contact stick/slide modes with a padded 4×4 force solve
(:275-:359).

The twist solve is branch-free (`torch.where` over the mode conditions),
so MPPI's [faces × samples] rollouts evaluate at once, the four faces as a
leading batch dim of one `mppi_plan`. The nine two-contact mode
combinations are one batch of padded 4×4 systems (`_small.solve_small`)
with validity masks and a first-valid priority pick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rust_robotics_tpu_torch._numeric import filled, norm2, true_div
from rust_robotics_tpu_torch.control._small import as_float, at, dot, rsum, solve_small
from rust_robotics_tpu_torch.control.mppi import MPPIConfig, mppi_plan

__all__ = [
    "PusherSliderParams",
    "contact_frame",
    "pusher_twist",
    "pusher_step",
    "two_contact_twist",
    "PusherMppiConfig",
    "pusher_mppi_plan",
    "simulate_push",
    "MODE_SEPARATED",
    "MODE_STICK",
    "MODE_SLIDE_UP",
    "MODE_SLIDE_DOWN",
]

MODE_SEPARATED, MODE_STICK, MODE_SLIDE_UP, MODE_SLIDE_DOWN = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class PusherSliderParams:
    """half_extent b, limit-surface characteristic length c, pusher
    friction μ (pusher_slider.rs:114)."""

    half_extent: float = 0.5
    char_len: float = 0.35
    pusher_friction: float = 0.3


def _face_tensor(face, like):
    if isinstance(face, torch.Tensor):
        return face.to(torch.int64) % 4
    return torch.full((), int(face) % 4, dtype=torch.int64, device=like.device)


def contact_frame(face, contact, half_extent):
    """Body-frame contact point p, inward normal d and tangent t [..., 2]
    for faces 0..3 (pusher_slider.rs:156), branch-free. `face` is an int
    or an integer tensor broadcastable with `contact`."""
    b = half_extent
    s = torch.clamp(contact, -b, b)
    face = _face_tensor(face, s)
    zero = torch.zeros_like(s)
    one = zero + 1.0

    def pick(v0, v1, v2, v3):
        return torch.where(face == 0, v0, torch.where(face == 1, v1, torch.where(face == 2, v2, v3)))

    p = torch.stack([pick(-b + zero, s, b + zero, s), pick(s, b + zero, s, -b + zero)], -1)
    d = torch.stack([pick(one, zero, -one, zero), pick(zero, -one, zero, one)], -1)
    t = torch.stack([pick(zero, one, zero, -one), pick(one, zero, -one, zero)], -1)
    return p, d, t


def pusher_twist(params: PusherSliderParams, face, contact, push_speed, tangent_speed):
    """Body twist [..., 3] = [vx, vy, ω] and contact mode for one command —
    the limit-surface solve (pusher_slider.rs:172-:230), branch-free."""
    c2 = params.char_len ** 2
    p, d, t = contact_frame(face, contact, params.half_extent)
    px, py = p[..., 0], p[..., 1]
    vn = torch.clamp(push_speed, min=0.0)
    vt = tangent_speed

    wx = vn * d[..., 0] + vt * t[..., 0]
    wy = vn * d[..., 1] + vt * t[..., 1]
    m11 = true_div(c2 + py * py, c2)
    m12 = true_div(-(px * py), c2)
    m22 = true_div(c2 + px * px, c2)
    det = m11 * m22 - m12 * m12
    safe = torch.abs(det) > 1e-15
    den = torch.where(safe, det, torch.ones_like(det))
    fx = torch.where(safe, (m22 * wx - m12 * wy) / den, wx)
    fy = torch.where(safe, (-m12 * wx + m11 * wy) / den, wy)

    fn_ = fx * d[..., 0] + fy * d[..., 1]
    ft = fx * t[..., 0] + fy * t[..., 1]
    mu = params.pusher_friction

    # stick branch
    stick_twist = torch.stack([fx, fy, true_div(px * fy - py * fx, c2)], -1)

    # slide branch: the cone-edge force rescaled to keep v_n
    sign = torch.where(ft > 0, 1.0, -1.0).to(ft.dtype)
    fe0 = d[..., 0] + sign * mu * t[..., 0]
    fe1 = d[..., 1] + sign * mu * t[..., 1]
    omega1 = true_div(px * fe1 - py * fe0, c2)
    proj = (fe0 - omega1 * py) * d[..., 0] + (fe1 + omega1 * px) * d[..., 1]
    big = torch.abs(proj) > 1e-12
    k = torch.where(big, vn / torch.where(big, proj, torch.ones_like(proj)), vn)
    k = torch.clamp(k, min=0.0)
    slide_twist = k[..., None] * torch.stack([fe0, fe1, omega1], -1)

    sticks = torch.abs(ft) <= mu * fn_ + 1e-12
    separated = (vn <= 1e-12) | (fn_ <= 0.0)
    twist = torch.where(sticks[..., None], stick_twist, slide_twist)
    twist = torch.where(separated[..., None], torch.zeros_like(twist), twist)
    mode = torch.where(separated, MODE_SEPARATED,
                       torch.where(sticks, MODE_STICK,
                                   torch.where(sign > 0, MODE_SLIDE_UP, MODE_SLIDE_DOWN)))
    return twist, mode


def _advance(pose, twist, dt):
    th = pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    vx = c * twist[..., 0] - s * twist[..., 1]
    vy = s * twist[..., 0] + c * twist[..., 1]
    return torch.stack([pose[..., 0] + vx * dt, pose[..., 1] + vy * dt,
                        th + twist[..., 2] * dt], -1)


def pusher_step(params: PusherSliderParams, pose, face, contact, push_speed, tangent_speed, dt):
    """Advance the slider one quasi-static step (pusher_slider.rs:234)."""
    twist, mode = pusher_twist(params, face, contact, push_speed, tangent_speed)
    return _advance(pose, twist, dt), mode


# ---------------------------------------------------------------------------
# two simultaneous contacts (pusher_slider.rs:275)

# the mode combinations in priority order: 0 stick, ±1 slide±
_COMBOS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))


def two_contact_twist(params: PusherSliderParams, faces, contacts, push_speeds, tangent_speeds,
                      dtype=None, device=None):
    """Contact-implicit two-contact solve: enumerate per-contact {stick,
    slide+, slide−} modes (9 combinations), solve each padded 4×4 force
    system, keep the first valid combination in priority order (both
    stick first). Host inputs go to `device` (default cuda; the contacts'
    own when a tensor) in `dtype` (default torch's). Returns (twist [3],
    modes [2], valid)."""
    c2 = params.char_len ** 2
    mu = params.pusher_friction
    contacts = as_float(contacts, dtype, device)
    f, dev = contacts.dtype, contacts.device
    vn = torch.clamp(as_float(push_speeds, f, dev), min=0.0)
    vt = as_float(tangent_speeds, f, dev)
    frames = [contact_frame(faces[i], contacts[i], params.half_extent) for i in range(2)]
    p = torch.stack([fr[0] for fr in frames])  # [2, 2]
    d = torch.stack([fr[1] for fr in frames])
    t = torch.stack([fr[2] for fr in frames])
    zero = torch.zeros((), dtype=f, device=dev)

    def twist_of(force):
        """Body twist (v [2], ω) of contact forces [2, 2]:
        v = Σ f_i, ω = Σ (p_i × f_i)/c²."""
        om = true_div(p[0, 0] * force[0, 1] - p[0, 1] * force[0, 0]
                      + p[1, 0] * force[1, 1] - p[1, 1] * force[1, 0], c2)
        return force[0] + force[1], om

    def contact_vel(v, om, i):
        """u_i = v + ω × p_i."""
        return torch.stack([v[0] - om * p[i, 1], v[1] + om * p[i, 0]])

    def solve_combo(modes):
        # unknowns z[4]: a sticking contact takes 2 (x, y force), a sliding
        # one 1 (along its cone edge); contact 0 first, zero padded
        cols = []
        for i, m in enumerate(modes):
            if m == 0:
                cols += [(torch.stack([zero + 1.0, zero]), i), (torch.stack([zero, zero + 1.0]), i)]
            else:
                cols.append((d[i] + m * mu * t[i], i))
        # equations: each contact's normal speed; a sticking one's tangent too
        rows = [("n", i, vn[i]) for i in range(2)]
        rows += [("t", i, vt[i]) for i, m in enumerate(modes) if m == 0]
        amat = [[zero] * 4 for _ in range(4)]
        bvec = [zero] * 4
        for r, (kind, i, rhs) in enumerate(rows):
            axis = d[i] if kind == "n" else t[i]
            for k, (basis, j) in enumerate(cols):
                unit = torch.stack([basis if jj == j else torch.zeros_like(basis)
                                    for jj in range(2)])
                v, om = twist_of(unit)
                amat[r][k] = dot(contact_vel(v, om, i), axis)
            bvec[r] = rhs
        for k in range(max(len(rows), len(cols)), 4):  # pad: z_k = 0
            amat[k][k] = zero + 1.0
        # the regularization sits above the dtype's epsilon (1e-12 in f64
        # vanishes in f32, where a near-singular combination solves to noise)
        eps = 1e-12 if f == torch.float64 else 1e-4
        a = torch.stack([torch.stack(row) for row in amat]) + eps * torch.eye(4, dtype=f, device=dev)
        z = solve_small(a, torch.stack(bvec))
        force = [zero.expand(2), zero.expand(2)]
        for k, (basis, i) in enumerate(cols):
            force[i] = force[i] + z[k] * basis
        force = torch.stack(force)
        v, om = twist_of(force)
        valid = torch.ones((), dtype=torch.bool, device=dev)
        for i, m in enumerate(modes):
            fn_i, ft_i = dot(force[i], d[i]), dot(force[i], t[i])
            valid = valid & (fn_i >= -1e-9)
            if m == 0:
                valid = valid & (torch.abs(ft_i) <= mu * fn_i + 1e-9)
            else:
                slip = vt[i] - dot(contact_vel(v, om, i), t[i])  # pusher minus body
                valid = valid & (m * slip >= -1e-9)  # friction drags along slip
        return torch.cat([v, om[None]]), valid

    twists, valids = zip(*(solve_combo(modes) for modes in _COMBOS))
    twists, valids = torch.stack(twists), torch.stack(valids)
    pick = torch.argmax(valids.to(torch.uint8))  # the first valid in priority order
    any_valid = torch.any(valids)
    twist = torch.where(any_valid, at(twists, pick), torch.zeros_like(twists[0]))
    codes = filled([m for combo in _COMBOS for m in combo], torch.int64, dev).reshape(9, 2)
    modes = torch.where(any_valid, at(codes, pick), torch.zeros_like(codes[0]))
    return twist, modes, any_valid


def two_contact_step(params, pose, faces, contacts, push_speeds, tangent_speeds, dt):
    twist, modes, valid = two_contact_twist(params, faces, contacts, push_speeds, tangent_speeds,
                                            dtype=pose.dtype, device=pose.device)
    return _advance(pose, twist, dt), modes, valid


# ---------------------------------------------------------------------------
# per-face MPPI controller (pusher_slider.rs:475-:860)


@dataclasses.dataclass(frozen=True)
class PusherMppiConfig:
    horizon: int = 20
    num_samples: int = 128
    temperature: float = 0.3
    dt: float = 0.1
    push_speed_max: float = 0.6
    tangent_speed_max: float = 0.4
    pos_weight: float = 10.0
    theta_weight: float = 2.0
    control_weight: float = 0.05
    obstacle_weight: float = 50.0
    obstacle_radius: float = 0.8


def pusher_mppi_plan(generator, params: PusherSliderParams, pose, goal,
                     cfg: PusherMppiConfig = PusherMppiConfig(), obstacles=None, draws=None,
                     dtype=None, device=None):
    """MPPI per face, the four faces at once; returns (best_face, first
    command [3], per-face costs [4]). Control = (contact offset, push
    speed, tangent speed). Face j's noise is `draws[j]` (standard normals
    [4, K, H, 3]) or drawn from `generator`. Host inputs go to `device`
    (default cuda; pose's own when a tensor) in `dtype`."""
    pose = as_float(pose, dtype, device)
    f, dev = pose.dtype, pose.device
    goal = as_float(goal, f, dev)
    obs = (as_float(obstacles, f, dev) if obstacles is not None
           else torch.full((1, 2), 1e6, dtype=f, device=dev))
    b = params.half_extent
    mcfg = MPPIConfig(
        horizon=cfg.horizon, num_samples=cfg.num_samples, temperature=cfg.temperature,
        noise_sigma=(0.3 * b, 0.2, 0.15),
        control_min=(-b, 0.0, -cfg.tangent_speed_max),
        control_max=(b, cfg.push_speed_max, cfg.tangent_speed_max),
        dt=cfg.dt,
    )
    faces = torch.arange(4, device=dev)[:, None]  # one per leading lane

    def dyn(state, u, dt):
        new, _ = pusher_step(params, state, faces, u[..., 0], u[..., 1], u[..., 2], dt)
        return new

    def pose_cost(state):
        e = state[..., :2] - goal[:2]
        dth = torch.atan2(torch.sin(state[..., 2] - goal[2]), torch.cos(state[..., 2] - goal[2]))
        return cfg.pos_weight * rsum(e * e, -1) + cfg.theta_weight * dth * dth

    def stage(state, u):
        od = norm2(state[..., None, :2] - obs)
        pen = rsum(torch.clamp(cfg.obstacle_radius - od, min=0.0) ** 2, -1)
        return pose_cost(state) + cfg.control_weight * rsum(u * u, -1) + cfg.obstacle_weight * pen

    def terminal(state):
        return 5.0 * pose_cost(state)

    u0 = torch.zeros((4, cfg.horizon, 3), dtype=f, device=dev)
    u0[..., 1] = 0.5 * cfg.push_speed_max
    _, first, diag = mppi_plan(generator, dyn, stage, terminal, pose.expand(4, 3), u0, mcfg,
                               draws=draws)
    costs = diag.best_cost
    best = torch.argmin(costs)
    return best, at(first, best), costs


def simulate_push(generator, params: PusherSliderParams, start, goal, steps: int = 80,
                  cfg: PusherMppiConfig = PusherMppiConfig(), obstacles=None,
                  goal_tol: float = 0.08, draws=None, dtype=None, device=None):
    """Closed-loop push to a goal pose (simulate_push, :794). Step i's
    faces draw `draws[i]` ([steps, 4, K, H, 3] standard normals) or from
    `generator`. One read a step (the goal test). On `device` (default
    cuda) in `dtype` (default torch's). Returns a PushReport dict
    (trajectory [T+1, 3], faces [T], modes [T], final_position_error,
    final_heading_error, reached, steps_used)."""
    pose = as_float(start, dtype, device)
    goal_t = as_float(goal, pose.dtype, pose.device)
    traj, faces, modes = [pose], [], []
    used = steps
    for i in range(steps):
        face, cmd, _ = pusher_mppi_plan(generator, params, pose, goal_t, cfg, obstacles,
                                        draws=None if draws is None else draws[i])
        pose, mode = pusher_step(params, pose, face, cmd[0], cmd[1], cmd[2], cfg.dt)
        traj.append(pose)
        faces.append(face)
        modes.append(mode)
        perr = norm2(pose[:2] - goal_t[:2])
        herr = torch.abs(torch.atan2(torch.sin(pose[2] - goal_t[2]), torch.cos(pose[2] - goal_t[2])))
        if bool((perr < goal_tol) & (herr < 0.3)):
            used = i + 1
            break
    traj = torch.stack(traj).cpu().numpy()
    g = np.asarray(goal_t.cpu().numpy(), float)
    last = traj[-1]
    return {
        "trajectory": traj,
        "faces": torch.stack(faces).cpu().numpy() if faces else np.zeros(0, np.int64),
        "modes": torch.stack(modes).cpu().numpy() if modes else np.zeros(0, np.int64),
        "final_position_error": float(np.hypot(*(last[:2] - g[:2]))),
        "final_heading_error": float(abs(np.arctan2(np.sin(last[2] - g[2]),
                                                    np.cos(last[2] - g[2])))),
        "reached": used < steps,
        "steps_used": used,
    }

