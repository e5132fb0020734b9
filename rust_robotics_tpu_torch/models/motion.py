"""Motion models for the shared 2D unicycle demo problem.

Reference: the motion model every localizer in the reference shares
(localization/src/ekf.rs:203-212 `motion_model`, :214-233 `jacobian_f`):

    x' = x + dt * v * cos(yaw)
    y' = y + dt * v * sin(yaw)
    yaw' = yaw + dt * omega
    v' = v                      (velocity is overwritten by the control)

State is [x, y, yaw, v]; control is [v, omega]. Batched over leading dims and
differentiable; the analytic Jacobian has the reference's zeroed last row.
"""

import torch


def unicycle_propagate(state, control, dt):
    """State [..., 4], control [..., 2] -> next state [..., 4]. `ekf.rs:203`."""
    x, y, yaw = state[..., 0], state[..., 1], state[..., 2]
    v, omega = control[..., 0], control[..., 1]
    parts = torch.broadcast_tensors(
        x + dt * v * torch.cos(yaw),
        y + dt * v * torch.sin(yaw),
        yaw + dt * omega,
        v,
    )
    return torch.stack(parts, dim=-1)


def unicycle_jacobian(state, control, dt):
    """Analytic dF/dstate [..., 4, 4] evaluated like the reference.

    The reference evaluates the Jacobian at the *predicted* state
    (ekf.rs:318-321); callers here follow the same convention. The last row
    is zero (v' depends only on the control).
    """
    yaw = state[..., 2]
    v = control[..., 0]
    z = torch.zeros_like(yaw)
    one = torch.ones_like(yaw)
    row0 = torch.stack([one, z, -dt * v * torch.sin(yaw), z], dim=-1)
    row1 = torch.stack([z, one, dt * v * torch.cos(yaw), z], dim=-1)
    row2 = torch.stack([z, z, one, z], dim=-1)
    row3 = torch.stack([z, z, z, z], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def unicycle_jacobian_autodiff(state, control, dt):
    """Autodiff Jacobian (sanity check against the analytic form)."""
    return torch.func.jacrev(lambda s: unicycle_propagate(s, control, dt))(state)
