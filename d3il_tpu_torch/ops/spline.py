"""Point-to-point quintic trajectories, closed form and batched.

Counterpart of ``d3il_tpu/ops/spline.py``. The reference's goto
trajectories are degree-5 B-splines through two points with zero first and
second derivatives at both ends, which is the quintic smoothstep

    s(u) = 10 u^3 - 15 u^4 + 6 u^5,     u = t / T in [0, 1],

evaluated here in closed form on tensors.
"""
from __future__ import annotations

import torch


def quintic_blend(u: torch.Tensor) -> torch.Tensor:
    """Minimum-jerk blend s(u): s(0) = 0, s(1) = 1, zero velocity and
    acceleration at both ends."""
    u = u.clamp(0.0, 1.0)
    return u * u * u * (10.0 + u * (-15.0 + 6.0 * u))


def quintic_blend_vel(u: torch.Tensor) -> torch.Tensor:
    """ds/du."""
    u = u.clamp(0.0, 1.0)
    return u * u * (30.0 + u * (-60.0 + 30.0 * u))


def p2p_trajectory(p0: torch.Tensor, p1: torch.Tensor, duration,
                   dt) -> torch.Tensor:
    """Positions [n_steps + 1, dim] of the quintic point-to-point
    trajectory over t = 0..duration inclusive (the reference's
    ``np.linspace(0, duration, int(duration / dt) + 1)`` grid)."""
    n = int(round(duration / dt)) + 1
    u = torch.linspace(0.0, 1.0, n, dtype=p0.dtype, device=p0.device)
    return p0[None, :] + (p1 - p0)[None, :] * quintic_blend(u)[:, None]


def p2p_eval(p0: torch.Tensor, p1: torch.Tensor, duration, t):
    """Position and velocity of the quintic p2p trajectory at time t
    (clamped to [0, duration])."""
    u = torch.as_tensor(t / duration, dtype=p0.dtype,
                        device=p0.device).clamp(0.0, 1.0)
    return (p0 + (p1 - p0) * quintic_blend(u),
            (p1 - p0) * quintic_blend_vel(u) / duration)
