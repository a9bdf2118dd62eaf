"""Batched tensor helpers of the scripted experts, shared by the action
kinds ``pushing_expert`` and ``stacking_expert``.

A frozen copy of the helpers of ``d3il_tpu_torch/data/experts.py`` at
commit 03a1e77, unchanged but for the module's imports, so that a change
to the program cannot change the traffic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_CONSTS: dict = {}


def const(name: str, values, device) -> torch.Tensor:
    """A float32 constant on ``device``, copied there once."""
    key = (name, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(np.asarray(values, np.float32),
                                       device=device)
    return _CONSTS[key]


def norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def dot(a, b):
    return (a * b).sum(dim=-1)


def col(x):
    """A per-env [B] value as a [B, 1] column (a Python number as is)."""
    return x[:, None] if torch.is_tensor(x) else x


def rows(x, idx):
    """x[e, idx[e]] for every env e: x [B, n, ...], idx [B]."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def step_toward(cur, tgt, step):
    step = col(step)
    return cur + torch.clamp(tgt - cur, -step, step)


def limit_lead(nxt, tcp, max_lead):
    """Cap how far the setpoint leads the physical tcp."""
    ahead = nxt - tcp
    d = norm(ahead)
    capped = tcp + ahead / col(torch.clamp(d, min=1e-9)) * col(max_lead)
    return torch.where(col(d > max_lead), capped, nxt)


def yaw_of(quat):
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


def i32(x):
    return x.to(torch.int32)


def phase_shares(phase, n_phases: int):
    """The share of envs in each phase, as a device tensor (no sync)."""
    counts = torch.bincount(phase.long().clamp(0, n_phases - 1),
                            minlength=n_phases)
    return counts.float() / phase.shape[0]
