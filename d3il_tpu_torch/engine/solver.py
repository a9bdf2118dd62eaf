"""Soft-constraint contact model pieces (``d3il_tpu/engine/solver.py``):
the MuJoCo solimp impedance sigmoid and the friction-cone projection."""
from __future__ import annotations

import torch


def impedance(solimp, r):
    """MuJoCo solimp sigmoid d(r) in (0, 1); solimp = (d0, dw, width, mid,
    power), each broadcastable against r."""
    d0, dw, width, mid, power = solimp
    x = (r.abs() / width.clamp_min(1e-12)).clamp(0.0, 1.0)
    a = 1.0 / mid ** (power - 1)
    b = 1.0 / (1.0 - mid) ** (power - 1)
    y = torch.where(x < mid, a * x ** power, 1.0 - b * (1.0 - x) ** power)
    return d0 + y * (dw - d0)


def _project_cone_rows(f, mu, active):
    """Elliptic friction-cone projection over contact rows.

    f [..., nc, 3] (fn, ft1, ft2); mu [..., nc]; active [..., nc] bool."""
    fn, ft = f[..., 0], f[..., 1:]
    t = torch.linalg.vector_norm(ft, dim=-1)
    inside = t <= mu * fn
    below = mu * t <= -fn
    fn_p = (fn + mu * t) / (1.0 + mu * mu)
    scale = mu * fn_p / t.clamp_min(1e-12)
    f_proj = torch.cat([fn_p[..., None], ft * scale[..., None]], dim=-1)
    out = torch.where(inside[..., None], f,
                      torch.where(below[..., None], torch.zeros_like(f),
                                  f_proj))
    return torch.where(active[..., None], out, torch.zeros_like(out))
