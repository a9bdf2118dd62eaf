"""Soft-constraint contact model (``d3il_tpu/engine/solver.py``): the
MuJoCo solimp impedance sigmoid, the constraint stiffness and damping, the
friction-cone projection and the dense per-env APGD solve of the dual cone
QP. The batched windows solve the same QP matrix-free
(``contact.phase_core``, K3)."""
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


def kbi(solref, solimp, r):
    """Stiffness k, damping b and impedance d of one constraint with
    violation r (solref = (timeconst, dampratio))."""
    as_t = lambda x: torch.as_tensor(x, dtype=r.dtype, device=r.device)
    timeconst, dampratio = (as_t(x) for x in solref)
    solimp = tuple(as_t(x) for x in solimp)
    d = impedance(solimp, r)
    dmax = solimp[1]
    b = 2.0 / (dmax * timeconst).clamp_min(1e-12)
    k = 1.0 / (dmax * dmax * timeconst * timeconst * dampratio
               * dampratio).clamp_min(1e-12)
    return k, b, d


def _project_cone(f, mu):
    """Project one contact's (fn, ft1, ft2) onto the friction cone
    {||ft|| <= mu fn}."""
    fn, ft = f[0], f[1:]
    t = torch.linalg.vector_norm(ft)
    inside = t <= mu * fn
    below = mu * t <= -fn
    fn_p = (fn + mu * t) / (1.0 + mu * mu)
    scale = mu * fn_p / t.clamp_min(1e-12)
    f_proj = torch.cat([fn_p[None], ft * scale])
    return torch.where(inside, f, torch.where(below, torch.zeros_like(f),
                                              f_proj))


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


def solve_contacts(A, b0, mu, active, n_iters: int, f0=None):
    """Preconditioned APGD on the dual contact QP min_{f in cone}
    1/2 f'Af + f'b0, for one env with a dense Delassus matrix.

    A [nc, 3, nc, 3], b0 [nc, 3], mu [nc], active [nc] bool, f0 an optional
    warm start [nc, 3]. Each contact block is scaled by diag(sn, st, st)
    ^-1/2, which keeps the cone circular (mu' = mu sqrt(st / sn)); the step
    is 1 / (1.5 x) the Rayleigh quotient of a 6-step power iteration.
    Returns the contact forces f [nc, 3]."""
    nc = b0.shape[0]
    n = 3 * nc
    Af = A.reshape(n, n)
    d3 = torch.diagonal(Af).reshape(nc, 3)
    sn = d3[:, 0].clamp_min(1e-10)
    st = (0.5 * (d3[:, 1] + d3[:, 2])).clamp_min(1e-10)
    s_half = torch.sqrt(torch.stack([sn, st, st], dim=1).reshape(n))
    mu_s = mu * torch.sqrt(st / sn)
    mask = active.to(b0.dtype).repeat_interleave(3)
    inv_sh = mask / s_half
    Ah = Af * (inv_sh[:, None] * inv_sh[None, :])
    bh = b0.reshape(n) * inv_sh

    v = b0.new_ones(n)
    for _ in range(6):
        v = Ah @ v
        v = v / torch.linalg.vector_norm(v).clamp_min(1e-12)
    # 1.5x safety: the Rayleigh quotient under-estimates lambda_max
    step = 1.0 / (1.5 * (v @ (Ah @ v)).clamp_min(1.0))

    def proj(fh):
        return _project_cone_rows(fh.reshape(nc, 3), mu_s,
                                  active).reshape(n)

    fh = proj(b0.new_zeros(n) if f0 is None
              else f0.reshape(n) * s_half * mask)
    y = fh
    theta = b0.new_ones(())
    for _ in range(n_iters):
        g = Ah @ y + bh
        f_new = proj(y - step * g)
        # adaptive restart: drop the momentum when the gradient opposes
        # the progress
        df = f_new - fh
        restart = (g * df).sum() > 0.0
        theta = torch.where(restart, 1.0, theta)
        theta_new = 0.5 * (torch.sqrt(theta ** 4 + 4 * theta ** 2)
                           - theta ** 2)
        beta = torch.where(restart, 0.0,
                           theta * (1 - theta) / (theta ** 2 + theta_new))
        fh, y, theta = f_new, f_new + beta * df, theta_new
    return (fh / s_half * mask).reshape(nc, 3)
