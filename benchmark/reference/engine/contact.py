"""Contact constraint phase: Jacobian rows -> Delassus operator -> cone QP.

Counterpart of ``d3il_tpu/engine/contact.py``. ``ContactMeta`` and
``build_meta`` are host NumPy (identical arrays to the JAX package's);
``build_rows`` and ``phase_core`` are written over a leading env batch and
are the plain PyTorch version of the contact kernel
(``engine/contact_kernel.py``): matrix-free preconditioned APGD, with the
Delassus matvec A y = J M^-1 J' y + R y evaluated as two [n, nv]
contractions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.engine import solver as solver_mod
from benchmark.reference.ops import quat as quat_ops


class ContactMeta(NamedTuple):
    """Static (host NumPy) per-scene constraint-row metadata."""

    ncon: int
    nv_r: int
    nf: int
    nv: int
    mask_rob: np.ndarray      # [ncon, nv_r] signed robot-dof mask (A side - B side)
    is_hinge: np.ndarray      # [nv_r]
    onehot_a: np.ndarray      # [ncon, nf] free-body selector, side A
    onehot_b: np.ndarray      # [ncon, nf]
    inv_free: np.ndarray      # [nf, 6] (1/m x3, 1/I x3)
    k_row: np.ndarray         # [ncon] constraint stiffness (static part of kbi)
    b_row: np.ndarray         # [ncon] constraint damping
    solimp: np.ndarray        # [ncon, 5]
    mu: np.ndarray            # [ncon]
    impratio: float
    n_iters: int


def build_meta(scene) -> ContactMeta:
    """Flatten scene.pairs into per-row static arrays (pair-major, the
    narrow phase's row order)."""
    robot = scene.robot
    nv_r = robot.nv
    nf = scene.n_free
    rows_a, rows_b, solref, solimp, mu = [], [], [], [], []
    for pair in scene.pairs:
        for _ in range(pair.max_points):
            rows_a.append(pair.geom_a)
            rows_b.append(pair.geom_b)
            solref.append(pair.solref)
            solimp.append(pair.solimp)
            mu.append(pair.friction)
    ncon = len(mu)

    def side(geoms):
        is_rob = np.array([1.0 if (g.body >= 0 and g.free_idx < 0) else 0.0
                           for g in geoms])
        body = np.array([max(g.body, 0) for g in geoms], np.int32)
        mask = is_rob[:, None] * robot.ancestor_mask[body]
        onehot = np.zeros((ncon, max(nf, 0)))
        for r, g in enumerate(geoms):
            if g.free_idx >= 0:
                onehot[r, g.free_idx] = 1.0
        return mask, onehot

    mask_a, oh_a = side(rows_a)
    mask_b, oh_b = side(rows_b)
    solref = np.asarray(solref, np.float64)
    solimp_arr = np.asarray(solimp, np.float64)
    dmax = solimp_arr[:, 1]
    tc, dr = solref[:, 0], solref[:, 1]
    b_row = 2.0 / np.maximum(dmax * tc, 1e-12)
    k_row = 1.0 / np.maximum(dmax * dmax * tc * tc * dr * dr, 1e-12)
    if nf:
        inv_free = np.concatenate(
            [np.repeat(1.0 / scene.free_mass[:, None], 3, axis=1),
             1.0 / scene.free_inertia], axis=1)
    else:
        inv_free = np.zeros((0, 6))
    is_hinge = (robot.joint_type[robot.dof_body] == 1).astype(np.float64)
    return ContactMeta(
        ncon=ncon, nv_r=nv_r, nf=nf, nv=nv_r + 6 * nf,
        mask_rob=(mask_a - mask_b), is_hinge=is_hinge,
        onehot_a=oh_a, onehot_b=oh_b, inv_free=inv_free,
        k_row=k_row, b_row=b_row, solimp=solimp_arr,
        mu=np.asarray(mu, np.float64),
        impratio=float(scene.impratio), n_iters=int(scene.solver_iters))


def select_contacts(meta: ContactMeta, idx) -> ContactMeta:
    """The scene made of ``meta``'s contacts ``idx`` (in that order,
    repeats allowed): its row tables, for a kernel's inputs cut the same
    way."""
    idx = np.asarray(idx)
    return meta._replace(
        ncon=len(idx), mask_rob=meta.mask_rob[idx],
        onehot_a=meta.onehot_a[idx], onehot_b=meta.onehot_b[idx],
        k_row=meta.k_row[idx], b_row=meta.b_row[idx],
        solimp=meta.solimp[idx], mu=meta.mu[idx])


def _frames(normal):
    """Contact frames [..., ncon, 3(dirs), 3(xyz)] from normals."""
    big = normal[..., 2:3].abs() < 0.9
    ref = torch.where(big, normal.new_tensor([0.0, 0, 1]),
                      normal.new_tensor([1.0, 0, 0]))
    t1 = quat_ops.cross(normal, ref)
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True).clamp_min(1e-9)
    t2 = quat_ops.cross(normal, t1)
    return torch.stack([normal, t1, t2], dim=-2)


def build_rows(meta: ContactMeta, pts, normal, axes, anchors, free_pos,
               free_quat):
    """Constraint Jacobian rows J [B, 3*ncon, nv] in the contact frames.

    pts/normal [B, ncon, 3]; axes/anchors [B, nv_r, 3]; free_pos
    [B, nf, 3]; free_quat [B, nf, 4]."""
    B = pts.shape[0]
    ncon, nf = meta.ncon, meta.nf
    frames = _frames(normal)                                   # [B,ncon,3,3]
    is_h = pts.new_tensor(meta.is_hinge)[None, None, :, None]
    mask = pts.new_tensor(meta.mask_rob)[None, :, :, None]

    diff = pts[:, :, None, :] - anchors[:, None, :, :]          # [B,ncon,nv_r,3]
    axb = axes[:, None].expand_as(diff)
    base = mask * (is_h * quat_ops.cross(axb, diff) + (1.0 - is_h) * axb)
    J_rob = torch.einsum("brdc,brkc->brdk", frames, base)      # [B,ncon,3,nv_r]
    if not nf:
        return J_rob.reshape(B, 3 * ncon, meta.nv)

    Rb = quat_ops.to_mat(free_quat)                             # [B,nf,3,3]

    def side(onehot):
        oh = pts.new_tensor(onehot)                             # [ncon, nf]
        pos_sel = torch.einsum("rf,bfc->brc", oh, free_pos)
        Rb_sel = torch.einsum("rf,bfij->brij", oh, Rb)
        rvec = pts - pos_sel
        # omega_body columns: Rb[:, j] x r
        Jw = quat_ops.cross(Rb_sel.transpose(-1, -2), rvec[:, :, None, :])
        Jw = Jw.transpose(-1, -2)                               # [B,ncon,3,3]
        Jlin = oh.sum(dim=1)[None, :, None, None] * frames
        Jang = torch.einsum("brdc,brcj->brdj", frames, Jw)
        return torch.cat([Jlin, Jang], dim=-1), oh              # [B,ncon,3,6]

    J6a, oh_a = side(meta.onehot_a)
    J6b, oh_b = side(meta.onehot_b)
    J_free = (oh_a[None, :, None, :, None] * J6a[:, :, :, None, :]
              - oh_b[None, :, None, :, None] * J6b[:, :, :, None, :]
              ).reshape(B, ncon, 3, 6 * nf)
    return torch.cat([J_rob, J_free], dim=-1).reshape(B, 3 * ncon, meta.nv)


def phase_core(meta: ContactMeta, Jf, depth, Minv_arm, v_all, a_smooth, warm):
    """Soft-constraint cone QP given assembled rows Jf [B, n, nv].

    depth [B, ncon]; Minv_arm [B, nv_r, nv_r]; v_all, a_smooth [B, nv];
    warm [B, ncon, 3]. Returns (f [B, ncon, 3], qfrc [B, nv])."""
    B = Jf.shape[0]
    ncon, nv_r = meta.ncon, meta.nv_r
    n = 3 * ncon

    MinvJT = Jf[..., :nv_r] @ Minv_arm                          # [B, n, nv_r]
    if meta.nf:
        inv_flat = Jf.new_tensor(meta.inv_free.reshape(-1))
        MinvJT = torch.cat([MinvJT, Jf[..., nv_r:] * inv_flat], dim=-1)

    vel = (Jf @ v_all[..., None]).reshape(B, ncon, 3)
    a0 = (Jf @ a_smooth[..., None]).reshape(B, ncon, 3)

    r_vio = -depth
    solimp = tuple(Jf.new_tensor(meta.solimp[:, i]) for i in range(5))
    d_imp = solver_mod.impedance(solimp, r_vio)                 # [B, ncon]
    k_r = Jf.new_tensor(meta.k_row)
    b_r = Jf.new_tensor(meta.b_row)
    aref = torch.cat([(-b_r * vel[..., 0] - k_r * d_imp * r_vio)[..., None],
                      -b_r[:, None] * vel[..., 1:]], dim=-1)    # [B, ncon, 3]

    diagA = (Jf * MinvJT).sum(dim=-1).reshape(B, ncon, 3)
    rr = ((1 - d_imp) / d_imp.clamp_min(1e-6))[..., None]
    Rreg = rr * diagA
    Rreg = torch.cat([Rreg[..., :1], Rreg[..., 1:] / meta.impratio], dim=-1)
    Rflat = Rreg.reshape(B, n)
    b0 = (a0 - aref).reshape(B, n)

    active = depth > 0.0
    mu = Jf.new_tensor(meta.mu)

    dA = diagA + Rreg
    sn = dA[..., 0].clamp_min(1e-10)
    st = (0.5 * (dA[..., 1] + dA[..., 2])).clamp_min(1e-10)
    s_half = torch.sqrt(torch.stack([sn, st, st], dim=-1).reshape(B, n))
    mu_s = mu * torch.sqrt(st / sn)
    mask = active.to(Jf.dtype).repeat_interleave(3, dim=-1)
    inv_sh = mask / s_half
    bh = b0 * inv_sh

    def matvec(y):
        x = inv_sh * y
        t = (MinvJT.transpose(-1, -2) @ x[..., None])               # [B, nv, 1]
        u = (Jf @ t)[..., 0] + Rflat * x
        return inv_sh * u

    def dot(a, b):
        return (a * b).sum(dim=-1)

    v = Jf.new_ones((B, n))
    for _ in range(6):
        v = matvec(v)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
    # 1.5x safety: the Rayleigh quotient under-estimates lambda_max and a
    # too-large step diverges (see the JAX counterpart)
    step = (1.0 / (1.5 * dot(v, matvec(v)).clamp_min(1.0)))[:, None]

    def proj(fh):
        return solver_mod._project_cone_rows(
            fh.reshape(B, ncon, 3), mu_s, active).reshape(B, n)

    fh = proj(warm.reshape(B, n) * s_half * mask)
    y = fh
    theta = Jf.new_ones((B, 1))
    for _ in range(meta.n_iters):
        g = matvec(y) + bh
        f_new = proj(y - step * g)
        df = f_new - fh
        restart = (dot(g, df) > 0.0)[:, None]
        theta = torch.where(restart, 1.0, theta)
        theta_new = 0.5 * (torch.sqrt(theta ** 4 + 4 * theta ** 2) - theta ** 2)
        beta = torch.where(restart, 0.0,
                           theta * (1 - theta) / (theta ** 2 + theta_new))
        fh, y, theta = f_new, f_new + beta * df, theta_new
    f_flat = fh / s_half * mask
    qfrc = (Jf.transpose(-1, -2) @ f_flat[..., None])[..., 0]
    return f_flat.reshape(B, ncon, 3), qfrc
