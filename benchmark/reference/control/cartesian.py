"""Cartesian pos+quat impedance controller (damped-least-squares IK).

Counterpart of ``d3il_tpu/control/cartesian.py``: a fixed-count
damped-least-squares IK loop that maintains a virtual joint trajectory
``q_virt`` and hands (q*, qd*, qdd*) to the joint-space tracking
controller. ``step`` is one controller update on tensors with the joints
last (``[..., 7]``; one env is ``[7]``), built on ``chain.fk``,
``chain.point_jacobian`` and ``ops/linalg.clamped_spd_solve``. The batched
windows run the same update for a whole substep window in the IK-window
kernel, ``engine/dyn_kernel.ik_window_bm``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.control.gains import CartPosQuatGains
from benchmark.reference.ops import linalg as linalg_ops
from benchmark.reference.ops import quat as quat_ops
from benchmark.reference.robot import chain as chain_mod
from benchmark.reference.robot.panda import JOINT_POS_MAX, JOINT_POS_MIN


class CartImpedanceState(NamedTuple):
    q_virt: torch.Tensor       # [..., 7] virtual IK joint positions
    old_des_vel: torch.Tensor  # [..., 7] previous commanded joint velocity


def init_state(current_j_pos: torch.Tensor) -> CartImpedanceState:
    """Seed the virtual trajectory from the measured joints."""
    return CartImpedanceState(q_virt=current_j_pos,
                              old_des_vel=torch.zeros_like(current_j_pos))


def _clamped_sym_solve(A, b, lo: float, hi: float):
    """Solve A x = b with A's small eigenvalues regularized up to ~lo (the
    reference's SVD clamp of J W J' + reg I) by ``clamped_spd_solve``;
    ``hi`` never binds for this system (see the JAX counterpart)."""
    del hi
    return linalg_ops.clamped_spd_solve(A, b, lo)


def _flip(cur_quat, des_quat):
    """-1 where des_quat lies in the other hemisphere from cur_quat, else 1
    ([..., 1])."""
    d_minus = ((cur_quat - des_quat) ** 2).sum(-1, keepdim=True)
    d_plus = ((cur_quat + des_quat) ** 2).sum(-1, keepdim=True)
    return torch.where(d_minus > d_plus, -1.0, 1.0)


def step(ctrl_chain, gains: CartPosQuatGains, state: CartImpedanceState,
         des_pos, des_quat, dt: float):
    """One physics-step controller update.

    Returns (new_state, q_des, qd_des, qdd_des), each ``[..., 7]``: the
    setpoint for the joint tracking controller."""
    q = state.q_virt
    f64 = lambda a: q.new_tensor(np.asarray(a, np.float64))
    ee = ctrl_chain.body_index("panda_grasptarget")
    jnt_lo, jnt_hi = f64(JOINT_POS_MIN), f64(JOINT_POS_MAX)
    pgain = f64(np.concatenate([gains.pgain_pos, gains.pgain_quat]))
    W = f64(gains.W)
    rest = f64(gains.rest_posture)
    pnull = f64(gains.pgain_null)
    eye6 = torch.eye(6, dtype=q.dtype, device=q.device)

    des_quat = quat_ops.normalize(des_quat)
    fk0 = chain_mod.fk(ctrl_chain, q)   # iteration 1 and the gate below

    def ik_iter(q, des_quat, fk_cache):
        xpos, xquat = fk_cache
        cur_pos, cur_quat = xpos[..., ee, :], xquat[..., ee, :]
        dq = des_quat * _flip(cur_quat, des_quat)
        pos_err = (des_pos - cur_pos).clamp(-0.01, 0.01)
        quat_err = quat_ops.quat_error(cur_quat, dq).clamp(-0.1, 0.1)
        target = pgain * torch.cat([pos_err, quat_err], dim=-1)
        J = chain_mod.point_jacobian(ctrl_chain, q, ee,
                                     fk_cache=fk_cache)[..., :7]    # [..,6,7]
        A = (J * W) @ J.transpose(-1, -2) + gains.J_reg * eye6
        qd_null = pnull * (rest - q).clamp(-0.2, 0.2)
        rhs = target - (J @ qd_null[..., None])[..., 0]
        y = _clamped_sym_solve(A, rhs, gains.min_svd_values,
                               gains.max_svd_values)
        qd_d = W * (J.transpose(-1, -2) @ y[..., None])[..., 0] + qd_null
        nrm = torch.linalg.vector_norm(qd_d, dim=-1, keepdim=True)
        qd_d = torch.where(nrm > 3.0, qd_d * 3.0 / nrm.clamp_min(1e-9), qd_d)
        q_new = torch.minimum(torch.maximum(q + gains.learning_rate * qd_d,
                                            jnt_lo), jnt_hi)
        return q_new, dq

    dq = des_quat
    for it in range(gains.num_iter):
        q, dq = ik_iter(q, dq,
                        fk0 if it == 0 else chain_mod.fk(ctrl_chain, q))

    # convergence gate: freeze the virtual trajectory once the task error
    # is at the float32 solve-noise floor (see the JAX counterpart)
    xpos_f, xquat_f = fk0
    cq = xquat_f[..., ee, :]
    pos_err_raw = des_pos - xpos_f[..., ee, :]
    quat_err_raw = quat_ops.quat_error(cq, des_quat * _flip(cq, des_quat))
    converged = ((torch.linalg.vector_norm(pos_err_raw, dim=-1) < 5e-4)
                 & (torch.linalg.vector_norm(quat_err_raw, dim=-1) < 5e-3))
    q = torch.where(converged[..., None], state.q_virt, q)

    qd_des = (q - state.q_virt) / dt
    qdd_des = f64(gains.ddgain) * (qd_des - state.old_des_vel) / dt
    qdd_des = qdd_des.clamp(-gains.qdd_clip, gains.qdd_clip)
    return CartImpedanceState(q_virt=q, old_des_vel=qd_des), q, qd_des, \
        qdd_des
