"""Plain versions of the arm dynamics kernels K1 (IK window) and K2 (arm
stage): a frozen copy of the port's ``engine/dyn_kernel.py`` without the
CUDA launch path. The specs keep only what the plain versions read; the
``*_bm`` entry points run the plain versions on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.control import gripper
from benchmark.reference.engine import dyn_scalar as dsc


class ArmSpec:
    """Static inputs of the arm stage: the scene's sim chain (7 arm + 2
    finger dofs) and the joint PD gains."""

    def __init__(self, scene, pd_gains):
        if scene.robot.nv != 9:
            raise ValueError("arm_stage takes a 7-arm + 2-finger sim chain")
        self.scene, self.pd_gains = scene, pd_gains


class IkSpec:
    """Static inputs of the IK window: the URDF control chain, the
    cartesian impedance gains and the control period dt."""

    def __init__(self, ctrl_chain, gains, dt):
        if ctrl_chain.nv != 7:
            raise ValueError("ik_window takes the 7-dof control chain")
        self.ctrl_chain, self.gains, self.dt = ctrl_chain, gains, float(dt)


def _stack(rows, like: torch.Tensor) -> torch.Tensor:
    """Stack nested lists of [B] tensors / folded Python floats."""
    if isinstance(rows, (list, tuple)):
        return torch.stack([_stack(r, like) for r in rows])
    if isinstance(rows, (int, float)):
        return torch.full_like(like, float(rows))
    return rows


def arm_stage_plain(spec: ArmSpec, q, qd, q_des, qd_des, tau_model,
                    set_width, grasp_flag):
    """Plain version of the arm stage (dyn_kernel._make_arm_kernel math)."""
    scene = spec.scene
    robot = scene.robot
    nv = robot.nv
    h = float(scene.dt)
    pg = [float(v) for v in spec.pd_gains.pgain]
    dg = [float(v) for v in spec.pd_gains.dgain]
    D = [float(v) for v in robot.joint_damping]
    fr = np.asarray(scene.forcerange, np.float64)
    qs = [q[i] for i in range(nv)]
    qds = [qd[i] for i in range(nv)]

    xpos, xquat, axes, anchors, M, bias = dsc.dynamics_s(
        robot, qs, qds, tuple(float(v) for v in scene.gravity))
    # joint PD + feedforward + gravity comp, then the finger force law
    ctrl = [pg[i] * (q_des[i] - qs[i]) + dg[i] * (qd_des[i] - qds[i])
            + tau_model[i] + bias[i] for i in range(7)]
    fing = gripper.finger_forces(q[7:].T, qd[7:].T, set_width,
                                 grasp_flag > 0.5)
    ctrl += [fing[:, 0], fing[:, 1]]
    tau_c = [torch.clamp(ctrl[i], float(fr[i, 0]), float(fr[i, 1]))
             for i in range(nv)]
    f_arm = [tau_c[i] - bias[i] for i in range(nv)]
    Mh = dict(M)
    for i in range(nv):
        Mh[(i, i)] = Mh[(i, i)] + h * D[i]
    Minv = dsc.spd_inverse_s(Mh, nv)
    a_arm = dsc.matvec_sym_s(Minv, f_arm, nv)
    Mqd = dsc.matvec_sym_s(M, qds, nv)
    qd_pre = dsc.matvec_sym_s(Minv, [Mqd[i] + h * f_arm[i]
                                     for i in range(nv)], nv)
    full = [[Minv[(i, j)] if i <= j else Minv[(j, i)] for j in range(nv)]
            for i in range(nv)]
    return tuple(_stack(x, set_width) for x in
                 (xpos, xquat, axes, anchors, full, qd_pre, a_arm))


def ik_window_plain(spec: IkSpec, n_sub, q_virt, old_vel, des_pos, des_quat):
    """Plain version of the IK window (dyn_kernel._make_ik_window_kernel)."""
    chain, gains, dt = spec.ctrl_chain, spec.gains, spec.dt
    dp = tuple(des_pos[k] for k in range(3))
    dq = dsc.qnormalize(tuple(des_quat[k] for k in range(4)))
    qv = [q_virt[i] for i in range(7)]
    ov = [old_vel[i] for i in range(7)]
    qs, qds, taus = [], [], []
    for _ in range(n_sub):
        q_new, qd_des, qdd_des = dsc.cart_step_s(chain, gains, qv, ov, dp, dq,
                                                 dt)
        xpos, xquat = dsc.fk_s(chain, q_new)
        tau = dsc.rnea_s(chain, xpos, xquat, q_new, qd_des, qdd_des,
                         gravity=(0.0, 0.0, 0.0))
        qs.append(_stack(q_new, q_virt[0]))
        qds.append(_stack(qd_des, q_virt[0]))
        taus.append(_stack(tau, q_virt[0]))
        qv, ov = q_new, qd_des
    like = q_virt[0]
    return (_stack(qv, like), _stack(ov, like), torch.stack(qs),
            torch.stack(qds), torch.stack(taus))


def arm_stage_bm(spec: ArmSpec, q, qd, q_des, qd_des, tau_model, set_width,
                 grasp_flag):
    """Batch-minor arm stage (the plain version). q, qd [9, B]; q_des,
    qd_des, tau_model [7, B]; set_width, grasp_flag [B]. Returns (xpos,
    xquat, axes, anchors, Minv, qd_pre, a_arm)."""
    return arm_stage_plain(spec, q, qd, q_des, qd_des, tau_model, set_width,
                           grasp_flag.to(torch.float32))


def ik_window_bm(spec: IkSpec, n_sub: int, q_virt, old_vel, des_pos,
                 des_quat):
    """Whole-substep-window cartesian DLS-IK + model feedforward (the plain
    version). Returns (q_virt', old_vel', q_des_w, qd_des_w, tau_model_w)."""
    return ik_window_plain(spec, n_sub, q_virt, old_vel, des_pos, des_quat)
