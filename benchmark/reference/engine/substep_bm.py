"""The batched substep windows: one env step of every ported task under
full arm dynamics (or with the arm beamed, in kinematic mode). A frozen
copy of the port's ``engine/substep_bm.py``; here K1, K2 and K3 are their
plain versions (``engine/dyn_kernel.py``, ``engine/contact_kernel.py``).

Counterpart of ``d3il_tpu/engine/substep_bm.py`` (with the kernels on);
every size comes from the scene (``nf`` free bodies, one inertia each,
compound or not, or none at all; ``ncon`` contact rows). Unlike the JAX
package, which takes this window only where its contact kernel's tile test
passes and the scene has free bodies, every scene runs it (sorting_4,
sorting_6 and stacking through K3's general variant, avoiding with nf = 0).
Batch-first state goes in and out; inside the window every
tensor is batch-minor (``[..., B]``), the layout the three kernels read
with neighbouring threads on neighbouring addresses:

  * K1 ``dyn_kernel.ik_window_bm`` once per window: the whole controller
    trajectory q_des / qd_des and the model feedforward tau_model;
  * then, per substep: K2 ``dyn_kernel.arm_stage_bm`` (FK, dynamics, PD,
    gripper, (M + hD)^-1) -> the narrow phase (plain torch, as it is plain
    jnp in the reference) -> free-body smooth dynamics -> K3
    ``contact_kernel.phase_batched_bm`` (contact cone QP) -> integration
    (joint-range clip with qd zeroing; exact exponential map for the boxes).

With ``params.kinematic`` the arm is beamed along K1's trajectory instead:
no K2, FK of the new posture in plain torch, and K3 with a zero arm inverse
mass, so only the boxes respond to contact.

The joint window (``joint_substeps_bm``: stacking's step, every task's
reset hold) holds a joint setpoint instead: no K1, and K2 with qd_des and
tau_model at zero.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.engine import contact, contact_kernel, dyn_kernel
from benchmark.reference.engine import step as estep
from benchmark.reference.ops import quat as quat_ops
from benchmark.reference.robot import chain as chain_mod


class Statics:
    """Everything constant across windows, packed once per task params:
    the plain versions' specs, the contact meta and small constant
    tensors."""

    def __init__(self, scene, ctrl_chain, cart_gains, pd_gains, dt, device):
        self.scene = scene
        self.device = torch.device(device)
        self.meta = contact.build_meta(scene)
        self.arm = dyn_kernel.ArmSpec(scene, pd_gains)
        self.ik = dyn_kernel.IkSpec(ctrl_chain, cart_gains, dt)
        self.contact = self.meta
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                        dtype=torch.float32, device=self.device)
        robot = scene.robot
        self.gravity = f32(scene.gravity)[None, :, None]          # [1, 3, 1]
        self.q_lo = f32(robot.joint_range[:, 0])[:, None]         # [9, 1]
        self.q_hi = f32(robot.joint_range[:, 1])[:, None]
        self.free_mass = f32(scene.free_mass)[:, None, None]      # [nf, 1, 1]
        self.free_inertia = f32(scene.free_inertia)[..., None]    # [nf, 3, 1]


class SceneBM(NamedTuple):
    """Batch-minor scene state inside the window."""
    q: torch.Tensor            # [9, B]
    qd: torch.Tensor           # [9, B]
    free_pos: torch.Tensor     # [nf, 3, B]
    free_quat: torch.Tensor    # [nf, 4, B]
    free_linvel: torch.Tensor  # [nf, 3, B]
    free_angvel: torch.Tensor  # [nf, 3, B]
    warm: torch.Tensor         # [ncon, 3, B]


def _bm(x):
    return torch.movedim(x, 0, -1).contiguous()


def _bf(x):
    return torch.movedim(x, -1, 0).contiguous()


def scene_to_bm(sc: estep.SceneState) -> SceneBM:
    return SceneBM(*(_bm(x) for x in sc))


def scene_from_bm(sb: SceneBM) -> estep.SceneState:
    return estep.SceneState(*(_bf(x) for x in sb))


def _qintegrate(quat, omega, h):
    """quat_ops.integrate on [nf, 4, B] / [nf, 3, B]."""
    return torch.movedim(quat_ops.integrate(torch.movedim(quat, 1, -1),
                                            torch.movedim(omega, 1, -1), h),
                         -1, 1).contiguous()


def narrow_phase_bm(scene, xpos, xquat, free_pos, free_quat):
    """Batched narrow phase on batch-minor poses; returns (pts [ncon,3,B],
    normal [ncon,3,B], depth [ncon,B])."""
    c = estep.narrow_phase(scene, xpos.permute(2, 0, 1), xquat.permute(2, 0, 1),
                           free_pos.permute(2, 0, 1),
                           free_quat.permute(2, 0, 1))
    return _bm(c.pos), _bm(c.normal), _bm(c.depth)


def contact_inputs(st: Statics, sb: SceneBM, arm_out):
    """The contact phase's inputs for the current substep, given the arm
    stage's outputs: (pts, normal, depth, axes, anchors, Minv, v_all,
    a_smooth, free_pos, free_quat, warm), all batch-minor."""
    xpos, xquat, axes, anchors, Minv, _, a_arm = arm_out
    nf = st.scene.n_free
    B = sb.q.shape[-1]
    I_f = st.free_inertia
    gyro = torch.linalg.cross(sb.free_angvel, I_f * sb.free_angvel, dim=1)
    pts, normal, depth = narrow_phase_bm(st.scene, xpos, xquat, sb.free_pos,
                                         sb.free_quat)
    v_free = torch.cat([sb.free_linvel, sb.free_angvel], dim=1).reshape(
        6 * nf, B)
    a_free = torch.cat([st.gravity.expand(nf, 3, B), -gyro / I_f],
                       dim=1).reshape(6 * nf, B)
    return (pts, normal, depth, axes, anchors, Minv,
            torch.cat([sb.qd, v_free]), torch.cat([a_arm, a_free]),
            sb.free_pos, sb.free_quat, sb.warm)


def _finish_substep(st: Statics, sb: SceneBM, arm_out, kinematic: bool):
    """Contacts (K3) and integration given the arm stage's outputs. With
    ``kinematic`` the arm keeps ``sb.q`` / ``sb.qd`` (it was beamed there);
    otherwise the contact impulse joins the arm stage's velocity update."""
    h = float(st.scene.dt)
    nv_r, nf = st.scene.robot.nv, st.scene.n_free
    B = sb.q.shape[-1]
    Minv, qd_pre = arm_out[4], arm_out[5]
    args = contact_inputs(st, sb, arm_out)
    f, qfrc = contact_kernel.phase_batched_bm(st.contact, *args)

    if kinematic:
        q_out, qd_out = sb.q, sb.qd
    else:
        # arm: qd_pre = (M+hD)^-1 (M qd + h (tau - bias)); contacts add
        # h (M+hD)^-1 J' f; then the joint-range hard stop
        qd_out = qd_pre + h * torch.einsum("ijn,jn->in", Minv, qfrc[:nv_r])
        q_new = sb.q + h * qd_out
        q_out = torch.minimum(torch.maximum(q_new, st.q_lo), st.q_hi)
        qd_out = torch.where((q_new < st.q_lo) | (q_new > st.q_hi), 0.0,
                             qd_out)

    I_f = st.free_inertia
    f_free_ang = -torch.linalg.cross(sb.free_angvel, I_f * sb.free_angvel,
                                     dim=1)
    fcon = qfrc[nv_r:].reshape(nf, 6, B)
    linvel = sb.free_linvel + h * (st.gravity + fcon[:, :3] / st.free_mass)
    angvel = sb.free_angvel + h * ((f_free_ang + fcon[:, 3:]) / I_f)
    pos = sb.free_pos + h * linvel
    quat = _qintegrate(sb.free_quat, angvel, h)
    return SceneBM(q_out.contiguous(), qd_out.contiguous(), pos, quat,
                   linvel, angvel, f)


def physics_substep_bm(st: Statics, sb: SceneBM, q_des, qd_des, tau_model,
                       set_width, grasp_flag) -> SceneBM:
    """One 1 ms physics tick under full arm dynamics. q_des/qd_des/tau_model
    [7, B]; set_width [B] float; grasp_flag [B] bool."""
    arm_out = dyn_kernel.arm_stage_bm(st.arm, sb.q, sb.qd, q_des, qd_des,
                                      tau_model, set_width, grasp_flag)
    return _finish_substep(st, sb, arm_out, kinematic=False)


def beam_arm_out(st: Statics, q_new):
    """What the arm stage hands the contact phase when the arm is beamed to
    q_new [9, B]: FK and the dof frames of q_new in plain PyTorch, a zero
    inverse mass and a zero smooth acceleration (no qd_pre)."""
    robot = st.scene.robot
    B = q_new.shape[-1]
    xpos, xquat = chain_mod.fk(robot, q_new.T)
    axes, anchors = chain_mod._dof_frames(robot, xpos, xquat)
    zeros = lambda *s: torch.zeros(s + (B,), dtype=q_new.dtype,
                                   device=q_new.device)
    return (_bm(xpos), _bm(xquat), _bm(axes), _bm(anchors),
            zeros(robot.nv, robot.nv), None, zeros(robot.nv))


def beam_substep_bm(st: Statics, sb: SceneBM, q_new, qd_new) -> SceneBM:
    """One 1 ms tick with the arm beamed to (q_new, qd_new) [9, B]: an
    infinite-mass collider for the boxes (engine/step.py, kinematic_robot),
    so K3 moves the boxes only."""
    sb = sb._replace(q=q_new.contiguous(), qd=qd_new.contiguous())
    return _finish_substep(st, sb, beam_arm_out(st, sb.q), kinematic=True)


def kinematic_target(st: Statics, sb: SceneBM, q_des, set_width):
    """(q_new, qd_new) [9, B] of one kinematic tick: the arm follows the IK
    trajectory q_des [7, B]; the fingers rate-track set_width [B] at
    0.2 m/s; the velocity is the finite difference."""
    h = float(st.scene.dt)
    w = torch.minimum(torch.maximum(set_width.expand(2, -1),
                                    sb.q[7:] - 0.2 * h), sb.q[7:] + 0.2 * h)
    q_new = torch.cat([q_des, w])
    return q_new, (q_new - sb.q) / h


def kinematic_substep_bm(st: Statics, sb: SceneBM, q_des, set_width):
    """One tick of the kinematic mode (see kinematic_target)."""
    return beam_substep_bm(st, sb, *kinematic_target(st, sb, q_des, set_width))


def run_substeps_bm(params, sc: estep.SceneState, cs, des_pos, des_quat,
                    set_width, grasp_flag):
    """One env step's substep window. sc: SceneState [B, ...]; cs:
    CartImpedanceState [B, 7]; des_pos [B, 3]; des_quat [B, 4];
    set_width [B] float; grasp_flag [B] bool. Returns (sc', cs')."""
    st = params.statics
    sb = scene_to_bm(sc)
    q_virt, old_vel, q_des_w, qd_des_w, tau_w = dyn_kernel.ik_window_bm(
        st.ik, params.n_substeps, _bm(cs.q_virt), _bm(cs.old_des_vel),
        _bm(des_pos), _bm(des_quat))
    for i in range(params.n_substeps):
        if params.kinematic:
            sb = kinematic_substep_bm(st, sb, q_des_w[i], set_width)
        else:
            sb = physics_substep_bm(st, sb, q_des_w[i], qd_des_w[i],
                                    tau_w[i], set_width, grasp_flag)
    return scene_from_bm(sb), type(cs)(q_virt=_bf(q_virt),
                                       old_des_vel=_bf(old_vel))


def joint_target(st: Statics, sb: SceneBM, q_des, set_width):
    """(q_new, qd_new) [9, B] of one kinematic tick of the joint window: the
    arm moves toward q_des [7, B] at most 3 rad/s per joint (an unlimited
    jump would teleport the hand and kick touching boxes); the fingers
    rate-track set_width [B] at 0.1 m/s, or stay where they are when it is
    None; the velocity is the finite difference."""
    h = float(st.scene.dt)
    qa = sb.q[:7] + torch.clamp(q_des - sb.q[:7], -3.0 * h, 3.0 * h)
    w = sb.q[7:] if set_width is None else torch.minimum(
        torch.maximum(set_width.expand(2, -1), sb.q[7:] - 0.1 * h),
        sb.q[7:] + 0.1 * h)
    q_new = torch.cat([qa, w])
    return q_new, (q_new - sb.q) / h


def joint_substeps_bm(params, sc: estep.SceneState, q_des, set_width,
                      grasp_flag, n: int):
    """n substeps of the joint window: joint PD toward the fixed setpoint
    q_des [B, 7] with qd_des = 0 and tau_model = 0 (the model feedforward
    M qdd + C(q_des, 0) vanishes), the gripper law at set_width [B] and
    grasp_flag [B] (bool). No K1: the setpoint is the action. In kinematic
    mode the arm is beamed along ``joint_target`` instead (no K2), and a
    set_width of None keeps the fingers where they are."""
    st = params.statics
    sb = scene_to_bm(sc)
    q_des = _bm(q_des)
    if params.kinematic:
        for _ in range(n):
            sb = beam_substep_bm(st, sb, *joint_target(st, sb, q_des,
                                                       set_width))
        return scene_from_bm(sb)
    zeros = torch.zeros_like(q_des)
    for _ in range(n):
        sb = physics_substep_bm(st, sb, q_des, zeros, zeros, set_width,
                                grasp_flag)
    return scene_from_bm(sb)


def hold_substeps_bm(params, sc: estep.SceneState, n: int):
    """n joint-window substeps that hold the arm's posture: q_des =
    sc.q[:, :7], the fingers commanded to 0.04 with the grasp off (in
    kinematic mode they stay where they are, and qd = 0)."""
    B = sc.q.shape[0]
    dev = sc.q.device
    sw = None if params.kinematic else torch.full((B,), 0.04, device=dev)
    return joint_substeps_bm(params, sc, sc.q[:, :7].clone(), sw,
                             torch.zeros((B,), dtype=torch.bool, device=dev),
                             n)
