"""Action kind ``stacking_expert``: the stacking task's scripted
pick-and-place expert, the traffic of D3IL's demonstration runs
(``make_stacking_runner`` of the program's ``data/experts.py``), in a
closed loop.

Each env stacks its three boxes in one of the six orders, the orders in
turn over the envs, as the demonstrations take them: hover over the box,
descend, close, lift, carry, place, open, retreat, each phase's joint
setpoint from a rate-limited damped least-squares IK step. The executed
setpoint carries the demonstrations' exploration noise (``noise_rad``,
unit normals from a generator of the run's seed).

The expert reads the tcp and the finger opening from the state's joint
positions (the frozen reference's forward kinematics) and the boxes and
target from the state, as the demonstration runner reads them from the
env. A frozen copy of ``stacking_expert_step`` and ``_ik_toward`` at
commit 03a1e77, its imports rewritten.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch

from benchmark import traffic
from benchmark.actions.expert_ops import (const, i32, norm, phase_shares,
                                          rows, wrap, yaw_of)
from benchmark.reference.envs import stacking as ref_stacking
from benchmark.reference.ops import quat as quat_ops
from benchmark.reference.robot import chain as chain_mod
from benchmark.reference.robot import panda
from benchmark.reference.robot.panda import JOINT_POS_MAX, JOINT_POS_MIN


class StackingExpertState(NamedTuple):
    stage: torch.Tensor   # [B] which box in the order (0..2; 3 = finished)
    phase: torch.Tensor   # [B] 0 hover, 1 descend, 2 close, 3 lift, 4 carry,
    #                       5 place, 6 open, 7 retreat
    hold: torch.Tensor    # [B] dwell counter for close/open
    q_des: torch.Tensor   # [B, 7] joint setpoint the expert maintains


def init_stacking_expert_state(q_des) -> StackingExpertState:
    i0 = torch.zeros(q_des.shape[0], dtype=torch.int32, device=q_des.device)
    return StackingExpertState(stage=i0, phase=i0.clone(), hold=i0.clone(),
                               q_des=q_des)


STACK_Z_HOVER = 0.22
STACK_Z_GRASP = 0.018    # the tip pads on the resting box's center
STACK_HOLD_CLOSE = 22    # > the env's 0.5 s close_fingers servo window
STACK_HOLD_OPEN = 10
_STACK_TOL = [0.02, 0.006, 1.0, 0.02, 0.015, 0.006, 1.0, 0.02]
N_PHASES = 8


def _ik_toward(ctrl_chain, q, tgt_pos, tgt_quat, iters: int = 10,
               lr: float = 0.002, rate=0.05):
    """Rate-limited DLS IK tracking for a batch: move q [B, 7] a bounded
    step (``rate``: a number or [B]) toward the target EE pose. Each of the
    ``iters`` iterations solves the 6 x 6 system J J' + 1e-6 I."""
    ee = ctrl_chain.body_index("panda_grasptarget")
    dev = q.device
    lo = const("q_min", JOINT_POS_MIN, dev)
    hi = const("q_max", JOINT_POS_MAX, dev)
    eye = 1e-6 * torch.eye(6, dtype=q.dtype, device=dev)
    q0 = q
    for _ in range(iters):
        xpos, xquat = chain_mod.fk(ctrl_chain, q)
        cur_q = xquat[:, ee]
        flip = torch.where(((cur_q - tgt_quat) ** 2).sum(-1)
                           > ((cur_q + tgt_quat) ** 2).sum(-1), -1.0, 1.0)
        dqt = tgt_quat * flip[:, None]
        pos_err = torch.clamp(tgt_pos - xpos[:, ee], -0.02, 0.02)
        quat_err = torch.clamp(quat_ops.quat_error(cur_q, dqt), -0.1, 0.1)
        err = torch.cat([pos_err * 200.0, quat_err * 30.0], dim=-1)
        J = chain_mod.point_jacobian(ctrl_chain, q, ee,
                                     fk_cache=(xpos, xquat))[..., :7]
        A = J @ J.transpose(-1, -2) + eye
        qd = (J.transpose(-1, -2)
              @ torch.linalg.solve(A, err[..., None]))[..., 0]
        nrm = norm(qd)
        qd = torch.where((nrm > 3.0)[:, None],
                         qd * 3.0 / torch.clamp(nrm, min=1e-9)[:, None], qd)
        q = torch.clamp(q + lr * qd, lo, hi)
    dq = q - q0
    n = norm(dq)[:, None]
    rate = rate[:, None] if torch.is_tensor(rate) else rate
    return q0 + torch.where(n > rate, dq * rate / torch.clamp(n, min=1e-9),
                            dq)


def stacking_expert_step(ctrl_chain, st: StackingExpertState, box_pos,
                         box_quat, target_xy, order, tcp_pos, width_meas):
    """One step of the pick-and-place expert: (state, action [B, 8] =
    [q_des, width_cmd]). tcp_pos: the physical grasptarget [B, 3] (phase
    advance gates on the real arm); width_meas [B]: the measured finger
    opening (fully closed after the close dwell: the grasp missed, retry
    from hover)."""
    dev = box_pos.device
    stage = torch.clamp(st.stage, max=2)
    b = rows(order, stage)
    bp = rows(box_pos, b)
    yaw = yaw_of(rows(box_quat, b))
    # grasp-yaw symmetry: square boxes pi/2; the blue box pi, its gripper
    # yaw turned 90 degrees to close across its 0.06 x-axis
    yaw_sq = wrap(yaw + math.pi / 4) % (math.pi / 2) - math.pi / 4
    yb = wrap(yaw + math.pi / 2)
    yaw_bl = torch.where(yb > math.pi / 2, yb - math.pi,
                         torch.where(yb < -math.pi / 2, yb + math.pi, yb))
    h = torch.where(b == 2, yaw_bl, yaw_sq) / 2.0
    zero = torch.zeros_like(h)
    tgt_quat = torch.stack([zero, torch.cos(h), torch.sin(h), zero], -1)

    z_stack = 0.02 + 0.062 * stage.to(bp.dtype)
    zc = lambda v: torch.full_like(zero, v)  # noqa: E731
    bx, by = bp[:, 0], bp[:, 1]
    tx, ty = target_xy[:, 0], target_xy[:, 1]
    wp_tab = torch.stack([
        torch.stack([bx, by, zc(STACK_Z_HOVER)], -1),      # 0 hover
        torch.stack([bx, by, zc(STACK_Z_GRASP)], -1),      # 1 descend
        torch.stack([bx, by, zc(STACK_Z_GRASP)], -1),      # 2 close
        torch.stack([bx, by, zc(STACK_Z_HOVER)], -1),      # 3 lift
        torch.stack([tx, ty, zc(STACK_Z_HOVER)], -1),      # 4 carry
        torch.stack([tx, ty, z_stack], -1),                # 5 place
        torch.stack([tx, ty, z_stack], -1),                # 6 open
        torch.stack([tx, ty, zc(STACK_Z_HOVER)], -1),      # 7 retreat
    ], dim=1)
    wp = rows(wp_tab, st.phase)
    tol = const("stack_tol", _STACK_TOL, dev)[st.phase.long()]

    # vertical pick/place approach: hold altitude while off center
    des_ph = (st.phase == 1) | (st.phase == 5)
    xy_err = norm(tcp_pos[:, :2] - wp[:, :2])
    z_gate = torch.maximum(
        wp[:, 2], tcp_pos[:, 2] - 0.8 * torch.clamp(0.012 - xy_err, 0.0,
                                                    0.012))
    z_gate = torch.clamp(z_gate, max=STACK_Z_HOVER)
    wp_ik = torch.cat([wp[:, :2], torch.where(des_ph, z_gate,
                                              wp[:, 2])[:, None]], 1)
    # slow the virtual trajectory near the workpiece
    rate = torch.where(des_ph & (tcp_pos[:, 2] < 0.12), 0.02, 0.05)

    dwell = (st.phase == 2) | (st.phase == 6)
    q_new = _ik_toward(ctrl_chain, st.q_des, wp_ik, tgt_quat, rate=rate)
    q_des = torch.where((dwell | (st.stage >= 3))[:, None], st.q_des, q_new)

    reached = norm(tcp_pos - wp) < tol

    hold_lim = torch.where(st.phase == 2, STACK_HOLD_CLOSE, STACK_HOLD_OPEN)
    hold = i32(torch.where(dwell, st.hold + 1, 0))
    advance = torch.where(dwell, hold >= hold_lim, reached) & (st.stage < 3)
    missed = width_meas < 0.02
    retry = advance & (st.phase == 2) & missed
    phase = i32(torch.where(advance, st.phase + 1, st.phase))
    phase = i32(torch.where(retry, 0, phase))
    wrapped = phase > 7
    stage2 = st.stage + i32(wrapped)
    phase = i32(torch.where(wrapped, 0, phase))

    # the gripper: open through descend; closed from close to place
    width = torch.where((phase >= 2) & (phase <= 5), 0.0, 0.08)
    action = torch.cat([q_des, width[:, None]], dim=1)
    return StackingExpertState(stage=stage2, phase=phase, hold=hold,
                               q_des=q_des), action


class StackingExpert:
    """The expert of one run: its state, its orders and its noise."""

    def __init__(self, p: dict, params, state, seed: int):
        sc = state.scene
        dev = sc.q.device
        B = sc.q.shape[0]
        self.noise_rad = float(p["noise_rad"])
        perms = torch.tensor(list(itertools.permutations(range(3))),
                             dtype=torch.int32, device=dev)
        self.order = perms[torch.arange(B, device=dev) % 6]
        self.ctrl_chain = panda.build_control_chain()
        self.robot = ref_stacking.build_stacking_scene().robot
        self.tcp_body = self.robot.body_index("tcp")
        self.es = init_stacking_expert_state(sc.q[:, :7].clone())
        self.gen = traffic.generator(seed, "stacking_expert.noise", dev)

    def action(self, state, obs, k: int):
        sc = state.scene
        tcp_pos = chain_mod.fk(self.robot, sc.q)[0][:, self.tcp_body]
        width_meas = sc.q[:, 7] + sc.q[:, 8]
        self.es, action = stacking_expert_step(
            self.ctrl_chain, self.es, sc.free_pos, sc.free_quat,
            state.target_xy, self.order, tcp_pos, width_meas)
        z = torch.randn((action.shape[0], 7), generator=self.gen,
                        device=action.device)
        return torch.cat([action[:, :7] + z * self.noise_rad, action[:, 7:]],
                         dim=1)

    def summary(self):
        """Device tensors of the share of envs in each expert phase."""
        s = phase_shares(self.es.phase, N_PHASES)
        names = ("hover", "descend", "close", "lift", "carry", "place",
                 "open", "retreat")
        return {n: s[i] for i, n in enumerate(names)}


def make(p: dict, env, params, state, seed: int):
    return StackingExpert(p, params, state, seed)
