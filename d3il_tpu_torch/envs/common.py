"""Shared machinery for the batched rod-task environments.

Counterpart of ``d3il_tpu/envs/common.py``. An env is a pair of functions
over explicit batched state (batch first, ``[B, ...]``):

    reset(params, context)          -> state
    step(params, state, action)     -> (state, StepResult)

One env step runs one window of ``n_substeps`` 1 ms ticks through
``engine/substep_bm.py`` (cartesian DLS-IK -> joint PD + URDF-model
feedforward -> finger force law -> gravity compensation from the sim-model
bias -> actuator clamp -> contacts -> integration).

The per-env API (``physics_substep``, ``ik_trajectory``,
``control_substep``, ``hold_substep``, ``_run_substeps_single``) steps one
env's state (no batch axis) through ``params._engine_step``, the scene's
``engine/step.make_step_fn``; no entry point calls it: it serves tools and
tests, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from d3il_tpu_torch.control import (cartesian, gains, gripper, joint_pd,
                                    offline_ik)
from d3il_tpu_torch.engine import dyn_kernel, substep_bm
from d3il_tpu_torch.engine import step as estep
from d3il_tpu_torch.engine.model import SceneModel
from d3il_tpu_torch.envs import scenes
from d3il_tpu_torch.ops import quat as quat_ops
from d3il_tpu_torch.robot import chain as chain_mod
from d3il_tpu_torch.robot import panda

# controller updates of the start-posture window that every params object
# without a given q_init runs (one launch of K1 for a single env on the card)
NULL_CONVERGE_ITERS = 4000


class StepResult(NamedTuple):
    obs: torch.Tensor      # observation (reference semantics: pre-substep state)
    reward: torch.Tensor
    done: torch.Tensor
    info: dict


def resolve_device(device) -> torch.device:
    """The device entry points run on: CUDA unless the caller names another.
    Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    return dev


class RodTaskParams:
    """Static task parameters shared by the rod end-effector tasks.

    ``q_init`` (7 joint angles) skips the start-posture search, e.g. to
    share the JAX package's posture (``convert.params_from_numpy``)."""

    def __init__(self, scene: SceneModel, n_substeps: int, max_steps: int,
                 init_ee_pos=None, init_ee_quat=None, kinematic: bool = False,
                 device=None, q_init=None):
        self.device = resolve_device(device)
        self.scene = scene
        self.kinematic = kinematic
        self.ctrl_chain = panda.build_control_chain()
        self.cart_gains = gains.CartPosQuatGains()
        self.pd_gains = gains.JointPDGains()
        self.n_substeps = n_substeps
        self.max_steps = max_steps
        self.dt = scene.dt
        self.tcp_body = scene.robot.body_index("tcp")
        self.init_ee_pos = np.asarray(
            scenes.INIT_EE_POS if init_ee_pos is None else init_ee_pos)
        self.init_ee_quat = np.asarray(
            scenes.INIT_EE_QUAT if init_ee_quat is None else init_ee_quat)
        self.statics = substep_bm.Statics(scene, self.ctrl_chain,
                                          self.cart_gains, self.pd_gains,
                                          self.dt, self.device)
        if q_init is None:
            # episode start: offline IK from the default qpos, then
            # null-space convergence of the impedance controller's virtual
            # posture (see the JAX counterpart for why)
            q_init = self._null_converge(self.start_ik(), self.init_ee_pos,
                                         self.init_ee_quat)
        self.q_init = np.asarray(q_init, np.float64)
        self._engine_steps = {}

    @property
    def _engine_step(self):
        """The per-env physics step of the scene in the params' current
        mode (``engine/step.make_step_fn``, built once per mode)."""
        fn = self._engine_steps.get(self.kinematic)
        if fn is None:
            fn = self._engine_steps[self.kinematic] = estep.make_step_fn(
                self.scene, kinematic_robot=self.kinematic)
        return fn

    def start_ik(self):
        """Offline IK of the initial ee pose from the default qpos."""
        return offline_ik.solve(self.ctrl_chain, self.init_ee_pos,
                                self.init_ee_quat, q0=panda.INIT_QPOS)

    def null_converge_window(self, q0, ee_pos, ee_quat):
        """The inputs of ``_null_converge``'s IK window for a single env:
        q_virt = q0 at rest, the ee pose as setpoint, as [k, 1] columns."""
        col = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                        dtype=torch.float32,
                                        device=self.device)[:, None]
        return (col(q0).contiguous(), torch.zeros((7, 1), device=self.device),
                col(ee_pos).contiguous(), col(ee_quat).contiguous())

    def _null_converge(self, q0, ee_pos, ee_quat,
                       iters: int = NULL_CONVERGE_ITERS):
        """Iterate the cartesian controller's virtual-posture update (no
        physics) until the null-space drive is stationary: on the card one
        IK window of ``iters`` updates for a single env (one launch of K1);
        on the CPU ``iters`` calls of ``cartesian.step``, the JAX package's
        form, which stop at the first update that returns the state it was
        given: the update is a function of that state alone, so every later
        one returns it too and the result is the same bit for bit."""
        qv, ov, des_pos, des_quat = self.null_converge_window(q0, ee_pos,
                                                              ee_quat)
        if self.device.type != "cpu":
            qv, _, _, _, _ = dyn_kernel.ik_window_bm(
                self.statics.ik, iters, qv, ov, des_pos, des_quat)
            return qv[:, 0].double().cpu().numpy()
        st = cartesian.init_state(qv[:, 0])
        for _ in range(iters):
            new, _, _, _ = cartesian.step(self.ctrl_chain, self.cart_gains,
                                          st, des_pos[:, 0], des_quat[:, 0],
                                          self.dt)
            if all(torch.equal(a, b) for a, b in zip(new, st)):
                break
            st = new
        return st.q_virt.double().numpy()

    def tcp_pose(self, sc: estep.SceneState):
        xpos, xquat = chain_mod.fk(self.scene.robot, sc.q)
        return xpos[:, self.tcp_body], xquat[:, self.tcp_body]


def _scalar(x, like, dtype=None):
    return torch.as_tensor(x, dtype=dtype or like.dtype, device=like.device)


def physics_substep(params: RodTaskParams, sc, q_des, qd_des, tau_model,
                    set_width=0.04, grasp_flag=False):
    """One env's 1 ms physics tick given the controller's joint setpoint
    q_des / qd_des [7] and the model feedforward tau_model [7]. One
    dynamics evaluation is shared between gravity compensation and the
    engine. In kinematic mode the arm is beamed to q_des and the fingers
    rate-track set_width (qd_des and tau_model unused)."""
    if params.kinematic:
        sw = _scalar(set_width, sc.q).expand(2)
        w = torch.minimum(torch.maximum(sw, sc.q[7:] - 0.2 * params.dt),
                          sc.q[7:] + 0.2 * params.dt)
        q_new = torch.cat([q_des, w])
        qd_new = (q_new - sc.q) / params.dt
        return params._engine_step(sc, torch.cat([q_new, qd_new]))
    dyn = chain_mod.dynamics(params.scene.robot, sc.q, sc.qd,
                             params.scene.gravity)
    tau = joint_pd.pd_accel(params.pd_gains, q_des, qd_des, sc.q[:7],
                            sc.qd[:7]) + tau_model
    fing = gripper.finger_forces(sc.q[7:], sc.qd[7:],
                                 _scalar(set_width, sc.q),
                                 _scalar(grasp_flag, sc.q, torch.bool))
    ctrl = torch.cat([tau + dyn[2][:7], fing])
    return params._engine_step(sc, ctrl, dyn)


def ik_trajectory(params: RodTaskParams, cs, des_pos, des_quat):
    """The cartesian DLS-IK controller over a whole substep window for one
    env: (cs, (q_des, qd_des, qdd_des)), each [n_substeps, 7]."""
    out = []
    for _ in range(params.n_substeps):
        cs, q_des, qd_des, qdd_des = cartesian.step(
            params.ctrl_chain, params.cart_gains, cs, des_pos, des_quat,
            params.dt)
        out.append((q_des, qd_des, qdd_des))
    return cs, tuple(torch.stack(x) for x in zip(*out))


def control_substep(params: RodTaskParams, carry, _, set_width=0.04,
                    grasp_flag=False):
    """One env's 1 ms tick: controller update + physics (the interleaved
    form). carry = (sc, cs, des_pos, des_quat); returns (carry, None)."""
    sc, cs, des_pos, des_quat = carry
    cs, q_des, qd_des, qdd_des = cartesian.step(
        params.ctrl_chain, params.cart_gains, cs, des_pos, des_quat,
        params.dt)
    tau_model = joint_pd.model_feedforward(params.ctrl_chain, q_des, qd_des,
                                           qdd_des)
    sc = physics_substep(params, sc, q_des, qd_des, tau_model, set_width,
                         grasp_flag)
    return (sc, cs, des_pos, des_quat), None


def hold_substep(params: RodTaskParams, carry, _):
    """Joint-PD hold of one env at the fixed setpoint q_hold [7]
    (qd_des = tau_model = 0); in kinematic mode the arm is beamed to it
    with the fingers where they are. carry = (sc, q_hold)."""
    sc, q_hold = carry
    if params.kinematic:
        q_new = torch.cat([q_hold, sc.q[7:]])
        sc = params._engine_step(sc, torch.cat([q_new,
                                                torch.zeros_like(q_new)]))
        return (sc, q_hold), None
    zero = torch.zeros_like(q_hold)
    return (physics_substep(params, sc, q_hold, zero, zero), q_hold), None


def _run_substeps_single(params: RodTaskParams, sc, cs, des_pos, des_quat,
                         set_width, grasp_flag):
    """One env's substep window: the controller trajectory q_des / qd_des
    and its model feedforward from K1 (``dyn_kernel.ik_window_bm`` at a
    batch of one), then n_substeps of ``physics_substep``. Returns
    (sc', cs')."""
    col = lambda x: x[:, None].contiguous()
    qv, ov, q_w, qd_w, tau_w = dyn_kernel.ik_window_bm(
        params.statics.ik, params.n_substeps, col(cs.q_virt),
        col(cs.old_des_vel), col(des_pos), col(des_quat))
    for i in range(params.n_substeps):
        sc = physics_substep(params, sc, q_w[i, :, 0], qd_w[i, :, 0],
                             tau_w[i, :, 0], set_width, grasp_flag)
    return sc, type(cs)(q_virt=qv[:, 0], old_des_vel=ov[:, 0])


def run_substeps(params: RodTaskParams, sc, cs, des_pos, des_quat,
                 set_width=0.04, grasp_flag=False):
    """n_substeps of controller + physics for a batch of envs."""
    B = sc.q.shape[0]
    sw = torch.as_tensor(set_width, dtype=sc.q.dtype,
                         device=sc.q.device).expand(B).contiguous()
    gf = torch.as_tensor(grasp_flag, device=sc.q.device).expand(B)
    return substep_bm.run_substeps_bm(params, sc, cs, des_pos, des_quat, sw,
                                      gf)


def init_scene_state(params: RodTaskParams, free_pos, free_quat):
    """Scene state at q_init (fingers closed) with the given box poses."""
    B = free_pos.shape[0]
    q = torch.cat([torch.as_tensor(params.q_init, dtype=torch.float32,
                                   device=params.device),
                   torch.zeros(2, device=params.device)])
    return estep.init_state(params.scene, q.expand(B, -1).contiguous(),
                            free_pos, free_quat)


def settle(params: RodTaskParams, sc, n: int = 2):
    """n joint-hold physics substeps after a beam/reset."""
    return substep_bm.hold_substeps_bm(params, sc, n)


def yaw_tan(q: torch.Tensor) -> torch.Tensor:
    """tan(yaw) observation encoding: tan(quat2euler(quat)[-1:])."""
    return torch.tan(quat_ops.to_euler(q)[..., 2:3])
