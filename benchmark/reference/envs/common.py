"""Shared machinery for the batched rod-task environments: a frozen copy
of the port's ``envs/common.py`` without its per-env API. An env is a pair
of functions over explicit batched state (batch first, ``[B, ...]``):

    reset(params, context)          -> state
    step(params, state, action)     -> (state, StepResult)

One env step runs one window of ``n_substeps`` 1 ms ticks through
``engine/substep_bm.py``. Every kernel is its plain version, so the
start-posture search runs the controller's update as the port does on the
CPU, on whatever device the params name.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.control import cartesian, gains, offline_ik
from benchmark.reference.engine import substep_bm
from benchmark.reference.engine import step as estep
from benchmark.reference.engine.model import SceneModel
from benchmark.reference.envs import scenes
from benchmark.reference.ops import quat as quat_ops
from benchmark.reference.robot import chain as chain_mod
from benchmark.reference.robot import panda

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
        physics) until the null-space drive is stationary: up to ``iters``
        calls of ``cartesian.step``, which stop at the first update that
        returns the state it was given: the update is a function of that
        state alone, so every later one returns it too."""
        qv, ov, des_pos, des_quat = self.null_converge_window(q0, ee_pos,
                                                              ee_quat)
        st = cartesian.init_state(qv[:, 0])
        for _ in range(iters):
            new, _, _, _ = cartesian.step(self.ctrl_chain, self.cart_gains,
                                          st, des_pos[:, 0], des_quat[:, 0],
                                          self.dt)
            if all(torch.equal(a, b) for a, b in zip(new, st)):
                break
            st = new
        return st.q_virt.double().cpu().numpy()

    def tcp_pose(self, sc: estep.SceneState):
        xpos, xquat = chain_mod.fk(self.scene.robot, sc.q)
        return xpos[:, self.tcp_body], xquat[:, self.tcp_body]


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
