"""Obstacle-avoiding task: reach the goal line through 24 valid gate paths.

Counterpart of ``d3il_tpu/envs/avoiding.py``, batched over envs. The scene
has no free body: six static capsule obstacles on the table. Observation:
the tcp's xy. Failure: the rod touches an obstacle. Success: the tcp
crosses the goal line. Mode: a 9-bit encoding of the gates passed. Action:
absolute Cartesian setpoint [x, y, z, qw, qx, qy, qz].

The task has no context: a reset takes ``empty_context(B)``, one empty row
per env, which gives the batch size (the evaluation grid indexes it like
any other task's contexts).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from d3il_tpu_torch.control import cartesian
from d3il_tpu_torch.engine import collision as ecol
from d3il_tpu_torch.engine import step as estep
from d3il_tpu_torch.envs import common, scenes
from d3il_tpu_torch.ops import quat as quat_ops
from d3il_tpu_torch.robot import chain as chain_mod

SETTLE_SUBSTEPS = 2     # hold substeps of a reset


class AvoidingParams(common.RodTaskParams):
    def __init__(self, n_substeps: int = 35, max_steps: int = 250,
                 solver_iters: int = 15, kinematic: bool = False,
                 device=None, q_init=None):
        super().__init__(scenes.build_avoiding_scene(solver_iters),
                         n_substeps, max_steps, kinematic=kinematic,
                         device=device, q_init=q_init)
        # the rod and the obstacles as capsules (x, y, radius, half-length)
        # for the failure predicate
        self.rod = scenes.rod_robot_geoms(self.scene.robot)[0]
        self.obstacles = np.array([
            [scenes.AVOIDING_L1_X, scenes.AVOIDING_L1_Y, 0.03, 0.07],
            [scenes.AVOIDING_L2_TOP_X, scenes.AVOIDING_L2_Y, 0.025, 0.1],
            [scenes.AVOIDING_L2_BOT_X, scenes.AVOIDING_L2_Y, 0.025, 0.1],
            [scenes.AVOIDING_L3_TOP_X, scenes.AVOIDING_L3_Y, 0.025, 0.1],
            [scenes.AVOIDING_L3_MID_X, scenes.AVOIDING_L3_Y, 0.025, 0.1],
            [scenes.AVOIDING_L3_BOT_X, scenes.AVOIDING_L3_Y, 0.025, 0.1],
        ])


class AvoidingState(NamedTuple):
    scene: estep.SceneState
    ctrl: cartesian.CartImpedanceState
    t: torch.Tensor              # [B] int32
    terminated: torch.Tensor     # [B] bool
    mode_encoding: torch.Tensor  # [B, 9] float 0/1
    passed: torch.Tensor         # [B, 3] level-passed flags
    success: torch.Tensor        # [B] bool
    failure: torch.Tensor        # [B] bool


def empty_context(batch: int, device=None):
    """The context of ``batch`` envs: one empty row each."""
    return (torch.zeros((batch, 0), device=device),)


def reset(params: AvoidingParams, context) -> AvoidingState:
    """context: ``empty_context(B)`` (only its row count is read)."""
    B = context[0].shape[0]
    dev = params.device
    empty = torch.zeros((B, 0, 3), device=dev)
    sc = common.init_scene_state(params, empty, torch.zeros((B, 0, 4),
                                                            device=dev))
    sc = common.settle(params, sc, n=SETTLE_SUBSTEPS)
    zeros = lambda *s, dtype=torch.bool: torch.zeros((B,) + s, dtype=dtype,
                                                     device=dev)
    return AvoidingState(
        scene=sc, ctrl=cartesian.init_state(sc.q[:, :7].clone()),
        t=zeros(dtype=torch.int32), terminated=zeros(),
        mode_encoding=zeros(9, dtype=torch.float32), passed=zeros(3),
        success=zeros(), failure=zeros())


def get_observation(params: AvoidingParams, state: AvoidingState):
    """The tcp's xy [B, 2]."""
    tcp_pos, _ = params.tcp_pose(state.scene)
    return tcp_pos[:, :2]


def _rod_collision(params: AvoidingParams, sc: estep.SceneState):
    """[B] bool: the rod capsule touches an obstacle."""
    rod = params.rod
    xpos, xquat = chain_mod.fk(params.scene.robot, sc.q)
    hand_p, hand_q = xpos[:, rod.body], xquat[:, rod.body]
    rod_pos = hand_p + quat_ops.rotate(hand_q, hand_p.new_tensor(rod.pos))
    B = hand_p.shape[0]
    ident = hand_q.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(B, 4)
    hit = torch.zeros(B, dtype=torch.bool, device=hand_p.device)
    for x, y, r, hl in params.obstacles:
        obs_pos = hand_p.new_tensor([x, y, 0.0]).expand(B, 3)
        c = ecol.capsule_capsule(rod_pos, hand_q, *rod.size, obs_pos, ident,
                                 float(r), float(hl))
        hit = hit | (c.depth[:, 0] > 0)
    return hit


def _check_mode(params: AvoidingParams, state: AvoidingState):
    """The 9-bit gate encoding. The last branch tests against the top
    obstacle's x of level 3, as the reference does."""
    tcp_pos, _ = params.tcp_pose(state.scene)
    x, y = tcp_pos[:, 0], tcp_pos[:, 1]
    passed = state.passed

    l1 = ((y - scenes.AVOIDING_L1_Y).abs() <= 0.03) & ~passed[:, 0]
    l2 = ((y - scenes.AVOIDING_L2_Y).abs() <= 0.03) & ~passed[:, 1]
    l3 = (y >= scenes.AVOIDING_L3_Y) & ~passed[:, 2]
    b5 = x < scenes.AVOIDING_L3_TOP_X
    b6 = (x > scenes.AVOIDING_L3_TOP_X) & (x < scenes.AVOIDING_L3_MID_X)
    b7 = (x > scenes.AVOIDING_L3_MID_X) & (x < scenes.AVOIDING_L3_BOT_X) & ~b6
    b8 = (x > scenes.AVOIDING_L3_TOP_X) & ~b6 & ~b7
    hits = torch.stack([
        l1 & (x < scenes.AVOIDING_L1_X),
        l1 & (x > scenes.AVOIDING_L1_X),
        l2 & (x < scenes.AVOIDING_L2_TOP_X),
        l2 & (x > scenes.AVOIDING_L2_TOP_X) & (x < scenes.AVOIDING_L2_BOT_X),
        l2 & (x > scenes.AVOIDING_L2_BOT_X),
        l3 & b5, l3 & b6, l3 & b7, l3 & b8], dim=1)
    enc = torch.clamp(state.mode_encoding + hits.to(torch.float32), 0.0, 1.0)
    passed = passed | torch.stack([l1, l2, l3], dim=1)
    return state._replace(mode_encoding=enc, passed=passed)


def step(params: AvoidingParams, state: AvoidingState, action):
    """action [B, 7]: absolute Cartesian setpoint [x, y, z, qw, qx, qy, qz]."""
    tcp_pos, _ = params.tcp_pose(state.scene)
    obs = tcp_pos[:, :2]
    success_now = tcp_pos[:, 1] > scenes.AVOIDING_GOAL_Y
    failure_now = _rod_collision(params, state.scene)
    early = success_now | failure_now
    done = state.terminated | early | (state.t >= params.max_steps - 1)
    terminated = state.terminated | early
    success = state.success | success_now
    failure = state.failure | (failure_now & ~state.success)

    action = torch.as_tensor(action, dtype=torch.float32, device=params.device)
    sc, cs = common.run_substeps(params, state.scene, state.ctrl,
                                 action[:, :3].contiguous(),
                                 quat_ops.normalize(action[:, 3:7]))
    state = state._replace(scene=sc, ctrl=cs, t=state.t + 1,
                           terminated=terminated, success=success,
                           failure=failure)
    state = _check_mode(params, state)
    info = {"mode_encoding": state.mode_encoding, "success": state.success}
    return state, common.StepResult(obs=obs, reward=torch.zeros_like(obs[:, 0]),
                                    done=done, info=info)
