"""Pushing task: two blocks to two targets, 4 solution modes.

Counterpart of ``d3il_tpu/envs/pushing.py``, batched over envs: the same
observation layout, action semantics, success predicate (both boxes within
0.05 m of either color assignment), first/second-visit mode tracking and
context distribution as the reference ``Block_Push_Env``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.control import cartesian
from benchmark.reference.engine import step as estep
from benchmark.reference.envs import common, scenes
from benchmark.reference.ops import quat as quat_ops

TARGET_MIN_DIST = 0.05
N_MODES = 4


class PushingParams(common.RodTaskParams):
    def __init__(self, n_substeps: int = 35, max_steps: int = 400,
                 solver_iters: int = 25, kinematic: bool = False,
                 device=None, q_init=None):
        super().__init__(scenes.build_pushing_scene(solver_iters), n_substeps,
                         max_steps, kinematic=kinematic, device=device,
                         q_init=q_init)
        self.target1 = torch.as_tensor(scenes.PUSHING_TARGET_1,
                                       dtype=torch.float32, device=self.device)
        self.target2 = torch.as_tensor(scenes.PUSHING_TARGET_2,
                                       dtype=torch.float32, device=self.device)


class PushingState(NamedTuple):
    scene: estep.SceneState
    ctrl: cartesian.CartImpedanceState
    t: torch.Tensor            # [B] int32
    terminated: torch.Tensor   # [B] bool
    first_visit: torch.Tensor  # [B] int32, -1 until a box first reaches a target
    mode: torch.Tensor         # [B] int32, -1 until the second target is reached
    success: torch.Tensor      # [B] bool


def sample_context(generator: torch.Generator, batch: int):
    """Sample ``batch`` contexts (red_xy [B,2], red_quat [B,4], green_xy,
    green_quat) from the reference context spaces on the generator's
    device: box x, y and a yaw in [-90, 90] degrees."""
    dev = generator.device
    lo_r = torch.tensor([0.4, -0.15, -90.0], device=dev)
    hi_r = torch.tensor([0.5, 0.0, 90.0], device=dev)
    lo_g = torch.tensor([0.55, -0.15, -90.0], device=dev)
    hi_g = torch.tensor([0.65, 0.0, 90.0], device=dev)
    red = torch.rand((batch, 3), generator=generator, device=dev) \
        * (hi_r - lo_r) + lo_r
    green = torch.rand((batch, 3), generator=generator, device=dev) \
        * (hi_g - lo_g) + lo_g
    zz = torch.tensor([0.0, 0.0, 1.0], device=dev)
    qr = quat_ops.from_euler(zz * red[:, 2:3] * math.pi / 180.0)
    qg = quat_ops.from_euler(zz * green[:, 2:3] * math.pi / 180.0)
    return red[:, :2], qr, green[:, :2], qg


def reset(params: PushingParams, context) -> PushingState:
    """context = (red_xy [B,2], red_quat [B,4], green_xy, green_quat)."""
    red_xy, red_quat, green_xy, green_quat = (
        torch.as_tensor(c, dtype=torch.float32, device=params.device)
        for c in context)
    B = red_xy.shape[0]
    z = red_xy.new_zeros((B, 1))
    free_pos = torch.stack([torch.cat([red_xy, z], dim=1),
                            torch.cat([green_xy, z], dim=1)], dim=1)
    free_quat = torch.stack([red_quat, green_quat], dim=1)
    sc = common.init_scene_state(params, free_pos, free_quat)
    sc = common.settle(params, sc, n=2)
    cs = cartesian.init_state(sc.q[:, :7].clone())
    dev = params.device
    return PushingState(
        scene=sc, ctrl=cs, t=torch.zeros(B, dtype=torch.int32, device=dev),
        terminated=torch.zeros(B, dtype=torch.bool, device=dev),
        first_visit=torch.full((B,), -1, dtype=torch.int32, device=dev),
        mode=torch.full((B,), -1, dtype=torch.int32, device=dev),
        success=torch.zeros(B, dtype=torch.bool, device=dev))


def get_observation(params: PushingParams, state: PushingState):
    """[robot_xy, box1_xy, tan(yaw1), box2_xy, tan(yaw2)] per env."""
    tcp_pos, _ = params.tcp_pose(state.scene)
    fp, fq = state.scene.free_pos, state.scene.free_quat
    return torch.cat([tcp_pos[:, :2], fp[:, 0, :2], common.yaw_tan(fq[:, 0]),
                      fp[:, 1, :2], common.yaw_tan(fq[:, 1])], dim=1)


def _distances(params, state):
    b1, b2 = state.scene.free_pos[:, 0], state.scene.free_pos[:, 1]
    g1, g2 = params.target1, params.target2
    n = lambda x: torch.linalg.vector_norm(x, dim=-1)
    return n(b1 - g1), n(b1 - g2), n(b2 - g1), n(b2 - g2)


def _success_now(params, state):
    rr, rg, gr, gg = _distances(params, state)
    d = TARGET_MIN_DIST
    return ((rr <= d) & (gg <= d)) | ((rg <= d) & (gr <= d))


def _pick(conds_vals, default):
    """Nested where: the value of the first true condition, else default."""
    out = torch.full_like(conds_vals[0][0], default, dtype=torch.int32)
    for cond, val in reversed(conds_vals):
        out = torch.where(cond, val, out)
    return out


def _update_mode(params, state: PushingState) -> PushingState:
    """First/second-visit tracking (pushing.py:341-377)."""
    rr, rg, gr, gg = _distances(params, state)
    d = TARGET_MIN_DIST
    fv = state.first_visit
    visit = _pick([((rr <= d) & (fv != 0), 0), ((rg <= d) & (fv != 1), 1),
                   ((gr <= d) & (fv != 2), 2), ((gg <= d) & (fv != 3), 3)], -1)
    new_fv = torch.where(fv == -1, visit, fv)
    pair_mode = _pick([((fv == 0) & (visit == 3), 0),
                       ((fv == 3) & (visit == 0), 1),
                       ((fv == 1) & (visit == 2), 2),
                       ((fv == 2) & (visit == 1), 3)], -1)
    new_mode = torch.where(fv == -1, torch.full_like(pair_mode, -1), pair_mode)
    return state._replace(first_visit=new_fv, mode=new_mode)


def get_reward(params, state):
    """Dense reward -(|robot-box1| + |box1-target1|)."""
    tcp_pos, _ = params.tcp_pose(state.scene)
    b1 = state.scene.free_pos[:, 0]
    rr, _, _, _ = _distances(params, state)
    d_rb = torch.linalg.vector_norm(tcp_pos[:, :2] - b1[:, :2], dim=-1)
    return -(d_rb + rr)


def step(params: PushingParams, state: PushingState, action):
    """action [B, 7]: absolute Cartesian setpoint [x, y, z, qw, qx, qy, qz]."""
    # pre-substep outputs (the reference computes obs/reward/done before
    # running the substeps)
    obs = get_observation(params, state)
    reward = get_reward(params, state)
    early = _success_now(params, state)
    done = state.terminated | early | (state.t >= params.max_steps - 1)
    terminated = state.terminated | early

    action = torch.as_tensor(action, dtype=torch.float32, device=params.device)
    des_pos = action[:, :3].contiguous()
    des_quat = quat_ops.normalize(action[:, 3:7])
    sc, cs = common.run_substeps(params, state.scene, state.ctrl, des_pos,
                                 des_quat)
    state = state._replace(scene=sc, ctrl=cs, t=state.t + 1,
                           terminated=terminated)
    succ = _success_now(params, state)
    state = state._replace(success=succ, terminated=state.terminated | succ)
    state = _update_mode(params, state)
    rr, rg, gr, gg = _distances(params, state)
    mean_distance = 0.5 * (torch.minimum(rr, rg) + torch.minimum(gr, gg))
    info = {"mode": state.mode, "success": state.success,
            "mean_distance": mean_distance}
    return state, common.StepResult(obs=obs, reward=reward, done=done,
                                    info=info)
