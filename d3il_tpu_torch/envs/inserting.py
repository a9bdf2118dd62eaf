"""Inserting task: push three boxes through gate channels onto their targets.

Counterpart of ``d3il_tpu/envs/inserting.py``, batched over envs: three
0.05 kg boxes (2.5 cm half-extents) must each be pushed through a maze of
17 static walls (maze_3..maze_19) to within 0.01 m (3-D) of its fixed
target. The behavior mode is the order in which the red, green and blue
boxes first reach their targets: 6 permutations, 0 until all three are
placed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from d3il_tpu_torch.control import cartesian
from d3il_tpu_torch.engine import model as emodel
from d3il_tpu_torch.engine import step as estep
from d3il_tpu_torch.envs import common, scenes
from d3il_tpu_torch.ops import quat as quat_ops
from d3il_tpu_torch.robot import panda

TARGET_MIN_DIST = 0.01
N_MODES = 6
N_BOXES = 3
SETTLE_SUBSTEPS = 2     # hold substeps of a reset

# fixed target poses; z = 0
TARGETS = np.array([
    [0.3575, 0.276, 0.0],
    [0.525, 0.4535, 0.0],
    [0.6925, 0.276, 0.0],
])

# context spaces: [x_lo, y_lo, x_hi, y_hi] per box
CONTEXT_SPACES = np.array([
    [0.35, -0.2, 0.5, -0.15],
    [0.55, -0.1, 0.7, -0.05],
    [0.35, 0.0, 0.5, 0.05],
])

# static maze walls: (pos, yaw_deg, half_size). The reference's diagonal
# walls use quat [0, 0.5, +-1, 0], a 180 degree flip about an in-plane
# axis, which for a symmetric box is an in-plane rotation by
# 2 atan2(-+0.5, 1), about -+53.13 degrees.
_DIAG = float(np.degrees(2 * np.arctan2(0.5, 1.0)))
MAZE_WALLS = [
    ((0.4, 0.17, 0.0), -_DIAG, (0.03, 0.01, 0.03)),      # maze_3
    ((0.65, 0.17, 0.0), _DIAG, (0.03, 0.01, 0.03)),      # maze_4
    ((0.383, 0.2185, 0.0), 0.0, (0.01, 0.03, 0.03)),     # maze_5
    ((0.667, 0.2185, 0.0), 0.0, (0.01, 0.03, 0.03)),     # maze_6
    ((0.3525, 0.2385, 0.0), 0.0, (0.04, 0.01, 0.03)),    # maze_7
    ((0.6975, 0.2385, 0.0), 0.0, (0.04, 0.01, 0.03)),    # maze_8
    ((0.32, 0.276, 0.0), 0.0, (0.01, 0.0475, 0.03)),     # maze_9
    ((0.73, 0.276, 0.0), 0.0, (0.01, 0.0475, 0.03)),     # maze_10
    ((0.3525, 0.3135, 0.0), 0.0, (0.04, 0.01, 0.03)),    # maze_11
    ((0.6975, 0.3135, 0.0), 0.0, (0.04, 0.01, 0.03)),    # maze_12
    ((0.383, 0.3335, 0.0), 0.0, (0.01, 0.03, 0.03)),     # maze_13
    ((0.667, 0.3335, 0.0), 0.0, (0.01, 0.03, 0.03)),     # maze_14
    ((0.435, 0.3975, 0.0), -_DIAG, (0.01, 0.07, 0.03)),  # maze_15
    ((0.615, 0.3975, 0.0), _DIAG, (0.01, 0.07, 0.03)),   # maze_16
    ((0.4875, 0.4585, 0.0), 0.0, (0.01, 0.04, 0.03)),    # maze_17
    ((0.5625, 0.4585, 0.0), 0.0, (0.01, 0.04, 0.03)),    # maze_18
    ((0.525, 0.491, 0.0), 0.0, (0.0475, 0.01, 0.03)),    # maze_19
]

# first two boxes of the first-visit order (0 = r, 1 = g, 2 = b) -> the
# reference's mode id: rgb 1, rbg 2, grb 3, gbr 4, brg 5, bgr 6
_MODE_LUT = np.zeros((3, 3), np.int32)
_MODE_LUT[0, 1], _MODE_LUT[0, 2] = 1, 2
_MODE_LUT[1, 0], _MODE_LUT[1, 2] = 3, 4
_MODE_LUT[2, 0], _MODE_LUT[2, 1] = 5, 6


def build_inserting_scene(solver_iters: int = 25) -> emodel.SceneModel:
    """The rod chain, three boxes, the table and the maze walls, each
    rotated by its yaw about z."""
    robot = panda.build_sim_chain("rod")
    boxes = [dict(name=f"push_box{i+1}", mass=0.05, size=(0.025, 0.025, 0.025))
             for i in range(N_BOXES)]
    statics = [scenes.table_geom()]
    for i, (pos, yaw_deg, half) in enumerate(MAZE_WALLS):
        yaw = np.radians(yaw_deg)
        quat = (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
        statics.append(emodel.Geom(
            gtype=emodel.BOX, size=tuple(half), pos=tuple(pos),
            quat=tuple(quat), name=f"maze_{i+3}"))
    return emodel.build_scene(robot, scenes.rod_robot_geoms(robot), boxes,
                              statics, collide_robot_static=True,
                              solver_iters=solver_iters)


class InsertingParams(common.RodTaskParams):
    def __init__(self, n_substeps: int = 35, max_steps: int = 2000,
                 solver_iters: int = 25, kinematic: bool = False,
                 device=None, q_init=None):
        super().__init__(build_inserting_scene(solver_iters), n_substeps,
                         max_steps, kinematic=kinematic, device=device,
                         q_init=q_init)
        self.targets = torch.as_tensor(TARGETS, dtype=torch.float32,
                                       device=self.device)


class InsertingState(NamedTuple):
    scene: estep.SceneState
    ctrl: cartesian.CartImpedanceState
    t: torch.Tensor             # [B] int32
    terminated: torch.Tensor    # [B] bool
    visited: torch.Tensor       # [B, 3] bool: box i has reached its target
    order: torch.Tensor         # [B, 3] int32 box index, -1 until filled
    n_visited: torch.Tensor     # [B] int32
    success: torch.Tensor       # [B] bool


def sample_context(generator: torch.Generator, batch: int):
    """Sample ``batch`` contexts (xy [B, 3, 2], quat [B, 3, 4]) on the
    generator's device: each box's xy in its own context space and a yaw in
    [-90, 90] degrees."""
    dev = generator.device
    space = torch.as_tensor(CONTEXT_SPACES, dtype=torch.float32, device=dev)
    lo, hi = space[:, :2], space[:, 2:]
    xy = torch.rand((batch, N_BOXES, 2), generator=generator, device=dev) \
        * (hi - lo) + lo
    deg = torch.rand((batch, N_BOXES), generator=generator, device=dev) \
        * 180.0 - 90.0
    zz = torch.tensor([0.0, 0.0, 1.0], device=dev)
    return xy, quat_ops.from_euler(zz * (deg * math.pi / 180.0)[..., None])


def reset(params: InsertingParams, context) -> InsertingState:
    """context = (xy [B, 3, 2], quat [B, 3, 4]). The boxes spawn at their
    settled rest height (the table top plus the half extent), then
    SETTLE_SUBSTEPS hold substeps."""
    xy, quat = (torch.as_tensor(c, dtype=torch.float32, device=params.device)
                for c in context)
    B = xy.shape[0]
    free_pos = torch.cat([xy, xy.new_full((B, N_BOXES, 1),
                                          scenes.TABLE_Z + 0.025)], dim=2)
    sc = common.init_scene_state(params, free_pos, quat.contiguous())
    sc = common.settle(params, sc, n=SETTLE_SUBSTEPS)
    cs = cartesian.init_state(sc.q[:, :7].clone())
    dev = params.device
    return InsertingState(
        scene=sc, ctrl=cs, t=torch.zeros(B, dtype=torch.int32, device=dev),
        terminated=torch.zeros(B, dtype=torch.bool, device=dev),
        visited=torch.zeros((B, N_BOXES), dtype=torch.bool, device=dev),
        order=torch.full((B, N_BOXES), -1, dtype=torch.int32, device=dev),
        n_visited=torch.zeros(B, dtype=torch.int32, device=dev),
        success=torch.zeros(B, dtype=torch.bool, device=dev))


def get_observation(params: InsertingParams, state: InsertingState):
    """[tcp_xy, then per box xy and tan(yaw)]: 11 dims per env."""
    tcp_pos, _ = params.tcp_pose(state.scene)
    fp, fq = state.scene.free_pos, state.scene.free_quat
    parts = [tcp_pos[:, :2]]
    for i in range(N_BOXES):
        parts += [fp[:, i, :2], common.yaw_tan(fq[:, i])]
    return torch.cat(parts, dim=1)


def _target_dists(params, state):
    """[B, 3] box-center to target distances in 3-D."""
    return torch.linalg.vector_norm(state.scene.free_pos - params.targets,
                                    dim=-1)


def _success_now(params, state):
    return (_target_dists(params, state) <= TARGET_MIN_DIST).all(dim=1)


def _update_mode(params, state: InsertingState) -> InsertingState:
    """First-visit order: each box is appended to the order the first step
    it is within the target threshold; boxes that cross in one step are
    appended in the fixed r, g, b scan order."""
    near = _target_dists(params, state) <= TARGET_MIN_DIST
    visited, order = state.visited.clone(), state.order.clone()
    n = state.n_visited
    rows = torch.arange(near.shape[0], device=near.device)
    for i in range(N_BOXES):
        new = near[:, i] & ~visited[:, i]
        slot = n.clamp(max=N_BOXES - 1).long()
        order[rows, slot] = torch.where(new, i, order[rows, slot]).to(
            torch.int32)
        n = n + new.to(torch.int32)
        visited[:, i] = visited[:, i] | near[:, i]
    return state._replace(visited=visited, order=order, n_visited=n)


def decode_mode(order, n_visited):
    """The reference's mode id 1..6 of order [..., 3], or 0 while fewer
    than 3 boxes are placed."""
    lut = torch.as_tensor(_MODE_LUT, device=order.device)
    first = order[..., 0].clamp(0, 2).long()
    second = order[..., 1].clamp(0, 2).long()
    return torch.where(n_visited == N_BOXES, lut[first, second],
                       torch.zeros_like(n_visited))


def get_reward(params, state):
    """-(the nearest box's planar distance to the tcp + the sum of the
    boxes' target distances)."""
    tcp_pos, _ = params.tcp_pose(state.scene)
    d_rb = torch.linalg.vector_norm(
        state.scene.free_pos[..., :2] - tcp_pos[:, None, :2], dim=-1)
    return -(d_rb.amin(dim=1) + _target_dists(params, state).sum(dim=1))


def step(params: InsertingParams, state: InsertingState, action):
    """action [B, 7]: absolute Cartesian setpoint [x, y, z, qw, qx, qy, qz]."""
    obs = get_observation(params, state)
    reward = get_reward(params, state)
    early = _success_now(params, state)
    done = state.terminated | early | (state.t >= params.max_steps - 1)
    terminated = state.terminated | early

    action = torch.as_tensor(action, dtype=torch.float32, device=params.device)
    sc, cs = common.run_substeps(params, state.scene, state.ctrl,
                                 action[:, :3].contiguous(),
                                 quat_ops.normalize(action[:, 3:7]))
    state = state._replace(scene=sc, ctrl=cs, t=state.t + 1,
                           terminated=terminated)
    succ = _success_now(params, state)
    state = state._replace(success=succ, terminated=state.terminated | succ)
    state = _update_mode(params, state)
    info = {"mode": decode_mode(state.order, state.n_visited),
            "success": state.success,
            "mean_distance": _target_dists(params, state).mean(dim=1),
            "one_box_success": state.n_visited >= 1,
            "two_box_success": state.n_visited >= 2,
            "three_box_success": state.n_visited >= 3}
    return state, common.StepResult(obs=obs, reward=reward, done=done,
                                    info=info)
