"""Aligning task: push/rotate an open tray onto a target pose, 2 modes.

Counterpart of ``d3il_tpu/envs/aligning.py``, batched over envs: an
open-top tray (a 1 kg base plate 0.05 x 0.05 x 0.01 with friction 0.3 and
priority 1, plus four 1 g walls up to z ~ 0.0935) must match a sampled
target pose within pos 0.018 m and rot 0.048 pi. Action: absolute
Cartesian xyz setpoint. Mode: push from inside (rod within 0.051 m of the
tray center in xy) vs outside, per step.
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

INIT_EE_POS = np.array([0.525, -0.35, 0.25])

POS_MIN_DIST = 0.018
ROT_MIN_DIST = 0.048    # fraction of pi
ROBOT_BOX_DIST = 0.051
SETTLE_SUBSTEPS = 5     # hold substeps of a reset

# context spaces: [[x_lo, y_lo], [x_hi, y_hi]]
BOX_SPACE = np.array([[0.4, -0.25], [0.6, -0.1]])
TARGET_SPACE = np.array([[0.4, 0.2], [0.6, 0.35]])


def _tray_body():
    """One compound free body: the base plate and four walls, each a box
    geom offset in the body frame; one inertia for the body, the base
    plate's (the walls weigh 1 g each)."""
    geoms = [
        dict(gtype=emodel.BOX, size=(0.05, 0.05, 0.01), pos=(0, 0, 0),
             friction=(0.3, 0.001, 0.0001), priority=1),
        dict(gtype=emodel.BOX, size=(0.005, 0.05, 0.045), pos=(0.05, 0, 0.0485)),
        dict(gtype=emodel.BOX, size=(0.05, 0.005, 0.045), pos=(0, 0.05, 0.0485)),
        dict(gtype=emodel.BOX, size=(0.005, 0.05, 0.045), pos=(-0.05, 0, 0.0485)),
        dict(gtype=emodel.BOX, size=(0.05, 0.005, 0.045), pos=(0, -0.05, 0.0485)),
    ]
    inertia = emodel.box_inertia(1.0, (0.05, 0.05, 0.01))
    return dict(name="aligning_box", mass=1.004, geoms=geoms, inertia=inertia)


def build_aligning_scene(solver_iters: int = 30) -> emodel.SceneModel:
    robot = panda.build_sim_chain("rod")
    return emodel.build_scene(robot, scenes.rod_robot_geoms(robot),
                              [_tray_body()], [scenes.table_geom()],
                              collide_robot_static=True,
                              solver_iters=solver_iters)


class AligningParams(common.RodTaskParams):
    def __init__(self, n_substeps: int = 35, max_steps: int = 400,
                 solver_iters: int = 30, kinematic: bool = False,
                 device=None, q_init=None):
        super().__init__(build_aligning_scene(solver_iters), n_substeps,
                         max_steps, init_ee_pos=INIT_EE_POS,
                         kinematic=kinematic, device=device, q_init=q_init)


class AligningState(NamedTuple):
    scene: estep.SceneState
    ctrl: cartesian.CartImpedanceState
    t: torch.Tensor            # [B] int32
    terminated: torch.Tensor   # [B] bool
    target_pos: torch.Tensor   # [B, 3]
    target_quat: torch.Tensor  # [B, 4]
    mode: torch.Tensor         # [B] int32, -1 before the first step
    success: torch.Tensor      # [B] bool


def _yaw_quat(deg):
    zz = torch.tensor([0.0, 0.0, 1.0], device=deg.device)
    return quat_ops.from_euler(zz * deg[:, None] * math.pi / 180.0)


def sample_context(generator: torch.Generator, batch: int):
    """Sample ``batch`` contexts (box_xy [B, 2], box_quat [B, 4], target_xy,
    target_quat) on the generator's device: xy uniform in the context
    spaces, yaws uniform in [-90, 90] degrees."""
    dev = generator.device
    space = lambda s: torch.as_tensor(s, dtype=torch.float32, device=dev)
    lo_b, hi_b = space(BOX_SPACE)
    lo_t, hi_t = space(TARGET_SPACE)
    box_xy = torch.rand((batch, 2), generator=generator, device=dev) \
        * (hi_b - lo_b) + lo_b
    tgt_xy = torch.rand((batch, 2), generator=generator, device=dev) \
        * (hi_t - lo_t) + lo_t
    deg = torch.rand((batch, 2), generator=generator, device=dev) * 180.0 \
        - 90.0
    return box_xy, _yaw_quat(deg[:, 0]), tgt_xy, _yaw_quat(deg[:, 1])


def rotation_distance(p, q):
    """Angle between two quaternions."""
    d = torch.abs((p * q).sum(dim=-1))
    return 2.0 * torch.arccos(torch.clamp(d, -1.0, 1.0))


def initial_scene(params: AligningParams, context) -> estep.SceneState:
    """The scene a reset starts from, before its hold substeps: the arm at
    q_init, the tray at the context's xy and yaw with its base plate's
    center at z = 0 (9 mm above the table)."""
    box_xy, box_quat = (torch.as_tensor(c, dtype=torch.float32,
                                        device=params.device)
                        for c in context[:2])
    z = box_xy.new_zeros((box_xy.shape[0], 1))
    return common.init_scene_state(params, torch.cat([box_xy, z], 1)[:, None],
                                   box_quat[:, None].contiguous())


def reset(params: AligningParams, context) -> AligningState:
    """context = (box_xy [B, 2], box_quat [B, 4], target_xy, target_quat)."""
    sc = common.settle(params, initial_scene(params, context),
                       n=SETTLE_SUBSTEPS)
    tgt_xy, tgt_quat = (torch.as_tensor(c, dtype=torch.float32,
                                        device=params.device)
                        for c in context[2:])
    B = tgt_xy.shape[0]
    cs = cartesian.init_state(sc.q[:, :7].clone())
    dev = params.device
    return AligningState(
        scene=sc, ctrl=cs, t=torch.zeros(B, dtype=torch.int32, device=dev),
        terminated=torch.zeros(B, dtype=torch.bool, device=dev),
        target_pos=torch.cat([tgt_xy, tgt_xy.new_zeros((B, 1))], 1),
        target_quat=tgt_quat,
        mode=torch.full((B,), -1, dtype=torch.int32, device=dev),
        success=torch.zeros(B, dtype=torch.bool, device=dev))


def get_observation(params: AligningParams, state: AligningState):
    """[tcp_pos(3), box pos(3), box quat(4), target pos(3), target
    quat(4)] per env."""
    tcp_pos, _ = params.tcp_pose(state.scene)
    return torch.cat([tcp_pos, state.scene.free_pos[:, 0],
                      state.scene.free_quat[:, 0], state.target_pos,
                      state.target_quat], dim=1)


def _dists(state):
    pos_d = torch.linalg.vector_norm(
        state.scene.free_pos[:, 0] - state.target_pos, dim=-1)
    rot_d = rotation_distance(state.scene.free_quat[:, 0],
                              state.target_quat) / math.pi
    return pos_d, rot_d


def _success_now(state):
    pos_d, rot_d = _dists(state)
    return (pos_d <= POS_MIN_DIST) & (rot_d <= ROT_MIN_DIST)


def step(params: AligningParams, state: AligningState, action):
    """action [B, 7]: absolute Cartesian setpoint [x, y, z, qw, qx, qy, qz]."""
    obs = get_observation(params, state)
    early = _success_now(state)
    done = state.terminated | early | (state.t >= params.max_steps - 1)
    terminated = state.terminated | early

    action = torch.as_tensor(action, dtype=torch.float32, device=params.device)
    sc, cs = common.run_substeps(params, state.scene, state.ctrl,
                                 action[:, :3].contiguous(),
                                 quat_ops.normalize(action[:, 3:7]))
    state = state._replace(scene=sc, ctrl=cs, t=state.t + 1,
                           terminated=terminated)
    succ = _success_now(state)
    # mode per step: the rod inside (0) or outside (1) the tray
    tcp_pos, _ = params.tcp_pose(state.scene)
    d = torch.linalg.vector_norm(state.scene.free_pos[:, 0, :2]
                                 - tcp_pos[:, :2], dim=-1)
    mode = torch.where(d < ROBOT_BOX_DIST, 0, 1).to(torch.int32)
    pos_d, rot_d = _dists(state)
    state = state._replace(success=succ, terminated=state.terminated | succ,
                           mode=mode)
    info = {"mode": mode, "success": succ,
            "mean_distance": 0.5 * (pos_d + rot_d)}
    return state, common.StepResult(obs=obs, reward=torch.zeros_like(pos_d),
                                    done=done, info=info)
