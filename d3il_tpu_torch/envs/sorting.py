"""Sorting task (2/4/6 boxes): push red boxes to the red zone, blue to blue.

Counterpart of ``d3il_tpu/envs/sorting.py``, batched over envs: boxes slide
on a raised platform (a static box, top z = 0.1, friction 0.3 with geom
priority, at [0.5, -0.1, 0]) and are pushed off its +y edge into
rectangular target zones on the table (red x in (0.3, 0.5), blue x in
(0.525, 0.725), y in (0.22, 0.41)). The behavior mode is the color order in
which boxes reach their zones, bit-packed.
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

INIT_EE_POS = np.array([0.525, -0.3, 0.25])

RED_TARGET = np.array([0.4, 0.32])
BLUE_TARGET = np.array([0.625, 0.32])
RED_ZONE = np.array([[0.3, 0.22], [0.5, 0.41]])      # [[xmin,ymin],[xmax,ymax]]
BLUE_ZONE = np.array([[0.525, 0.22], [0.725, 0.41]])

# context spaces: rows of [x_lo, y_lo, x_hi, y_hi]
CONTEXT_SPACES = np.array([
    [0.4, -0.15, 0.5, -0.1],
    [0.4, -0.05, 0.5, 0.0],
    [0.4, 0.05, 0.5, 0.1],
    [0.55, -0.15, 0.65, -0.1],
    [0.55, -0.05, 0.65, 0.0],
    [0.55, 0.05, 0.65, 0.1],
])
MODE_SLOTS = 6    # boxes the mode record holds (the most a scene has)
SETTLE_SUBSTEPS = 60    # hold substeps of a reset: the boxes leave the platform


def build_sorting_scene(num_boxes: int,
                        solver_iters: int = 25) -> emodel.SceneModel:
    """num_boxes / 2 red then num_boxes / 2 blue 0.05 kg boxes with 3 cm
    half-extents, the table and the static platform."""
    robot = panda.build_sim_chain("rod")
    half = num_boxes // 2
    boxes = ([dict(name=f"red_{i+1}", mass=0.05, size=(0.03, 0.03, 0.03))
              for i in range(half)]
             + [dict(name=f"blue_{i+1}", mass=0.05, size=(0.03, 0.03, 0.03))
                for i in range(half)])
    platform = emodel.Geom(
        gtype=emodel.BOX, size=(0.3, 0.3, 0.1), pos=(0.5, -0.1, 0.0),
        friction=(0.3, 0.001, 0.0001), priority=1, name="platform")
    return emodel.build_scene(robot, scenes.rod_robot_geoms(robot), boxes,
                              [scenes.table_geom(), platform],
                              collide_robot_static=True,
                              solver_iters=solver_iters)


class SortingParams(common.RodTaskParams):
    def __init__(self, num_boxes: int = 2, n_substeps: int = 35,
                 max_steps: int = 700, solver_iters: int = 25,
                 kinematic: bool = False, device=None, q_init=None):
        if num_boxes not in (2, 4, 6):
            raise ValueError(f"sorting takes 2, 4 or 6 boxes, not {num_boxes}")
        super().__init__(build_sorting_scene(num_boxes, solver_iters),
                         n_substeps, max_steps, init_ee_pos=INIT_EE_POS,
                         kinematic=kinematic, device=device, q_init=q_init)
        self.num_boxes = num_boxes
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                        device=self.device)
        half = num_boxes // 2
        is_red = torch.arange(num_boxes, device=self.device) < half
        self.is_red = is_red                                        # [n]
        self.box_target = torch.where(is_red[:, None], f32(RED_TARGET),
                                      f32(BLUE_TARGET))             # [n, 2]
        self.box_zone = torch.where(is_red[:, None, None], f32(RED_ZONE),
                                    f32(BLUE_ZONE))                 # [n, 2, 2]


class SortingState(NamedTuple):
    scene: estep.SceneState
    ctrl: cartesian.CartImpedanceState
    t: torch.Tensor             # [B] int32
    terminated: torch.Tensor    # [B] bool
    mode: torch.Tensor          # [B, 6] int32 color bits, -1 until filled
    mode_step: torch.Tensor     # [B] int32 boxes credited so far
    finished_box: torch.Tensor  # [B, 6] bool: box already credited
    success: torch.Tensor       # [B] bool


def sample_context(generator: torch.Generator, batch: int, num_boxes: int):
    """Sample ``batch`` contexts (xy [B, n, 2], quat [B, n, 4]) on the
    generator's device: a point and a yaw in [-90, 90] degrees in each of
    the 6 spawn regions, one permutation of the regions per env, and the
    first ``num_boxes`` of them."""
    dev = generator.device
    space = torch.as_tensor(CONTEXT_SPACES, dtype=torch.float32, device=dev)
    lo, hi = space[:, :2], space[:, 2:]
    xy = torch.rand((batch, 6, 2), generator=generator, device=dev) \
        * (hi - lo) + lo
    deg = torch.rand((batch, 6), generator=generator, device=dev) * 180.0 \
        - 90.0
    perm = torch.argsort(torch.rand((batch, 6), generator=generator,
                                    device=dev), dim=1)[:, :num_boxes]
    xy = torch.gather(xy, 1, perm[..., None].expand(-1, -1, 2))
    yaw = torch.gather(deg, 1, perm) * math.pi / 180.0
    zz = torch.tensor([0.0, 0.0, 1.0], device=dev)
    return xy, quat_ops.from_euler(zz * yaw[..., None])


def initial_scene(params: SortingParams, context) -> estep.SceneState:
    """The scene a reset starts from, before its hold substeps: the arm at
    q_init, the boxes at the context's xy and yaw at z = 0.05, inside the
    platform (its top is at z = 0.1)."""
    xy, quat = (torch.as_tensor(c, dtype=torch.float32, device=params.device)
                for c in context)
    B, n = xy.shape[:2]
    free_pos = torch.cat([xy, xy.new_full((B, n, 1), 0.05)], dim=2)
    return common.init_scene_state(params, free_pos, quat.contiguous())


def reset(params: SortingParams, context) -> SortingState:
    """context = (xy [B, n, 2], quat [B, n, 4]); the boxes rise out of the
    platform over the reset's hold substeps."""
    sc = common.settle(params, initial_scene(params, context),
                       n=SETTLE_SUBSTEPS)
    B = sc.q.shape[0]
    cs = cartesian.init_state(sc.q[:, :7].clone())
    dev = params.device
    return SortingState(
        scene=sc, ctrl=cs, t=torch.zeros(B, dtype=torch.int32, device=dev),
        terminated=torch.zeros(B, dtype=torch.bool, device=dev),
        mode=torch.full((B, MODE_SLOTS), -1, dtype=torch.int32, device=dev),
        mode_step=torch.zeros(B, dtype=torch.int32, device=dev),
        finished_box=torch.zeros((B, MODE_SLOTS), dtype=torch.bool,
                                 device=dev),
        success=torch.zeros(B, dtype=torch.bool, device=dev))


def get_observation(params: SortingParams, state: SortingState):
    """[tcp_xy, then per box xy and tan(yaw)] per env."""
    tcp_pos, _ = params.tcp_pose(state.scene)
    fp, fq = state.scene.free_pos, state.scene.free_quat
    parts = [tcp_pos[:, :2]]
    for i in range(params.num_boxes):
        parts += [fp[:, i, :2], common.yaw_tan(fq[:, i])]
    return torch.cat(parts, dim=1)


def _in_zone(xy, zone):
    """xy [..., 2] strictly inside zone [..., 2, 2] = [[xmin, ymin],
    [xmax, ymax]] (broadcast)."""
    zone = torch.as_tensor(zone, dtype=xy.dtype, device=xy.device)
    return ((xy[..., 0] > zone[..., 0, 0]) & (xy[..., 0] < zone[..., 1, 0])
            & (xy[..., 1] > zone[..., 0, 1]) & (xy[..., 1] < zone[..., 1, 1]))


def _success_now(params, state):
    """Every box inside its color's zone."""
    xy = state.scene.free_pos[..., :2]
    return _in_zone(xy, params.box_zone).all(dim=1)


def _update_mode(params, state: SortingState) -> SortingState:
    """One box may 'finish' per step: the unfinished box closest to its
    color target, if it is inside its zone and fewer than 6 have finished."""
    n = params.num_boxes
    xy = state.scene.free_pos[..., :2]
    dists = torch.linalg.vector_norm(xy - params.box_target, dim=-1)
    dists = torch.where(state.finished_box[:, :n], 1e5, dists)
    mi = torch.argmin(dists, dim=1)                                 # [B]
    rows = torch.arange(xy.shape[0], device=xy.device)
    fin = _in_zone(xy[rows, mi], params.box_zone[mi])
    can = (state.mode_step <= 5) & fin
    color_bit = torch.where(params.is_red[mi], 0, 1).to(torch.int32)
    slot = state.mode_step.clamp(max=MODE_SLOTS - 1).long()
    mode = state.mode.clone()
    mode[rows, slot] = torch.where(can, color_bit, mode[rows, slot])
    finished = state.finished_box.clone()
    finished[rows, mi] = finished[rows, mi] | can
    return state._replace(mode=mode,
                          mode_step=state.mode_step + can.to(torch.int32),
                          finished_box=finished)


def decode_mode(mode, num_boxes: int):
    """Bit-pack the first num_boxes entries of mode [..., 6], MSB first in
    a byte: any nonzero entry (the unfilled -1 too) is a 1 bit."""
    bits = (mode[..., :num_boxes] != 0).to(torch.int32)
    weights = 2 ** (7 - torch.arange(num_boxes, device=mode.device,
                                     dtype=torch.int32))
    return (bits * weights).sum(dim=-1).to(torch.int32)


def step(params: SortingParams, state: SortingState, action):
    """action [B, 7]: absolute Cartesian setpoint [x, y, z, qw, qx, qy, qz]."""
    obs = get_observation(params, state)
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
    info = {"mode": decode_mode(state.mode, params.num_boxes),
            "success": state.success}
    return state, common.StepResult(obs=obs,
                                    reward=torch.zeros_like(obs[:, 0]),
                                    done=done, info=info)
