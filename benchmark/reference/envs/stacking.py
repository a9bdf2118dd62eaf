"""Stacking task: pick and place three cubes onto a target, 6 order modes.

Counterpart of ``d3il_tpu/envs/stacking.py``, batched over envs: the
gripper Panda under the joint tracking controller. Action: an absolute
joint setpoint (7) and a gripper width (1); a width above 0.075 opens the
fingers, any other closes them. Success: all three boxes within 0.06 m (xy)
of the target, with every pairwise z separation above 0.03. Mode: the
order in which the boxes arrive at the target.

The step runs the joint window (``engine/substep_bm.joint_substeps_bm``):
no IK, the setpoint held by joint PD (K2) and the contacts (K3's general
variant: 22 pairs, 88 contacts, nv 27), including the finger pads on the
slide joints.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.engine import model as emodel
from benchmark.reference.engine import step as estep
from benchmark.reference.engine import substep_bm
from benchmark.reference.envs import common, scenes
from benchmark.reference.ops import quat as quat_ops
from benchmark.reference.robot import panda

INIT_EE_POS = np.array([0.525, 0.0, 0.3])
POS_MIN_DIST = 0.06
Z_SEP = 0.03
OPEN_WIDTH = 0.04       # the fingers' commanded width when open
SETTLE_SUBSTEPS = 5     # joint-window substeps of a reset, fingers open
GRASP_DELAY_S = 0.5     # closing time before the grasp force engages

# context spaces, rows of [x_lo, y_lo, x_hi, y_hi]: red, green, blue, target
SPACES = np.array([
    [0.35, -0.25, 0.45, -0.15],
    [0.35, -0.10, 0.45, 0.00],
    [0.55, -0.20, 0.60, 0.00],
    [0.40, 0.15, 0.60, 0.25],
])
BOX_SIZES = ((0.03, 0.03, 0.03), (0.03, 0.03, 0.03), (0.03, 0.05, 0.03))


def gripper_finger_geoms(chain):
    """Finger collision geoms for grasping: each finger's tip pad (an
    8 x 4 x 8 mm box, friction 2, solref 0.01 0.5) and a box in place of
    its mesh pad (friction 1, solimp 0.998 0.999 0.001, solref 0.02 1)."""
    out = []
    for fname, tip, sgn in (("panda_leftfinger", "finger_joint1_tip", 1.0),
                            ("panda_rightfinger", "finger_joint2_tip", -1.0)):
        fb = chain.body_index(fname)
        tb = chain.body_index(tip)
        out.append(emodel.Geom(
            gtype=emodel.BOX, size=(0.008, 0.004, 0.008), body=tb,
            pos=(0.0, -0.005 * sgn, -0.012),
            friction=(2.0, 0.05, 0.0001), solref=(0.01, 0.5),
            name=f"{tip}_collision"))
        out.append(emodel.Geom(
            gtype=emodel.BOX, size=(0.009, 0.008, 0.024), body=fb,
            pos=(0.0, 0.0105 * sgn, 0.028),
            friction=(1.0, 0.005, 0.0001),
            solimp=(0.998, 0.999, 0.001, 0.5, 2.0), solref=(0.02, 1.0),
            name=f"{fname}_pad"))
    return out


def build_stacking_scene(solver_iters: int = 40) -> emodel.SceneModel:
    """The gripper chain with its finger pads, three 0.05 kg boxes and the
    table."""
    robot = panda.build_sim_chain("gripper")
    boxes = [dict(name=n, mass=0.05, size=s) for n, s in
             zip(("red_box", "green_box", "blue_box"), BOX_SIZES)]
    return emodel.build_scene(robot, gripper_finger_geoms(robot), boxes,
                              [scenes.table_geom()],
                              collide_robot_static=True,
                              solver_iters=solver_iters)


class StackingParams(common.RodTaskParams):
    def __init__(self, n_substeps: int = 30, max_steps: int = 1000,
                 solver_iters: int = 40, kinematic: bool = False,
                 device=None, q_init=None):
        super().__init__(build_stacking_scene(solver_iters), n_substeps,
                         max_steps, init_ee_pos=INIT_EE_POS,
                         kinematic=kinematic, device=device, q_init=q_init)
        # close-command steps after which the grasp force engages
        self.grasp_steps = int(round(GRASP_DELAY_S / (n_substeps * self.dt)))


class StackingState(NamedTuple):
    scene: estep.SceneState
    ctrl_q: torch.Tensor       # [B, 7] joint setpoint held between steps
    grasp: torch.Tensor        # [B] int32: consecutive close-command steps
    t: torch.Tensor            # [B] int32
    terminated: torch.Tensor   # [B] bool
    target_xy: torch.Tensor    # [B, 2]
    mode: torch.Tensor         # [B, 3] int32 arrival order, -1 unfilled
    mode_len: torch.Tensor     # [B] int32
    placed: torch.Tensor       # [B, 3] bool
    success: torch.Tensor      # [B] bool


def sample_context(generator: torch.Generator, batch: int):
    """``batch`` contexts (xy [B, 4, 2], quat [B, 4, 4]; rows red, green,
    blue, target) on the generator's device: xy uniform in the context
    spaces, yaws uniform in [-90, 90] degrees."""
    dev = generator.device
    lo = torch.as_tensor(SPACES[:, :2], dtype=torch.float32, device=dev)
    hi = torch.as_tensor(SPACES[:, 2:], dtype=torch.float32, device=dev)
    xy = torch.rand((batch, 4, 2), generator=generator, device=dev) \
        * (hi - lo) + lo
    deg = torch.rand((batch, 4), generator=generator, device=dev) * 180.0 \
        - 90.0
    zz = torch.tensor([0.0, 0.0, 1.0], device=dev)
    return xy, quat_ops.from_euler(zz * deg[..., None] * math.pi / 180.0)


def reset(params: StackingParams, context) -> StackingState:
    """context = (xy [B, 4, 2], quat [B, 4, 4]): the boxes at z = 0 with
    their yaws, the target's xy; the fingers open."""
    xy, quat = (torch.as_tensor(c, dtype=torch.float32, device=params.device)
                for c in context)
    B = xy.shape[0]
    dev = params.device
    free_pos = torch.cat([xy[:, :3], xy.new_zeros((B, 3, 1))], dim=2)
    sc = common.init_scene_state(params, free_pos, quat[:, :3].contiguous())
    q = sc.q.clone()
    q[:, 7:9] = OPEN_WIDTH
    sc = common.settle(params, sc._replace(q=q), n=SETTLE_SUBSTEPS)
    zeros = lambda *s, dtype=torch.bool: torch.zeros((B,) + s, dtype=dtype,
                                                     device=dev)
    return StackingState(
        scene=sc, ctrl_q=sc.q[:, :7].clone(), grasp=zeros(dtype=torch.int32),
        t=zeros(dtype=torch.int32), terminated=zeros(),
        target_xy=xy[:, 3].contiguous(),
        mode=torch.full((B, 3), -1, dtype=torch.int32, device=dev),
        mode_len=zeros(dtype=torch.int32), placed=zeros(3), success=zeros())


def get_observation(params: StackingParams, state: StackingState):
    """[per box: pos(3), tan yaw] [B, 12]."""
    sc = state.scene
    return torch.cat([torch.cat([sc.free_pos[:, i],
                                 common.yaw_tan(sc.free_quat[:, i])], dim=1)
                      for i in range(3)], dim=1)


def robot_state(params: StackingParams, state: StackingState):
    """[joint positions (7), gripper width (1)] [B, 8]: the rollout's
    action prefix."""
    q = state.scene.q
    return torch.cat([q[:, :7], (q[:, 7] + q[:, 8])[:, None]], dim=1)


def _target_dist(state):
    return torch.linalg.vector_norm(
        state.scene.free_pos[:, :, :2] - state.target_xy[:, None], dim=-1)


def _success_now(state):
    z = state.scene.free_pos[:, :, 2]
    diff_z = torch.stack([(z[:, 0] - z[:, 1]).abs(), (z[:, 0] - z[:, 2]).abs(),
                          (z[:, 1] - z[:, 2]).abs()], dim=1).amin(dim=1)
    return (_target_dist(state) <= POS_MIN_DIST).all(dim=1) & (diff_z > Z_SEP)


def _update_mode(state: StackingState) -> StackingState:
    """The nearest box not yet placed arrives when it is within
    POS_MIN_DIST of the target; its index joins the order."""
    d = torch.where(state.placed, 1e5, _target_dist(state))
    mi = torch.argmin(d, dim=1, keepdim=True)
    arrive = (torch.gather(d, 1, mi)[:, 0] <= POS_MIN_DIST) \
        & (state.mode_len < 3)
    slot = state.mode_len.clamp(max=2).long()[:, None]
    mode = torch.where(arrive[:, None],
                       state.mode.scatter(1, slot, mi.to(torch.int32)),
                       state.mode)
    placed = torch.where(arrive[:, None], state.placed.scatter(1, mi, True),
                         state.placed)
    return state._replace(mode=mode, placed=placed,
                          mode_len=state.mode_len + arrive.to(torch.int32))


def step(params: StackingParams, state: StackingState, action):
    """action [B, 8]: [q_des (7), gripper width (1)], absolute."""
    obs = get_observation(params, state)
    early = _success_now(state)
    done = state.terminated | early | (state.t >= params.max_steps - 1)
    terminated = state.terminated | early

    action = torch.as_tensor(action, dtype=torch.float32, device=params.device)
    q_des = action[:, :7].contiguous()
    open_cmd = action[:, 7] > 0.075
    # closing target: width 0 under the grasp force in dynamic mode; the
    # position-prescribed (kinematic) fingers need a geometric target, 2 mm
    # of indent per finger into the 3 cm half-width boxes
    close_w = 0.028 if params.kinematic else 0.0
    set_width = torch.where(open_cmd, OPEN_WIDTH, close_w)
    # the first GRASP_DELAY_S of a close command run the closing-velocity
    # servo; the grasp force engages once the fingers sit on the box
    close_t = torch.where(open_cmd, 0, state.grasp + 1).to(torch.int32)
    grasp_on = close_t > params.grasp_steps
    sc = substep_bm.joint_substeps_bm(params, state.scene, q_des, set_width,
                                      grasp_on, params.n_substeps)
    state = state._replace(scene=sc, ctrl_q=q_des, grasp=close_t,
                           t=state.t + 1, terminated=terminated)
    succ = _success_now(state)
    state = _update_mode(state._replace(success=succ,
                                        terminated=state.terminated | succ))
    info = {"mode": state.mode, "mode_len": state.mode_len,
            "success": state.success, "success_1": state.mode_len > 0,
            "success_2": state.mode_len > 1}
    return state, common.StepResult(obs=obs, reward=torch.zeros_like(obs[:, 0]),
                                    done=done, info=info)
