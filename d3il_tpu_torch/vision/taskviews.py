"""Per-task camera views: state observation -> rendered images + low-dim.

Counterpart of ``d3il_tpu/vision/taskviews.py``, batched: each task's
``render_obs(obs [B, Do])`` rebuilds the visible scene of every env (boxes
from the xy + tan-yaw channels, static fixtures from the scene constants,
the rod at the current tcp) and renders both cameras (the bp cage camera
and the inhand camera above the tcp) -> (bp [B, res, res, 3],
inhand [B, res, res, 3], low_dim [B, k]). The vision agents call it in
their loss (training renders the logged states: no image dataset on disk)
and in their policy (evaluation renders the live state of all B envs at
once each step).

The low-dim channel is the robot-state prefix of the policy observation
(des-prefix concat): [des, cur] xy, aligning's xyz.
"""
from __future__ import annotations

import numpy as np
import torch

from d3il_tpu_torch.envs import scenes, sorting
from d3il_tpu_torch.ops import quat as quat_ops
from d3il_tpu_torch.vision import renderer as R

VISION_TASKS = ("avoiding", "pushing", "aligning", "sorting_2", "sorting_4",
                "sorting_6")

RED = (0.85, 0.12, 0.12)
GREEN = (0.12, 0.75, 0.12)
BLUE = (0.15, 0.25, 0.85)
PAD_RED = (1.0, 0.45, 0.45)
PAD_GREEN = (0.45, 1.0, 0.45)
PAD_BLUE = (0.5, 0.6, 1.0)
GREY = (0.55, 0.55, 0.6)
UNIT_QUAT = (1.0, 0.0, 0.0, 0.0)


def _yaw_quat(tan_yaw):
    """[...] tan(yaw) -> [...] x 4 quaternions of that yaw."""
    yaw = torch.arctan(tan_yaw)
    zero = torch.zeros_like(yaw)
    return quat_ops.from_euler(torch.stack([zero, zero, yaw], dim=-1))


def _with_z(xy, z: float):
    """[B, ..., 2] -> [B, ..., 3] at height z."""
    return torch.cat([xy, torch.full_like(xy[..., :1], z)], dim=-1)


def _cams(geoms, cur, res):
    """Render the shared bp + inhand camera pair; the inhand camera looks
    straight down (-z) from 0.45 m above the tcp's xy."""
    bp = R.render(geoms, R.BP_CAM_POS, R.BP_CAM_QUAT, R.BP_CAM_FOVY, res=res)
    ih = R.render(geoms, _with_z(cur[:, :2], 0.45), UNIT_QUAT,
                  R.INHAND_CAM_FOVY, res=res)
    return bp, ih


def _unit_quats(n):
    return np.tile(np.array([UNIT_QUAT], np.float32), (n, 1))


def make_pushing_view(res: int = 96):
    """obs [B, 10] = [des(2), cur(2), red xy+tan, green xy+tan]."""
    t1 = np.asarray(scenes.PUSHING_TARGET_1, np.float32)
    t2 = np.asarray(scenes.PUSHING_TARGET_2, np.float32)
    statics_pos = np.stack([[t1[0], t1[1], -0.018], [t2[0], t2[1], -0.018]])

    def render_obs(obs):
        cur = obs[:, 2:4]
        boxes = torch.stack([obs[:, 4:7], obs[:, 7:10]], dim=1)   # [B, 2, 3]
        geoms = R.scene_geoms(
            _with_z(boxes[..., :2], 0.011), _yaw_quat(boxes[..., 2]),
            free_half=[[0.03, 0.03, 0.03]] * 2, free_colors=[RED, GREEN],
            static_pos=statics_pos, static_quat=_unit_quats(2),
            static_half=[[0.05, 0.05, 0.002]] * 2,
            static_colors=[PAD_RED, PAD_GREEN],
            rod_pos=_with_z(cur, 0.15), rod_quat=UNIT_QUAT)
        bp, ih = _cams(geoms, cur, res)
        return bp, ih, obs[:, :4]

    return render_obs


def make_sorting_view(num_boxes: int, res: int = 96):
    """obs [B, 4+3n] = [des(2), cur(2), red boxes (xy,tan)...,
    blue boxes...]."""
    half = num_boxes // 2
    platform = np.array([[0.5, -0.1, 0.0]], np.float32)
    rz = sorting.RED_ZONE
    bz = sorting.BLUE_ZONE
    zones = np.array([
        [(rz[0, 0] + rz[1, 0]) / 2, (rz[0, 1] + rz[1, 1]) / 2, -0.018],
        [(bz[0, 0] + bz[1, 0]) / 2, (bz[0, 1] + bz[1, 1]) / 2, -0.018]],
        np.float32)
    zone_half = np.array([
        [(rz[1, 0] - rz[0, 0]) / 2, (rz[1, 1] - rz[0, 1]) / 2, 0.002],
        [(bz[1, 0] - bz[0, 0]) / 2, (bz[1, 1] - bz[0, 1]) / 2, 0.002]],
        np.float32)
    statics_pos = np.concatenate([platform, zones])
    statics_half = np.concatenate([[[0.3, 0.3, 0.1]], zone_half])
    statics_color = np.array([GREY, PAD_RED, PAD_BLUE], np.float32)

    def render_obs(obs):
        cur = obs[:, 2:4]
        xs = obs[:, 4:].reshape(obs.shape[0], num_boxes, 3)
        geoms = R.scene_geoms(
            _with_z(xs[..., :2], 0.13), _yaw_quat(xs[..., 2]),
            free_half=[[0.03, 0.03, 0.03]] * num_boxes,
            free_colors=[RED] * half + [BLUE] * half,
            static_pos=statics_pos, static_quat=_unit_quats(3),
            static_half=statics_half, static_colors=statics_color,
            rod_pos=_with_z(cur, 0.25), rod_quat=UNIT_QUAT)
        bp, ih = _cams(geoms, cur, res)
        return bp, ih, obs[:, :4]

    return render_obs


def make_aligning_view(res: int = 96):
    """obs [B, 20] = [des(3), cur(3), box pos+quat(7), target pos+quat(7)].
    The tray renders as its 5-geom composite (bottom plate + 4 walls); the
    target as a flat pad."""
    # local offsets/halves of the tray composite (envs/aligning.py geoms)
    tray_off = np.array([[0, 0, 0], [0.05, 0, 0.0485], [0, 0.05, 0.0485],
                         [-0.05, 0, 0.0485], [0, -0.05, 0.0485]], np.float32)
    tray_half = np.array([[0.05, 0.05, 0.01], [0.005, 0.05, 0.045],
                          [0.05, 0.005, 0.045], [0.005, 0.05, 0.045],
                          [0.05, 0.005, 0.045]], np.float32)

    def render_obs(obs):
        cur = obs[:, 3:6]
        box_p, box_q = obs[:, 6:9], quat_ops.normalize(obs[:, 9:13])
        tgt_p, tgt_q = obs[:, 13:16], quat_ops.normalize(obs[:, 16:20])
        off_w = quat_ops.rotate(box_q[:, None],
                                torch.as_tensor(tray_off, device=obs.device))
        geoms = R.scene_geoms(
            box_p[:, None] + off_w, box_q[:, None].expand(-1, 5, 4),
            free_half=tray_half, free_colors=[[0.9, 0.5, 0.1]] * 5,
            static_pos=_with_z(tgt_p[:, None, :2], -0.018),
            static_quat=tgt_q[:, None], static_half=[[0.055, 0.055, 0.002]],
            static_colors=[PAD_GREEN],
            rod_pos=cur + torch.tensor([0.0, 0.0, 0.15], device=obs.device),
            rod_quat=UNIT_QUAT)
        bp, ih = _cams(geoms, cur, res)
        return bp, ih, obs[:, :6]

    return render_obs


def make_avoiding_view(res: int = 96):
    """obs [B, 4] = [des(2), cur(2)]; six static obstacles + the goal line;
    the free-body slot holds a hidden dummy box at z = -9."""
    mid, off, y1, dy = 0.5, 0.075, -0.1, 0.18
    obst = np.array([
        [mid, y1, 0.05], [mid - off, y1 + dy, 0.05], [mid + off, y1 + dy, 0.05],
        [mid - 2 * off, y1 + 2 * dy, 0.05], [mid, y1 + 2 * dy, 0.05],
        [mid + 2 * off, y1 + 2 * dy, 0.05]], np.float32)
    goal = np.array([[0.5, scenes.AVOIDING_GOAL_Y, -0.018]], np.float32)
    statics_pos = np.concatenate([obst, goal])
    statics_half = np.concatenate([
        np.tile([[0.027, 0.027, 0.09]], (6, 1)), [[0.25, 0.004, 0.002]]])
    statics_color = np.concatenate([
        np.tile([GREY], (6, 1)), [[0.2, 0.9, 0.2]]]).astype(np.float32)

    def render_obs(obs):
        cur = obs[:, 2:4]
        B = obs.shape[0]
        free_pos = obs.new_zeros((B, 1, 3)) + torch.tensor(
            [0.0, 0.0, -9.0], device=obs.device)
        geoms = R.scene_geoms(
            free_pos, torch.as_tensor(_unit_quats(1), device=obs.device)
            .expand(B, 1, 4),
            free_half=[[0.001] * 3], free_colors=[GREY],
            static_pos=statics_pos, static_quat=_unit_quats(7),
            static_half=statics_half, static_colors=statics_color,
            rod_pos=_with_z(cur, 0.15), rod_quat=UNIT_QUAT)
        bp, ih = _cams(geoms, cur, res)
        return bp, ih, obs[:, :4]

    return render_obs


def make_render_obs(task: str, res: int = 96):
    """Factory: task name -> render_obs(obs [B, Do]) -> (bp, inhand,
    low_dim)."""
    if task == "pushing":
        return make_pushing_view(res)
    if task == "aligning":
        return make_aligning_view(res)
    if task == "avoiding":
        return make_avoiding_view(res)
    if task.startswith("sorting"):
        return make_sorting_view(int(task.split("_")[1]), res)
    raise ValueError(f"no vision view for task {task!r} "
                     f"(supported: {VISION_TASKS})")


def low_dim_size(task: str) -> int:
    return {"aligning": 6}.get(task, 4)
