"""Demonstration datasets: reference pickle schema -> padded device tensors.

Counterpart of ``d3il_tpu/data/dataset.py``. Reads the per-episode pickle
schema of the reference datasets, a dict of logger channels

    env_state['robot']['des_c_pos' | 'c_pos' | 'des_j_pos' | 'gripper_width']
    env_state['<object>']['pos' | 'quat']

and builds fixed-size [N, max_len, D] float32 tensors + masks with the
action = next-step desired-position delta convention. The whole padded
tensor lives on the device and a minibatch is one gather over the table of
valid window starts.
"""
from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Sequence

import numpy as np
import torch

from d3il_tpu_torch.envs.common import resolve_device


class TrajectoryData(NamedTuple):
    """Padded trajectory tensors, device-resident."""
    observations: torch.Tensor  # [N, T, Do]
    actions: torch.Tensor       # [N, T, Da]
    masks: torch.Tensor         # [N, T]
    slices: torch.Tensor        # [S, 2] int64 (traj, start) valid window starts

    @property
    def n_windows(self):
        return self.slices.shape[0]


def _yaw_tan(quat: np.ndarray) -> np.ndarray:
    """np.tan(quat2euler(q)[..., -1:]) with the reference euler convention."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    # yaw of the reference quat2euler == -atan2(m01, m00) of the rotation
    m00 = 1 - 2 * (y * y + z * z)
    m01 = 2 * (x * y - w * z)
    return np.tan(-np.arctan2(m01, m00))[..., None]


def load_episode(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


# --- per-task observation/action assembly (mirrors *_dataset.py layouts) ---

def assemble_avoiding(ep: dict):
    """obs = [des_c_pos(2), c_pos(2)] (avoiding_dataset.py:54-63)."""
    des = np.asarray(ep["robot"]["des_c_pos"])[:, :2]
    cur = np.asarray(ep["robot"]["c_pos"])[:, :2]
    obs = np.concatenate([des, cur], axis=-1)
    act = des[1:] - des[:-1]
    return obs[:-1], act


def assemble_pushing(ep: dict):
    """obs = [des_c_pos(2), c_pos(2), red(2), tan yaw, green(2), tan yaw]
    (pushing_dataset.py:60-96)."""
    des = np.asarray(ep["robot"]["des_c_pos"])[:, :2]
    cur = np.asarray(ep["robot"]["c_pos"])[:, :2]
    red = np.asarray(ep["red-box"]["pos"])[:, :2]
    red_y = _yaw_tan(np.asarray(ep["red-box"]["quat"]))
    green = np.asarray(ep["green-box"]["pos"])[:, :2]
    green_y = _yaw_tan(np.asarray(ep["green-box"]["quat"]))
    obs = np.concatenate([des, cur, red, red_y, green, green_y], axis=-1)
    act = des[1:] - des[:-1]
    return obs[:-1], act


def assemble_sorting(ep: dict, n_boxes: int):
    """obs = [des(2), cur(2)] + per red/blue box [pos(2), tan yaw]
    (sorting_dataset.py:308-360 order: red boxes then blue boxes)."""
    des = np.asarray(ep["robot"]["des_c_pos"])[:, :2]
    cur = np.asarray(ep["robot"]["c_pos"])[:, :2]
    parts = [des, cur]
    half = n_boxes // 2
    for prefix in ("red-box", "blue-box"):
        for i in range(1, half + 1):
            key = f"{prefix}{i}"
            parts.append(np.asarray(ep[key]["pos"])[:, :2])
            parts.append(_yaw_tan(np.asarray(ep[key]["quat"])))
    obs = np.concatenate(parts, axis=-1)
    act = des[1:] - des[:-1]
    return obs[:-1], act


def assemble_aligning(ep: dict):
    """obs = [des_c_pos(3), c_pos(3), box pos+quat(7), target pos+quat(7)]
    (aligning_dataset.py:62-84)."""
    des = np.asarray(ep["robot"]["des_c_pos"])[:, :3]
    cur = np.asarray(ep["robot"]["c_pos"])[:, :3]
    box = np.concatenate([np.asarray(ep["push-box"]["pos"]),
                          np.asarray(ep["push-box"]["quat"])], axis=-1)
    tgt = np.concatenate([np.asarray(ep["target-box"]["pos"]),
                          np.asarray(ep["target-box"]["quat"])], axis=-1)
    obs = np.concatenate([des, cur, box, tgt], axis=-1)
    act = des[1:] - des[:-1]
    return obs[:-1], act


def assemble_inserting(ep: dict):
    """obs = [des(2), cur(2)] + per box [pos(2), tan yaw] = 13. The reference
    logs the three boxes as 'box-1/2/3' (gate_insertion.py:258-266) and ships
    no inserting dataset class; the layout follows its get_observation
    (gate_insertion.py:278-317) with the standard des-pos concat."""
    des = np.asarray(ep["robot"]["des_c_pos"])[:, :2]
    cur = np.asarray(ep["robot"]["c_pos"])[:, :2]
    parts = [des, cur]
    for i in (1, 2, 3):
        key = f"box-{i}"
        parts.append(np.asarray(ep[key]["pos"])[:, :2])
        parts.append(_yaw_tan(np.asarray(ep[key]["quat"])))
    obs = np.concatenate(parts, axis=-1)
    act = des[1:] - des[:-1]
    return obs[:-1], act


def assemble_stacking(ep: dict):
    """obs = [des_j_pos(7), gripper_width(1), 3 boxes (pos3 + tan yaw)] = 20
    action = [d des_j_pos(7), gripper_width(1)] (stacking_dataset.py:92-140:
    full 3-D box positions, next-step absolute gripper width)."""
    des_j = np.asarray(ep["robot"]["des_j_pos"])
    grip = np.asarray(ep["robot"]["gripper_width"]).reshape(-1, 1)
    parts = [des_j, grip]
    for key in ("red-box", "green-box", "blue-box"):
        parts.append(np.asarray(ep[key]["pos"]))
        parts.append(_yaw_tan(np.asarray(ep[key]["quat"])))
    obs = np.concatenate(parts, axis=-1)
    act = np.concatenate([des_j[1:] - des_j[:-1], grip[1:]], axis=-1)
    return obs[:-1], act


def _window_starts(lengths, window_size: int) -> np.ndarray:
    """[S, 2] (traj, start) of every window that fits its episode."""
    slices = [(i, s) for i, T in enumerate(lengths)
              for s in range(int(T) - window_size + 1)]
    return np.array(slices, np.int64).reshape(-1, 2)


def build(episodes: Sequence[tuple], max_len: int, window_size: int,
          obs_dim: int | None = None, action_dim: int | None = None,
          device=None) -> TrajectoryData:
    """episodes: list of (obs [T,Do], act [T,Da]) already assembled."""
    device = resolve_device(device)
    n = len(episodes)
    obs_dim = obs_dim or episodes[0][0].shape[-1]
    action_dim = action_dim or episodes[0][1].shape[-1]
    obs = np.zeros((n, max_len, obs_dim), np.float32)
    act = np.zeros((n, max_len, action_dim), np.float32)
    mask = np.zeros((n, max_len), np.float32)
    lengths = []
    for i, (o, a) in enumerate(episodes):
        T = min(len(o), max_len)
        obs[i, :T] = o[:T]
        act[i, :T] = a[:T]
        mask[i, :T] = 1.0
        lengths.append(T)
    dev = lambda a: torch.as_tensor(a, device=device)
    return TrajectoryData(dev(obs), dev(act), dev(mask),
                          dev(_window_starts(lengths, window_size)))


def load_task_dataset(data_dir: str, files, assemble_fn, max_len: int,
                      window_size: int = 1, device=None) -> TrajectoryData:
    device = resolve_device(device)
    eps = [assemble_fn(load_episode(os.path.join(data_dir, f))) for f in files]
    return build(eps, max_len, window_size, device=device)


def rewindow(data: TrajectoryData, window_size: int) -> TrajectoryData:
    """Recompute the valid window-start index table for a new window size."""
    lengths = data.masks.sum(1).cpu().numpy().astype(np.int64)
    return data._replace(slices=torch.as_tensor(
        _window_starts(lengths, window_size), device=data.masks.device))


def sample_windows(data: TrajectoryData, generator: torch.Generator,
                   batch_size: int, window_size: int):
    """Minibatch sampler: gather [B, W, D] windows. The generator lives on
    the data's device."""
    idx = torch.randint(0, data.slices.shape[0], (batch_size,),
                        generator=generator, device=data.slices.device)
    sl = data.slices[idx]                                         # [B, 2]
    t = sl[:, 1:2] + torch.arange(window_size, device=sl.device)  # [B, W]
    traj = sl[:, 0:1]
    return data.observations[traj, t], data.actions[traj, t]


def all_valid(data: TrajectoryData):
    """Flattened valid (obs, act) pairs as NumPy, for scaler fitting."""
    m = data.masks.cpu().numpy().astype(bool)
    return (data.observations.cpu().numpy()[m], data.actions.cpu().numpy()[m])
