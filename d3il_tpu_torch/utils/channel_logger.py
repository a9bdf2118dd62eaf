"""In-sim channel logger: the reference's per-step robot and object loggers
as preallocated device buffers.

Counterpart of ``d3il_tpu/utils/channel_logger.py``:

  * a ``Channel`` declares a dotted name ``group.field`` and a function
    ``extract(state) -> tensor``;
  * ``make_logger`` turns a channel list into ``(init, record, export)``:
    ``init()`` allocates one zeroed buffer per channel on the state's
    device, ``record(bufs, t, state)`` writes step ``t`` into them in place
    (every ``interval``-th step; no host sync, also for a tensor ``t``),
    and ``export(bufs, length)`` trims them to the episode length and
    returns the nested ``{group: {field: np.ndarray}}`` dict, the episode
    pickle schema of the demo generator;
  * ``plot`` draws per-channel line plots, headless.

One logger serves a batched rollout through ``batch_dims`` leading batch
axes of the extracted values (where the JAX package vmaps the logger): the
buffers are then ``[*batch, n_slots, ...]``, the layout ``vmap`` gives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class Channel:
    """One logged quantity: dotted name 'group.field' + extractor."""
    name: str
    extract: Callable[[Any], torch.Tensor]


def robot_channels(tcp_pose_fn) -> list[Channel]:
    """The robot logger's standard set for a scene state: joint position
    and velocity, cartesian position and orientation, gripper width."""
    return [
        Channel("robot.j_pos", lambda s: s.q[..., :7]),
        Channel("robot.j_vel", lambda s: s.qd[..., :7]),
        Channel("robot.c_pos", lambda s: tcp_pose_fn(s)[0]),
        Channel("robot.c_quat", lambda s: tcp_pose_fn(s)[1]),
        Channel("robot.gripper_width", lambda s: s.q[..., 7] + s.q[..., 8]),
    ]


def object_channels(names: Sequence[str]) -> list[Channel]:
    """Position and orientation of each free body."""
    out = []
    for i, nm in enumerate(names):
        out.append(Channel(f"{nm}.pos", lambda s, i=i: s.free_pos[..., i, :]))
        out.append(Channel(f"{nm}.quat",
                           lambda s, i=i: s.free_quat[..., i, :]))
    return out


def make_logger(channels: Sequence[Channel], max_steps: int,
                interval: int = 1, example_state=None, batch_dims: int = 0):
    """Build (init, record, export) for a channel list.

    interval: record every k-th step. Buffer slots beyond the episode
    length stay zero. ``example_state`` (or the state given to ``init``)
    fixes the shapes and the device."""
    n_slots = -(-max_steps // interval)
    ax = batch_dims

    def values(state):
        return [torch.as_tensor(c.extract(state)).to(torch.float32)
                for c in channels]

    def init(state=None):
        state = example_state if state is None else state
        if state is None:
            raise ValueError("need example_state or state")
        return tuple(v.new_zeros(v.shape[:ax] + (n_slots,) + v.shape[ax:])
                     for v in values(state))

    def record(bufs, t, state):
        vals = values(state)
        if not torch.is_tensor(t):
            if t % interval == 0 and t // interval < n_slots:
                for buf, v in zip(bufs, vals):
                    buf.select(ax, t // interval).copy_(v)
            return bufs
        # a step held on the device: a masked write, no host sync
        take = ((t % interval == 0) & (t // interval < n_slots)).reshape(())
        slot = (t // interval).reshape(1).clamp(max=n_slots - 1)
        for buf, v in zip(bufs, vals):
            old = buf.index_select(ax, slot).squeeze(ax)
            buf.index_copy_(ax, slot, torch.where(take, v, old).unsqueeze(ax))
        return bufs

    def export(bufs, length=None):
        L = n_slots if length is None else -(-int(length) // interval)
        out: dict[str, dict[str, np.ndarray]] = {}
        for c, buf in zip(channels, bufs):
            group, _, field = c.name.partition(".")
            out.setdefault(group, {})[field or "value"] = \
                buf.narrow(ax, 0, L).cpu().numpy()
        return out

    return init, record, export


def plot(log: dict, path: str, groups: Sequence[str] | None = None):
    """Per-channel line plots as a headless PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    groups = list(log.keys()) if groups is None else list(groups)
    rows = sum(len(log[g]) for g in groups)
    fig, axes = plt.subplots(rows, 1, figsize=(8, 2.2 * rows), squeeze=False)
    r = 0
    for g in groups:
        for field, arr in log[g].items():
            a = np.asarray(arr)
            axes[r, 0].plot(a.reshape(a.shape[0], -1))
            axes[r, 0].set_ylabel(f"{g}.{field}", fontsize=8)
            r += 1
    axes[-1, 0].set_xlabel("control step")
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
