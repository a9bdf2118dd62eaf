"""Demonstration datasets from the scripted experts, batched on the device.

Counterpart of ``tools/gen_demos.py``'s pipeline: per task, the contexts
(each env's ``sample_context`` from a seeded ``torch.Generator``), the
mode or order choice (pure NumPy of the contexts and a seeded NumPy rng,
as the JAX pipeline chooses them), the batched expert rollout
(``experts.make_<task>_runner`` and ``run_chunked``), and the writer of the
reference pickle schema (nested float32 dicts plus ``mode``, one
``env_NNN.pkl`` per successful episode) with the seeded train/eval split.

The choose and write halves take NumPy arrays and need no Params, so they
can be held against the JAX pipeline without a scene.

    from d3il_tpu_torch.data import gen_demos
    files = gen_demos.generate("pushing", 120, "build/demos/pushing/all_data")
    gen_demos.write_split("build/demos/pushing", files, seed=0)
"""
from __future__ import annotations

import itertools
import os
import pickle
import time

import numpy as np
import torch

from d3il_tpu_torch.data import experts as ex
from d3il_tpu_torch.envs import scenes

TASKS = ["avoiding", "pushing", "aligning", "sorting_2", "sorting_4",
         "sorting_6", "stacking", "inserting"]
_PUSH_SEQ_BOX = np.array([[0, 1], [1, 0], [0, 1], [1, 0]], np.int32)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def write_episode(out_dir, ep_i, log_dict, mode):
    """One episode pickle: every channel float32, plus ``mode``."""
    fname = f"env_{ep_i:03d}.pkl"
    episode = {k: {kk: np.asarray(vv, np.float32) for kk, vv in v.items()}
               for k, v in log_dict.items()}
    episode["mode"] = mode
    with open(os.path.join(out_dir, fname), "wb") as f:
        pickle.dump(episode, f)
    return fname


def ep_len(dones_row):
    """Steps up to and including the first done (all if none)."""
    idx = np.argmax(dones_row)
    return int(idx) + 1 if dones_row.any() else len(dones_row)


def write_split(task_dir, files, seed=0):
    """train_files.pkl / eval_files.pkl: a tenth (at least one) of the
    episodes, by a permutation from NumPy seed + 1, for evaluation.
    Returns (train, eval) or None when there is nothing to split."""
    files = list(files)
    if not files:
        return None
    perm = np.random.default_rng(seed + 1).permutation(len(files))
    n_eval = max(1, len(files) // 10)
    eval_files = [files[i] for i in perm[:n_eval]]
    train_files = [files[i] for i in perm[n_eval:]]
    with open(os.path.join(task_dir, "train_files.pkl"), "wb") as f:
        pickle.dump(train_files, f)
    with open(os.path.join(task_dir, "eval_files.pkl"), "wb") as f:
        pickle.dump(eval_files, f)
    return train_files, eval_files


# ---- the choices: NumPy functions of the contexts and a seeded rng --------

def avoiding_waypoint_table(n, seed=0):
    """[n, 6, 2]: episode i takes gate mode (i % 2, i // 2 % 3, i // 6 %
    4) with jittered waypoints."""
    rng = np.random.default_rng(seed)
    return np.stack([ex.avoiding_waypoints(
        ((i % 2), (i // 2) % 3, (i // 6) % 4), rng)
        for i in range(n)]).astype(np.float32)


def pushing_modes(red_xy, green_xy, seed=0):
    """Context-correlated modes: usually the box nearer the arm first (20 %
    flipped), the target assignment a coin flip."""
    n = len(red_xy)
    rng = np.random.default_rng(seed + 7)
    start = np.asarray(scenes.INIT_EE_POS[:2])
    d_red = np.linalg.norm(np.asarray(red_xy) - start, axis=-1)
    d_green = np.linalg.norm(np.asarray(green_xy) - start, axis=-1)
    red_first = (d_red < d_green) ^ (rng.random(n) < 0.2)
    tgt_swap = rng.random(n) < 0.5
    return np.where(red_first, np.where(tgt_swap, 2, 0),
                    np.where(tgt_swap, 3, 1)).astype(np.int64)


def pushing_sequences(modes):
    """(seq_box [n, 2], seq_tgt [n, 2, 2]) of each mode."""
    t1 = scenes.PUSHING_TARGET_1[:2]
    t2 = scenes.PUSHING_TARGET_2[:2]
    seq_tgt = np.array([[t1, t2], [t2, t1], [t2, t1], [t1, t2]], np.float32)
    return _PUSH_SEQ_BOX[modes], seq_tgt[modes]


def sorting_orders(box_xy, seed=0):
    """Noisy-greedy nearest-first orders [n, nb] from the start point (the
    second-nearest box a quarter of the time)."""
    box_xy = np.asarray(box_xy)
    n, num_boxes = box_xy.shape[:2]
    rng = np.random.default_rng(seed)
    start = np.array([0.525, -0.3])
    orders = np.zeros((n, num_boxes), np.int32)
    for i in range(n):
        cur = start
        remaining = list(range(num_boxes))
        for k in range(num_boxes):
            d = np.linalg.norm(box_xy[i, remaining] - cur, axis=-1)
            pick = np.argsort(d)
            j = pick[1] if (len(pick) > 1 and rng.random() < 0.25) else pick[0]
            b = remaining.pop(int(j))
            orders[i, k] = b
            cur = box_xy[i, b]
    return orders


def aligning_modes(box_x, seed=0):
    """From inside (0) when the tray spawns left of x = 0.5, from outside
    (1) otherwise, each flipped 35 % of the time."""
    box_x = np.asarray(box_x)
    rng = np.random.default_rng(seed + 3)
    return ((box_x >= 0.5) ^ (rng.random(len(box_x)) < 0.35)).astype(
        np.int32)


def permutation_orders(n):
    """The 6 box orders in turn [n, 3]."""
    perms = np.array(list(itertools.permutations(range(3))), np.int32)
    return perms[np.arange(n) % 6]


def plan(task, contexts, n, seed=0):
    """The expert inputs a task's episodes take (NumPy), from its NumPy
    contexts: avoiding (waypoints,), pushing (modes, seq_box, seq_tgt),
    sorting (orders,), aligning (modes,), stacking and inserting
    (orders,)."""
    if task == "avoiding":
        return (avoiding_waypoint_table(n, seed),)
    if task == "pushing":
        modes = pushing_modes(contexts[0], contexts[2], seed)
        return (modes,) + pushing_sequences(modes)
    if task.startswith("sorting"):
        return (sorting_orders(contexts[0], seed),)
    if task == "aligning":
        return (aligning_modes(np.asarray(contexts[0])[:, 0], seed),)
    return (permutation_orders(n),)


# ---- the rollout ------------------------------------------------------------

def num_boxes(task):
    return int(task.split("_")[1]) if task.startswith("sorting") else None


def make_params(task, kinematic=True, device=None):
    """The task's Params for demo generation: stacking always under full
    dynamics (the kinematic fingers cannot hold a box)."""
    from d3il_tpu_torch import registry
    spec = registry.TASKS[task]
    if task == "stacking":
        kinematic = False
    return spec.make_params(kinematic=kinematic, device=device)


def sample_contexts(task, n, seed, device):
    """n contexts from the task's sample_context on a torch.Generator at
    ``seed`` (avoiding has none: ``()``)."""
    if task == "avoiding":
        return ()
    from d3il_tpu_torch import registry
    env = registry.TASKS[task].env()
    gen = torch.Generator(device=device).manual_seed(seed)
    if task.startswith("sorting"):
        return env.sample_context(gen, n, num_boxes(task))
    return env.sample_context(gen, n)


RUNNERS = {"avoiding": ex.make_avoiding_runner,
           "pushing": ex.make_pushing_runner,
           "aligning": ex.make_aligning_runner,
           "stacking": ex.make_stacking_runner,
           "inserting": ex.make_inserting_runner}


def make_runner(task, params, chunk_len=ex.CHUNK, generator=None):
    make = ex.make_sorting_runner if task.startswith("sorting") \
        else RUNNERS[task]
    return make(params, chunk_len, generator)


def init_args(task, contexts, extras):
    """The runner's init arguments from the contexts and ``plan``'s
    extras."""
    if task == "avoiding":
        return (extras[0],)
    if task == "pushing":
        return (contexts, extras[1], extras[2])
    return (contexts, extras[0])


def rollout(task, params, contexts, extras, seed=0):
    """The batched expert episodes over the task's horizon: (final env
    state, logs [n, T, ...] NumPy, dones [n, T] NumPy). The exploration
    noise comes from a torch.Generator at seed + 1000 on the params'
    device."""
    gen = torch.Generator(device=params.device).manual_seed(seed + 1000)
    init, chunk = make_runner(task, params, ex.CHUNK, gen)
    carry = init(*init_args(task, contexts, extras))
    carry, logs, dones = ex.run_chunked(chunk, carry, params.max_steps,
                                        ex.CHUNK)
    return carry.env, logs, dones


# ---- the writer -------------------------------------------------------------

def _episode_logs(task, i, L, logs, state, extras):
    """One episode's channels (reference logger schema) and its mode."""
    if task == "stacking":
        des_q, width, fpos, fquat = logs
        log = {"robot": {"des_j_pos": des_q[i, :L],
                         "gripper_width": width[i, :L]}}
        for bi, nm in enumerate(("red-box", "green-box", "blue-box")):
            log[nm] = {"pos": fpos[i, :L, bi], "quat": fquat[i, :L, bi]}
        return log, [int(x) for x in _np(state.mode)[i]]
    des, tcp = logs[:2]
    log = {"robot": {"des_c_pos": des[i, :L], "c_pos": tcp[i, :L]}}
    if task == "avoiding":
        return log, np.asarray(_np(state.mode_encoding)[i], np.int32)
    fpos, fquat = logs[2:]
    if task == "pushing":
        tgt_quat = np.tile([0, 1, 0, 0], (L, 1)).astype(np.float32)
        log.update({
            "red-box": {"pos": fpos[i, :L, 0], "quat": fquat[i, :L, 0]},
            "green-box": {"pos": fpos[i, :L, 1], "quat": fquat[i, :L, 1]},
            "red-target": {"pos": np.tile(scenes.PUSHING_TARGET_1, (L, 1)),
                           "quat": tgt_quat},
            "green-target": {"pos": np.tile(scenes.PUSHING_TARGET_2, (L, 1)),
                             "quat": tgt_quat}})
        return log, int(extras[0][i])
    if task == "aligning":
        log.update({
            "push-box": {"pos": fpos[i, :L], "quat": fquat[i, :L]},
            "target-box": {"pos": np.tile(_np(state.target_pos)[i], (L, 1)),
                           "quat": np.tile(_np(state.target_quat)[i],
                                           (L, 1))}})
        return log, int(extras[0][i])
    if task == "inserting":
        for bi in range(3):
            log[f"box-{bi + 1}"] = {"pos": fpos[i, :L, bi],
                                    "quat": fquat[i, :L, bi]}
        return log, None
    nb = fpos.shape[2]
    names = [f"red-box{j + 1}" for j in range(nb // 2)] + \
            [f"blue-box{j + 1}" for j in range(nb // 2)]
    for bi, nm in enumerate(names):
        log[nm] = {"pos": fpos[i, :L, bi], "quat": fquat[i, :L, bi]}
    return log, None


def episode_modes(task, state):
    """The sorting and inserting episodes' mode codes [n] from the final
    env state (others: None)."""
    if task.startswith("sorting"):
        from d3il_tpu_torch.envs import sorting
        mode = torch.as_tensor(_np(state.mode))
        return _np(sorting.decode_mode(mode, num_boxes(task)))
    if task == "inserting":
        from d3il_tpu_torch.envs import inserting
        return _np(inserting.decode_mode(torch.as_tensor(_np(state.order)),
                                         torch.as_tensor(_np(
                                             state.n_visited))))
    return None


def write(task, out_dir, logs, dones, state, extras, keep_failed=False):
    """Write each successful episode (every episode with ``keep_failed``)
    as env_NNN.pkl under out_dir; returns the file names."""
    succ = _np(state.success)
    codes = episode_modes(task, state)
    files = []
    for i in range(len(succ)):
        if not (succ[i] or keep_failed):
            continue
        log, mode = _episode_logs(task, i, ep_len(dones[i]), logs, state,
                                  extras)
        files.append(write_episode(out_dir, i, log,
                                   int(codes[i]) if codes is not None
                                   else mode))
    return files


def generate(task, n, out_dir, seed=0, kinematic=True, device=None):
    """The whole pipeline for one task: contexts, choices, the batched
    rollout and the writer. Returns (files, info) with the success share,
    the seconds of the rollout and its steps."""
    os.makedirs(out_dir, exist_ok=True)
    params = make_params(task, kinematic, device)
    ctx = sample_contexts(task, n, seed, params.device)
    extras = plan(task, tuple(_np(c) for c in ctx), n, seed)
    t0 = time.time()
    state, logs, dones = rollout(task, params, ctx, extras, seed)
    secs = time.time() - t0
    files = write(task, out_dir, logs, dones, state, extras)
    succ = _np(state.success)
    return files, {"task": task, "n": n, "success": float(succ.mean()),
                   "kept": len(files), "rollout_seconds": secs,
                   "steps": int(dones.shape[1]),
                   "kinematic": bool(params.kinematic)}
