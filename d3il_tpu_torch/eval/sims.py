"""Per-task evaluation harnesses ("sims"), batched on device.

Counterpart of ``d3il_tpu/eval/sims.py``: every (context x trajectory)
episode is one row of a batched rollout running in lockstep on the device,
one Python loop over env steps under ``torch.no_grad()``. Under a process
group of more than one process (or with a ``mesh``) each rank rolls out
its own rows of the grid and every rank scores the whole grid
(``parallel/mesh.run_sharded``).

Each Sim exposes ``test_agent(agent) -> dict`` returning the reference's
metrics (success rate, behavioral entropy, KL, composite score) with the
same formulas (eval/metrics.py). Fixed test contexts are the reference's shipped
ones; the fallback samples from seed 2, the seed the reference's context
files were generated with.
"""
from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from d3il_tpu_torch.eval import contexts as ref_contexts
from d3il_tpu_torch.eval import metrics, rollout
from d3il_tpu_torch.parallel import mesh as pmesh

CONTEXT_SEED = 2


def _fixed_or_sampled(loader, sample_fn, n: int, use_fixed: bool, device):
    """Evaluation context set as a tuple of tensors [n, ...]: the
    reference's shipped fixed contexts when available (tiled if more are
    asked for), else freshly sampled from seed 2."""
    if use_fixed:
        fixed = loader()
        if fixed is not None:
            m = fixed[0].shape[0]
            reps = -(-n // m)  # ceil: tile if more contexts requested
            return tuple(torch.as_tensor(np.concatenate([x] * reps)[:n],
                                         device=device) for x in fixed)
    gen = torch.Generator(device=device).manual_seed(CONTEXT_SEED)
    return sample_fn(gen, n)


def _grid(n_contexts: int, n_trajs: int, device):
    """The flattened grid's context index of every episode [C*T]."""
    return torch.as_tensor(np.repeat(np.arange(n_contexts), n_trajs),
                           device=device)


def policy_generator(seed: int, device, mesh=None):
    """The generator of the policy's noise in a Sim seeded ``seed``: one
    generator for all of a rank's episodes, seeded seed + 1 (on rank 0 of
    a ``mesh``; ``pmesh.rank_generator``)."""
    return pmesh.rank_generator(mesh, seed + 1, device)


class _TaskSim:
    """What the tasks' Sims share: every (context, trajectory) episode of
    the grid rolled out in lockstep through ``make_rollout`` (the
    Cartesian-delta rollout, ``rollout.make_rod_rollout``, unless a Sim
    names another). A task's Sim names its env module, its default params,
    its context set, the policy's input width and the rollout form
    (``pos_dim``)."""

    pos_dim = 2

    def env(self):
        raise NotImplementedError

    def default_params(self):
        raise NotImplementedError

    def contexts(self, params) -> tuple:
        raise NotImplementedError

    def obs_dim(self) -> int:
        raise NotImplementedError

    def make_rollout(self, params, env, policy_apply):
        return rollout.make_rod_rollout(
            params, env.reset, env.step, env.get_observation, policy_apply,
            pos_dim=self.pos_dim)

    def run_episodes(self, agent, params=None, on_step=None, mesh=None):
        """Roll every (context, trajectory) episode to params.max_steps;
        returns (final env state [C*T, ...], dones [max_steps, C*T]).

        The policy's noise comes from ``policy_generator``. Over a ``mesh``
        (by default a process group of more than one process) each rank
        rolls out its block of the grid, padded to a multiple of the world
        size, with a generator of its own, and the final states and dones
        are gathered and cut back to the grid on every rank; ``on_step``
        sees this rank's carry."""
        env = self.env()
        params = params or self.default_params()
        ctxs = self.contexts(params)
        cidx = _grid(self.n_contexts, self.n_trajectories_per_context,
                     params.device)
        mesh = mesh if mesh is not None else pmesh.default_mesh()

        def episodes(rows):
            gen = policy_generator(self.seed, params.device, mesh)
            run = self.make_rollout(params, env, agent.policy_apply(gen))
            carry0 = agent.init_carry(self.obs_dim(), rows.shape[0])
            state, dones = run(agent.params, carry0,
                               tuple(x[rows] for x in ctxs), on_step=on_step)
            return state, dones.T

        state, dones = pmesh.run_sharded(episodes, cidx, mesh=mesh)
        return state, dones.T

    def test_agent(self, agent, params=None):
        state, _ = self.run_episodes(agent, params)
        return self.score(state)


@dataclass
class AvoidingSim(_TaskSim):
    """No contexts: the grid repeats one empty context, so all
    n_contexts x n_trajectories_per_context episodes start alike. Default
    workload = the reference benchmark's 480 trajectories (1 x 480); the
    entropy pools every successful episode's gate encoding (base 24)."""
    seed: int = 0
    n_contexts: int = 1
    n_trajectories_per_context: int = 480

    def env(self):
        from d3il_tpu_torch.envs import avoiding
        return avoiding

    def default_params(self):
        return avoiding_params()

    def contexts(self, params):
        return self.env().empty_context(1, params.device)

    def obs_dim(self):
        return 4        # des xy + tcp xy

    def score(self, state) -> dict:
        return {k: float(v) for k, v in metrics.avoiding_score(
            state.success.to(torch.float32), state.mode_encoding).items()}


@dataclass
class PushingSim(_TaskSim):
    """Default workload = the reference benchmark's 30 contexts x 16 trajs,
    on the reference's shipped fixed test contexts."""
    seed: int = 0
    n_contexts: int = 30
    n_trajectories_per_context: int = 16
    use_reference_contexts: bool = True

    def env(self):
        from d3il_tpu_torch.envs import pushing
        return pushing

    def default_params(self):
        return pushing_params()

    def contexts(self, params):
        return _fixed_or_sampled(ref_contexts.pushing_contexts,
                                 self.env().sample_context, self.n_contexts,
                                 self.use_reference_contexts, params.device)

    def obs_dim(self):
        return 10       # des xy + robot xy + 2 x (box xy, tan yaw)

    def score(self, state) -> dict:
        C, T = self.n_contexts, self.n_trajectories_per_context
        return {k: float(v) for k, v in metrics.pushing_score(
            state.success.to(torch.float32).reshape(C, T),
            state.mode.reshape(C, T)).items()}


@dataclass
class AligningSim(_TaskSim):
    """Default workload = 60 contexts x 8 trajs on the reference's shipped
    fixed contexts; the policy moves the setpoint in xyz."""
    seed: int = 0
    n_contexts: int = 60
    n_trajectories_per_context: int = 8

    pos_dim = 3

    def env(self):
        from d3il_tpu_torch.envs import aligning
        return aligning

    def default_params(self):
        return aligning_params()

    def contexts(self, params):
        return _fixed_or_sampled(ref_contexts.aligning_contexts,
                                 self.env().sample_context, self.n_contexts,
                                 True, params.device)

    def obs_dim(self):
        return 20       # des xyz + the 17-dim observation

    def score(self, state) -> dict:
        env = self.env()
        pos_d = torch.linalg.vector_norm(
            state.scene.free_pos[:, 0] - state.target_pos, dim=-1)
        rot_d = env.rotation_distance(state.scene.free_quat[:, 0],
                                      state.target_quat) / math.pi
        C, T = self.n_contexts, self.n_trajectories_per_context
        return {k: float(v) for k, v in metrics.aligning_score(
            state.success.to(torch.float32).reshape(C, T),
            state.mode.reshape(C, T),
            (0.5 * (pos_d + rot_d)).reshape(C, T)).items()}


@dataclass
class InsertingSim(_TaskSim):
    """Mode = the order in which the boxes first reach their targets
    (the reference's ids 1..6); scored by the pushing convention over the 6
    orders. Default workload = 30 contexts x 8 trajs at a horizon of 400
    steps, sampled from seed 2 (no context file is shipped for
    inserting)."""
    seed: int = 0
    n_contexts: int = 30
    n_trajectories_per_context: int = 8

    def env(self):
        from d3il_tpu_torch.envs import inserting
        return inserting

    def default_params(self):
        return inserting_params(max_steps=400)

    def contexts(self, params):
        gen = torch.Generator(device=params.device).manual_seed(CONTEXT_SEED)
        return self.env().sample_context(gen, self.n_contexts)

    def obs_dim(self):
        return 13       # des xy + robot xy + 3 x (box xy, tan yaw)

    def score(self, state) -> dict:
        modes = self.env().decode_mode(state.order, state.n_visited)
        C, T = self.n_contexts, self.n_trajectories_per_context
        return {k: float(v) for k, v in metrics.inserting_score(
            state.success.to(torch.float32).reshape(C, T),
            modes.reshape(C, T)).items()}


@dataclass
class SortingSim(_TaskSim):
    """Mode = bit-packed color order; score SR - KL against the demo mode
    prior (the generated demos' mode histogram when the task's data
    directory exists, else uniform over the balanced color orders).
    Default workload = 60 contexts x 8 trajs, sampled from seed 2 (no
    context file is shipped for sorting)."""
    seed: int = 0
    num_boxes: int = 2
    n_contexts: int = 60
    n_trajectories_per_context: int = 8

    def env(self):
        from d3il_tpu_torch.envs import sorting
        return sorting

    def default_params(self):
        return sorting_params(self.num_boxes)

    def contexts(self, params):
        gen = torch.Generator(device=params.device).manual_seed(CONTEXT_SEED)
        return self.env().sample_context(gen, self.n_contexts, self.num_boxes)

    def obs_dim(self):
        return 4 + 3 * self.num_boxes  # des xy + robot xy + per box xy, yaw

    def mode_prior(self):
        """(mode_keys, prior): the demos' mode histogram of the task's data
        directory beside the reference contexts, else uniform."""
        task_dir = os.path.join(os.path.dirname(ref_contexts.REF_DIR),
                                f"sorting_{self.num_boxes}")
        demo = (ref_contexts.mode_prior_from_demos(task_dir)
                if os.path.isdir(task_dir) else None)
        return demo if demo is not None \
            else sorting_uniform_prior(self.num_boxes)

    def score(self, state, mode_keys=None, prior=None) -> dict:
        if mode_keys is None:
            mode_keys, prior = self.mode_prior()
        modes = self.env().decode_mode(state.mode, self.num_boxes)
        C, T = self.n_contexts, self.n_trajectories_per_context
        return {k: float(v) for k, v in metrics.sorting_score(
            state.success.to(torch.float32).reshape(C, T),
            modes.reshape(C, T), mode_keys, prior).items()}

    def test_agent(self, agent, params=None, mode_keys=None, prior=None):
        state, _ = self.run_episodes(agent, params)
        return self.score(state, mode_keys, prior)


@dataclass
class StackingSim(_TaskSim):
    """Default workload = 60 contexts x 18 trajs on the reference's shipped
    fixed contexts, at a horizon of 400 steps; joint-space rollout. KL is
    scored against the shipped demo mode priors (``stacking_mode_prob.pkl``),
    uniform where that file is missing."""
    seed: int = 0
    n_contexts: int = 60
    n_trajectories_per_context: int = 18

    def env(self):
        from d3il_tpu_torch.envs import stacking
        return stacking

    def default_params(self):
        return stacking_params(max_steps=400)

    def contexts(self, params):
        return _fixed_or_sampled(ref_contexts.stacking_contexts,
                                 self.env().sample_context, self.n_contexts,
                                 True, params.device)

    def obs_dim(self):
        return 20       # previous action (7 joints + width) + 12-dim obs

    def make_rollout(self, params, env, policy_apply):
        return rollout.make_joint_rollout(
            params, env.reset, env.step, env.get_observation, env.robot_state,
            policy_apply)

    def score(self, state) -> dict:
        priors = ref_contexts.stacking_mode_priors()
        if priors is None:
            priors = (np.full(3, 1 / 3), np.full(6, 1 / 6), np.full(6, 1 / 6))
        C, T = self.n_contexts, self.n_trajectories_per_context
        f32 = lambda x: x.to(torch.float32).reshape(C, T)
        return {k: float(v) for k, v in metrics.stacking_score(
            state.mode.reshape(C, T, 3), state.mode_len.reshape(C, T),
            f32(state.success), f32(state.mode_len > 0),
            f32(state.mode_len > 1), *priors).items()}


def sorting_uniform_prior(num_boxes: int):
    """All bit-packed encodings of balanced red/blue orders, uniform prior."""
    half = num_boxes // 2
    keys = sorted({
        sum(b << (7 - i) for i, b in enumerate(bits))
        for bits in itertools.permutations([0] * half + [1] * half)})
    keys = np.asarray(keys, np.int32)
    return keys, np.full(len(keys), 1.0 / len(keys), np.float32)


def avoiding_params(**kw):
    """The task's default params (35 substeps, 15 solver iterations)."""
    from d3il_tpu_torch.envs import avoiding
    return avoiding.AvoidingParams(**kw)


def pushing_params(**kw):
    """The task's default params (35 substeps, full arm dynamics)."""
    from d3il_tpu_torch.envs import pushing
    return pushing.PushingParams(**kw)


def aligning_params(**kw):
    """The task's default params (35 substeps, 30 solver iterations)."""
    from d3il_tpu_torch.envs import aligning
    return aligning.AligningParams(**kw)


def inserting_params(**kw):
    """The task's default params (35 substeps, 25 solver iterations)."""
    from d3il_tpu_torch.envs import inserting
    return inserting.InsertingParams(**kw)


def sorting_params(num_boxes: int, **kw):
    """The task's default params (35 substeps, 25 solver iterations)."""
    from d3il_tpu_torch.envs import sorting
    return sorting.SortingParams(num_boxes, **kw)


def stacking_params(**kw):
    """The task's default params (30 substeps, 40 solver iterations)."""
    from d3il_tpu_torch.envs import stacking
    return stacking.StackingParams(**kw)
