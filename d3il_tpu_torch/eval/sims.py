"""Per-task evaluation harnesses ("sims"), batched on device.

Counterpart of ``d3il_tpu/eval/sims.py``: every (context x trajectory)
episode is one row of a batched rollout running in lockstep on the device,
one Python loop over env steps under ``torch.no_grad()``.

Each Sim exposes ``test_agent(agent) -> dict`` returning the reference's
metrics (success rate, behavioral entropy, composite score) with the same
formulas (eval/metrics.py). Fixed test contexts are the reference's shipped
ones; the fallback samples from seed 2, the seed the reference's context
files were generated with.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from d3il_tpu_torch.eval import contexts as ref_contexts
from d3il_tpu_torch.eval import metrics, rollout

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


def _grid(n_contexts: int, n_trajs: int, seed: int, device):
    """Flattened (context index [C*T], agent generator) grid: the policy's
    noise for all episodes comes from one generator seeded seed + 1."""
    cidx = torch.as_tensor(np.repeat(np.arange(n_contexts), n_trajs),
                           device=device)
    return cidx, torch.Generator(device=device).manual_seed(seed + 1)


@dataclass
class PushingSim:
    """Default workload = the reference benchmark's 30 contexts x 16 trajs,
    on the reference's shipped fixed test contexts."""
    seed: int = 0
    n_contexts: int = 30
    n_trajectories_per_context: int = 16
    use_reference_contexts: bool = True

    def run_episodes(self, agent, params=None, on_step=None):
        """Roll every (context, trajectory) episode to params.max_steps;
        returns (final env state [C*T, ...], dones [max_steps, C*T])."""
        from d3il_tpu_torch.envs import pushing as env
        params = params or pushing_params()
        ctxs = _fixed_or_sampled(ref_contexts.pushing_contexts,
                                 env.sample_context, self.n_contexts,
                                 self.use_reference_contexts, params.device)
        cidx, gen = _grid(self.n_contexts, self.n_trajectories_per_context,
                          self.seed, params.device)
        run = rollout.make_rod_rollout(
            params, env.reset, env.step, env.get_observation,
            agent.policy_apply(gen))
        carry0 = agent.init_carry(10, cidx.shape[0])
        return run(agent.params, carry0, tuple(x[cidx] for x in ctxs),
                   on_step=on_step)

    def score(self, state) -> dict:
        C, T = self.n_contexts, self.n_trajectories_per_context
        return {k: float(v) for k, v in metrics.pushing_score(
            state.success.to(torch.float32).reshape(C, T),
            state.mode.reshape(C, T)).items()}

    def test_agent(self, agent, params=None):
        state, _ = self.run_episodes(agent, params)
        return self.score(state)


def pushing_params(**kw):
    """The task's default params (35 substeps, full arm dynamics)."""
    from d3il_tpu_torch.envs import pushing
    return pushing.PushingParams(**kw)
