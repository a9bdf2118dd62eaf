"""Task and agent registries: the framework's composition layer.

Counterpart of ``d3il_tpu/registry.py``: every ported task maps to (env
params, dataset assembly, eval sim) and every ported imitation method to a
uniform constructor

    make(generator, obs_dim, act_dim, scaler, **overrides)

returning an agent exposing ``loss_fn() / policy_apply() / init_carry() /
params`` (see d3il_tpu_torch/agents/*). Asking for a task or agent that is
not ported yet raises a KeyError that names what is.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable

from d3il_tpu_torch.data import dataset as ds


@dataclass(frozen=True)
class TaskSpec:
    name: str
    env_module: str                  # d3il_tpu_torch.envs.<...>
    params_name: str                 # Params class in the env module
    assemble: Callable               # episode dict -> (obs, act)
    obs_dim: int                     # agent input dim (incl. des-pos concat)
    act_dim: int
    sim_name: str                    # class in d3il_tpu_torch.eval.sims
    max_steps: int
    params_kw: dict = field(default_factory=dict)   # Params defaults
    # tuned per-task training/eval defaults, applied by
    # run_train_torch.make_args before explicit overrides
    train_kw: dict = field(default_factory=dict)

    def env(self):
        return importlib.import_module(self.env_module)

    def make_params(self, **kw):
        merged = dict(self.params_kw)
        merged.update(kw)
        return getattr(self.env(), self.params_name)(**merged)

    def make_sim(self, **kw):
        from d3il_tpu_torch.eval import sims
        return getattr(sims, self.sim_name)(**kw)


class _Ported(dict):
    """A registry dict whose KeyError names what is ported."""

    def __init__(self, kind, items):
        super().__init__(items)
        self.kind = kind

    def __missing__(self, key):
        raise KeyError(f"{self.kind} {key!r} is not ported to d3il_tpu_torch "
                       f"yet; ported: {sorted(self)}")


TASKS: dict[str, TaskSpec] = _Ported("task", {
    # workload of the reference benchmark scripts: 30 contexts x 16
    # trajectories; the tuned training window stays 1 (see the JAX registry)
    "pushing": TaskSpec(
        "pushing", "d3il_tpu_torch.envs.pushing", "PushingParams",
        ds.assemble_pushing, 10, 2, "PushingSim", 400,
        train_kw={"epochs": 100, "n_contexts": 30, "n_trajs": 16}),
})


@dataclass(frozen=True)
class AgentSpec:
    name: str
    module: str
    cls: str
    ema_decay: float | None = None   # EMA tracking during fit
    defaults: dict = field(default_factory=dict)

    def make(self, generator, obs_dim, act_dim, scaler, **overrides):
        cls = getattr(importlib.import_module(self.module), self.cls)
        kw = dict(self.defaults)
        kw.update(overrides)
        return cls.create(generator, obs_dim, act_dim, scaler, **kw)


AGENTS: dict[str, AgentSpec] = _Ported("agent", {
    "bc": AgentSpec("bc", "d3il_tpu_torch.agents.bc", "BCAgent"),
    "gmm": AgentSpec("gmm", "d3il_tpu_torch.agents.gmm", "GMMAgent"),
})


def make_agent(name: str, generator, obs_dim: int, act_dim: int, scaler,
               **overrides):
    spec = AGENTS[name]
    return spec.make(generator, obs_dim, act_dim, scaler,
                     **overrides), spec.ema_decay
