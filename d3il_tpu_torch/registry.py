"""Task and agent registries: the framework's composition layer.

Counterpart of ``d3il_tpu/registry.py``: every ported task maps to (env
params, dataset assembly, eval sim) and every ported imitation method to a
uniform constructor

    make(generator, obs_dim, act_dim, scaler, train_actions_scaled,
         **overrides)

returning an agent exposing ``loss_fn() / policy_apply() / init_carry() /
params`` (see d3il_tpu_torch/agents/*). Asking for a task or agent that is
not ported yet raises a KeyError that names what is.
"""
from __future__ import annotations

import functools
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
    # per-(task, agent) constructor overrides, merged over the CLI's agent
    # kwargs and saved in the checkpoint as ``agent_extra``
    agent_kw: dict = field(default_factory=dict)

    def env(self):
        return importlib.import_module(self.env_module)

    def make_params(self, **kw):
        merged = dict(self.params_kw)
        merged.update(kw)
        return getattr(self.env(), self.params_name)(**merged)

    def make_sim(self, **kw):
        """The task's Sim; a scene's box count is its Sim's too."""
        from d3il_tpu_torch.eval import sims
        if "num_boxes" in self.params_kw:
            kw.setdefault("num_boxes", self.params_kw["num_boxes"])
        return getattr(sims, self.sim_name)(**kw)


class _Ported(dict):
    """A registry dict whose KeyError names what is ported."""

    def __init__(self, kind, items):
        super().__init__(items)
        self.kind = kind

    def __missing__(self, key):
        raise KeyError(f"{self.kind} {key!r} is not ported to d3il_tpu_torch "
                       f"yet; ported: {sorted(self)}")


def _sorting(n: int) -> TaskSpec:
    return TaskSpec(
        f"sorting_{n}", "d3il_tpu_torch.envs.sorting", "SortingParams",
        functools.partial(ds.assemble_sorting, n_boxes=n), 4 + 3 * n, 2,
        "SortingSim", 700, params_kw={"num_boxes": n},
        train_kw={"epochs": 100, "n_contexts": 60, "n_trajs": 8})


# Workloads follow the reference benchmark scripts: avoiding 480
# trajectories (one empty context x 480), pushing 30 contexts x 16
# trajectories, aligning and sorting 60 x 8, stacking 60 x 18, inserting
# 30 x 8. The rollout
# form (a planar or, for aligning, an xyz setpoint; stacking's joint
# setpoint) is the task's Sim's (eval/sims.py).
TASKS: dict[str, TaskSpec] = _Ported("task", {
    "avoiding": TaskSpec(
        "avoiding", "d3il_tpu_torch.envs.avoiding", "AvoidingParams",
        ds.assemble_avoiding, 4, 2, "AvoidingSim", 250,
        train_kw={"epochs": 80, "n_contexts": 1, "n_trajs": 480}),
    # the tuned training window stays 1 (see the JAX registry); beso takes
    # the transformer score backbone there, at window 5
    "pushing": TaskSpec(
        "pushing", "d3il_tpu_torch.envs.pushing", "PushingParams",
        ds.assemble_pushing, 10, 2, "PushingSim", 400,
        train_kw={"epochs": 100, "n_contexts": 30, "n_trajs": 16},
        agent_kw={"beso": {"backbone": "gpt", "window_size": 5}}),
    "aligning": TaskSpec(
        "aligning", "d3il_tpu_torch.envs.aligning", "AligningParams",
        ds.assemble_aligning, 20, 3, "AligningSim", 400,
        train_kw={"epochs": 100, "n_contexts": 60, "n_trajs": 8}),
    **{f"sorting_{n}": _sorting(n) for n in (2, 4, 6)},
    "stacking": TaskSpec(
        "stacking", "d3il_tpu_torch.envs.stacking", "StackingParams",
        ds.assemble_stacking, 20, 8, "StackingSim", 1000,
        train_kw={"epochs": 100, "n_contexts": 60, "n_trajs": 18,
                  "window": 5}),
    "inserting": TaskSpec(
        "inserting", "d3il_tpu_torch.envs.inserting", "InsertingParams",
        ds.assemble_inserting, 13, 2, "InsertingSim", 2000,
        train_kw={"epochs": 100, "n_contexts": 30, "n_trajs": 8}),
})


@dataclass(frozen=True)
class AgentSpec:
    name: str
    module: str
    cls: str
    ema_decay: float | None = None   # EMA tracking during fit
    needs_actions: bool = False      # k-means fit over all demo actions
    vision: bool = False             # needs a task render_fn (vision/taskviews)
    defaults: dict = field(default_factory=dict)

    def make(self, generator, obs_dim, act_dim, scaler,
             train_actions_scaled=None, **overrides):
        cls = getattr(importlib.import_module(self.module), self.cls)
        kw = dict(self.defaults)
        kw.update(overrides)
        if self.needs_actions:
            return cls.create(generator, obs_dim, act_dim, scaler,
                              train_actions_scaled, **kw)
        return cls.create(generator, obs_dim, act_dim, scaler, **kw)


AGENTS: dict[str, AgentSpec] = _Ported("agent", {
    "bc": AgentSpec("bc", "d3il_tpu_torch.agents.bc", "BCAgent"),
    "cvae": AgentSpec("cvae", "d3il_tpu_torch.agents.cvae", "CVAEAgent"),
    "gmm": AgentSpec("gmm", "d3il_tpu_torch.agents.gmm", "GMMAgent"),
    "lstm_gmm": AgentSpec("lstm_gmm", "d3il_tpu_torch.agents.lstm_gmm",
                          "LSTMGMMAgent"),
    "ibc": AgentSpec("ibc", "d3il_tpu_torch.agents.ibc", "IBCAgent"),
    "gpt_bc": AgentSpec("gpt_bc", "d3il_tpu_torch.agents.gpt_bc",
                        "GPTBCAgent"),
    "bet": AgentSpec("bet", "d3il_tpu_torch.agents.bet", "BeTAgent",
                     needs_actions=True, defaults={"use_gpt": True}),
    "bet_mlp": AgentSpec("bet_mlp", "d3il_tpu_torch.agents.bet", "BeTAgent",
                         needs_actions=True, defaults={"use_gpt": False}),
    "act": AgentSpec("act", "d3il_tpu_torch.agents.act", "ACTAgent"),
    "ddpm": AgentSpec("ddpm", "d3il_tpu_torch.agents.ddpm", "DDPMAgent",
                      ema_decay=0.995),
    "ddpm_encdec": AgentSpec("ddpm_encdec",
                             "d3il_tpu_torch.agents.ddpm_encdec",
                             "DDPMEncDecAgent", ema_decay=0.995),
    "beso": AgentSpec("beso", "d3il_tpu_torch.agents.beso", "BesoAgent",
                      ema_decay=0.995),
    # vision variants: the shared MultiImageObsEncoder + method heads,
    # rendering on the device from the state observations (agents/vision.py)
    **{name: AgentSpec(name, "d3il_tpu_torch.agents.vision", cls, vision=True,
                       **kw)
       for name, cls, kw in (
           ("bc_vision", "VisionBCAgent", {}),
           ("ddpm_vision", "VisionDDPMAgent", {"ema_decay": 0.995}),
           ("bet_mlp_vision", "VisionBeTAgent", {"needs_actions": True}),
           ("gmm_vision", "VisionGMMAgent", {}),
           ("cvae_vision", "VisionCVAEAgent", {}),
           ("beso_vision", "VisionBesoAgent", {"ema_decay": 0.995}),
           ("act_vision", "VisionACTAgent", {}),
           ("gpt_bc_vision", "VisionGPTBCAgent", {}),
           ("ibc_vision", "VisionIBCAgent", {}),
           ("ddpm_encdec_vision", "VisionDDPMEncDecAgent",
            {"ema_decay": 0.995}))},
})


def make_agent(name: str, generator, obs_dim: int, act_dim: int, scaler,
               train_actions_scaled=None, **overrides):
    """(agent, ema_decay); ``train_actions_scaled`` [N, Da] (NumPy or a
    tensor) feeds the agents whose spec ``needs_actions`` (BeT's bins)."""
    spec = AGENTS[name]
    return spec.make(generator, obs_dim, act_dim, scaler,
                     train_actions_scaled, **overrides), spec.ema_decay
