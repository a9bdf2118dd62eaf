"""Implicit BC (IBC): an energy-based model with the InfoNCE loss and two
samplers.

Counterpart of ``d3il_tpu/agents/ibc.py``, batched: the EBM is a
ResidualMLP over [s, a]; training contrasts each demo action with uniform
negatives inside 1.1x the action bounds; inference minimises the energy
per env with the derivative-free optimizer (sample, softmax-resample,
shrink the noise) or with Langevin MCMC, every env's samples in one batch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.bc import init_window, push_window
from d3il_tpu_torch.agents.nets.mlp import ResidualMLP
from d3il_tpu_torch.data.scaler import Scaler


class EBM(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int, hidden_dim: int = 256,
                 num_hidden_layers: int = 4, *, generator: torch.Generator):
        super().__init__()
        self.mlp = ResidualMLP(obs_dim + action_dim, hidden_dim,
                               num_hidden_layers, 1, generator=generator)

    def forward(self, s, a):
        return self.mlp(torch.cat([s, a], dim=-1))[..., 0]


def _uniform(shape, generator, u, lo, hi):
    """Uniform samples in [lo, hi) from the draws ``u`` in [0, 1) (from
    ``generator`` unless given)."""
    if u is None:
        u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def _energy(model, params, s, a):
    """E(s, a) for every sample: s [B, Ds], a [B, N, Da] -> [B, N]."""
    s_rep = s[:, None].expand(-1, a.shape[1], -1)
    return functional_call(model, params, (s_rep, a))


def _best(model, params, s, a):
    """The lowest-energy sample of each env: [B, Da]."""
    i = torch.argmin(_energy(model, params, s, a), dim=1)
    return a[torch.arange(a.shape[0], device=a.device), i]


def dfo_sample(model, params, s, generator, n_samples, action_dim, bounds,
               n_iters=3, sigma=0.033, shrink=0.5, draws=None):
    """Derivative-free optimizer for each env of s [B, Ds]: n_samples
    uniform actions, then n_iters rounds of a softmax(-E) resample plus
    normal noise of a shrinking sigma, clipped to the bounds; the lowest
    energy sample. ``draws`` = (uniform [B, N, Da], Gumbel [n_iters, B, N,
    N] for the resample indices, normal [n_iters, B, N, Da]) replaces the
    generator's."""
    lo, hi = bounds
    B, N = s.shape[0], n_samples
    u0, gumbels, normals = draws if draws is not None else (None,) * 3
    a = _uniform((B, N, action_dim), generator, u0, lo, hi)
    rows = torch.arange(B, device=s.device)[:, None]
    sig = sigma
    for i in range(n_iters):
        logp = torch.log(torch.softmax(-_energy(model, params, s, a), dim=1)
                         + 1e-12)
        g = None if gumbels is None else gumbels[i]
        idx = base.draw_categorical(logp[:, None, :].expand(B, N, N),
                                    generator, g)
        eps = normals[i] if normals is not None else torch.randn(
            a.shape, generator=generator, device=a.device)
        a = torch.clamp(a[rows, idx] + sig * eps, lo, hi)
        sig = sig * shrink
    return _best(model, params, s, a)


def langevin_sample(model, params, s, generator, n_samples, action_dim,
                    bounds, n_iters=20, step_init=0.5, step_decay=0.8,
                    noise_scale=0.5, draws=None):
    """Langevin MCMC toward low energy for each env of s [B, Ds]: n_samples
    uniform actions moved n_iters times down the energy's gradient plus
    noise, the step decaying geometrically, clipped to the bounds; the
    lowest energy sample. ``draws`` = (uniform [B, N, Da], normal
    [n_iters, B, N, Da]) replaces the generator's."""
    lo, hi = bounds
    u0, normals = draws if draws is not None else (None, None)
    a = _uniform((s.shape[0], n_samples, action_dim), generator, u0, lo, hi)
    step = step_init
    for i in range(n_iters):
        with torch.enable_grad():
            ag = a.detach().requires_grad_(True)
            grad, = torch.autograd.grad(
                _energy(model, params, s, ag).sum(), ag)
        noise = normals[i] if normals is not None else torch.randn(
            a.shape, generator=generator, device=a.device)
        a = torch.clamp(a - step * grad
                        + noise_scale * math.sqrt(2 * step) * noise * step,
                        lo, hi)
        step = step * step_decay
    return _best(model, params, s, a)


@dataclass
class IBCAgent:
    model: EBM
    params: dict
    scaler: Scaler
    n_negatives: int = 8
    n_infer_samples: int = 64
    sampler: str = "dfo"   # "dfo" | "langevin"
    window_size: int = 1

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               hidden_dim=256, num_hidden_layers=4, window_size=1,
               sampler="dfo", **_):
        model = EBM(obs_dim * window_size, action_dim, hidden_dim,
                    num_hidden_layers,
                    generator=generator).to(scaler.x_mean.device)
        return IBCAgent(model=model, params=base.params_of(model),
                        scaler=scaler, window_size=window_size,
                        sampler=sampler)

    def _bounds(self):
        return (self.scaler.y_bounds[0] * 1.1, self.scaler.y_bounds[1] * 1.1)

    def loss_fn(self):
        model, scaler, K = self.model, self.scaler, self.n_negatives
        lo, hi = self._bounds()

        def loss(params, obs_w, act_w, generator=None, neg=None):
            """InfoNCE: the demo action should have the lowest energy of
            it and K negatives; ``neg`` [B, K, Da] the negatives' uniform
            draws (from ``generator`` unless given)."""
            B = obs_w.shape[0]
            s = scaler.scale_input(obs_w).reshape(B, -1)
            a_pos = scaler.scale_output(act_w[:, -1])
            if neg is None:
                neg = torch.rand((B, K, a_pos.shape[-1]), generator=generator,
                                 device=s.device)
            a_all = torch.cat([a_pos[:, None], neg * (hi - lo) + lo], dim=1)
            e = _energy(model, params, s, a_all)               # [B, K+1]
            return -torch.mean(torch.log_softmax(-e, dim=1)[:, 0])

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]) by the agent's sampler; ``draws`` as the sampler takes
        them."""
        model, scaler, W = self.model, self.scaler, self.window_size
        N, bounds = self.n_infer_samples, self._bounds()
        fn = langevin_sample if self.sampler == "langevin" else dfo_sample
        Da = scaler.y_mean.shape[-1]

        def apply(params, carry, obs, draws=None):
            window, filled = push_window(carry, obs, W)
            s = scaler.scale_input(window).reshape(window.shape[0], -1)
            a = fn(model, params, s, generator, N, Da, bounds, draws=draws)
            act = scaler.inverse_scale_output(scaler.clip_action(a))
            return (window, filled), act

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_window(obs_dim, batch, self.window_size,
                           self.scaler.x_mean.device)
