"""BC-GMM agent.

Counterpart of ``d3il_tpu/agents/gmm.py``, batched. ResidualMLP trunk ->
(means, stds, logits) heads for an n-component Gaussian mixture over
actions; trained with NLL, sampled at inference (component by logits, then
Gaussian; low_noise_eval scales the stds by 1e-4).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.bc import init_window, push_window
from d3il_tpu_torch.agents.nets.mlp import ResidualMLP, dense, mish
from d3il_tpu_torch.data.scaler import Scaler


class GMMNet(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 num_hidden_layers: int = 4, action_dim: int = 2,
                 n_gaussians: int = 8, min_std: float = 1e-4, *,
                 generator: torch.Generator):
        super().__init__()
        self.K, self.D, self.min_std = n_gaussians, action_dim, min_std
        self.trunk = ResidualMLP(input_dim, hidden_dim, num_hidden_layers,
                                 hidden_dim, generator=generator)
        self.means = dense(hidden_dim, n_gaussians * action_dim, generator)
        self.stds = dense(hidden_dim, n_gaussians * action_dim, generator)
        self.logits = dense(hidden_dim, n_gaussians, generator)

    def forward(self, x):
        h = mish(self.trunk(x))
        kd = x.shape[:-1] + (self.K, self.D)
        means = self.means(h).reshape(kd)
        stds = F.softplus(self.stds(h)).reshape(kd) + self.min_std
        return means, stds, self.logits(h)


def gmm_log_prob(means, stds, logits, a):
    """log p(a) under the mixture; a broadcast against [.., K, D]."""
    log_w = F.log_softmax(logits, dim=-1)
    z = (a[..., None, :] - means) / stds
    comp = -0.5 * torch.sum(z ** 2 + math.log(2 * math.pi)
                            + 2 * torch.log(stds), dim=-1)
    return torch.logsumexp(log_w + comp, dim=-1)


def draw_normal(shape, generator: torch.Generator):
    return torch.randn(shape, generator=generator, device=generator.device)


def gmm_sample(means, stds, comp, eps, low_noise: bool):
    """The mixture sample given the component index comp [B] and the
    standard-normal draw eps [B, D]."""
    pick = comp[:, None, None].expand(-1, 1, means.shape[-1])
    mean = torch.gather(means, 1, pick)[:, 0]
    std = (1e-4 if low_noise else 1.0) * torch.gather(stds, 1, pick)[:, 0]
    return mean + std * eps


@dataclass
class GMMAgent:
    model: GMMNet
    params: dict
    scaler: Scaler
    window_size: int = 1
    low_noise_eval: bool = True

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               hidden_dim=256, num_hidden_layers=4, n_gaussians=8,
               window_size=1, low_noise_eval=True):
        model = GMMNet(obs_dim * window_size, hidden_dim, num_hidden_layers,
                       action_dim, n_gaussians,
                       generator=generator).to(scaler.x_mean.device)
        return GMMAgent(model=model, params=base.params_of(model),
                        scaler=scaler, window_size=window_size,
                        low_noise_eval=low_noise_eval)

    def loss_fn(self):
        model, scaler = self.model, self.scaler

        def loss(params, obs_w, act_w, generator=None):
            x = scaler.scale_input(obs_w).reshape(obs_w.shape[0], -1)
            a = scaler.scale_output(act_w[:, -1])
            means, stds, logits = functional_call(model, params, (x,))
            return -torch.mean(gmm_log_prob(means, stds, logits, a))

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do]) -> (carry, action [B, Da]); the
        component and the Gaussian noise are drawn from ``generator``."""
        model, scaler, W = self.model, self.scaler, self.window_size
        low_noise = self.low_noise_eval

        def apply(params, carry, obs):
            window, filled = push_window(carry, obs, W)
            x = scaler.scale_input(window).reshape(window.shape[0], -1)
            means, stds, logits = functional_call(model, params, (x,))
            comp = base.draw_categorical(logits, generator)
            eps = draw_normal(means.shape[:1] + means.shape[-1:], generator)
            a = gmm_sample(means, stds, comp, eps, low_noise)
            act = scaler.inverse_scale_output(scaler.clip_action(a))
            return (window, filled), act

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_window(obs_dim, batch, self.window_size,
                           self.scaler.x_mean.device)
