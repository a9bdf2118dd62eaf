"""Conditional VAE agent.

Counterpart of ``d3il_tpu/agents/cvae.py``, batched: encoder([s, a]) ->
(mean, std); z = mean + std * eps; decoder([s, z]) -> a_hat. The loss is
the reconstruction MSE + beta x KL; inference draws z ~ N(0, 1), clips it
to +-0.5 and decodes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.bc import init_window, push_window
from d3il_tpu_torch.agents.nets.mlp import ResidualMLP, dense
from d3il_tpu_torch.data.scaler import Scaler


class CVAENet(nn.Module):
    def __init__(self, obs_dim: int, latent_dim: int = 32,
                 hidden_dim: int = 256, num_hidden_layers: int = 4,
                 action_dim: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.latent_dim = latent_dim
        g = generator
        self.enc = ResidualMLP(obs_dim + action_dim, hidden_dim,
                               num_hidden_layers, hidden_dim, generator=g)
        self.mean_head = dense(hidden_dim, latent_dim, g)
        self.logstd_head = dense(hidden_dim, latent_dim, g)
        self.dec = ResidualMLP(obs_dim + latent_dim, hidden_dim,
                               num_hidden_layers, action_dim, generator=g)

    def encode(self, s, a):
        """(mean, std): the second head's output is the std itself, as in
        the reference."""
        h = self.enc(torch.cat([s, a], dim=-1))
        return self.mean_head(h), self.logstd_head(h)

    def decode(self, s, z):
        return self.dec(torch.cat([s, z], dim=-1))

    def forward(self, s, a, eps):
        mean, std = self.encode(s, a)
        return self.decode(s, mean + std * eps), mean, std


@dataclass
class CVAEAgent:
    model: CVAENet
    params: dict
    scaler: Scaler
    beta: float = 1.0
    window_size: int = 1

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               latent_dim=32, hidden_dim=256, num_hidden_layers=4, beta=1.0,
               window_size=1):
        model = CVAENet(obs_dim * window_size, latent_dim, hidden_dim,
                        num_hidden_layers, action_dim,
                        generator=generator).to(scaler.x_mean.device)
        return CVAEAgent(model=model, params=base.params_of(model),
                         scaler=scaler, beta=beta, window_size=window_size)

    def loss_fn(self):
        model, scaler, beta = self.model, self.scaler, self.beta

        def loss(params, obs_w, act_w, generator=None, eps=None):
            """``eps`` [B, latent]: the reparameterisation's normal draws
            (from ``generator`` unless given)."""
            s = scaler.scale_input(obs_w).reshape(obs_w.shape[0], -1)
            a = scaler.scale_output(act_w[:, -1])
            if eps is None:
                eps = torch.randn((s.shape[0], model.latent_dim),
                                  generator=generator, device=s.device)
            a_hat, mean, std = functional_call(model, params, (s, a, eps))
            recon = torch.mean((a_hat - a) ** 2)
            var = std ** 2
            kl = 0.5 * torch.mean(torch.sum(
                mean ** 2 + var - torch.log(var + 1e-8) - 1, dim=-1))
            return recon + beta * kl

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); z's standard-normal draws [B, latent] come from
        ``generator``, or are ``draws`` when given, clipped to +-0.5."""
        model, scaler, W = self.model, self.scaler, self.window_size

        def apply(params, carry, obs, draws=None):
            window, filled = push_window(carry, obs, W)
            x = scaler.scale_input(window).reshape(window.shape[0], -1)
            if draws is None:
                draws = torch.randn((x.shape[0], model.latent_dim),
                                    generator=generator, device=x.device)
            pred = base.call_method(model, params, "decode", x,
                                    draws.clamp(-0.5, 0.5))
            act = scaler.inverse_scale_output(scaler.clip_action(pred))
            return (window, filled), act

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_window(obs_dim, batch, self.window_size,
                           self.scaler.x_mean.device)
