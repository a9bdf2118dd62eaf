"""BC-MLP agent: MSE behavioral cloning.

Counterpart of ``d3il_tpu/agents/bc.py``, batched. Model: ResidualMLP on
the (windowed, flattened) observation; training scales obs/actions with the
dataset Scaler and regresses scaled actions with MSE; inference scales the
obs, runs one forward pass and clamps the scaled action to 1.1x the data
bounds before unscaling.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.nets.mlp import ResidualMLP
from d3il_tpu_torch.data.scaler import Scaler


def push_window(carry, obs, window_size: int):
    """Append obs [B, Do] to the rolling window carry (window [B, W, Do],
    filled [B]). Before the window fills, every row holds the first obs."""
    window, filled = carry
    shifted = torch.cat([window[:, 1:], obs[:, None]], dim=1)
    window = torch.where((filled == 0)[:, None, None],
                         obs[:, None].expand_as(shifted), shifted)
    return window, torch.clamp(filled + 1, max=window_size)


def init_window(obs_dim: int, batch: int, window_size: int, device):
    return (torch.zeros((batch, window_size, obs_dim), dtype=torch.float32,
                        device=device),
            torch.zeros(batch, dtype=torch.int32, device=device))


@dataclass
class BCAgent:
    model: ResidualMLP
    params: dict
    scaler: Scaler
    window_size: int = 1

    @staticmethod
    def create(generator: torch.Generator, obs_dim: int, action_dim: int,
               scaler: Scaler, hidden_dim: int = 256,
               num_hidden_layers: int = 4, window_size: int = 1) -> "BCAgent":
        """The weights are drawn from ``generator``; the agent lives on the
        scaler's device."""
        model = ResidualMLP(obs_dim * window_size, hidden_dim,
                            num_hidden_layers, action_dim,
                            generator=generator).to(scaler.x_mean.device)
        return BCAgent(model=model, params=base.params_of(model),
                       scaler=scaler, window_size=window_size)

    def loss_fn(self):
        model, scaler = self.model, self.scaler

        def loss(params, obs_w, act_w, generator=None):
            # window flattened into features; target = last action in window
            x = scaler.scale_input(obs_w).reshape(obs_w.shape[0], -1)
            y = scaler.scale_output(act_w[:, -1])
            pred = functional_call(model, params, (x,))
            return torch.mean((pred - y) ** 2)

        return loss

    def policy_apply(self, generator=None):
        """(params, carry, obs [B, Do]) -> (carry, action [B, Da]) for the
        rollout harness. The carry is the rolling obs window; the policy is
        deterministic, so ``generator`` is unused."""
        model, scaler, W = self.model, self.scaler, self.window_size

        def apply(params, carry, obs):
            window, filled = push_window(carry, obs, W)
            x = scaler.scale_input(window).reshape(window.shape[0], -1)
            pred = functional_call(model, params, (x,))
            act = scaler.inverse_scale_output(scaler.clip_action(pred))
            return (window, filled), act

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_window(obs_dim, batch, self.window_size,
                           self.scaler.x_mean.device)
