"""GPT-BC agent: causal transformer regression over the obs window.

Counterpart of ``d3il_tpu/agents/gpt_bc.py``, batched: a MinGPT backbone
over the scaled observation window, MSE against every step's scaled action,
the last token's prediction at inference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.bc import init_window, push_window
from d3il_tpu_torch.agents.nets.transformer import GPT
from d3il_tpu_torch.data.scaler import Scaler


@dataclass
class GPTBCAgent:
    model: GPT
    params: dict
    scaler: Scaler
    window_size: int = 5

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               n_embd=120, n_head=4, n_layer=4, window_size=5, **_):
        model = GPT(obs_dim, n_embd, n_head, n_layer, window_size,
                    action_dim, generator=generator).to(scaler.x_mean.device)
        return GPTBCAgent(model=model, params=base.params_of(model),
                          scaler=scaler, window_size=window_size)

    def loss_fn(self):
        model, scaler = self.model, self.scaler

        def loss(params, obs_w, act_w, generator=None):
            pred = functional_call(model, params, (scaler.scale_input(obs_w),))
            return torch.mean((pred - scaler.scale_output(act_w)) ** 2)

        return loss

    def policy_apply(self, generator=None):
        """(params, carry, obs [B, Do]) -> (carry, action [B, Da]); the
        policy is deterministic, so ``generator`` is unused."""
        model, scaler, W = self.model, self.scaler, self.window_size

        def apply(params, carry, obs):
            window, filled = push_window(carry, obs, W)
            pred = functional_call(model, params,
                                   (scaler.scale_input(window),))[:, -1]
            act = scaler.inverse_scale_output(scaler.clip_action(pred))
            return (window, filled), act

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_window(obs_dim, batch, self.window_size,
                           self.scaler.x_mean.device)
