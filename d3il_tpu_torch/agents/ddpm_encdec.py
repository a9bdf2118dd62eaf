"""DDPM encoder-decoder agent: diffusion over action chunks.

Counterpart of ``d3il_tpu/agents/ddpm_encdec.py``, batched: a transformer
of ``Block``s over [obs token, t token, noisy action tokens + learned
positions] predicts the chunk's noise; the diffusion math is the DDPM
agent's (cosine schedule, eps prediction, clipped x0). Inference samples a
new chunk every env step and takes it where the replay buffer is spent,
as the JAX policy does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.act import chunk_step, init_chunk
from d3il_tpu_torch.agents.ddpm import (Schedule, TimeEmbed, diffusion_loss,
                                        reverse_diffusion)
from d3il_tpu_torch.agents.nets.mlp import dense
from d3il_tpu_torch.agents.nets.transformer import Block, normal_param
from d3il_tpu_torch.data.scaler import Scaler


class EncDecDenoiser(nn.Module):
    def __init__(self, obs_dim: int, embed_dim: int = 96, n_heads: int = 4,
                 n_layers: int = 4, chunk: int = 8, action_dim: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.action_dim = action_dim
        self.s_in = dense(obs_dim, embed_dim, g)
        self.t_in = dense(16, embed_dim, g)
        self.temb = TimeEmbed(16, generator=g)
        self.a_in = dense(action_dim, embed_dim, g)
        self.pos = normal_param((1, chunk, embed_dim), 0.02, g)
        self.blocks = nn.ModuleList(Block(embed_dim, n_heads, g)
                                    for _ in range(n_layers))
        self.out = dense(embed_dim, action_dim, g)

    def forward(self, s, a_chunk, t):
        """s [B, Ds], a_chunk [B, C, Da], t [B] -> eps [B, C, Da]."""
        t_tok = self.t_in(self.temb(t.to(torch.float32)))
        h = torch.cat([self.s_in(s)[:, None], t_tok[:, None],
                       self.a_in(a_chunk) + self.pos], dim=1)
        for blk in self.blocks:
            h = blk(h)
        return self.out(h[:, 2:])


@dataclass
class DDPMEncDecAgent:
    model: EncDecDenoiser
    params: dict
    scaler: Scaler
    chunk: int = 8
    n_timesteps: int = 16
    window_size: int = 1

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               chunk=8, embed_dim=96, n_timesteps=16, **_):
        model = EncDecDenoiser(obs_dim, embed_dim, chunk=chunk,
                               action_dim=action_dim,
                               generator=generator).to(scaler.x_mean.device)
        return DDPMEncDecAgent(model=model, params=base.params_of(model),
                               scaler=scaler, chunk=chunk,
                               n_timesteps=n_timesteps)

    @property
    def train_window(self):
        return self.chunk

    def schedule(self) -> Schedule:
        return Schedule(self.n_timesteps, self.scaler.x_mean.device)

    def loss_fn(self):
        model, scaler, T = self.model, self.scaler, self.n_timesteps
        abar = self.schedule().abar

        def loss(params, obs_w, act_w, generator=None, t=None, eps=None):
            """``t`` [B] and ``eps`` [B, C, Da]: the steps and the noise
            (from ``generator`` unless given)."""
            s = scaler.scale_input(obs_w[:, 0])
            a0 = scaler.scale_output(act_w)
            return diffusion_loss(
                lambda a_t, tt: functional_call(model, params, (s, a_t, tt)),
                a0, T, abar, generator, t, eps)

        return loss

    def sample_chunk(self, params, s, generator, noise=None, sched=None):
        """Reverse diffusion of a chunk [B, C, Da] for scaled observations
        s [B, Ds]; ``noise`` [T + 1, B, C, Da] as reverse_diffusion."""
        sched = sched or self.schedule()
        lo, hi = self.scaler.y_bounds[0] * 1.1, self.scaler.y_bounds[1] * 1.1
        B = s.shape[0]

        def denoise(a, t):
            tt = torch.full((B,), t, dtype=torch.int64, device=s.device)
            return functional_call(self.model, params, (s, a, tt))

        return reverse_diffusion(
            denoise, sched, (B, self.chunk, self.model.action_dim), lo, hi,
            generator, noise)

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); ``draws`` [T + 1, B, C, Da]: the chunk's reverse
        diffusion draws (from ``generator`` unless given)."""
        scaler, C = self.scaler, self.chunk
        sched = self.schedule()

        def apply(params, carry, obs, draws=None):
            new = self.sample_chunk(params, scaler.scale_input(obs),
                                    generator, draws, sched)
            carry, a = chunk_step(carry, new, C)
            return carry, scaler.inverse_scale_output(scaler.clip_action(a))

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_chunk(batch, self.chunk, self.model.action_dim,
                          self.scaler.x_mean.device)
