"""ACT agent: action chunking with a transformer CVAE.

Counterpart of ``d3il_tpu/agents/act.py``, batched: an encoder of ``Block``s
over [state, action chunk] gives z's (mu, logvar); a decoder of ``Block``s
over [state, z, learned query tokens] gives a chunk of actions. Training:
reconstruction MSE + kl_weight x KL; inference decodes with z = 0 and
replays the chunk from a buffer, one decode per ``chunk`` env steps.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.nets.mlp import dense
from d3il_tpu_torch.agents.nets.transformer import Block, normal_param
from d3il_tpu_torch.data.scaler import Scaler


class ACTNet(nn.Module):
    def __init__(self, obs_dim: int, embed_dim: int = 64, n_heads: int = 4,
                 enc_layers: int = 2, dec_layers: int = 4,
                 latent_dim: int = 32, chunk: int = 8, action_dim: int = 2,
                 *, generator: torch.Generator):
        super().__init__()
        self.latent_dim, self.action_dim = latent_dim, action_dim
        g = generator
        self.state_in = dense(obs_dim, embed_dim, g)
        self.act_in = dense(action_dim, embed_dim, g)
        self.enc_blocks = nn.ModuleList(Block(embed_dim, n_heads, g)
                                        for _ in range(enc_layers))
        self.z_head = dense(embed_dim, 2 * latent_dim, g)
        self.z_in = dense(latent_dim, embed_dim, g)
        self.dec_blocks = nn.ModuleList(Block(embed_dim, n_heads, g)
                                        for _ in range(dec_layers))
        self.out = dense(embed_dim, action_dim, g)
        self.query = normal_param((1, chunk, embed_dim), 0.02, g)

    def encode(self, s, chunk):
        """s [B, Ds], chunk [B, C, Da] -> (mu, logvar) [B, latent]."""
        h = torch.cat([self.state_in(s)[:, None], self.act_in(chunk)], dim=1)
        for blk in self.enc_blocks:
            h = blk(h)
        stats = self.z_head(h[:, 0])
        return stats[:, :self.latent_dim], stats[:, self.latent_dim:]

    def decode(self, s, z):
        """s [B, Ds], z [B, latent] -> chunk [B, C, Da]."""
        B = s.shape[0]
        h = torch.cat([self.state_in(s)[:, None], self.z_in(z)[:, None],
                       self.query.expand(B, -1, -1)], dim=1)
        for blk in self.dec_blocks:
            h = blk(h)
        return self.out(h[:, 2:])

    def forward(self, s, chunk, eps):
        """The training pass with z = mu + exp(logvar / 2) eps."""
        mu, logvar = self.encode(s, chunk)
        return self.decode(s, mu + torch.exp(0.5 * logvar) * eps), mu, logvar


def chunk_step(carry, new_chunk, C: int):
    """Replay from the chunk buffer: carry (buf [B, C, Da], k [B]) takes
    ``new_chunk`` where k has reached C; returns (carry', action [B, Da])."""
    buf, k = carry
    need = k >= C
    buf = torch.where(need[:, None, None], new_chunk, buf)
    k = torch.where(need, torch.zeros_like(k), k)
    a = buf[torch.arange(buf.shape[0], device=buf.device), k.long()]
    return (buf, k + 1), a


def init_chunk(batch: int, chunk: int, action_dim: int, device):
    """An empty chunk buffer whose index asks for a decode at once."""
    return (torch.zeros((batch, chunk, action_dim), dtype=torch.float32,
                        device=device),
            torch.full((batch,), chunk, dtype=torch.int32, device=device))


@dataclass
class ACTAgent:
    model: ACTNet
    params: dict
    scaler: Scaler
    chunk: int = 8
    kl_weight: float = 10.0
    window_size: int = 1  # obs conditioning is the current obs

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               chunk=8, embed_dim=64, latent_dim=32, kl_weight=10.0, **_):
        model = ACTNet(obs_dim, embed_dim, latent_dim=latent_dim, chunk=chunk,
                       action_dim=action_dim,
                       generator=generator).to(scaler.x_mean.device)
        return ACTAgent(model=model, params=base.params_of(model),
                        scaler=scaler, chunk=chunk, kl_weight=kl_weight)

    @property
    def train_window(self):
        """Window needed from the dataset sampler: 1 obs + chunk actions."""
        return self.chunk

    def loss_fn(self):
        model, scaler, klw = self.model, self.scaler, self.kl_weight

        def loss(params, obs_w, act_w, generator=None, eps=None):
            """The chunk reconstructed from the window's first obs; ``eps``
            [B, latent] the reparameterisation's normal draws (from
            ``generator`` unless given)."""
            s = scaler.scale_input(obs_w[:, 0])
            chunk = scaler.scale_output(act_w)
            if eps is None:
                eps = torch.randn((s.shape[0], model.latent_dim),
                                  generator=generator, device=s.device)
            pred, mu, logvar = functional_call(model, params, (s, chunk, eps))
            recon = torch.mean((pred - chunk) ** 2)
            kl = -0.5 * torch.mean(torch.sum(
                1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))
            return recon + klw * kl

        return loss

    def policy_apply(self, generator=None):
        """(params, carry, obs [B, Do]) -> (carry, action [B, Da]): a decode
        at z = 0 every step, taken where the buffer is spent (deterministic,
        ``generator`` unused)."""
        model, scaler, C = self.model, self.scaler, self.chunk

        def apply(params, carry, obs):
            s = scaler.scale_input(obs)
            z = s.new_zeros((s.shape[0], model.latent_dim))
            new = base.call_method(model, params, "decode", s, z)
            carry, a = chunk_step(carry, new, C)
            return carry, scaler.inverse_scale_output(scaler.clip_action(a))

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_chunk(batch, self.chunk, self.model.action_dim,
                          self.scaler.x_mean.device)

