"""LSTM-GMM agent.

Counterpart of ``d3il_tpu/agents/lstm_gmm.py``, batched: a stack of LSTM
cells consumes the observation sequence and a GMM head (means squashed by
2.1 tanh) models the action at each step; training maximizes the
likelihood of the window's last action, inference carries the recurrent
state (c, h per layer) across env steps as the policy carry.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.gmm import gmm_log_prob, gmm_sample
from d3il_tpu_torch.agents.nets.mlp import dense
from d3il_tpu_torch.data.scaler import Scaler


def _orthogonal(n: int, generator: torch.Generator):
    """A random orthogonal [n, n] matrix (QR of a normal one, signs fixed
    by R's diagonal): Flax's recurrent-kernel initialiser."""
    q, r = torch.linalg.qr(torch.randn((n, n), generator=generator,
                                       device=generator.device))
    return q * torch.sign(torch.diagonal(r))


def lstm_cell(in_dim: int, hidden: int,
              generator: torch.Generator) -> nn.LSTMCell:
    """nn.LSTMCell (gates i, f, g, o stacked) initialised as Flax's
    OptimizedLSTMCell: input kernels from Dense's initialiser, recurrent
    kernels orthogonal per gate, the recurrent bias zero. Flax's input
    gates have no bias: ``bias_ih`` is a zero buffer, not a parameter."""
    cell = nn.LSTMCell(in_dim, hidden, device=generator.device)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.cat([dense(in_dim, hidden,
                                              generator).weight
                                        for _ in range(4)]))
        cell.weight_hh.copy_(torch.cat([_orthogonal(hidden, generator).T
                                        for _ in range(4)]))
        cell.bias_hh.zero_()
    del cell.bias_ih
    cell.register_buffer("bias_ih", torch.zeros(4 * hidden,
                                                device=generator.device))
    return cell


class LSTMGMMNet(nn.Module):
    def __init__(self, obs_dim: int, hidden_dim: int = 256,
                 num_layers: int = 2, action_dim: int = 2,
                 n_gaussians: int = 8, min_std: float = 1e-4, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.K, self.D, self.min_std = n_gaussians, action_dim, min_std
        self.cells = nn.ModuleList(
            lstm_cell(obs_dim if i == 0 else hidden_dim, hidden_dim, g)
            for i in range(num_layers))
        self.mid = dense(hidden_dim, hidden_dim, g)
        self.mean_head = dense(hidden_dim, n_gaussians * action_dim, g)
        self.std_head = dense(hidden_dim, n_gaussians * action_dim, g)
        self.logit_head = dense(hidden_dim, n_gaussians, g)

    def zero_state(self, batch: int, device):
        """The LSTM carry: (c, h) [B, H] per layer, zeros."""
        z = torch.zeros((batch, self.hidden_dim), device=device)
        return tuple((z, z) for _ in range(self.num_layers))

    def step(self, state, x):
        """One LSTM tick: x [B, Do] -> (state', features [B, H])."""
        new_state, h = [], x
        for cell, (c, hp) in zip(self.cells, state):
            h, c = cell(h, (hp, c))
            new_state.append((c, h))
        return tuple(new_state), h

    def head(self, h):
        h = F.relu(self.mid(h))
        kd = h.shape[:-1] + (self.K, self.D)
        means = 2.1 * torch.tanh(self.mean_head(h).reshape(kd))
        stds = F.softplus(self.std_head(h)).reshape(kd) + self.min_std
        return means, stds, self.logit_head(h)

    def forward(self, xs):
        """xs [B, W, Do] -> the GMM of the last step."""
        state = self.zero_state(xs.shape[0], xs.device)
        for t in range(xs.shape[1]):
            state, h = self.step(state, xs[:, t])
        return self.head(h)


@dataclass
class LSTMGMMAgent:
    model: LSTMGMMNet
    params: dict
    scaler: Scaler
    window_size: int = 5
    low_noise_eval: bool = True

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               hidden_dim=256, num_layers=2, n_gaussians=8, window_size=5,
               **_):
        model = LSTMGMMNet(obs_dim, hidden_dim, num_layers, action_dim,
                           n_gaussians,
                           generator=generator).to(scaler.x_mean.device)
        return LSTMGMMAgent(model=model, params=base.params_of(model),
                            scaler=scaler, window_size=window_size)

    def loss_fn(self):
        model, scaler = self.model, self.scaler

        def loss(params, obs_w, act_w, generator=None):
            means, stds, logits = functional_call(
                model, params, (scaler.scale_input(obs_w),))
            a = scaler.scale_output(act_w[:, -1])
            return -torch.mean(gmm_log_prob(means, stds, logits, a))

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); the component (standard Gumbel draws [B, K]) and the
        normal draws [B, Da] come from ``generator``, or are ``draws`` =
        (gumbel, eps) when given."""
        model, scaler = self.model, self.scaler
        low_noise = self.low_noise_eval

        def apply(params, carry, obs, draws=None):
            state, h = base.call_method(model, params, "step", carry,
                                        scaler.scale_input(obs))
            means, stds, logits = base.call_method(model, params, "head", h)
            g, eps = draws if draws is not None else (
                None, torch.randn(means.shape[:1] + means.shape[-1:],
                                  generator=generator, device=obs.device))
            comp = base.draw_categorical(logits, generator, g)
            a = gmm_sample(means, stds, comp, eps, low_noise)
            return state, scaler.inverse_scale_output(scaler.clip_action(a))

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return self.model.zero_state(batch, self.scaler.x_mean.device)
