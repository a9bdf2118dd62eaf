"""Behavior Transformer (BeT) agents: k-means action bins, a focal loss over
the bins and per-bin offsets.

Counterpart of ``d3il_tpu/agents/bet.py``, batched: ``bet`` on the GPT
backbone over the observation window, ``bet_mlp`` on a ResidualMLP over the
flattened window. The bins are a k-means fit over all scaled training
actions (NumPy, at creation); the loss is the focal classification loss
(gamma 2) plus the MSE of the target bin's offset; inference draws a bin
from the logits and adds its offset to its center.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.bc import init_window, push_window
from d3il_tpu_torch.agents.nets.mlp import ResidualMLP, dense, mish
from d3il_tpu_torch.agents.nets.transformer import GPT
from d3il_tpu_torch.data.scaler import Scaler


def kmeans_fit(actions: np.ndarray, n_bins: int = 64, iters: int = 50,
               seed: int = 0) -> np.ndarray:
    """K-means over (scaled) actions, Lloyd's iterations from ``n_bins``
    distinct actions drawn with NumPy's generator of ``seed``."""
    rng = np.random.default_rng(seed)
    centers = actions[rng.choice(len(actions), n_bins, replace=False)].copy()
    for _ in range(iters):
        d = ((actions[:, None] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for k in range(n_bins):
            m = assign == k
            if m.any():
                centers[k] = actions[m].mean(0)
    return centers


def focal_loss(logits, targets, gamma: float = 2.0):
    """Cross-entropy of ``targets`` scaled by (1 - p_target)^gamma."""
    lp_t = torch.gather(F.log_softmax(logits, dim=-1), -1,
                        targets[..., None])[..., 0]
    return -((1 - torch.exp(lp_t)) ** gamma) * lp_t


class BeTMLPHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 num_hidden_layers: int = 4, n_bins: int = 64,
                 action_dim: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.n_bins, self.action_dim = n_bins, action_dim
        self.trunk = ResidualMLP(input_dim, hidden_dim, num_hidden_layers,
                                 hidden_dim, generator=generator)
        self.logits = dense(hidden_dim, n_bins, generator)
        self.offsets = dense(hidden_dim, n_bins * action_dim, generator)

    def forward(self, x):
        h = mish(self.trunk(x))
        return self.logits(h), self.offsets(h).reshape(
            x.shape[:-1] + (self.n_bins, self.action_dim))


class BeTGPTHead(nn.Module):
    def __init__(self, input_dim: int, n_embd: int = 120, n_head: int = 4,
                 n_layer: int = 4, block_size: int = 10, n_bins: int = 64,
                 action_dim: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.n_bins, self.action_dim = n_bins, action_dim
        self.gpt = GPT(input_dim, n_embd, n_head, n_layer, block_size,
                       n_bins * (1 + action_dim), generator=generator)

    def forward(self, x):
        out = self.gpt(x)
        return out[..., :self.n_bins], out[..., self.n_bins:].reshape(
            x.shape[:-1] + (self.n_bins, self.action_dim))


@dataclass
class BeTAgent:
    model: nn.Module
    params: dict
    scaler: Scaler
    centers: torch.Tensor       # [n_bins, Da] in scaled action space
    window_size: int = 1
    use_gpt: bool = False
    focal_gamma: float = 2.0
    offset_scale: float = 1.0

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               train_actions_scaled, hidden_dim=256, num_hidden_layers=4,
               n_bins=64, window_size=1, use_gpt=False, n_embd=120, n_head=4,
               n_layer=4, **_):
        dev = scaler.x_mean.device
        acts = np.asarray(torch.as_tensor(train_actions_scaled).cpu())
        centers = torch.as_tensor(kmeans_fit(acts, n_bins),
                                  dtype=torch.float32, device=dev)
        if use_gpt:
            model = BeTGPTHead(obs_dim, n_embd, n_head, n_layer, window_size,
                               n_bins, action_dim, generator=generator)
        else:
            model = BeTMLPHead(obs_dim * window_size, hidden_dim,
                               num_hidden_layers, n_bins, action_dim,
                               generator=generator)
        model = model.to(dev)
        return BeTAgent(model=model, params=base.params_of(model),
                        scaler=scaler, centers=centers,
                        window_size=window_size, use_gpt=use_gpt)

    def _heads(self, params, window):
        """(logits, offsets) of the last step of the scaled window
        [B, W, Do] (the GPT's last token, or the MLP on the flat window)."""
        w = self.scaler.scale_input(window)
        if self.use_gpt:
            logits, offsets = functional_call(self.model, params, (w,))
            return logits[:, -1], offsets[:, -1]
        return functional_call(self.model, params,
                               (w.reshape(w.shape[0], -1),))

    def loss_fn(self):
        model, scaler, centers = self.model, self.scaler, self.centers
        gamma, oscale, use_gpt = (self.focal_gamma, self.offset_scale,
                                  self.use_gpt)

        def loss(params, obs_w, act_w, generator=None):
            if use_gpt:
                x = scaler.scale_input(obs_w)
                y = scaler.scale_output(act_w)            # [B, W, Da]
            else:
                x = scaler.scale_input(obs_w).reshape(obs_w.shape[0], -1)
                y = scaler.scale_output(act_w[:, -1])
            logits, offsets = functional_call(model, params, (x,))
            bins = ((y[..., None, :] - centers) ** 2).sum(-1).argmin(-1)
            cls = focal_loss(logits, bins, gamma).mean()
            pick = bins[..., None, None].expand(
                bins.shape + (1, offsets.shape[-1]))
            off_t = torch.gather(offsets, -2, pick)[..., 0, :]
            off = torch.mean((off_t - (y - centers[bins])) ** 2)
            return cls + oscale * off

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); the bin is drawn from ``generator``, or from the standard
        Gumbel draws ``draws`` [B, n_bins] when given."""
        scaler, centers, W = self.scaler, self.centers, self.window_size

        def apply(params, carry, obs, draws=None):
            window, filled = push_window(carry, obs, W)
            logits, offsets = self._heads(params, window)
            b = base.draw_categorical(logits, generator, draws)
            rows = torch.arange(b.shape[0], device=b.device)
            a = centers[b] + offsets[rows, b]
            act = scaler.inverse_scale_output(scaler.clip_action(a))
            return (window, filled), act

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_window(obs_dim, batch, self.window_size,
                           self.scaler.x_mean.device)
