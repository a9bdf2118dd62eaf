"""DDPM diffusion-policy agent.

Counterpart of ``d3il_tpu/agents/ddpm.py``, batched: a cosine beta
schedule, epsilon prediction by a ResidualMLP over [obs, a_t, sinusoidal
t-embedding (t_dim 16)], EMA 0.995 in training (the registry's), and the
T-step reverse diffusion with the x0 estimate clipped to 1.1x the action
bounds, as a Python loop on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.bc import init_window, push_window
from d3il_tpu_torch.agents.nets.mlp import ResidualMLP, dense, mish
from d3il_tpu_torch.data.scaler import Scaler


def cosine_betas(T: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule (NumPy): betas [T] in [0, 0.999]."""
    t = np.linspace(0, T, T + 1) / T
    f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
    alphas_bar = f / f[0]
    betas = 1 - alphas_bar[1:] / alphas_bar[:-1]
    return np.clip(betas, 0, 0.999)


class Schedule:
    """The float32 schedule of T steps: ``abar`` [T] as a tensor for the
    loss; per step t the reverse update's coefficients as Python floats:
    x0 = (a - sqrt(1 - abar) eps) / sqrt(abar), mean = c0 x0 + c1 a, plus
    sigma * noise (sigma = 0 at t = 0)."""

    def __init__(self, T: int, device):
        betas = torch.as_tensor(cosine_betas(T), dtype=torch.float32)
        alphas = 1.0 - betas
        abar = torch.cumprod(alphas, dim=0)
        abar_prev = torch.cat([torch.ones(1), abar[:-1]])
        self.T = T
        self.abar = abar.to(device)
        self.sqrt_1m_abar = torch.sqrt(1 - abar).tolist()
        self.sqrt_abar = torch.sqrt(abar).tolist()
        self.c0 = (torch.sqrt(abar_prev) * betas / (1 - abar)).tolist()
        self.c1 = (torch.sqrt(alphas) * (1 - abar_prev) / (1 - abar)).tolist()
        var = betas * (1 - abar_prev) / (1 - abar)
        self.sigma = [math.sqrt(v) if t > 0 else 0.0
                      for t, v in enumerate(var.tolist())]


def reverse_diffusion(denoise, sched: Schedule, shape, lo, hi, generator,
                      noise=None):
    """a_T ~ N(0, 1) of ``shape``, then T reverse steps t = T-1 .. 0 with
    ``denoise(a, t)`` -> eps_hat. ``noise`` [T + 1, *shape] holds the
    initial and the per-step normal draws (from ``generator`` unless
    given)."""
    if noise is None:
        noise = torch.randn((sched.T + 1,) + tuple(shape),
                            generator=generator, device=generator.device)
    a = noise[0]
    for i, t in enumerate(range(sched.T - 1, -1, -1)):
        eps_hat = denoise(a, t)
        x0 = torch.clamp((a - sched.sqrt_1m_abar[t] * eps_hat)
                         / sched.sqrt_abar[t], lo, hi)
        a = sched.c0[t] * x0 + sched.c1[t] * a + sched.sigma[t] * noise[i + 1]
    return a


class TimeEmbed(nn.Module):
    def __init__(self, t_dim: int = 16, *, generator: torch.Generator):
        super().__init__()
        self.t_dim = t_dim
        self.fc1 = dense(t_dim, 2 * t_dim, generator)
        self.fc2 = dense(2 * t_dim, t_dim, generator)

    def forward(self, t):
        half = self.t_dim // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(
            half, device=t.device, dtype=torch.float32) / (half - 1))
        ang = t[..., None] * freqs
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.fc2(mish(self.fc1(emb)))


class DenoiseMLP(nn.Module):
    def __init__(self, obs_dim: int, hidden_dim: int = 256,
                 num_hidden_layers: int = 4, action_dim: int = 2,
                 t_dim: int = 16, *, generator: torch.Generator):
        super().__init__()
        self.action_dim = action_dim
        self.temb = TimeEmbed(t_dim, generator=generator)
        self.mlp = ResidualMLP(obs_dim + action_dim + t_dim, hidden_dim,
                               num_hidden_layers, action_dim,
                               generator=generator)

    def forward(self, obs, a_t, t):
        temb = self.temb(t.to(torch.float32))
        return self.mlp(torch.cat([obs, a_t, temb], dim=-1))


def diffusion_loss(denoise, a0, T: int, abar, generator, t=None, eps=None):
    """The eps-prediction MSE at steps ``t`` [B] (uniform in [0, T)) with
    normal draws ``eps`` like a0 (both from ``generator`` unless given);
    ``denoise(a_t, t)`` -> eps_hat."""
    B = a0.shape[0]
    if t is None:
        t = torch.randint(0, T, (B,), generator=generator, device=a0.device)
    if eps is None:
        eps = torch.randn(a0.shape, generator=generator, device=a0.device)
    ab = abar[t].reshape((B,) + (1,) * (a0.ndim - 1))
    a_t = torch.sqrt(ab) * a0 + torch.sqrt(1 - ab) * eps
    return torch.mean((denoise(a_t, t) - eps) ** 2)


@dataclass
class DDPMAgent:
    model: DenoiseMLP
    params: dict
    scaler: Scaler
    n_timesteps: int = 16
    window_size: int = 1

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               hidden_dim=256, num_hidden_layers=4, n_timesteps=16,
               window_size=1):
        model = DenoiseMLP(obs_dim * window_size, hidden_dim,
                           num_hidden_layers, action_dim,
                           generator=generator).to(scaler.x_mean.device)
        return DDPMAgent(model=model, params=base.params_of(model),
                         scaler=scaler, n_timesteps=n_timesteps,
                         window_size=window_size)

    def schedule(self) -> Schedule:
        return Schedule(self.n_timesteps, self.scaler.x_mean.device)

    def loss_fn(self):
        model, scaler, T = self.model, self.scaler, self.n_timesteps
        abar = self.schedule().abar

        def loss(params, obs_w, act_w, generator=None, t=None, eps=None):
            """``t`` [B] and ``eps`` [B, Da]: the steps and the noise (from
            ``generator`` unless given)."""
            s = scaler.scale_input(obs_w).reshape(obs_w.shape[0], -1)
            a0 = scaler.scale_output(act_w[:, -1])
            return diffusion_loss(
                lambda a_t, tt: functional_call(model, params, (s, a_t, tt)),
                a0, T, abar, generator, t, eps)

        return loss

    def sample(self, params, s, generator, noise=None, sched=None):
        """Reverse diffusion for scaled observations s [B, Ds] -> scaled
        actions [B, Da]; ``noise`` [T + 1, B, Da] as reverse_diffusion."""
        sched = sched or self.schedule()
        lo, hi = self.scaler.y_bounds[0] * 1.1, self.scaler.y_bounds[1] * 1.1
        B = s.shape[0]

        def denoise(a, t):
            tt = torch.full((B,), t, dtype=torch.int64, device=s.device)
            return functional_call(self.model, params, (s, a, tt))

        return reverse_diffusion(denoise, sched, (B, self.model.action_dim),
                                 lo, hi, generator, noise)

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); ``draws`` [T + 1, B, Da]: the reverse diffusion's normal
        draws (from ``generator`` unless given)."""
        scaler, W = self.scaler, self.window_size
        sched = self.schedule()

        def apply(params, carry, obs, draws=None):
            window, filled = push_window(carry, obs, W)
            s = scaler.scale_input(window).reshape(window.shape[0], -1)
            a = self.sample(params, s, generator, draws, sched)
            act = scaler.inverse_scale_output(scaler.clip_action(a))
            return (window, filled), act

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_window(obs_dim, batch, self.window_size,
                           self.scaler.x_mean.device)
