"""BESO agent: continuous-time score matching (EDM) with k-diffusion samplers.

Counterpart of ``d3il_tpu/agents/beso.py``, batched: the EDM-preconditioned
denoiser on an MLP (``ScoreMLP``) or a causal transformer (``ScoreGPT``:
the token sequence [sigma, s_1, a_1, ..., s_W, a_W] with one position
embedding shared by each (s_t, a_t) pair), the truncated log-logistic
training density of sigma, the karras / exponential / linear schedules
(NumPy float64, then float32) and the 14 samplers of ``SAMPLERS``.

Every sampler takes ``denoise(a, sigma)`` with ``a`` [B, ...] and sigma a
0-d or a [B] tensor. The stochastic ones take their normal draws as an
optional ``draws`` argument (from the generator unless given), so a test
can hand them the JAX keys' draws. ``dpm_adaptive`` runs one step-size
controller per env, as the JAX policy does under ``vmap``: each env's error
norm is its own, each env stops on its own, and the batch loops while any
env is active, up to the ``max_steps`` fuse. The JAX controller is kept as
written: an ``order`` other than 2 runs the 2/3 pair, and h is clipped to
[0.25, 4] times itself before the ``accept_safety`` factor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.bc import init_window, push_window
from d3il_tpu_torch.agents.ddpm import TimeEmbed
from d3il_tpu_torch.agents.nets.mlp import ResidualMLP, dense
from d3il_tpu_torch.agents.nets.transformer import (Block, layer_norm,
                                                    normal_param)
from d3il_tpu_torch.data.scaler import Scaler

SIGMA_DATA = 0.5
SIGMA_MIN, SIGMA_MAX = 0.001, 1.0         # training noise-density range
SAMPLE_SIGMA_MIN, SAMPLE_SIGMA_MAX = 0.1, 1.0   # inference schedule range
DENSITY_LOC, DENSITY_SCALE = -0.6, 1.6   # truncated log-logistic density


def _sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def rand_log_logistic(generator, shape, u=None, loc=DENSITY_LOC,
                      scale=DENSITY_SCALE, min_value=SIGMA_MIN,
                      max_value=SIGMA_MAX):
    """Truncated log-logistic sigma draws of ``shape``. ``u``: the uniform
    draw in [cdf(min_value), cdf(max_value)] (from ``generator`` unless
    given)."""
    if u is None:
        lo = _sigmoid((math.log(min_value) - loc) / scale)
        hi = _sigmoid((math.log(max_value) - loc) / scale)
        u = torch.rand(shape, generator=generator,
                       device=generator.device) * (hi - lo) + lo
    return torch.exp(torch.logit(u) * scale + loc)


class ScoreMLP(nn.Module):
    def __init__(self, obs_dim: int, hidden_dim: int = 256,
                 num_hidden_layers: int = 4, action_dim: int = 2,
                 t_dim: int = 16, *, generator: torch.Generator):
        super().__init__()
        self.temb = TimeEmbed(t_dim, generator=generator)
        self.mlp = ResidualMLP(obs_dim + action_dim + t_dim, hidden_dim,
                               num_hidden_layers, action_dim,
                               generator=generator)

    def forward(self, s, a, sigma):
        temb = self.temb(torch.log(sigma) / 4.0)
        return self.mlp(torch.cat([s, a, temb], dim=-1))


class ScoreGPT(nn.Module):
    """s [B, W, Ds], a [B, W, Da] (noised), sigma [B] -> denoised
    [B, W, Da]."""

    def __init__(self, obs_dim: int, n_embd: int = 120, n_head: int = 4,
                 n_layer: int = 4, window: int = 5, action_dim: int = 2,
                 *, generator: torch.Generator):
        super().__init__()
        self.t_in = dense(1, n_embd, generator)
        self.pos_emb = normal_param((1, window, n_embd), 0.02, generator)
        self.s_in = dense(obs_dim, n_embd, generator)
        self.a_in = dense(action_dim, n_embd, generator)
        self.blocks = nn.ModuleList(Block(n_embd, n_head, generator)
                                    for _ in range(n_layer))
        self.ln_f = layer_norm(n_embd, generator.device)
        self.hid = dense(n_embd, 100, generator)
        self.out = dense(100, action_dim, generator)

    def forward(self, s, a, sigma):
        B, W, _ = s.shape
        E = self.pos_emb.shape[-1]
        temb = self.t_in((torch.log(sigma) / 4.0)[:, None])
        pos = self.pos_emb[:, :W]
        sa = torch.stack([self.s_in(s) + pos, self.a_in(a) + pos],
                         dim=2).reshape(B, 2 * W, E)
        x = torch.cat([temb[:, None], sa], dim=1)
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        act_tok = x[:, 1:].reshape(B, W, 2, E)[:, :, 1]
        return self.out(F.silu(self.hid(act_tok)))


def edm_denoise(model, params, s, a, sigma):
    """EDM preconditioning (Karras et al. 2022); sigma [B] broadcasts over
    the trailing action dims of a ([B, Da] or [B, W, Da])."""
    sig = sigma.reshape(sigma.shape + (1,) * (a.ndim - sigma.ndim))
    c_skip = SIGMA_DATA ** 2 / (sig ** 2 + SIGMA_DATA ** 2)
    c_out = sig * SIGMA_DATA / torch.sqrt(sig ** 2 + SIGMA_DATA ** 2)
    c_in = 1.0 / torch.sqrt(sig ** 2 + SIGMA_DATA ** 2)
    F_ = functional_call(model, params, (s, c_in * a, sigma))
    return c_skip * a + c_out * F_


# ---- sigma schedules: NumPy float64, then float32 -------------------------

def karras_sigmas(n: int, rho: float = 7.0, smin=SAMPLE_SIGMA_MIN,
                  smax=SAMPLE_SIGMA_MAX) -> np.ndarray:
    ramp = np.linspace(0, 1, n)
    s = (smax ** (1 / rho) + ramp * (smin ** (1 / rho)
                                     - smax ** (1 / rho))) ** rho
    return np.append(s, 0.0).astype(np.float32)


def exponential_sigmas(n: int, smin=SAMPLE_SIGMA_MIN,
                       smax=SAMPLE_SIGMA_MAX) -> np.ndarray:
    s = np.exp(np.linspace(np.log(smax), np.log(smin), n))
    return np.append(s, 0.0).astype(np.float32)


def linear_sigmas(n: int, smin=SAMPLE_SIGMA_MIN,
                  smax=SAMPLE_SIGMA_MAX) -> np.ndarray:
    s = np.linspace(smax, smin, n)
    return np.append(s, 0.0).astype(np.float32)


SIGMA_SCHEDULES = {"karras": karras_sigmas, "exponential": exponential_sigmas,
                   "linear": linear_sigmas}


# ---- samplers ------------------------------------------------------------
#
# ``sigmas`` is a float32 NumPy grid (n + 1 values, the last 0). The scalar
# algebra on it runs as float32 0-d tensors on a's device, as the JAX
# samplers run it on float32 device scalars.

def _col(x, a):
    """A per-env [B] tensor as a column that broadcasts against a."""
    if torch.is_tensor(x) and x.ndim == 1:
        return x.reshape(x.shape + (1,) * (a.ndim - 1))
    return x


def _grid(sigmas, a):
    return torch.as_tensor(np.asarray(sigmas, np.float32), device=a.device)


def _pos(x):
    return torch.clamp(x, min=1e-12)


def _to_d(a, sigma, denoised):
    return (a - denoised) / _col(_pos(sigma), a)


def _normals(generator, draws, n, shape, like):
    """The sampler's normal draws [n, *shape] (from generator unless
    given)."""
    if draws is not None:
        return draws
    return torch.randn((n,) + tuple(shape), generator=generator,
                       device=like.device)


def _ancestral_sigmas(s, sn, eta=None):
    var_up = sn ** 2 * (s ** 2 - sn ** 2) / _pos(s ** 2)
    sigma_up = torch.sqrt(torch.clamp(var_up, min=0.0))
    if eta is not None:
        sigma_up = torch.minimum(sigma_up * eta, sn)
    sigma_down = torch.sqrt(torch.clamp(sn ** 2 - sigma_up ** 2, min=0.0))
    return sigma_up, sigma_down


def sample_euler(denoise, a, sigmas, generator=None, draws=None):
    sg = _grid(sigmas, a)
    for i in range(len(sigmas) - 1):
        d = _to_d(a, sg[i], denoise(a, sg[i]))
        a = a + d * (sg[i + 1] - sg[i])
    return a


def sample_ddim(denoise, a, sigmas, generator=None, draws=None):
    sg = _grid(sigmas, a)
    for i in range(len(sigmas) - 1):
        den = denoise(a, sg[i])
        ratio = sg[i + 1] / _pos(sg[i])
        a = den + ratio * (a - den)
    return a


def sample_euler_ancestral(denoise, a, sigmas, generator=None, draws=None):
    """draws [n, *a.shape]: one normal per step."""
    sg = _grid(sigmas, a)
    n = len(sigmas) - 1
    z = _normals(generator, draws, n, a.shape, a)
    for i in range(n):
        s, sn = sg[i], sg[i + 1]
        den = denoise(a, s)
        sigma_up, sigma_down = _ancestral_sigmas(s, sn)
        a = a + _to_d(a, s, den) * (sigma_down - s)
        a = a + z[i] * sigma_up
    return a


def sample_heun(denoise, a, sigmas, generator=None, draws=None):
    sg = _grid(sigmas, a)
    for i in range(len(sigmas) - 1):
        s, sn = sg[i], sg[i + 1]
        d = _to_d(a, s, denoise(a, s))
        a_e = a + d * (sn - s)
        d2 = _to_d(a_e, _pos(sn),
                   denoise(a_e, torch.clamp(sn, min=SIGMA_MIN)))
        a_h = a + 0.5 * (d + d2) * (sn - s)
        a = torch.where(sn > 0, a_h, a + d * (sn - s))
    return a


def sample_dpmpp_2s_ancestral(denoise, a, sigmas, generator=None,
                              draws=None):
    """draws [n, *a.shape]: one normal per step."""
    sg = _grid(sigmas, a)
    n = len(sigmas) - 1
    z = _normals(generator, draws, n, a.shape, a)
    for i in range(n):
        s, sn = sg[i], sg[i + 1]
        den = denoise(a, s)
        sigma_up, sigma_down = _ancestral_sigmas(s, sn)
        t, tn = -torch.log(_pos(s)), -torch.log(_pos(sigma_down))
        r = (tn - t) / 2
        s_mid = torch.exp(-(t + r))
        a_2 = (s_mid / _pos(s)) * a - torch.expm1(-r) * den
        den2 = denoise(a_2, s_mid)
        a_new = (sigma_down / _pos(s)) * a - torch.expm1(tn - t) * (-den2)
        # the euler-ancestral form where sigma_down == 0
        a_eul = a + _to_d(a, s, den) * (sigma_down - s)
        a_new = torch.where(sigma_down > 1e-10, a_new, a_eul)
        a = a_new + z[i] * sigma_up
    return a


def sample_dpm_2(denoise, a, sigmas, generator=None, draws=None):
    """DPM-Solver-2: the midpoint in log sigma; euler on the last step."""
    sg = _grid(sigmas, a)
    for i in range(len(sigmas) - 1):
        s, sn = sg[i], sg[i + 1]
        d = _to_d(a, s, denoise(a, s))
        s_mid = torch.exp(0.5 * (torch.log(_pos(s)) + torch.log(_pos(sn))))
        a_2 = a + d * (s_mid - s)
        d2 = _to_d(a_2, s_mid, denoise(a_2, s_mid))
        a = torch.where(sn > 1e-10, a + d2 * (sn - s), a + d * (sn - s))
    return a


def sample_dpm_2_ancestral(denoise, a, sigmas, generator=None, draws=None):
    """Ancestral DPM-Solver-2; draws [n, *a.shape]: one normal per step."""
    sg = _grid(sigmas, a)
    n = len(sigmas) - 1
    z = _normals(generator, draws, n, a.shape, a)
    for i in range(n):
        s, sn = sg[i], sg[i + 1]
        sigma_up, sigma_down = _ancestral_sigmas(s, sn)
        d = _to_d(a, s, denoise(a, s))
        s_mid = torch.exp(0.5 * (torch.log(_pos(s))
                                 + torch.log(_pos(sigma_down))))
        a_2 = a + d * (s_mid - s)
        d2 = _to_d(a_2, s_mid, denoise(a_2, s_mid))
        a_new = torch.where(sigma_down > 1e-10, a + d2 * (sigma_down - s),
                            a + d * (sigma_down - s))
        a = a_new + z[i] * sigma_up
    return a


def sample_dpmpp_2s(denoise, a, sigmas, generator=None, draws=None):
    """DPM-Solver++(2S), deterministic."""
    sg = _grid(sigmas, a)
    for i in range(len(sigmas) - 1):
        s, sn = sg[i], sg[i + 1]
        den = denoise(a, s)
        t, tn = -torch.log(_pos(s)), -torch.log(_pos(sn))
        h = tn - t
        s_mid = torch.exp(-(t + 0.5 * h))
        a_2 = (s_mid / _pos(s)) * a - torch.expm1(-0.5 * h) * den
        den2 = denoise(a_2, s_mid)
        a_new = (sn / _pos(s)) * a - torch.expm1(-h) * den2
        a_eul = a + _to_d(a, s, den) * (sn - s)
        a = torch.where(sn > 1e-10, a_new, a_eul)
    return a


def sample_dpmpp_2m(denoise, a, sigmas, generator=None, draws=None):
    """DPM-Solver++(2M): linear multistep over the previous denoised
    estimate; the first step is DDIM."""
    sg = _grid(sigmas, a)
    old_den = torch.zeros_like(a)
    h_last = torch.zeros((), device=a.device)
    for i in range(len(sigmas) - 1):
        s, sn = sg[i], sg[i + 1]
        den = denoise(a, s)
        t, tn = -torch.log(_pos(s)), -torch.log(_pos(sn))
        h = tn - t
        r = h_last / _pos(h)
        den_p = (1 + 1 / (2 * r)) * den - (1 / (2 * r)) * old_den
        use_ms = (h_last > 0) & (sn > 1e-10)
        den_use = torch.where(use_ms, den_p, den)
        a_new = (sn / _pos(s)) * a - torch.expm1(-h) * den_use
        a_ddim = den + (sn / _pos(s)) * (a - den)
        a = torch.where(sn > 1e-10, a_new, a_ddim)
        old_den, h_last = den, h
    return a


def _lms_coeffs(sigmas_np, order: int):
    """Adams-Bashforth-style coefficients over the (static) sigma grid,
    integrated on the host exactly as the JAX sampler integrates them."""
    n = len(sigmas_np) - 1
    out = []
    for i in range(n):
        cur = min(i + 1, order)
        xs = np.linspace(sigmas_np[i], sigmas_np[i + 1], 513)
        cs = []
        for j in range(cur):
            prod = np.ones_like(xs)
            for k in range(cur):
                if k == j:
                    continue
                prod = prod * (xs - sigmas_np[i - k]) / (
                    sigmas_np[i - j] - sigmas_np[i - k])
            cs.append(np.trapezoid(prod, xs))
        out.append(cs)
    return out


def sample_lms(denoise, a, sigmas, generator=None, draws=None,
               order: int = 4):
    """Linear multistep sampler; coefficients from the host."""
    coeffs = _lms_coeffs(np.asarray(sigmas, np.float32), order)
    sg = _grid(sigmas, a)
    ds = []
    for i in range(len(sigmas) - 1):
        ds.append(_to_d(a, sg[i], denoise(a, sg[i])))
        if len(ds) > order:
            ds.pop(0)
        a = a + sum(float(c) * dd for c, dd in zip(coeffs[i], reversed(ds)))
    return a


def sample_dpmpp_sde(denoise, a, sigmas, generator=None, draws=None,
                     eta: float = 1.0, r: float = 0.5):
    """DPM-Solver++ (stochastic) with Gaussian increments in place of the
    reference's BrownianTree; draws [n, 2, *a.shape]: the midpoint's and the
    step's normal per step."""
    sg = _grid(sigmas, a)
    n = len(sigmas) - 1
    z = _normals(generator, draws, n, (2,) + tuple(a.shape), a)
    for i in range(n):
        s, sn = sg[i], sg[i + 1]
        den = denoise(a, s)
        a_eul = a + _to_d(a, s, den) * (sn - s)   # the last step
        t, tn = -torch.log(_pos(s)), -torch.log(_pos(sn))
        h = tn - t
        sm = t + h * r
        fac = 1.0 / (2.0 * r)
        sig_s = torch.exp(-sm)
        su1, sd1 = _ancestral_sigmas(s, sig_s, eta)
        s_ = -torch.log(_pos(sd1))
        a_2 = (torch.exp(-s_) / _pos(s)) * a - torch.expm1(t - s_) * den
        a_2 = a_2 + z[i, 0] * su1
        den2 = denoise(a_2, sig_s)
        su2, sd2 = _ancestral_sigmas(s, sn, eta)
        tn_ = -torch.log(_pos(sd2))
        den_d = (1 - fac) * den + fac * den2
        a_new = (torch.exp(-tn_) / _pos(s)) * a \
            - torch.expm1(t - tn_) * den_d
        a_new = a_new + z[i, 1] * su2
        a = torch.where(sn > 1e-10, a_new, a_eul)
    return a


def sample_dpmpp_2m_sde(denoise, a, sigmas, generator=None, draws=None,
                        eta: float = 1.0):
    """DPM-Solver++(2M) SDE with the heun correction and Gaussian
    increments; draws [n, *a.shape]: one normal per step."""
    sg = _grid(sigmas, a)
    n = len(sigmas) - 1
    z = _normals(generator, draws, n, a.shape, a)
    old_den = torch.zeros_like(a)
    h_last = torch.zeros((), device=a.device)
    for i in range(n):
        s, sn = sg[i], sg[i + 1]
        den = denoise(a, s)
        t, tn = -torch.log(_pos(s)), -torch.log(_pos(sn))
        h = tn - t
        eta_h = eta * h
        a_new = (sn / _pos(s)) * torch.exp(-eta_h) * a \
            - torch.expm1(-h - eta_h) * den
        use_ms = (h_last > 0) & (sn > 1e-10)
        rr = h_last / _pos(h)
        # (-h-eta_h).expm1().neg()/(-h-eta_h) + 1: the correction vanishes
        # as h -> 0
        heun = (-torch.expm1(-h - eta_h) / (-h - eta_h) + 1.0) \
            * (1.0 / _pos(rr)) * (den - old_den)
        a_new = a_new + torch.where(use_ms, heun, torch.zeros_like(heun))
        a_new = a_new + z[i] * sn * torch.sqrt(
            torch.clamp(-torch.expm1(-2 * eta_h), min=0.0))
        a = torch.where(sn > 1e-10, a_new, den)
        old_den, h_last = den, h
    return a


# ---- DPM-Solver (fast, adaptive) in t = -log sigma ------------------------

def _dpm_eps(denoise, a, t):
    sigma = torch.exp(-t)
    return (a - denoise(a, sigma)) / _col(_pos(sigma), a)


def _dpm_1_step(denoise, a, t, tn, eps=None):
    h = _col(tn - t, a)
    eps = _dpm_eps(denoise, a, t) if eps is None else eps
    return a - torch.exp(-_col(tn, a)) * torch.expm1(h) * eps, eps


def _dpm_2_step(denoise, a, t, tn, r1=0.5, eps=None):
    h = tn - t
    eps = _dpm_eps(denoise, a, t) if eps is None else eps
    s1 = t + r1 * h
    hc, s1c, tnc = _col(h, a), _col(s1, a), _col(tn, a)
    u1 = a - torch.exp(-s1c) * torch.expm1(r1 * hc) * eps
    eps_r1 = _dpm_eps(denoise, u1, s1)
    a2 = a - torch.exp(-tnc) * torch.expm1(hc) * eps \
        - torch.exp(-tnc) / (2 * r1) * torch.expm1(hc) * (eps_r1 - eps)
    return a2, eps


def _dpm_3_step(denoise, a, t, tn, r1=1 / 3, r2=2 / 3, eps=None):
    h = tn - t
    eps = _dpm_eps(denoise, a, t) if eps is None else eps
    s1, s2 = t + r1 * h, t + r2 * h
    hc, tnc = _col(h, a), _col(tn, a)
    s1c, s2c = _col(s1, a), _col(s2, a)
    u1 = a - torch.exp(-s1c) * torch.expm1(r1 * hc) * eps
    eps_r1 = _dpm_eps(denoise, u1, s1)
    u2 = a - torch.exp(-s2c) * torch.expm1(r2 * hc) * eps \
        - torch.exp(-s2c) * (r2 / r1) * (torch.expm1(r2 * hc) / (r2 * hc)
                                         - 1.0) * (eps_r1 - eps)
    eps_r2 = _dpm_eps(denoise, u2, s2)
    a3 = a - torch.exp(-tnc) * torch.expm1(hc) * eps \
        - torch.exp(-tnc) / r2 * (torch.expm1(hc) / hc - 1.0) \
        * (eps_r2 - eps)
    return a3, eps


def sample_dpm_fast(denoise, a, sigmas, generator=None, draws=None):
    """DPM-Solver-fast: a fixed mix of 3rd/2nd/1st-order steps whose order
    schedule resolves on the host; deterministic."""
    sigs = np.asarray(sigmas, np.float64)
    t_start = -np.log(sigs[0])
    t_end = -np.log(sigs[-2])            # last nonzero sigma
    nfe = len(sigs) - 1
    m = nfe // 3 + 1
    ts = np.linspace(t_start, t_end, m + 1)
    orders = [3] * (m - 2) + [2, 1] if nfe % 3 == 0 \
        else [3] * (m - 1) + [nfe % 3]
    steps = {1: _dpm_1_step, 2: _dpm_2_step, 3: _dpm_3_step}
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=a.device)
    for i, order in enumerate(orders):
        a, _ = steps[order](denoise, a, f32(ts[i]), f32(ts[i + 1]))
    # the trailing sigma = 0: its exact solution is the denoised estimate
    return denoise(a, _grid(sigmas, a)[-2])


def dpm_adaptive_solve(denoise, a, sigmas, order: int = 3,
                       rtol: float = 0.05, atol: float = 0.0078,
                       h_init: float = 0.05, accept_safety: float = 0.81,
                       max_steps: int = 64):
    """The adaptive DPM-Solver-12/23 loop, one controller per env: an
    embedded lower/higher-order pair and an I-controller on each env's
    error norm (over its own action, divided by the square root of its
    size). Returns (a, accepted [B], iterations [B]): the state at the
    last t and each env's accepted steps and loop iterations."""
    sigs = np.asarray(sigmas, np.float64)
    t_start = float(-np.log(sigs[0]))
    t_end = float(-np.log(sigs[-2]))
    eps_coeff = 1.0 / (2 if order == 2 else 3)
    B = a.shape[0]
    dev = a.device
    f32 = lambda x: torch.full((B,), x, dtype=torch.float32, device=dev)
    s, h = f32(t_start), f32(h_init)
    i = torch.zeros(B, dtype=torch.int32, device=dev)
    accepted = torch.zeros(B, dtype=torch.int32, device=dev)
    a_prev = a
    t_end32 = torch.tensor(t_end, dtype=torch.float32, device=dev)
    per_env = math.sqrt(a[0].numel())
    while True:
        active = (s < t_end - 1e-5) & (i < max_steps)
        if not bool(active.any()):
            break
        t = torch.minimum(t_end32, s + h)
        if order == 2:
            a_low, eps = _dpm_1_step(denoise, a, s, t)
            a_high, _ = _dpm_2_step(denoise, a, s, t, eps=eps)
        else:
            a_low, eps = _dpm_2_step(denoise, a, s, t, r1=1 / 3)
            a_high, _ = _dpm_3_step(denoise, a, s, t, eps=eps)
        delta = torch.clamp(rtol * torch.maximum(a_low.abs(), a_prev.abs()),
                            min=atol)
        err = torch.linalg.vector_norm(
            ((a_low - a_high) / delta).reshape(B, -1), dim=1) / per_env
        accept = err < 1.0 / accept_safety
        fac = torch.clamp(torch.pow(torch.clamp(err, min=1e-8), -eps_coeff),
                          min=0.25, max=4.0)
        h_new = torch.clamp(h * fac * accept_safety, max=10.0)
        take = _col(active & accept, a)
        a = torch.where(take, a_high, a)
        a_prev = torch.where(take, a_low, a_prev)
        s = torch.where(active & accept, t, s)
        h = torch.where(active, h_new, h)
        accepted = accepted + (active & accept).to(torch.int32)
        i = i + active.to(torch.int32)
    return a, accepted, i


def sample_dpm_adaptive(denoise, a, sigmas, generator=None, draws=None,
                        **kw):
    """Adaptive DPM-Solver, deterministic; ``kw`` as dpm_adaptive_solve."""
    a, _, _ = dpm_adaptive_solve(denoise, a, sigmas, **kw)
    return denoise(a, _grid(sigmas, a)[-2])   # the trailing sigma = 0


SAMPLERS = {"euler": sample_euler, "ddim": sample_ddim,
            "euler_ancestral": sample_euler_ancestral, "heun": sample_heun,
            "dpmpp_2s_ancestral": sample_dpmpp_2s_ancestral,
            "dpm_2": sample_dpm_2, "dpm_2_ancestral": sample_dpm_2_ancestral,
            "dpmpp_2s": sample_dpmpp_2s, "dpmpp_2m": sample_dpmpp_2m,
            "lms": sample_lms, "dpmpp_sde": sample_dpmpp_sde,
            "dpmpp_2m_sde": sample_dpmpp_2m_sde,
            "dpm_fast": sample_dpm_fast,
            "dpm_adaptive": sample_dpm_adaptive}


@dataclass
class BesoAgent:
    model: nn.Module
    params: dict
    scaler: Scaler
    n_steps: int = 8
    sampler: str = "euler_ancestral"
    schedule: str = "exponential"
    window_size: int = 1
    backbone: str = "mlp"

    @staticmethod
    def create(generator: torch.Generator, obs_dim, action_dim, scaler,
               hidden_dim=256, num_hidden_layers=4, n_steps=8,
               sampler="euler_ancestral", schedule="exponential",
               window_size=1, backbone="mlp", n_embd=120, n_head=4,
               n_layer=4, **_):
        """backbone "mlp" (ScoreMLP on the flattened window) or "gpt"
        (ScoreGPT over the window)."""
        if backbone == "gpt":
            model = ScoreGPT(obs_dim, n_embd, n_head, n_layer, window_size,
                             action_dim, generator=generator)
        else:
            model = ScoreMLP(obs_dim * window_size, hidden_dim,
                             num_hidden_layers, action_dim,
                             generator=generator)
        model = model.to(scaler.x_mean.device)
        return BesoAgent(model=model, params=base.params_of(model),
                         scaler=scaler, n_steps=n_steps, sampler=sampler,
                         schedule=schedule, window_size=window_size,
                         backbone=backbone)

    @property
    def gpt(self) -> bool:
        return self.backbone == "gpt"

    def loss_fn(self):
        """EDM-weighted denoising loss: the GPT denoises the whole action
        window, the MLP the window's last action."""
        model, scaler, gpt = self.model, self.scaler, self.gpt

        def loss(params, obs_w, act_w, generator=None, u=None, noise=None):
            """``u`` [B]: the sigma density's uniform draws (see
            rand_log_logistic); ``noise``: normals like the target (both
            from ``generator`` unless given)."""
            B = obs_w.shape[0]
            sw = scaler.scale_input(obs_w)
            s = sw if gpt else sw.reshape(B, -1)
            a0 = scaler.scale_output(act_w if gpt else act_w[:, -1])
            sigma = rand_log_logistic(generator, (B,), u)
            if noise is None:
                noise = torch.randn(a0.shape, generator=generator,
                                    device=a0.device)
            sig_b = sigma.reshape((B,) + (1,) * (a0.ndim - 1))
            den = edm_denoise(model, params, s, a0 + sig_b * noise, sigma)
            w = (sigma ** 2 + SIGMA_DATA ** 2) / (sigma * SIGMA_DATA) ** 2
            return torch.mean(w.reshape(sig_b.shape) * (den - a0) ** 2)

        return loss

    def action_shape(self, batch: int):
        adim = self.scaler.y_mean.shape[-1]
        return (batch, self.window_size, adim) if self.gpt else (batch, adim)

    def sample(self, params, s, generator, draws=None):
        """Scaled observations s ([B, W, Ds] for the GPT, [B, W * Ds] for
        the MLP) -> the sampler's scaled actions ([B, W, Da] or [B, Da]).
        ``draws``: (a_T [B, ...] unit normals, the sampler's draws or None),
        from ``generator`` unless given."""
        B = s.shape[0]
        a0, zs = (None, None) if draws is None else draws
        if a0 is None:
            a0 = torch.randn(self.action_shape(B), generator=generator,
                             device=s.device)
        model = self.model

        def denoise(a, sigma):
            return edm_denoise(model, params, s, a,
                               torch.broadcast_to(sigma, (B,)))

        sigmas = SIGMA_SCHEDULES[self.schedule](self.n_steps)
        return SAMPLERS[self.sampler](denoise, a0 * SIGMA_MAX, sigmas,
                                      generator, zs)

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); ``draws`` as ``sample``. The window starts as W copies of
        the first obs; the GPT acts with its window's last action."""
        scaler, W, gpt = self.scaler, self.window_size, self.gpt

        def apply(params, carry, obs, draws=None):
            window, filled = push_window(carry, obs, W)
            sw = scaler.scale_input(window)
            s = sw if gpt else sw.reshape(sw.shape[0], -1)
            a = self.sample(params, s, generator, draws)
            a = a[:, -1] if gpt else a
            act = scaler.inverse_scale_output(scaler.clip_action(a))
            return (window, filled), act

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_window(obs_dim, batch, self.window_size,
                           self.scaler.x_mean.device)
