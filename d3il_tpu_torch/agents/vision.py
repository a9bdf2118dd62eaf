"""Vision agents: a shared image encoder + per-method heads.

Counterpart of ``d3il_tpu/agents/vision.py``, batched. Every vision agent
owns one ``VisionNet``: the ``core`` (MultiImageObsEncoder: a ResNet18 +
SpatialSoftmax per camera, concatenated with the scaled low-dim robot
state) and its method's head modules, trained end to end. The agent renders
its images on the device from the state observation through a task
``render_fn`` (vision/taskviews.py): the loss renders the minibatch's
observations, the policy the live observations of all B envs at once, then
encodes them once per env step, and the head runs on the features (the
T reverse diffusion steps, the sampler's denoiser calls and the DFO's
energy calls all reuse them).

Randomness follows the state agents: one ``torch.Generator`` per batch,
and every stochastic loss and policy takes its draws as optional arguments
(from the generator unless given). All vision agents are single-frame but
GPT-BC, which carries the window of encoded features; ACT and DDPM-encdec
act in chunks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.act import ACTNet, chunk_step, init_chunk
from d3il_tpu_torch.agents.bc import push_window
from d3il_tpu_torch.agents.bet import BeTMLPHead, focal_loss, kmeans_fit
from d3il_tpu_torch.agents.beso import (SAMPLERS, SIGMA_DATA, SIGMA_MAX,
                                        SIGMA_SCHEDULES, ScoreMLP,
                                        edm_denoise, rand_log_logistic)
from d3il_tpu_torch.agents.ddpm import (DenoiseMLP, Schedule, diffusion_loss,
                                        reverse_diffusion)
from d3il_tpu_torch.agents.ddpm_encdec import EncDecDenoiser
from d3il_tpu_torch.agents.gmm import GMMNet, gmm_log_prob, gmm_sample
from d3il_tpu_torch.agents.ibc import EBM, _energy, dfo_sample, \
    langevin_sample
from d3il_tpu_torch.agents.nets.mlp import ResidualMLP
from d3il_tpu_torch.agents.nets.transformer import GPT
from d3il_tpu_torch.data.scaler import Scaler
from d3il_tpu_torch.vision.encoder import MultiImageObsEncoder

_EPS = 1e-12


def _scale_low(scaler: Scaler, low):
    """Z-score the low-dim robot-state prefix with the leading slice of the
    full-obs scaler statistics (the prefix IS the first k obs dims)."""
    k = low.shape[-1]
    return (low - scaler.x_mean[:k]) / (scaler.x_std[:k] + _EPS)


class VisionNet(nn.Module):
    """The shared encoder ``core`` and a method's named head modules."""

    def __init__(self, low_dim: int, generator: torch.Generator, heads):
        super().__init__()
        self.core = MultiImageObsEncoder(generator=generator)
        feat_dim = self.core.feature_dim(low_dim)
        for name, make in heads.items():
            setattr(self, name, make(feat_dim))


def _sub(params: dict, part: str) -> dict:
    """The parameters of submodule ``part``, named as in it."""
    n = len(part) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(part + ".")}


def _call(model: VisionNet, params: dict, part: str, *args):
    return functional_call(getattr(model, part), _sub(params, part), args)


def _unscale(scaler: Scaler, a):
    return scaler.inverse_scale_output(scaler.clip_action(a))


@dataclass
class _VisionAgent:
    """What the vision agents share: render + encode, no carry."""
    model: VisionNet
    params: dict
    scaler: Scaler
    render_fn: Callable      # obs [B, Do] -> (bp, inhand, low_dim)
    window_size: int = 1     # single-frame; the dataset's window

    @staticmethod
    def _net(generator, scaler, low_dim, **heads) -> VisionNet:
        """``heads``: name -> (feature dim -> module)."""
        return VisionNet(low_dim, generator, heads).to(scaler.x_mean.device)

    def encode(self, params, obs):
        """obs [B, Do] -> features [B, 2 * 64 + low_dim]."""
        bp, ih, low = self.render_fn(obs)
        return _call(self.model, params, "core", bp, ih,
                     _scale_low(self.scaler, low))

    def init_carry(self, obs_dim: int, batch: int):
        return ()


@dataclass
class VisionBCAgent(_VisionAgent):
    """bc vision variant: MSE regression of the scaled action."""

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, render_fn, low_dim=4,
               hidden_dim=256, num_hidden_layers=4, **_):
        model = _VisionAgent._net(
            generator, scaler, low_dim, head=lambda f: ResidualMLP(
                f, hidden_dim, num_hidden_layers, action_dim,
                generator=generator))
        return VisionBCAgent(model, base.params_of(model), scaler, render_fn)

    def loss_fn(self):
        def loss(params, obs_w, act_w, generator=None):
            pred = _call(self.model, params, "head",
                         self.encode(params, obs_w[:, -1]))
            return torch.mean((pred - self.scaler.scale_output(act_w[:, -1]))
                              ** 2)

        return loss

    def policy_apply(self, generator=None):
        """(params, carry, obs [B, Do]) -> (carry, action [B, Da]);
        deterministic."""
        def apply(params, carry, obs):
            pred = _call(self.model, params, "head", self.encode(params, obs))
            return carry, _unscale(self.scaler, pred)

        return apply


@dataclass
class VisionDDPMAgent(_VisionAgent):
    """ddpm vision variant: the state DDPM's schedule, loss and reverse
    diffusion on the encoder features."""
    n_timesteps: int = 16

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, render_fn, low_dim=4,
               hidden_dim=256, num_hidden_layers=4, n_timesteps=16, **_):
        model = _VisionAgent._net(
            generator, scaler, low_dim, den=lambda f: DenoiseMLP(
                f, hidden_dim, num_hidden_layers, action_dim,
                generator=generator))
        return VisionDDPMAgent(model, base.params_of(model), scaler,
                               render_fn, n_timesteps=n_timesteps)

    def schedule(self) -> Schedule:
        return Schedule(self.n_timesteps, self.scaler.x_mean.device)

    def loss_fn(self):
        T, abar = self.n_timesteps, self.schedule().abar

        def loss(params, obs_w, act_w, generator=None, t=None, eps=None):
            """``t`` [B], ``eps`` [B, Da]: the steps and the noise."""
            feat = self.encode(params, obs_w[:, -1])
            return diffusion_loss(
                lambda a_t, tt: _call(self.model, params, "den", feat, a_t,
                                      tt),
                self.scaler.scale_output(act_w[:, -1]), T, abar, generator,
                t, eps)

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); ``draws`` [T + 1, B, Da]: the reverse diffusion's normal
        draws. One encoder pass, then T denoiser calls on its features."""
        sched, scaler = self.schedule(), self.scaler
        lo, hi = scaler.y_bounds[0] * 1.1, scaler.y_bounds[1] * 1.1
        den = self.model.den

        def apply(params, carry, obs, draws=None):
            feat = self.encode(params, obs)
            B, p = feat.shape[0], _sub(params, "den")

            def denoise(a, t):
                tt = torch.full((B,), t, dtype=torch.int64, device=a.device)
                return functional_call(den, p, (feat, a, tt))

            a = reverse_diffusion(denoise, sched, (B, scaler.y_mean.shape[-1]),
                                  lo, hi, generator, draws)
            return carry, _unscale(scaler, a)

        return apply


@dataclass
class VisionBeTAgent(_VisionAgent):
    """bet_mlp vision variant: focal bin classification + per-bin offsets
    on the encoder features."""
    centers: torch.Tensor = None    # [n_bins, Da] in scaled action space
    focal_gamma: float = 2.0
    offset_scale: float = 1.0

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, train_actions_scaled,
               render_fn=None, low_dim=4, hidden_dim=256,
               num_hidden_layers=4, n_bins=64, **_):
        dev = scaler.x_mean.device
        acts = np.asarray(torch.as_tensor(train_actions_scaled).cpu())
        centers = torch.as_tensor(kmeans_fit(acts, n_bins),
                                  dtype=torch.float32, device=dev)
        model = _VisionAgent._net(
            generator, scaler, low_dim, head=lambda f: BeTMLPHead(
                f, hidden_dim, num_hidden_layers, n_bins, action_dim,
                generator=generator))
        return VisionBeTAgent(model, base.params_of(model), scaler,
                              render_fn, centers=centers)

    def loss_fn(self):
        centers, gamma = self.centers, self.focal_gamma

        def loss(params, obs_w, act_w, generator=None):
            logits, offsets = _call(self.model, params, "head",
                                    self.encode(params, obs_w[:, -1]))
            y = self.scaler.scale_output(act_w[:, -1])
            bins = ((y[:, None, :] - centers) ** 2).sum(-1).argmin(-1)
            rows = torch.arange(y.shape[0], device=y.device)
            off = torch.mean((offsets[rows, bins] - (y - centers[bins])) ** 2)
            return focal_loss(logits, bins, gamma).mean() \
                + self.offset_scale * off

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); the bin is drawn from ``generator``, or from the standard
        Gumbel draws ``draws`` [B, n_bins] when given."""
        def apply(params, carry, obs, draws=None):
            logits, offsets = _call(self.model, params, "head",
                                    self.encode(params, obs))
            b = base.draw_categorical(logits, generator, draws)
            rows = torch.arange(b.shape[0], device=b.device)
            return carry, _unscale(self.scaler,
                                   self.centers[b] + offsets[rows, b])

        return apply


@dataclass
class VisionGMMAgent(_VisionAgent):
    """bc_gmm vision variant: the GMM head on the encoder features."""
    low_noise_eval: bool = True

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, render_fn, low_dim=4,
               hidden_dim=256, num_hidden_layers=4, n_gaussians=8, **_):
        model = _VisionAgent._net(
            generator, scaler, low_dim, head=lambda f: GMMNet(
                f, hidden_dim, num_hidden_layers, action_dim, n_gaussians,
                generator=generator))
        return VisionGMMAgent(model, base.params_of(model), scaler, render_fn)

    def loss_fn(self):
        def loss(params, obs_w, act_w, generator=None):
            means, stds, logits = _call(self.model, params, "head",
                                        self.encode(params, obs_w[:, -1]))
            a = self.scaler.scale_output(act_w[:, -1])
            return -torch.mean(gmm_log_prob(means, stds, logits, a))

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); ``draws`` = (Gumbel [B, K] for the component, normal
        [B, Da]) replaces the generator's."""
        def apply(params, carry, obs, draws=None):
            means, stds, logits = _call(self.model, params, "head",
                                        self.encode(params, obs))
            g, eps = (None, None) if draws is None else draws
            comp = base.draw_categorical(logits, generator, g)
            if eps is None:
                eps = torch.randn(means.shape[:1] + means.shape[-1:],
                                  generator=generator, device=means.device)
            a = gmm_sample(means, stds, comp, eps, self.low_noise_eval)
            return carry, _unscale(self.scaler, a)

        return apply


@dataclass
class VisionCVAEAgent(_VisionAgent):
    """cvae vision variant: a VAE over actions conditioned on the encoder
    features; the posterior gives (mu, logvar), KL-regularised
    reconstruction; the policy decodes z ~ N(0, 1)."""
    latent_dim: int = 8
    kl_weight: float = 1.0

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, render_fn, low_dim=4,
               hidden_dim=256, num_hidden_layers=4, latent_dim=8,
               kl_weight=1.0, **_):
        g = generator
        model = _VisionAgent._net(
            g, scaler, low_dim,
            enc=lambda f: ResidualMLP(f + action_dim, hidden_dim, 2,
                                      2 * latent_dim, generator=g),
            dec=lambda f: ResidualMLP(f + latent_dim, hidden_dim,
                                      num_hidden_layers, action_dim,
                                      generator=g))
        return VisionCVAEAgent(model, base.params_of(model), scaler,
                               render_fn, latent_dim=latent_dim,
                               kl_weight=kl_weight)

    def loss_fn(self):
        L = self.latent_dim

        def loss(params, obs_w, act_w, generator=None, eps=None):
            """``eps`` [B, latent]: the reparameterisation's normals."""
            feat = self.encode(params, obs_w[:, -1])
            a = self.scaler.scale_output(act_w[:, -1])
            mo = _call(self.model, params, "enc", torch.cat([feat, a], -1))
            mu, logvar = mo[:, :L], mo[:, L:]
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator,
                                  device=mu.device)
            z = mu + torch.exp(0.5 * logvar) * eps
            rec = _call(self.model, params, "dec", torch.cat([feat, z], -1))
            kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
            return torch.mean((rec - a) ** 2) + self.kl_weight * kl

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); z's standard-normal draws [B, latent] come from
        ``generator``, or are ``draws`` when given."""
        def apply(params, carry, obs, draws=None):
            feat = self.encode(params, obs)
            if draws is None:
                draws = torch.randn((feat.shape[0], self.latent_dim),
                                    generator=generator, device=feat.device)
            a = _call(self.model, params, "dec", torch.cat([feat, draws], -1))
            return carry, _unscale(self.scaler, a)

        return apply


@dataclass
class VisionBesoAgent(_VisionAgent):
    """beso vision variant: EDM denoising on the encoder features with the
    state agent's samplers."""
    n_steps: int = 8
    sampler: str = "euler_ancestral"
    schedule: str = "exponential"

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, render_fn, low_dim=4,
               hidden_dim=256, num_hidden_layers=4, n_steps=8,
               sampler="euler_ancestral", schedule="exponential", **_):
        model = _VisionAgent._net(
            generator, scaler, low_dim, score=lambda f: ScoreMLP(
                f, hidden_dim, num_hidden_layers, action_dim,
                generator=generator))
        return VisionBesoAgent(model, base.params_of(model), scaler,
                               render_fn, n_steps=n_steps, sampler=sampler,
                               schedule=schedule)

    def loss_fn(self):
        score = self.model.score

        def loss(params, obs_w, act_w, generator=None, u=None, noise=None):
            """``u`` [B]: the sigma density's uniform draws (see
            rand_log_logistic); ``noise`` [B, Da]: normals."""
            feat = self.encode(params, obs_w[:, -1])
            a0 = self.scaler.scale_output(act_w[:, -1])
            sigma = rand_log_logistic(generator, (a0.shape[0],), u)
            if noise is None:
                noise = torch.randn(a0.shape, generator=generator,
                                    device=a0.device)
            den = edm_denoise(score, _sub(params, "score"), feat,
                              a0 + sigma[:, None] * noise, sigma)
            w = (sigma ** 2 + SIGMA_DATA ** 2) / (sigma * SIGMA_DATA) ** 2
            return torch.mean(w[:, None] * (den - a0) ** 2)

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); ``draws`` = (a_T [B, Da] unit normals, the sampler's
        draws or None), from ``generator`` unless given."""
        sigmas = SIGMA_SCHEDULES[self.schedule](self.n_steps)
        sampler, score = SAMPLERS[self.sampler], self.model.score

        def apply(params, carry, obs, draws=None):
            feat = self.encode(params, obs)
            B, p = feat.shape[0], _sub(params, "score")
            a0, zs = (None, None) if draws is None else draws
            if a0 is None:
                a0 = torch.randn((B, self.scaler.y_mean.shape[-1]),
                                 generator=generator, device=feat.device)

            def denoise(a, sigma):
                return edm_denoise(score, p, feat, a,
                                   torch.broadcast_to(sigma, (B,)))

            a = sampler(denoise, a0 * SIGMA_MAX, sigmas, generator, zs)
            return carry, _unscale(self.scaler, a)

        return apply


@dataclass
class VisionACTAgent(_VisionAgent):
    """act vision variant: the state ACT head with the encoder features
    standing in for the state vector; chunked replay at inference."""
    chunk: int = 8
    kl_weight: float = 10.0

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, render_fn, low_dim=4,
               chunk=8, embed_dim=64, latent_dim=32, kl_weight=10.0, **_):
        model = _VisionAgent._net(
            generator, scaler, low_dim, act=lambda f: ACTNet(
                f, embed_dim, latent_dim=latent_dim, chunk=chunk,
                action_dim=action_dim, generator=generator))
        return VisionACTAgent(model, base.params_of(model), scaler,
                              render_fn, chunk=chunk, kl_weight=kl_weight)

    @property
    def train_window(self):
        """1 obs + chunk actions from the dataset sampler."""
        return self.chunk

    def loss_fn(self):
        def loss(params, obs_w, act_w, generator=None, eps=None):
            """The chunk reconstructed from the window's first obs; ``eps``
            [B, latent] the reparameterisation's normals."""
            feat = self.encode(params, obs_w[:, 0])
            chunk = self.scaler.scale_output(act_w)
            if eps is None:
                eps = torch.randn((feat.shape[0],
                                   self.model.act.latent_dim),
                                  generator=generator, device=feat.device)
            pred, mu, logvar = _call(self.model, params, "act", feat, chunk,
                                     eps)
            kl = -0.5 * torch.mean(torch.sum(
                1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))
            return torch.mean((pred - chunk) ** 2) + self.kl_weight * kl

        return loss

    def policy_apply(self, generator=None):
        """(params, carry, obs [B, Do]) -> (carry, action [B, Da]): a decode
        at z = 0 every step, taken where the buffer is spent."""
        act = self.model.act

        def apply(params, carry, obs):
            feat = self.encode(params, obs)
            z = feat.new_zeros((feat.shape[0], act.latent_dim))
            new = base.call_method(act, _sub(params, "act"), "decode", feat,
                                   z)
            carry, a = chunk_step(carry, new, self.chunk)
            return carry, _unscale(self.scaler, a)

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_chunk(batch, self.chunk, self.model.act.action_dim,
                          self.scaler.x_mean.device)


@dataclass
class VisionDDPMEncDecAgent(_VisionAgent):
    """ddpm_encdec vision variant: the chunked enc-dec denoiser on the
    encoder features; a new chunk sampled every step, taken where the
    replay buffer is spent."""
    chunk: int = 8
    n_timesteps: int = 16

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, render_fn, low_dim=4,
               chunk=8, embed_dim=96, n_timesteps=16, **_):
        model = _VisionAgent._net(
            generator, scaler, low_dim, den=lambda f: EncDecDenoiser(
                f, embed_dim, chunk=chunk, action_dim=action_dim,
                generator=generator))
        return VisionDDPMEncDecAgent(model, base.params_of(model), scaler,
                                     render_fn, chunk=chunk,
                                     n_timesteps=n_timesteps)

    @property
    def train_window(self):
        return self.chunk

    def schedule(self) -> Schedule:
        return Schedule(self.n_timesteps, self.scaler.x_mean.device)

    def loss_fn(self):
        T, abar = self.n_timesteps, self.schedule().abar

        def loss(params, obs_w, act_w, generator=None, t=None, eps=None):
            """``t`` [B], ``eps`` [B, C, Da]: the steps and the noise."""
            feat = self.encode(params, obs_w[:, 0])
            return diffusion_loss(
                lambda a_t, tt: _call(self.model, params, "den", feat, a_t,
                                      tt),
                self.scaler.scale_output(act_w), T, abar, generator, t, eps)

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]); ``draws`` [T + 1, B, C, Da]: the chunk's reverse
        diffusion draws."""
        sched, scaler, C = self.schedule(), self.scaler, self.chunk
        lo, hi = scaler.y_bounds[0] * 1.1, scaler.y_bounds[1] * 1.1
        den = self.model.den

        def apply(params, carry, obs, draws=None):
            feat = self.encode(params, obs)
            B, p = feat.shape[0], _sub(params, "den")

            def denoise(a, t):
                tt = torch.full((B,), t, dtype=torch.int64, device=a.device)
                return functional_call(den, p, (feat, a, tt))

            new = reverse_diffusion(denoise, sched,
                                    (B, C, den.action_dim), lo, hi,
                                    generator, draws)
            carry, a = chunk_step(carry, new, C)
            return carry, _unscale(scaler, a)

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        return init_chunk(batch, self.chunk, self.model.den.action_dim,
                          self.scaler.x_mean.device)


@dataclass
class VisionIBCAgent(_VisionAgent):
    """ibc vision variant: the EBM E(features, a) with the InfoNCE loss;
    the samplers of agents/ibc.py minimise it over the encoded features."""
    n_negatives: int = 8
    n_infer_samples: int = 64
    sampler: str = "dfo"

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, render_fn, low_dim=4,
               hidden_dim=256, num_hidden_layers=4, sampler="dfo", **_):
        model = _VisionAgent._net(
            generator, scaler, low_dim, ebm=lambda f: EBM(
                f, action_dim, hidden_dim, num_hidden_layers,
                generator=generator))
        return VisionIBCAgent(model, base.params_of(model), scaler,
                              render_fn, sampler=sampler)

    def _bounds(self):
        return (self.scaler.y_bounds[0] * 1.1, self.scaler.y_bounds[1] * 1.1)

    def loss_fn(self):
        K, (lo, hi) = self.n_negatives, self._bounds()

        def loss(params, obs_w, act_w, generator=None, neg=None):
            """InfoNCE over the demo action and K negatives; ``neg``
            [B, K, Da] the negatives' uniform draws in [0, 1)."""
            feat = self.encode(params, obs_w[:, -1])
            a_pos = self.scaler.scale_output(act_w[:, -1])
            if neg is None:
                neg = torch.rand((feat.shape[0], K, a_pos.shape[-1]),
                                 generator=generator, device=feat.device)
            a_all = torch.cat([a_pos[:, None], neg * (hi - lo) + lo], dim=1)
            e = _energy(self.model.ebm, _sub(params, "ebm"), feat, a_all)
            return -torch.mean(torch.log_softmax(-e, dim=1)[:, 0])

        return loss

    def policy_apply(self, generator: torch.Generator):
        """(params, carry, obs [B, Do], draws=None) -> (carry, action
        [B, Da]) by the agent's sampler on the features; ``draws`` as the
        sampler takes them."""
        fn = langevin_sample if self.sampler == "langevin" else dfo_sample
        N, bounds = self.n_infer_samples, self._bounds()
        Da = self.scaler.y_mean.shape[-1]

        def apply(params, carry, obs, draws=None):
            feat = self.encode(params, obs)
            a = fn(self.model.ebm, _sub(params, "ebm"), feat, generator, N,
                   Da, bounds, draws=draws)
            return carry, _unscale(self.scaler, a)

        return apply


@dataclass
class VisionGPTBCAgent(_VisionAgent):
    """gpt_bc vision variant: the per-frame encoder + a causal GPT over the
    window of features. The policy carries the ENCODED feature window: one
    encoder pass per env step."""
    feat_dim: int = 0
    window_size: int = 5

    @staticmethod
    def create(generator, obs_dim, action_dim, scaler, render_fn, low_dim=4,
               n_embd=120, n_head=4, n_layer=4, window_size=5, **_):
        model = _VisionAgent._net(
            generator, scaler, low_dim, gpt=lambda f: GPT(
                f, n_embd, n_head, n_layer, window_size, action_dim,
                generator=generator))
        return VisionGPTBCAgent(model, base.params_of(model), scaler,
                                render_fn,
                                feat_dim=model.core.feature_dim(low_dim),
                                window_size=window_size)

    def loss_fn(self):
        def loss(params, obs_w, act_w, generator=None):
            B, W = obs_w.shape[:2]
            feats = self.encode(params, obs_w.reshape(B * W, -1))
            pred = _call(self.model, params, "gpt", feats.reshape(B, W, -1))
            return torch.mean((pred - self.scaler.scale_output(act_w)) ** 2)

        return loss

    def policy_apply(self, generator=None):
        """(params, carry, obs [B, Do]) -> (carry, action [B, Da]);
        deterministic. Before the window fills, every slot holds the first
        frame's features."""
        def apply(params, carry, obs):
            feats, filled = push_window(carry, self.encode(params, obs),
                                        self.window_size)
            pred = _call(self.model, params, "gpt", feats)[:, -1]
            return (feats, filled), _unscale(self.scaler, pred)

        return apply

    def init_carry(self, obs_dim: int, batch: int):
        dev = self.scaler.x_mean.device
        return (torch.zeros((batch, self.window_size, self.feat_dim),
                            device=dev),
                torch.zeros(batch, dtype=torch.int32, device=dev))
