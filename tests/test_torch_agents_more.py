"""The nine further state agents of the port against the JAX package's:
GPT-BC, BeT (GPT and MLP heads), ACT, CVAE, LSTM-GMM, IBC, DDPM and
DDPM-encdec.

Each agent is built small on both sides (hidden 16, 2 layers or blocks,
n_embd 16, 2 heads, chunk 3, T = 4) and the Flax weights are carried across
by ``convert.agent_params_from_numpy``. ``jax.random`` and
``torch.Generator`` give different streams, so every draw a function makes
is taken from the JAX side's keys, split exactly as the JAX function splits
them, and passed to the port: the loss with JAX's draws (1e-5 relative),
the policy's action and carry over 3 steps of B = 3 episodes against the
JAX policy per episode (1e-5 absolute), one optimizer step against optax
(2e-5 absolute, as tests/test_torch_agents.py's clip test). A categorical
draw is the argmax of the logits plus standard Gumbel draws, which is how
``jax.random.categorical`` draws it.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from test_torch_jaxref import assert_scaled, tiny_agents

from d3il_tpu.agents import base as jbase
from d3il_tpu.agents import bet as jbet
from d3il_tpu.agents import ibc as jibc
from d3il_tpu_torch import convert
from d3il_tpu_torch.agents import base, bet, ibc

OBS, ACT, B, STEPS = 10, 2, 3, 3
ACTS = np.random.default_rng(11).normal(size=(40, ACT)).astype(np.float32)
GPT = dict(n_embd=16, n_head=2, n_layer=2)
AGENT_KW = {
    "gpt_bc": dict(GPT, window_size=3),
    "bet": dict(GPT, window_size=3, n_bins=4, train_actions_scaled=ACTS),
    "bet_mlp": dict(window_size=2, n_bins=4, train_actions_scaled=ACTS),
    "act": dict(chunk=3, embed_dim=16, latent_dim=4),
    "cvae": dict(latent_dim=4, window_size=2),
    "lstm_gmm": dict(window_size=3, n_gaussians=3),
    "ibc": dict(window_size=1),
    "ddpm": dict(n_timesteps=4, window_size=2),
    "ddpm_encdec": dict(chunk=3, embed_dim=16, n_timesteps=4),
}
NAMES = list(AGENT_KW)
_AGENTS = {}


def agents(name):
    """(JAX agent, port agent) of ``name``, built once per module."""
    if name not in _AGENTS:
        _AGENTS[name] = tiny_agents(name, **AGENT_KW[name])
    return _AGENTS[name]


def train_window(agent):
    return getattr(agent, "train_window", None) or agent.window_size


def _batch(seed, n, window):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, window, OBS)).astype(np.float32),
            (0.005 * rng.normal(size=(n, window, ACT))).astype(np.float32))


# ---- the draws the JAX loss makes from its key ---------------------------

def loss_draws(name, jagent, key, n):
    """kwargs of the port's loss holding the JAX loss's draws at ``key``
    for a minibatch of n."""
    if name == "act":
        return {"eps": jax.random.normal(key, (n, jagent.model.latent_dim))}
    if name == "cvae":
        return {"eps": jax.random.normal(key, (n, jagent.model.latent_dim))}
    if name == "ibc":
        return {"neg": jax.random.uniform(key, (n, jagent.n_negatives, ACT))}
    if name in ("ddpm", "ddpm_encdec"):
        k1, k2 = jax.random.split(key)
        t = jax.random.randint(k1, (n,), 0, jagent.n_timesteps)
        shape = (n, jagent.chunk, ACT) if name == "ddpm_encdec" else (n, ACT)
        return {"t": t, "eps": jax.random.normal(k2, shape)}
    return {}


def _torch(kw):
    return {k: torch.from_numpy(np.array(v)) for k, v in kw.items()}


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches(name):
    """The loss on a minibatch of 12 windows, the port given the JAX
    loss's draws: 1e-5 relative."""
    jagent, agent = agents(name)
    obs, act = _batch(1, 12, train_window(agent))
    key = jax.random.PRNGKey(7)
    jl = jax.jit(jagent.loss_fn())(jagent.params, jnp.asarray(obs),
                                   jnp.asarray(act), key)
    l = agent.loss_fn()(agent.params, torch.from_numpy(obs),
                        torch.from_numpy(act), None,
                        **_torch(loss_draws(name, jagent, key, 12)))
    np.testing.assert_allclose(l.item(), float(jl), rtol=1e-5)


# ---- the draws the JAX policy makes from its carry's key -----------------

def _diffusion_noise(key, T, shape):
    """A JAX reverse diffusion's normal draws from its key: the initial
    sample, then one per step."""
    key, k0 = jax.random.split(key)
    out = [jax.random.normal(k0, shape)]
    for _ in range(T):
        key, kn = jax.random.split(key)
        out.append(jax.random.normal(kn, shape))
    return np.stack([np.asarray(x)[0] for x in out])


def policy_draws(name, jagent, key):
    """One episode's draws of one JAX policy step from its carry's key, in
    the port's layout without the batch axis (None: deterministic)."""
    if name in ("bet", "bet_mlp"):
        _, k1 = jax.random.split(key)
        return np.asarray(jax.random.gumbel(k1, (jagent.centers.shape[0],)))
    if name == "cvae":
        _, sub = jax.random.split(key)
        return np.asarray(jax.random.normal(sub,
                                            (jagent.model.latent_dim,)))
    if name == "lstm_gmm":
        _, k1, k2 = jax.random.split(key, 3)
        K = jagent.model.n_gaussians
        return (np.asarray(jax.random.gumbel(k1, (K,))),
                np.asarray(jax.random.normal(k2, (ACT,))))
    if name == "ibc":
        _, k1 = jax.random.split(key)
        k0, key = jax.random.split(k1)
        N = jagent.n_infer_samples
        u0 = np.asarray(jax.random.uniform(k0, (N, ACT)))
        gs, ns = [], []
        for k in jax.random.split(key, 3):
            ka, kb = jax.random.split(k)
            gs.append(np.asarray(jax.random.gumbel(ka, (N, N))))
            ns.append(np.asarray(jax.random.normal(kb, (N, ACT))))
        return u0, np.stack(gs), np.stack(ns)
    if name == "ddpm":
        _, sub = jax.random.split(key)
        return _diffusion_noise(sub, jagent.n_timesteps, (1, ACT))
    if name == "ddpm_encdec":
        _, sub = jax.random.split(key)
        return _diffusion_noise(sub, jagent.n_timesteps,
                                (1, jagent.chunk, ACT))
    return None


def _stack_draws(per_env, axis):
    """The episodes' draws stacked on the batch axis (``axis`` of each
    array: 0, or 1 where the port's draws lead with a step axis)."""
    if per_env[0] is None:
        return None
    if isinstance(per_env[0], tuple):
        return tuple(_stack_draws([d[i] for d in per_env], axis[i])
                     for i in range(len(per_env[0])))
    return torch.from_numpy(np.stack(per_env, axis=axis))


# batch axis of each draw array in the port's layout
DRAW_AXES = {"ibc": (0, 1, 1), "lstm_gmm": (0, 0), "ddpm": 1,
             "ddpm_encdec": 1}


def _carry_pairs(name, carry, jcarries):
    """(port tensor, JAX array stacked over episodes) per carry leaf, the
    JAX key left out."""
    if name == "lstm_gmm":
        return [(carry[i][j], np.concatenate(
            [np.asarray(jc[0][i][j]) for jc in jcarries]))
            for i in range(len(carry)) for j in range(2)]
    return [(carry[i], np.stack([np.asarray(jc[i]) for jc in jcarries]))
            for i in range(len(carry))]


@pytest.mark.parametrize("name", NAMES)
def test_policy_matches(name):
    """B = 3 episodes for 3 steps: the port's batched policy, given each
    episode's JAX draws, against the JAX policy per episode: actions 1e-5
    absolute, every carry leaf alike (the windows, fill counts and chunk
    indices exactly; the chunk buffer and the LSTM's (c, h) 1e-5)."""
    jagent, agent = agents(name)
    seq = np.random.default_rng(2).normal(size=(STEPS, B, OBS)).astype(
        np.float32)
    apply, carry = agent.policy_apply(None), agent.init_carry(OBS, B)
    japply = jax.jit(jagent.policy_apply())
    jcarry = [jagent.init_carry(OBS, jax.random.PRNGKey(100 + e))
              for e in range(B)]
    for t in range(STEPS):
        per_env = [policy_draws(name, jagent, jc[-1]) for jc in jcarry]
        draws = _stack_draws(per_env, DRAW_AXES.get(name, 0))
        kw = {} if draws is None else {"draws": draws}
        carry, a = apply(agent.params, carry, torch.from_numpy(seq[t]), **kw)
        ja = []
        for e in range(B):
            jcarry[e], x = japply(jagent.params, jcarry[e],
                                  jnp.asarray(seq[t, e]))
            ja.append(np.asarray(x))
        np.testing.assert_allclose(a.detach().numpy(), np.stack(ja),
                                   atol=1e-5, err_msg=f"step {t}")
        for got, want in _carry_pairs(name, carry, jcarry):
            if got.is_floating_point():
                np.testing.assert_allclose(got.detach().numpy(), want,
                                           atol=1e-5, err_msg=f"step {t}")
            else:
                np.testing.assert_array_equal(got.numpy(), want)


# below this gradient magnitude Adam's first step, lr g / (|g| + 1e-8), is
# set by float32 rounding: the attention's key bias has a gradient of
# exactly zero (the softmax ignores a shift common to every score), which
# each side computes as noise of ~1e-9
NOISE_GRAD = 1e-6


@pytest.mark.parametrize("name", NAMES)
def test_one_optimizer_step_matches_optax(name):
    """One step of Adam behind the global-norm clip on a fixed minibatch of
    32, the port's loss given the JAX loss's draws: the gradients 5e-5
    max-scaled, every updated weight 2e-5 absolute where the gradient is
    above NOISE_GRAD (below it both gradients must be, and the weight is
    held to its lr bound), and the step moves the weights."""
    jagent, agent = agents(name)
    obs, act = _batch(8, 32, train_window(agent))
    key = jax.random.PRNGKey(9)
    tx = jbase.make_optimizer(jbase.TrainConfig(lr=1e-3))

    @jax.jit
    def jstep(p, o, a):
        grads = jax.grad(jagent.loss_fn())(p, o, a, key)
        updates, _ = tx.update(grads, tx.init(p), p)
        return grads, optax.apply_updates(p, updates)

    jgrads, jnew = (convert.agent_params_from_numpy(
        name, jax.tree_util.tree_map(np.asarray, x), "cpu")
        for x in jstep(jagent.params, jnp.asarray(obs), jnp.asarray(act)))
    params = {k: v.clone().requires_grad_(True)
              for k, v in agent.params.items()}
    opt = base.make_optimizer(base.TrainConfig(lr=1e-3), params)
    loss = functools.partial(agent.loss_fn(),
                             **_torch(loss_draws(name, jagent, key, 32)))
    grads = {}

    def loss_keeping_grads(p, o, a, g):
        out = loss(p, o, a, g)
        grads.update(zip(p, torch.autograd.grad(out, list(p.values()),
                                                retain_graph=True)))
        return out

    base.train_step(loss_keeping_grads, params, opt, torch.from_numpy(obs),
                    torch.from_numpy(act), None)
    assert set(params) == set(jnew)
    moved = 0.0
    for k in params:
        g, jg = grads[k].numpy(), jgrads[k].numpy()
        assert_scaled(g, jg, 5e-5, k)
        sure = np.abs(jg) > NOISE_GRAD
        assert (np.abs(g[~sure]) <= 10 * NOISE_GRAD).all(), k
        new, jw = params[k].detach().numpy(), jnew[k].numpy()
        np.testing.assert_allclose(new[sure], jw[sure], atol=2e-5,
                                   err_msg=k)
        old = agent.params[k].numpy()
        assert (np.abs(new - old)[~sure] <= 1e-3 + 1e-7).all(), k
        moved = max(moved, np.abs(new - old).max())
    assert moved > 5e-4


def test_kmeans_fit_equal():
    """BeT's bins: the port's NumPy k-means equals the JAX package's on
    the same actions (64 bins of 2,000 seeded actions), and the agents hold
    the same centers."""
    acts = np.random.default_rng(3).normal(size=(2000, ACT)).astype(
        np.float32)
    np.testing.assert_array_equal(bet.kmeans_fit(acts, 64),
                                  jbet.kmeans_fit(acts, 64))
    for name in ("bet", "bet_mlp"):
        jagent, agent = agents(name)
        np.testing.assert_array_equal(agent.centers.numpy(),
                                      np.asarray(jagent.centers))


def test_focal_loss_equal():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 5, 4)).astype(np.float32)
    tgt = rng.integers(0, 4, (6, 5))
    np.testing.assert_allclose(
        bet.focal_loss(torch.from_numpy(logits), torch.from_numpy(tgt)).numpy(),
        np.asarray(jbet.focal_loss(jnp.asarray(logits), jnp.asarray(tgt))),
        rtol=1e-5, atol=1e-7)


def test_langevin_sample_matches():
    """IBC's Langevin sampler (no agent policy takes it by default) with
    the JAX sampler's draws: for each of B = 3 observations, 16 samples,
    5 iterations, the chosen action 1e-5 absolute."""
    jagent, agent = agents("ibc")
    s = np.random.default_rng(5).normal(size=(B, OBS)).astype(np.float32)
    bounds = jagent._bounds()
    N, iters = 16, 5
    want, u0s, noises = [], [], []
    for e in range(B):
        key = jax.random.PRNGKey(30 + e)
        want.append(np.asarray(jibc.langevin_sample(
            jagent.model, jagent.params, jnp.asarray(s[e]), key, N, ACT,
            bounds, n_iters=iters)))
        kb, kn = jax.random.split(key)
        u0s.append(np.asarray(jax.random.uniform(kb, (N, ACT))))
        noises.append(np.stack([np.asarray(jax.random.normal(k, (N, ACT)))
                                for k in jax.random.split(kn, iters)]))
    got = ibc.langevin_sample(
        agent.model, agent.params, torch.from_numpy(s), None, N, ACT,
        agent._bounds(), n_iters=iters,
        draws=(torch.from_numpy(np.stack(u0s)),
               torch.from_numpy(np.stack(noises, axis=1))))
    np.testing.assert_allclose(got.detach().numpy(), np.stack(want),
                               atol=1e-5)


def test_draw_categorical_is_the_gumbel_argmax():
    """The port's categorical draw: argmax(logits + Gumbel), the same index
    as jax.random.categorical at the same Gumbel draws; drawn from the
    generator it follows the softmax (10,000 draws within 2 %)."""
    logits = np.log(np.array([[0.1, 0.2, 0.7]], np.float32))
    key = jax.random.PRNGKey(0)
    g = np.asarray(jax.random.gumbel(key, (3,)))
    assert int(base.draw_categorical(torch.from_numpy(logits), None,
                                     torch.from_numpy(g[None].copy()))[0]) == \
        int(jax.random.categorical(key, jnp.asarray(logits[0])))
    draws = base.draw_categorical(
        torch.from_numpy(logits).expand(10000, 3),
        torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=3).numpy() / 10000
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.02)
