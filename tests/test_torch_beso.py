"""The port's BESO agent against the JAX package's: the sigma schedules and
density, the EDM denoiser on both backbones, the loss, one optimizer step,
the 14 samplers, the policy, and pushing's transformer override through
the entry points.

Both agents are built small (hidden 16, 2 layers; the GPT n_embd 16, 1
layer, 2 heads, window 3) with the Flax weights carried across by
``convert.agent_params_from_numpy``. Every random draw the JAX function
makes is taken from its keys, split as it splits them, and passed to the
port. The JAX samplers run under ``jax.disable_jit()`` (their scans then
run as Python loops, per env under ``vmap``) with only the denoiser
jitted, and the adaptive controller's ``while_loop`` as a Python loop that
records each step: no sampler is compiled whole.
"""
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from test_torch_agents_more import NOISE_GRAD
from test_torch_jaxref import assert_scaled, tiny_agents

from d3il_tpu.agents import base as jbase
from d3il_tpu.agents import beso as jbeso
from d3il_tpu_torch import convert
from d3il_tpu_torch.agents import base, beso

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS, ACT, B, STEPS, N_STEPS = 10, 2, 4, 3, 4
BACKBONES = {
    "mlp": dict(window_size=2, n_steps=N_STEPS),
    "gpt": dict(backbone="gpt", n_embd=16, n_head=2, n_layer=1,
                window_size=3, n_steps=N_STEPS),
}
_AGENTS = {}


def agents(backbone):
    """(JAX agent, port agent) of ``backbone``, built once per module."""
    if backbone not in _AGENTS:
        _AGENTS[backbone] = tiny_agents("beso", **BACKBONES[backbone])
    return _AGENTS[backbone]


def _batch(seed, n, window):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, window, OBS)).astype(np.float32),
            (0.005 * rng.normal(size=(n, window, ACT))).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", sorted(jbeso.SIGMA_SCHEDULES))
@pytest.mark.parametrize("n", [1, 4, 8])
def test_schedules_equal(name, n):
    np.testing.assert_array_equal(beso.SIGMA_SCHEDULES[name](n),
                                  np.asarray(jbeso.SIGMA_SCHEDULES[name](n)))


def test_rand_log_logistic_matches():
    """The sigma density given JAX's uniform draw: 1e-6 relative, and the
    draws lie in [SIGMA_MIN, SIGMA_MAX]."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(jbeso.rand_log_logistic(key, (64,)))
    lo = jax.nn.sigmoid((np.log(jbeso.SIGMA_MIN) - jbeso.DENSITY_LOC)
                        / jbeso.DENSITY_SCALE)
    hi = jax.nn.sigmoid((np.log(jbeso.SIGMA_MAX) - jbeso.DENSITY_LOC)
                        / jbeso.DENSITY_SCALE)
    u = jax.random.uniform(key, (64,), minval=lo, maxval=hi)
    got = beso.rand_log_logistic(None, (64,), _t(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    drawn = beso.rand_log_logistic(torch.Generator().manual_seed(0),
                                   (10000,))
    assert drawn.min() >= beso.SIGMA_MIN * (1 - 1e-5)
    assert drawn.max() <= beso.SIGMA_MAX * (1 + 1e-5)


def _obs_act(agent, seed, n):
    """Scaled observations and noised actions in the backbone's layout."""
    rng = np.random.default_rng(seed)
    W = agent.window_size
    if agent.backbone == "gpt":
        s = rng.normal(size=(n, W, OBS)).astype(np.float32)
        a = rng.normal(size=(n, W, ACT)).astype(np.float32)
    else:
        s = rng.normal(size=(n, W * OBS)).astype(np.float32)
        a = rng.normal(size=(n, ACT)).astype(np.float32)
    sigma = np.exp(rng.uniform(np.log(0.01), 0.0, n)).astype(np.float32)
    return s, a, sigma


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_edm_denoise_matches(backbone):
    """Both backbones through convert, preconditioned: 1e-5 absolute."""
    jagent, agent = agents(backbone)
    s, a, sigma = _obs_act(agent, 1, 6)
    want = jax.jit(functools.partial(jbeso.edm_denoise, jagent.model))(
        jagent.params, jnp.asarray(s), jnp.asarray(a), jnp.asarray(sigma))
    got = beso.edm_denoise(agent.model, agent.params, _t(s), _t(a),
                           _t(sigma))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def loss_draws(jagent, key, n):
    """The port loss's kwargs holding the JAX loss's draws at ``key``."""
    k1, k2 = jax.random.split(key)
    lo = jax.nn.sigmoid((np.log(jbeso.SIGMA_MIN) - jbeso.DENSITY_LOC)
                        / jbeso.DENSITY_SCALE)
    hi = jax.nn.sigmoid((np.log(jbeso.SIGMA_MAX) - jbeso.DENSITY_LOC)
                        / jbeso.DENSITY_SCALE)
    shape = (n, jagent.window_size, ACT) if jagent.backbone == "gpt" \
        else (n, ACT)
    return {"u": _t(jax.random.uniform(k1, (n,), minval=lo, maxval=hi)),
            "noise": _t(jax.random.normal(k2, shape))}


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_loss_matches(backbone):
    """The EDM-weighted loss on 12 windows with JAX's draws: 1e-5
    relative."""
    jagent, agent = agents(backbone)
    obs, act = _batch(1, 12, agent.window_size)
    key = jax.random.PRNGKey(7)
    jl = jax.jit(jagent.loss_fn())(jagent.params, jnp.asarray(obs),
                                   jnp.asarray(act), key)
    l = agent.loss_fn()(agent.params, _t(obs), _t(act), None,
                        **loss_draws(jagent, key, 12))
    np.testing.assert_allclose(l.item(), float(jl), rtol=1e-5)


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_one_optimizer_step_matches_optax(backbone):
    """One clipped Adam step on a minibatch of 32 with JAX's draws, as
    tests/test_torch_agents_more.py holds the other agents: gradients 5e-5
    max-scaled, updated weights 2e-5 absolute where the gradient is above
    NOISE_GRAD (the attention's key bias has a gradient of exactly zero,
    which each side computes as float32 noise; there both gradients must
    be below it and the weight is held to its lr bound), and the weights
    move."""
    jagent, agent = agents(backbone)
    obs, act = _batch(8, 32, agent.window_size)
    key = jax.random.PRNGKey(9)
    tx = jbase.make_optimizer(jbase.TrainConfig(lr=1e-3))

    @jax.jit
    def jstep(p, o, a):
        grads = jax.grad(jagent.loss_fn())(p, o, a, key)
        updates, _ = tx.update(grads, tx.init(p), p)
        return grads, optax.apply_updates(p, updates)

    jgrads, jnew = (convert.agent_params_from_numpy(
        "beso", jax.tree_util.tree_map(np.asarray, x), "cpu")
        for x in jstep(jagent.params, jnp.asarray(obs), jnp.asarray(act)))
    params = {k: v.clone().requires_grad_(True)
              for k, v in agent.params.items()}
    opt = base.make_optimizer(base.TrainConfig(lr=1e-3), params)
    loss = functools.partial(agent.loss_fn(), **loss_draws(jagent, key, 32))
    grads = {}

    def loss_keeping_grads(p, o, a, g):
        out = loss(p, o, a, g)
        grads.update(zip(p, torch.autograd.grad(out, list(p.values()),
                                                retain_graph=True)))
        return out

    base.train_step(loss_keeping_grads, params, opt, _t(obs), _t(act), None)
    assert set(params) == set(jnew)
    moved = 0.0
    for k in params:
        g, jg = grads[k].numpy(), jgrads[k].numpy()
        assert_scaled(g, jg, 5e-5, k)
        sure = np.abs(jg) > NOISE_GRAD
        assert (np.abs(g[~sure]) <= 10 * NOISE_GRAD).all(), k
        new, old = params[k].detach().numpy(), agent.params[k].numpy()
        np.testing.assert_allclose(new[sure], jnew[k].numpy()[sure],
                                   atol=2e-5, err_msg=k)
        assert (np.abs(new - old)[~sure] <= 1e-3 + 1e-7).all(), k
        moved = max(moved, np.abs(new - old).max())
    assert moved > 5e-4


# ---- the samplers ---------------------------------------------------------

# the normals a stochastic sampler draws per step from its key (the others
# draw none)
SAMPLER_DRAWS = {"euler_ancestral": 1, "dpmpp_2s_ancestral": 1,
                 "dpm_2_ancestral": 1, "dpmpp_2m_sde": 1, "dpmpp_sde": 2}

def _sampler_draws(name, key, n, shape):
    """One env's normal draws of JAX sampler ``name`` from its key, in the
    port's layout without the batch axis (None: it draws nothing)."""
    per_step = SAMPLER_DRAWS.get(name)
    if per_step is None:
        return None
    out = []
    for _ in range(n):
        key, *ks = jax.random.split(key, per_step + 1)
        z = [np.asarray(jax.random.normal(k, shape))[0] for k in ks]
        out.append(z[0] if per_step == 1 else np.stack(z))
    return np.stack(out)


def _sampler_inputs(seed):
    """B envs' scaled observations and starting actions (MLP backbone)."""
    jagent, agent = agents("mlp")
    rng = np.random.default_rng(seed)
    return (jagent, agent, rng.normal(size=(B, 2 * OBS)).astype(np.float32),
            rng.normal(size=(B, ACT)).astype(np.float32))


_EDM = {}


def _jax_edm(jagent):
    if id(jagent) not in _EDM:
        _EDM[id(jagent)] = jax.jit(functools.partial(jbeso.edm_denoise,
                                                     jagent.model))
    return _EDM[id(jagent)]


def _jax_denoise(jagent, s_env):
    """The JAX policy's per-env denoiser, jitted alone (jit re-enabled
    inside the samplers' ``disable_jit``: their loops stay Python)."""
    def denoise(a, sigma):
        with jax.disable_jit(False):
            return _jax_edm(jagent)(jagent.params, s_env[None], a,
                                    jnp.broadcast_to(sigma, (1,)))
    return denoise


def _port_denoise(agent, s):
    def denoise(a, sigma):
        return beso.edm_denoise(agent.model, agent.params, s, a,
                                torch.broadcast_to(sigma, (s.shape[0],)))
    return denoise


@pytest.mark.parametrize("name", sorted(jbeso.SAMPLERS))
def test_sampler_matches(name):
    """B = 4 envs, 4 exponential-schedule steps: the port's batched sampler
    given each env's JAX draws against ``jax.vmap`` of the JAX sampler:
    1e-5 absolute in the scaled action space, plus 1e-6 relative. The
    relative part is float32's: dpmpp_2s_ancestral, as the JAX code writes
    its update, scales the midpoint's estimate by sigma / sigma_down - 1
    (3.6 at the third step here), and its actions reach |a| ~ 23, where
    one float32 ulp is 1.9e-6."""
    jagent, agent, s, a0 = _sampler_inputs(5)
    sigmas = jbeso.exponential_sigmas(N_STEPS)
    keys = jax.random.split(jax.random.PRNGKey(21), B)

    def one(s_env, a_env, key):
        return jbeso.SAMPLERS[name](_jax_denoise(jagent, s_env), a_env[None],
                                    sigmas, key)[0]

    with jax.disable_jit():
        want = np.asarray(jax.vmap(one)(jnp.asarray(s), jnp.asarray(a0),
                                        keys))
    per_env = [_sampler_draws(name, k, N_STEPS, (1, ACT)) for k in keys]
    axis = 2 if name == "dpmpp_sde" else 1
    draws = None if per_env[0] is None else _t(np.stack(per_env, axis=axis))
    with torch.no_grad():
        got = beso.SAMPLERS[name](_port_denoise(agent, _t(s)), _t(a0),
                                  beso.exponential_sigmas(N_STEPS), None,
                                  draws)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


def _jax_adaptive_counts(monkeypatch, jagent, s, a0, **kw):
    """Per env, the JAX controller's (accepted steps, iterations): its
    while_loop run as a Python loop that records each step."""
    counts = []

    def while_loop(cond, body, carry):
        acc = it = 0
        while bool(cond(carry)):
            new = body(carry)
            acc += bool(new[2] != carry[2])      # s moves only on accept
            it += 1
            carry = new
        counts.append((acc, it))
        return carry

    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    sigmas = jbeso.exponential_sigmas(N_STEPS)
    outs = []
    for e in range(B):
        outs.append(np.asarray(jbeso.sample_dpm_adaptive(
            _jax_denoise(jagent, jnp.asarray(s[e])),
            jnp.asarray(a0[e:e + 1]), sigmas, None, **kw))[0])
    monkeypatch.undo()
    return np.array(counts), np.stack(outs)


# tolerances of the controller under which these inputs' envs need 6 or 7
# iterations, one env rejecting a step
ADAPTIVE_KW = dict(rtol=0.01, atol=0.002)


def test_dpm_adaptive_steps_per_env(monkeypatch):
    """Each env's accepted steps and iterations equal the JAX controller's
    run for that env alone, and the actions agree within 1e-5, both with
    the default fuse and with a fuse one below the longest env's count:
    there that env stops at the fuse and the others on their own."""
    jagent, agent, s, a0 = _sampler_inputs(3)
    free = _jax_adaptive_counts(monkeypatch, jagent, s, a0, **ADAPTIVE_KW)
    assert (free[0][:, 0] < free[0][:, 1]).any(), free   # a rejected step
    fuse = int(free[0][:, 1].max()) - 1
    cut = free[0][:, 1] > fuse
    assert cut.any() and not cut.all(), free
    for kw in (ADAPTIVE_KW, dict(ADAPTIVE_KW, max_steps=fuse)):
        counts, want = free if kw is ADAPTIVE_KW else _jax_adaptive_counts(
            monkeypatch, jagent, s, a0, **kw)
        denoise = _port_denoise(agent, _t(s))
        with torch.no_grad():
            _, accepted, iters = beso.dpm_adaptive_solve(
                denoise, _t(a0), beso.exponential_sigmas(N_STEPS), **kw)
            got = beso.sample_dpm_adaptive(
                denoise, _t(a0), beso.exponential_sigmas(N_STEPS), **kw)
        np.testing.assert_array_equal(accepted.numpy(), counts[:, 0])
        np.testing.assert_array_equal(iters.numpy(), counts[:, 1])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(iters.numpy(),
                                  np.where(cut, fuse, free[0][:, 1]))


# ---- the policy -----------------------------------------------------------

def policy_draws(jagent, key):
    """One env's draws of one JAX policy step from its carry's key: the
    starting action and the sampler's normals."""
    _, k0, k1 = jax.random.split(key, 3)
    shape = (1, jagent.window_size, ACT) if jagent.backbone == "gpt" \
        else (1, ACT)
    return (np.asarray(jax.random.normal(k0, shape))[0],
            _sampler_draws(jagent.sampler, k1, jagent.n_steps, shape))


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_policy_matches(backbone):
    """B = 4 episodes for 3 steps (the window fills on the way): the port's
    batched policy given each episode's JAX draws against the JAX policy
    per episode: actions and windows 1e-5 absolute, fill counts exactly."""
    jagent, agent = agents(backbone)
    seq = np.random.default_rng(2).normal(size=(STEPS, B, OBS)).astype(
        np.float32)
    apply, carry = agent.policy_apply(None), agent.init_carry(OBS, B)
    japply = jax.jit(jagent.policy_apply())
    jcarry = [jagent.init_carry(OBS, jax.random.PRNGKey(100 + e))
              for e in range(B)]
    for t in range(STEPS):
        per_env = [policy_draws(jagent, jc[-1]) for jc in jcarry]
        draws = (_t(np.stack([d[0] for d in per_env])),
                 _t(np.stack([d[1] for d in per_env], axis=1)))
        with torch.no_grad():
            carry, a = apply(agent.params, carry, _t(seq[t]), draws)
        ja = []
        for e in range(B):
            jcarry[e], x = japply(jagent.params, jcarry[e],
                                  jnp.asarray(seq[t, e]))
            ja.append(np.asarray(x))
        np.testing.assert_allclose(a.numpy(), np.stack(ja), atol=1e-5,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(
            carry[0].numpy(), np.stack([np.asarray(c[0]) for c in jcarry]),
            atol=1e-5)
        np.testing.assert_array_equal(
            carry[1].numpy(), np.stack([np.asarray(c[1]) for c in jcarry]))
    assert int(carry[1].min()) == min(STEPS, agent.window_size)


def test_policy_draws_from_the_generator():
    """Without draws the policy samples from its generator: one seed
    repeats exactly, another differs; the actions are finite."""
    _, agent = agents("gpt")
    obs = _t(np.random.default_rng(3).normal(size=(B, OBS)).astype(
        np.float32))
    out = []
    for seed in (0, 0, 1):
        apply = agent.policy_apply(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            out.append(apply(agent.params, agent.init_carry(OBS, B), obs)[1])
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    assert torch.isfinite(out[0]).all()


def test_pushing_trains_the_gpt_backbone(tmp_path):
    """run_train_torch on pushing with beso takes the task's agent_kw (the
    GPT backbone at window 5), saves it as agent_extra, and
    run_eval_torch.load_agent rebuilds the same agent from it."""
    import run_eval_torch
    import run_train_torch
    ckpt = str(tmp_path / "beso.pt")
    args = run_train_torch.make_args(
        task="pushing", agent="beso", device="cpu", skip_eval=True,
        epochs=1, ckpt=ckpt, data=os.path.join(ROOT, "data"))
    row = run_train_torch.run_one(args)
    assert np.isfinite(row["final_train_loss"])
    assert args.agent_extra == {"backbone": "gpt", "window_size": 5}
    _, agent, meta = run_eval_torch.load_agent(ckpt, "cpu")
    assert meta["agent_extra"] == args.agent_extra
    assert agent.backbone == "gpt" and agent.window_size == 5
    assert isinstance(agent.model, beso.ScoreGPT)
    saved = base.load_checkpoint(ckpt, device="cpu")["params"]
    assert set(agent.params) == set(saved)
    with torch.no_grad():
        obs = torch.zeros((2, 10))
        _, act = agent.policy_apply(torch.Generator().manual_seed(0))(
            agent.params, agent.init_carry(10, 2), obs)
    assert act.shape == (2, 2) and torch.isfinite(act).all()
