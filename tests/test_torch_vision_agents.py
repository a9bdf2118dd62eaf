"""The ten vision agents of the port against the JAX package's
(d3il_tpu/agents/vision.py).

Each agent is built small on both sides at res 32 (the encoder at its
fixed width: ResNet18 width 32, 32 keypoints, 64 features per camera;
heads hidden 32 x 2, GPT n_embd 16 x 2 heads x 2 layers at window 3, ACT
and DDPM-encdec chunk 3, T = 4 diffusion steps, 3 sampler steps). Both
sides see a smooth synthetic view of the same pushing observation
(``jax_view`` / ``port_view``): the task views are held in
tests/test_torch_vision.py, and the JAX ray-caster's trace and compile
would be half of each JAX function's here. The Flax parameter tree comes from ``jax.eval_shape`` of
the module's init, filled from a NumPy seed (LeCun-scaled kernels, GroupNorm
scales around 1, biases and embeddings non-zero, so that a misplaced scale
or bias shows), and is carried across by ``convert.agent_params_from_numpy``,
which must name every port parameter at its shape. ``jax.random`` and
``torch.Generator`` give different streams, so every draw is taken from
the JAX side's keys, split exactly as the JAX function splits them, and
passed to the port. Checks: the loss on B = 4 windows, 1e-4 relative; one
policy step of B = 4 episodes (the JAX policy vmapped over them) from the
initial carry, the scaled actions 1e-4 max-scaled; GPT-BC's carried
feature window over 3 steps, 1e-4 max-scaled, its fill count exactly, and
ACT's chunk buffer and index. Each JAX loss and policy is traced and
compiled once (~2 s each on an idle CPU, most of it tracing the two
ResNet18s).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import assert_scaled, flax_params

from d3il_tpu.agents import beso as jbeso
from d3il_tpu.agents import bet as jbet
from d3il_tpu.agents import vision as jv
from d3il_tpu.data.scaler import Scaler as JScaler
from d3il_tpu_torch import convert, registry

OBS, ACT, LOW, RES, B, W = 10, 2, 4, 32, 4, 3
T_DIFF, CHUNK, N_BINS, K_GMM, LATENT, N_STEPS = 4, 3, 4, 3, 4, 3
HEAD = dict(hidden_dim=32, num_hidden_layers=2)
GPT = dict(n_embd=16, n_head=2, n_layer=2)


def _obs(seed, n):
    """Pushing policy observations: des and tcp xy, then each box's xy
    and tan(yaw), on the table in front of the camera."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform([0.35, -0.25], [0.65, 0.25], (n, 4, 2))
    tan = rng.uniform(-1.0, 1.0, (n, 2, 1))
    boxes = np.concatenate([xy[:, 2:], tan], 2).reshape(n, 6)
    return np.concatenate([xy[:, :2].reshape(n, 4), boxes], 1).astype(
        np.float32)


ACTS = (0.005 * np.random.default_rng(11).normal(size=(40, ACT))).astype(
    np.float32)
JSCALER = JScaler.fit(_obs(12, 32), ACTS[:32])
ACTS_SCALED = np.array(JSCALER.scale_output(jnp.asarray(ACTS)))


def _nets():
    """name -> (JAX agent class, its Flax net, extra init inputs after
    (bp, ih, low), agent fields, port create kwargs)."""
    key = jax.random.PRNGKey(0)
    a, ac = jnp.zeros((1, ACT)), jnp.zeros((1, CHUNK, ACT))
    return {
        "bc_vision": (jv.VisionBCAgent, jv.VisionBCNet(ACT, **HEAD), (), {},
                      HEAD),
        "ddpm_vision": (
            jv.VisionDDPMAgent, jv.VisionDDPMNet(ACT, **HEAD),
            (a, jnp.zeros((1,))), {"n_timesteps": T_DIFF},
            dict(HEAD, n_timesteps=T_DIFF)),
        "bet_mlp_vision": (
            jv.VisionBeTAgent, jv.VisionBeTNet(ACT, n_bins=N_BINS, **HEAD),
            (), {"centers": jnp.asarray(jbet.kmeans_fit(ACTS_SCALED, N_BINS))},
            dict(HEAD, n_bins=N_BINS)),
        "gmm_vision": (
            jv.VisionGMMAgent, jv.VisionGMMNet(ACT, n_gaussians=K_GMM,
                                               **HEAD),
            (), {}, dict(HEAD, n_gaussians=K_GMM)),
        "cvae_vision": (
            jv.VisionCVAEAgent, jv.VisionCVAENet(ACT, latent_dim=LATENT,
                                                 **HEAD),
            (a, key), {}, dict(HEAD, latent_dim=LATENT)),
        "beso_vision": (
            jv.VisionBesoAgent, jv.VisionBesoNet(ACT, **HEAD),
            (a, jnp.ones((1,))), {"n_steps": N_STEPS},
            dict(HEAD, n_steps=N_STEPS)),
        "act_vision": (
            jv.VisionACTAgent, jv.VisionACTNet(CHUNK, ACT, 16, LATENT),
            (ac, key), {"chunk": CHUNK},
            dict(chunk=CHUNK, embed_dim=16, latent_dim=LATENT)),
        "gpt_bc_vision": (
            jv.VisionGPTBCAgent, jv.VisionGPTBCNet(ACT, window=W, **GPT),
            None, {"feat_dim": 2 * 64 + LOW, "window_size": W},
            dict(GPT, window_size=W)),
        "ibc_vision": (jv.VisionIBCAgent, jv.VisionIBCNet(**HEAD),
                       (a,), {}, HEAD),
        "ddpm_encdec_vision": (
            jv.VisionDDPMEncDecAgent, jv.VisionEncDecNet(CHUNK, ACT, 16),
            (ac, jnp.zeros((1,))), {"chunk": CHUNK, "n_timesteps": T_DIFF},
            dict(chunk=CHUNK, embed_dim=16, n_timesteps=T_DIFF)),
    }


NAMES = sorted(_nets())


def jax_view(obs):
    """A smooth pair of images and the low-dim prefix of one pushing
    observation [10], every pixel a function of the tcp and box channels."""
    i = jnp.linspace(0.0, 1.0, RES)[:, None, None]
    j = jnp.linspace(0.0, 1.0, RES)[None, :, None]
    c = jnp.arange(3.0)[None, None, :]

    def img(a, b):
        return 0.5 + 0.5 * jnp.sin(4 * i * (1 + a) + 6 * j * (1 - b)
                                   + 2 * c + 3 * a * b)

    return img(obs[2], obs[4]), img(obs[3], obs[7]), obs[:4]


def port_view(obs):
    """``jax_view`` of a batch [B, 10] in the port."""
    i = torch.linspace(0.0, 1.0, RES)[:, None, None]
    j = torch.linspace(0.0, 1.0, RES)[None, :, None]
    c = torch.arange(3.0)[None, None, :]

    def img(a, b):
        a, b = a[:, None, None, None], b[:, None, None, None]
        return 0.5 + 0.5 * torch.sin(4 * i * (1 + a) + 6 * j * (1 - b)
                                     + 2 * c + 3 * a * b)

    return img(obs[:, 2], obs[:, 4]), img(obs[:, 3], obs[:, 7]), obs[:, :4]


_AGENTS = {}


def agents(name):
    """(JAX agent, port agent, the JAX policy vmapped over episodes and
    jitted) of ``name``, built once per module."""
    if name in _AGENTS:
        return _AGENTS[name]
    cls, net, extra, fields, kw = _nets()[name]
    img = jnp.zeros((1, RES, RES, 3))
    ins = (img, img, jnp.zeros((1, LOW))) + extra if extra is not None else \
        (jnp.zeros((1, W, RES, RES, 3)),) * 2 + (jnp.zeros((1, W, LOW)),)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), *ins)
    jparams = jax.tree_util.tree_map(jnp.asarray, flax_params(shapes, 7))
    jagent = cls(model=net, params=jparams, scaler=JSCALER,
                 render_fn=jax_view, **fields)
    scaler = convert.scaler_from_numpy(JSCALER, "cpu")
    agent, _ = registry.make_agent(
        name, torch.Generator().manual_seed(0), OBS, ACT, scaler,
        ACTS_SCALED,
        render_fn=port_view, low_dim=LOW, **kw)
    carried = convert.agent_params_from_numpy(
        name, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    assert {k: v.shape for k, v in carried.items()} == \
        {k: v.shape for k, v in agent.params.items()}, name
    agent.params = carried
    japply = jax.jit(jax.vmap(jagent.policy_apply(), in_axes=(None, 0, 0)))
    _AGENTS[name] = jagent, agent, japply
    return _AGENTS[name]


def _window(agent):
    return getattr(agent, "train_window", None) or agent.window_size


def _batch(seed, window):
    obs = _obs(seed, B * window).reshape(B, window, OBS)
    rng = np.random.default_rng(seed + 1)
    return obs, (0.005 * rng.normal(size=(B, window, ACT))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- the draws the JAX loss makes from its key ---------------------------

def loss_draws(name, jagent, key):
    if name in ("cvae_vision", "act_vision"):
        return {"eps": jax.random.normal(key, (B, LATENT))}
    if name == "ibc_vision":
        return {"neg": jax.random.uniform(key, (B, jagent.n_negatives, ACT))}
    if name in ("ddpm_vision", "ddpm_encdec_vision"):
        k1, k2 = jax.random.split(key)
        shape = (B, CHUNK, ACT) if "encdec" in name else (B, ACT)
        return {"t": jax.random.randint(k1, (B,), 0, T_DIFF),
                "eps": jax.random.normal(k2, shape)}
    if name == "beso_vision":
        k1, k2 = jax.random.split(key)
        cdf = lambda v: jax.nn.sigmoid((np.log(v) - jbeso.DENSITY_LOC)
                                       / jbeso.DENSITY_SCALE)
        return {"u": jax.random.uniform(k1, (B,), minval=cdf(jbeso.SIGMA_MIN),
                                        maxval=cdf(jbeso.SIGMA_MAX)),
                "noise": jax.random.normal(k2, (B, ACT))}
    return {}


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches(name):
    """The loss on B = 4 windows (rendered, encoded, the head), the port
    given the JAX loss's draws: 1e-4 relative."""
    jagent, agent, _ = agents(name)
    obs, act = _batch(1, _window(agent))
    key = jax.random.PRNGKey(3)
    jl = jax.jit(jagent.loss_fn())(jagent.params, jnp.asarray(obs),
                                   jnp.asarray(act), key)
    kw = {k: _t(v) for k, v in loss_draws(name, jagent, key).items()}
    with torch.no_grad():
        l = agent.loss_fn()(agent.params, _t(obs), _t(act), None, **kw)
    np.testing.assert_allclose(l.item(), float(jl), rtol=1e-4)


# ---- the draws the JAX policy makes from its carry's key -----------------

def _diffusion_noise(key, shape):
    """A JAX reverse diffusion's normals from the carry's key: the initial
    sample, then one per step."""
    key, k0 = jax.random.split(key)
    out = [jax.random.normal(k0, shape)]
    for _ in range(T_DIFF):
        key, kn = jax.random.split(key)
        out.append(jax.random.normal(kn, shape))
    return np.stack([np.asarray(x)[0] for x in out])


def policy_draws(name, jagent, key):
    """One episode's draws of one JAX policy step from its carry's key, in
    the port's layout without the batch axis (None: deterministic)."""
    if name == "ddpm_vision":
        return _diffusion_noise(key, (1, ACT))
    if name == "ddpm_encdec_vision":
        return _diffusion_noise(key, (1, CHUNK, ACT))
    if name == "bet_mlp_vision":
        _, k1 = jax.random.split(key)
        return np.asarray(jax.random.gumbel(k1, (N_BINS,)))
    if name == "gmm_vision":
        _, k1, k2 = jax.random.split(key, 3)
        return (np.asarray(jax.random.gumbel(k1, (K_GMM,))),
                np.asarray(jax.random.normal(k2, (ACT,))))
    if name == "cvae_vision":
        _, k1 = jax.random.split(key)
        return np.asarray(jax.random.normal(k1, (1, LATENT)))[0]
    if name == "beso_vision":         # euler_ancestral: one normal a step
        _, k0, key = jax.random.split(key, 3)
        zs = []
        for _ in range(N_STEPS):
            key, k = jax.random.split(key)
            zs.append(np.asarray(jax.random.normal(k, (1, ACT)))[0])
        return (np.asarray(jax.random.normal(k0, (1, ACT)))[0],
                np.stack(zs))
    if name == "ibc_vision":          # the DFO's: dfo_sample's splits
        _, k1 = jax.random.split(key)
        k0, key = jax.random.split(k1)
        N = jagent.n_infer_samples
        gs, ns = [], []
        for k in jax.random.split(key, 3):
            ka, kb = jax.random.split(k)
            gs.append(np.asarray(jax.random.gumbel(ka, (N, N))))
            ns.append(np.asarray(jax.random.normal(kb, (N, ACT))))
        return (np.asarray(jax.random.uniform(k0, (N, ACT))), np.stack(gs),
                np.stack(ns))
    return None


# batch axis of each draw array in the port's layout
DRAW_AXES = {"ddpm_vision": 1, "ddpm_encdec_vision": 1, "gmm_vision": (0, 0),
             "beso_vision": (0, 1), "ibc_vision": (0, 1, 1)}


def _stack_draws(per_env, axis):
    if per_env[0] is None:
        return None
    if isinstance(per_env[0], tuple):
        return tuple(_stack_draws([d[i] for d in per_env], axis[i])
                     for i in range(len(per_env[0])))
    return torch.from_numpy(np.stack(per_env, axis=axis))


def _jax_carries(name, jagent):
    keys = [jax.random.PRNGKey(100 + e) for e in range(B)]
    per_env = [jagent.init_carry(OBS, k) for k in keys]
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *per_env)


@pytest.mark.parametrize("name", NAMES)
def test_policy_step_matches(name):
    """One policy step of B = 4 episodes from the initial carry, the port's
    batched policy given each episode's JAX draws, against the JAX policy
    vmapped over the episodes: the scaled actions 1e-4 max-scaled."""
    jagent, agent, japply = agents(name)
    obs = _obs(2, B)
    jcarry = _jax_carries(name, jagent)
    keys = jcarry[-1] if name not in ("bc_vision", "act_vision",
                                      "gpt_bc_vision") else None
    per_env = [policy_draws(name, jagent, keys[e]) if keys is not None
               else None for e in range(B)]
    draws = _stack_draws(per_env, DRAW_AXES.get(name, 0))
    _, ja = japply(jagent.params, jcarry, jnp.asarray(obs))
    kw = {} if draws is None else {"draws": draws}
    with torch.no_grad():
        _, a = agent.policy_apply(None)(agent.params,
                                        agent.init_carry(OBS, B), _t(obs),
                                        **kw)
    sc = agent.scaler
    assert_scaled(sc.scale_output(a).numpy(),
                  sc.scale_output(_t(np.asarray(ja))).numpy(), 1e-4, name)


@pytest.mark.parametrize("name", ["gpt_bc_vision", "act_vision"])
def test_policy_carry_over_steps(name):
    """Three steps of the carried policies: GPT-BC's window of encoded
    features (1e-4 max-scaled) and fill count (exactly), ACT's chunk
    buffer (1e-4 max-scaled) and index (exactly), and the actions of every
    step (scaled, 1e-4 max-scaled)."""
    jagent, agent, japply = agents(name)
    seq = _obs(5, 3 * B).reshape(3, B, OBS)
    jcarry = _jax_carries(name, jagent)
    apply, carry = agent.policy_apply(None), agent.init_carry(OBS, B)
    sc = agent.scaler
    for t in range(3):
        jcarry, ja = japply(jagent.params, jcarry, jnp.asarray(seq[t]))
        with torch.no_grad():
            carry, a = apply(agent.params, carry, _t(seq[t]))
        assert_scaled(sc.scale_output(a).numpy(),
                      sc.scale_output(_t(np.asarray(ja))).numpy(), 1e-4,
                      f"step {t}")
        assert_scaled(carry[0].numpy(), np.asarray(jcarry[0]), 1e-4,
                      f"step {t}")
        np.testing.assert_array_equal(carry[1].numpy(),
                                      np.asarray(jcarry[1]))
        if name == "gpt_bc_vision" and t == 0:
            # the first frame's features fill the window
            assert (carry[0] == carry[0][:, :1]).all()
    if name == "gpt_bc_vision":
        # then each step shifts its frame in: three distinct frames
        assert (carry[1] == W).all()
        f = carry[0]
        assert not torch.allclose(f[:, 0], f[:, 1])
        assert not torch.allclose(f[:, 1], f[:, 2])


def test_registry_and_convert_name_the_ten():
    vision = sorted(n for n, s in registry.AGENTS.items() if s.vision)
    assert vision == NAMES
    assert set(NAMES) <= set(convert.PORTED_AGENTS)
    assert registry.AGENTS["ddpm_vision"].ema_decay == 0.995
    assert registry.AGENTS["bet_mlp_vision"].needs_actions
    assert not registry.AGENTS["gmm"].vision
