"""Port agents == the JAX package's: nets, bc, gmm, one optimizer step,
checkpoint resume.

The Flax weights of a small JAX agent are carried across by
``convert.agent_params_from_numpy``, so both sides compute the same function
of the same NumPy inputs. ``jax.random`` and ``torch.Generator`` give
different streams: the deterministic parts are held end to end, the GMM
sample with the component index and the normal draw passed in, and ``fit``
by one optimizer step on a fixed minibatch.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from test_torch_jaxref import tiny_agents

from d3il_tpu.agents import base as jbase
from d3il_tpu.agents import gmm as jgmm
from d3il_tpu.agents.nets import mlp as jmlp
from d3il_tpu_torch import convert, registry
from d3il_tpu_torch.agents import base, gmm
from d3il_tpu_torch.agents.nets import mlp
from d3il_tpu_torch.data import dataset as ds

OBS, ACT = 10, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, n=12, window=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, window, OBS)).astype(np.float32),
            (0.005 * rng.normal(size=(n, window, ACT))).astype(np.float32))


def test_mish_equal():
    x = np.linspace(-20, 20, 101).astype(np.float32)
    np.testing.assert_allclose(mlp.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jmlp.mish(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layers", [1, 2, 4])
def test_residual_mlp_forward_equal(layers):
    """Converted weights, same inputs: 1e-5 absolute (float32 products in
    another order). layers = 1 has no residual block."""
    jmodel = jmlp.ResidualMLP(hidden_dim=16, num_hidden_layers=layers,
                              output_dim=3)
    x = np.random.default_rng(layers).normal(size=(7, OBS)).astype(np.float32)
    jparams = jmodel.init(jax.random.PRNGKey(layers), jnp.asarray(x))
    model = mlp.ResidualMLP(OBS, 16, layers, 3,
                            generator=torch.Generator().manual_seed(0))
    model.load_state_dict(convert.agent_params_from_numpy("bc", _np(jparams), "cpu"))
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmodel.apply(jparams, jnp.asarray(x))),
                               atol=1e-5)


def test_mlp_forward_equal():
    """Plain MLP: the Flax tree Dense_0..Dense_n maps to hidden.i / out."""
    jmodel = jmlp.MLP(hidden_dim=16, num_hidden_layers=2, output_dim=1)
    x = np.random.default_rng(0).normal(size=(5, OBS)).astype(np.float32)
    jp = _np(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    model = mlp.MLP(OBS, 16, 2, 1, generator=torch.Generator().manual_seed(0))
    sd = {}
    for i, name in enumerate(("hidden.0", "hidden.1", "out")):
        convert._dense(jp[f"Dense_{i}"], name, sd, "cpu")
    model.load_state_dict(sd)
    np.testing.assert_allclose(
        model(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmodel.apply({"params": jp}, jnp.asarray(x))), atol=1e-5)


def test_dense_init_is_lecun_normal():
    """Flax Dense's initialiser: truncated normal of std sqrt(1 / fan_in),
    cut at 2 std of the untruncated normal, zero bias. Held to the
    distribution (the streams differ): std within 2 %, nothing beyond the
    cut, same as a Flax layer of the same shape."""
    layer = mlp.dense(400, 500, torch.Generator().manual_seed(0))
    w = layer.weight.detach().numpy()
    jw = np.asarray(jmlp.nn.Dense(500).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 400)))["params"]["kernel"])
    assert abs(w.std() / jw.std() - 1) < 0.02
    assert abs(w.std() * math.sqrt(400) - 1) < 0.02
    assert abs(np.abs(w).max() / np.abs(jw).max() - 1) < 0.02
    assert not layer.bias.detach().numpy().any()
    # the generator decides the draw
    again = mlp.dense(400, 500, torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, layer.weight)


@pytest.mark.parametrize("window", [1, 3])
def test_bc_loss_and_policy_equal(window):
    """BC end to end (deterministic): the loss on a minibatch (1e-5
    relative) and the policy over 5 steps of a rolling window, B = 4
    episodes in the port against the JAX policy per episode (1e-6
    absolute on actions of ~5e-3)."""
    jagent, agent = tiny_agents("bc", window_size=window)
    obs, act = _batch(1, window=window)
    jl = jagent.loss_fn()(jagent.params, jnp.asarray(obs), jnp.asarray(act),
                          None)
    l = agent.loss_fn()(agent.params, torch.from_numpy(obs),
                        torch.from_numpy(act))
    np.testing.assert_allclose(l.item(), float(jl), rtol=1e-5)

    B = 4
    seq = np.random.default_rng(2).normal(size=(5, B, OBS)).astype(np.float32)
    apply, carry = agent.policy_apply(), agent.init_carry(OBS, B)
    japply = jagent.policy_apply()
    jcarry = [jagent.init_carry(OBS) for _ in range(B)]
    for t in range(5):
        carry, a = apply(agent.params, carry, torch.from_numpy(seq[t]))
        for e in range(B):
            jcarry[e], ja = japply(jagent.params, jcarry[e],
                                   jnp.asarray(seq[t, e]))
            np.testing.assert_allclose(a[e].detach().numpy(), np.asarray(ja),
                                       atol=1e-6)
            np.testing.assert_array_equal(carry[0][e].numpy(),
                                          np.asarray(jcarry[e][0]))
            assert int(carry[1][e]) == int(jcarry[e][1])


def test_gmm_heads_logprob_and_sample_equal():
    """GMMNet's means/stds/logits (1e-5), gmm_log_prob (1e-5 relative on
    values of order 10), the NLL loss, and the sample given the component
    index and the normal draw, for both noise settings."""
    jagent, agent = tiny_agents("gmm", n_gaussians=3)
    obs, act = _batch(3)
    x = agent.scaler.scale_input(torch.from_numpy(obs[:, 0]))
    jx = jagent.scaler.scale_input(jnp.asarray(obs[:, 0]))
    jout = jagent.model.apply(jagent.params, jx)
    out = torch.func.functional_call(agent.model, agent.params, (x,))
    for a, b, name in zip(out, jout, ("means", "stds", "logits")):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, err_msg=name)
    a_s = np.random.default_rng(4).normal(size=(12, ACT)).astype(np.float32)
    np.testing.assert_allclose(
        gmm.gmm_log_prob(*out, torch.from_numpy(a_s)).detach().numpy(),
        np.asarray(jgmm.gmm_log_prob(*jout, jnp.asarray(a_s))), rtol=1e-5,
        atol=1e-5)
    jl = jagent.loss_fn()(jagent.params, jnp.asarray(obs), jnp.asarray(act),
                          None)
    l = agent.loss_fn()(agent.params, torch.from_numpy(obs),
                        torch.from_numpy(act))
    np.testing.assert_allclose(l.item(), float(jl), rtol=1e-5)

    rng = np.random.default_rng(5)
    comp = rng.integers(0, 3, 12)
    eps = rng.normal(size=(12, ACT)).astype(np.float32)
    jm, js, _ = (np.asarray(o) for o in jout)
    for low_noise in (True, False):
        # gmm.py:96-97 with the draws passed in
        want = jm[np.arange(12), comp] + (1e-4 if low_noise else 1.0) \
            * js[np.arange(12), comp] * eps
        got = gmm.gmm_sample(out[0], out[1], torch.from_numpy(comp),
                             torch.from_numpy(eps), low_noise)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_gmm_policy_draws_from_the_generator():
    """The policy's action is gmm_sample of exactly the generator's next
    categorical and normal draws, clipped and unscaled; the same seed
    repeats it."""
    _, agent = tiny_agents("gmm", n_gaussians=3)
    obs = torch.from_numpy(_batch(6, n=5)[0][:, 0])
    acts = []
    for _ in range(2):
        apply = agent.policy_apply(torch.Generator().manual_seed(7))
        _, a = apply(agent.params, agent.init_carry(OBS, 5), obs)
        acts.append(a)
    assert torch.equal(*acts)
    g = torch.Generator().manual_seed(7)
    means, stds, logits = torch.func.functional_call(
        agent.model, agent.params, (agent.scaler.scale_input(obs),))
    comp = gmm.draw_component(logits, g)
    eps = gmm.draw_normal((5, ACT), g)
    want = agent.scaler.inverse_scale_output(agent.scaler.clip_action(
        gmm.gmm_sample(means, stds, comp, eps, True)))
    assert torch.equal(acts[0], want)
    assert comp.shape == (5,) and int(comp.min()) >= 0 and int(comp.max()) < 3


@pytest.mark.parametrize("name", ["bc", "gmm"])
def test_one_optimizer_step_matches_optax(name):
    """One step of Adam behind the global-norm clip on a fixed minibatch:
    the loss (1e-5 relative) and every updated weight against optax.adam
    behind clip_by_global_norm(10). The first Adam step moves each weight by
    lr * g / (|g| + eps) ~ +-1e-3; 2e-6 absolute allows for float32
    gradients summed in another order."""
    jagent, agent = tiny_agents(name)
    obs, act = _batch(8, n=32)
    cfg = base.TrainConfig(lr=1e-3)
    tx = jbase.make_optimizer(jbase.TrainConfig(lr=1e-3))

    @jax.jit
    def jstep(p, o, a):
        loss, grads = jax.value_and_grad(jagent.loss_fn())(p, o, a, None)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, optax.apply_updates(p, updates)

    jloss, jnew = jstep(jagent.params, jnp.asarray(obs), jnp.asarray(act))
    jnew = convert.agent_params_from_numpy(name, _np(jnew), "cpu")

    params = {k: v.clone().requires_grad_(True)
              for k, v in agent.params.items()}
    opt = base.make_optimizer(cfg, params)
    loss = base.train_step(agent.loss_fn(), params, opt,
                           torch.from_numpy(obs), torch.from_numpy(act), None)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(params) == set(jnew)
    moved = 0.0
    for k in params:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   jnew[k].numpy(), atol=2e-6, err_msg=k)
        moved = max(moved, (params[k].detach() - agent.params[k]).abs().max()
                    .item())
    assert moved > 5e-4


def test_gradient_clip_matches_optax():
    """A minibatch whose gradient norm exceeds 10 (targets 50 std away):
    the clipped step still matches optax, 2e-6 absolute."""
    jagent, agent = tiny_agents("bc")
    obs, act = _batch(9, n=16)
    act = act + 0.25
    tx = jbase.make_optimizer(jbase.TrainConfig(lr=1e-2))

    @jax.jit
    def jstep(p, o, a):
        grads = jax.grad(jagent.loss_fn())(p, o, a, None)
        updates, _ = tx.update(grads, tx.init(p), p)
        return optax.global_norm(grads), optax.apply_updates(p, updates)

    norm, jnew = jstep(jagent.params, jnp.asarray(obs), jnp.asarray(act))
    assert float(norm) > 10.0
    jnew = convert.agent_params_from_numpy("bc", _np(jnew), "cpu")
    params = {k: v.clone().requires_grad_(True)
              for k, v in agent.params.items()}
    opt = base.make_optimizer(base.TrainConfig(lr=1e-2), params)
    base.train_step(agent.loss_fn(), params, opt, torch.from_numpy(obs),
                    torch.from_numpy(act), None)
    for k in params:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   jnew[k].numpy(), atol=2e-5, err_msg=k)


def _toy_data(seed):
    rng = np.random.default_rng(seed)
    eps = [(rng.normal(size=(T, OBS)).astype(np.float32),
            (0.005 * rng.normal(size=(T, ACT))).astype(np.float32))
           for T in (30, 40, 25)]
    return ds.build(eps, 40, 1, device="cpu")


@pytest.mark.parametrize("ema", [None, 0.9])
def test_checkpoint_resume_gives_the_same_run(tmp_path, ema):
    """fit for 4 epochs in one go == fit for 2 epochs with a checkpoint,
    then a second fit on the same directory up to 4: same final and best
    weights (exact: params, optimizer moments, EMA and generator state all
    come back), and the history continues at epoch 2."""
    _, agent = tiny_agents("bc")
    data, val = _toy_data(0), _toy_data(1)
    kw = dict(batch_size=16, eval_every_n_epochs=1, ema_decay=ema)

    def run(epochs, ckpt_dir, seed=0):
        return base.fit(agent.loss_fn(), agent.params, data, val,
                        base.TrainConfig(epochs=epochs, **kw),
                        torch.Generator().manual_seed(seed),
                        checkpoint_dir=ckpt_dir, checkpoint_every=2)

    best_a, final_a, hist_a = run(4, None)
    run(2, str(tmp_path))
    best_b, final_b, hist_b = run(4, str(tmp_path), seed=123)
    assert [r["epoch"] for r in hist_b] == [2, 3]
    assert [r["train_loss"] for r in hist_b] == \
        [r["train_loss"] for r in hist_a[2:]]
    for k in final_a:
        assert torch.equal(final_a[k], final_b[k]), k
        assert torch.equal(best_a[k], best_b[k]), k
    assert any(not torch.equal(final_a[k], agent.params[k]) for k in final_a)
    # a finished run resumes to a replayed record, not a new epoch
    _, final_c, hist_c = run(4, str(tmp_path))
    assert hist_c == [{"epoch": 3, "train_loss": hist_a[3]["train_loss"],
                       "resumed_complete": True}]
    for k in final_a:
        assert torch.equal(final_a[k], final_c[k]), k


def test_fit_lowers_the_loss():
    """20 epochs on a learnable toy set (actions a linear map of the
    observations): the train loss falls by more than half."""
    rng = np.random.default_rng(0)
    W = rng.normal(size=(OBS, ACT)) * 0.002
    eps = []
    for T in (60, 50):
        o = rng.normal(size=(T, OBS)).astype(np.float32)
        eps.append((o, (o @ W).astype(np.float32)))
    data = ds.build(eps, 60, 1, device="cpu")
    x, y = ds.all_valid(data)
    from d3il_tpu_torch.data.scaler import Scaler
    agent, _ = registry.make_agent("bc", torch.Generator().manual_seed(0),
                                   OBS, ACT, Scaler.fit(x, y, device="cpu"),
                                   hidden_dim=16,
                                   num_hidden_layers=2)
    _, _, hist = base.fit(agent.loss_fn(), agent.params, data, None,
                          base.TrainConfig(epochs=20, batch_size=32, lr=3e-3),
                          torch.Generator().manual_seed(0))
    assert hist[-1]["train_loss"] < 0.5 * hist[0]["train_loss"]


def test_registry_names_what_is_ported():
    assert sorted(registry.TASKS) == ["pushing"]
    assert sorted(registry.AGENTS) == ["bc", "gmm"]
    with pytest.raises(KeyError, match="ported.*pushing"):
        registry.TASKS["stacking"]
    with pytest.raises(KeyError, match="ported.*bc.*gmm"):
        registry.make_agent("ddpm", None, OBS, ACT, None)
    with pytest.raises(KeyError, match="ported"):
        convert.agent_params_from_numpy("ddpm", {}, "cpu")
