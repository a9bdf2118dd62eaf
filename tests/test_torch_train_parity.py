"""The port trains gmm on avoiding as the JAX package does.

``tests/test_e2e_avoiding.py``'s training on data/avoiding, held on the
CPU: the inputs that ``run_train_torch.run_one`` hands ``fit`` against
those of ``run_train.run_one`` (the train and val windows, the Scaler, the
resolved training config), and a 32-step training run from the same
weights on the same minibatches: the JAX package's ``fit`` (optax Adam
behind the global-norm clip) against the port's, JAX's windows recorded
from its keys as its ``fit`` splits them and replayed into the port's
loop, with a validation every epoch on JAX's validation windows.

The whole data/avoiding split is loaded (108 training and 12 validation
demonstrations, under 0.5 MB): the Scaler's statistics are over all of
it, and the replayed windows index all of it.
"""
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import np_tree

from d3il_tpu import registry as jregistry
from d3il_tpu.agents import base as jbase
from d3il_tpu.data import dataset as jds
from d3il_tpu_torch import convert, registry
from d3il_tpu_torch.agents import base
from d3il_tpu_torch.data import dataset as ds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")


class _Captured(Exception):
    pass


def _fit_inputs(module, monkeypatch, **kw):
    """run_one's (agent, train data, val data, TrainConfig) as it hands
    them to fit, fit itself replaced by a stop."""
    got = {}
    build = module.build_agent_and_data

    def record_build(*args):
        got["built"] = build(*args)
        return got["built"]

    def stop(loss_fn, params, train, val, cfg, *args, **more):
        got["cfg"] = cfg
        raise _Captured

    monkeypatch.setattr(module, "build_agent_and_data", record_build)
    monkeypatch.setattr(module.agent_base, "fit", stop)
    with pytest.raises(_Captured):
        module.run_one(module.make_args(task="avoiding", agent="gmm",
                                        data=DATA, skip_eval=True, **kw))
    _, agent, ema, train, val = got["built"]
    return agent, ema, train, val, got["cfg"]


def test_avoiding_training_inputs_match(monkeypatch):
    """Exact: observations and actions (fp32 bitwise), masks and window
    slices of both splits; the Scaler's statistics to 1e-6 relative
    (both fit in float64 and round to float32); every field of the
    resolved TrainConfig (run_one's --max-len, window, batch, epochs and
    eval_every_n_epochs), the EMA setting and the agent's window."""
    import run_train
    import run_train_torch
    jagent, jema, jtrain, jval, jcfg = _fit_inputs(run_train, monkeypatch)
    agent, ema, train, val, cfg = _fit_inputs(run_train_torch, monkeypatch,
                                              device="cpu")
    for name, a, b in (("train", train, jtrain), ("val", val, jval)):
        for field in ("observations", "actions", "masks", "slices"):
            np.testing.assert_array_equal(
                getattr(a, field).numpy(), np.asarray(getattr(b, field)),
                err_msg=f"{name}.{field}")
        assert a.n_windows == b.n_windows
    assert train.observations.shape[:2] == (108, 250)
    assert val.observations.shape[:2] == (12, 250)
    js = jagent.scaler
    for field in ("x_mean", "x_std", "y_mean", "y_std", "y_bounds",
                  "x_bounds"):
        np.testing.assert_allclose(getattr(agent.scaler, field).numpy(),
                                   np.asarray(getattr(js, field)),
                                   rtol=1e-6, atol=0, err_msg=field)
    assert agent.scaler.scale_data == js.scale_data
    assert vars(cfg) == vars(jcfg)
    assert (cfg.epochs, cfg.batch_size, cfg.window_size,
            cfg.eval_every_n_epochs) == (80, 512, 1, 10)
    assert ema == jema is None
    assert agent.window_size == jagent.window_size == 1


EPOCHS = 32             # one step an epoch, a validation after each


def _f64(tree):
    """The floating leaves of a JAX tree in float64 (under x64)."""
    def one(x):
        x = np.asarray(x)
        return jnp.asarray(x.astype(np.float64) if x.dtype.kind == "f" else x)
    return jax.tree_util.tree_map(one, tree)


@pytest.fixture(scope="module")
def runs():
    """The JAX fit (one compile of its epoch and one of its validation)
    and the port's fit from the JAX weights on JAX's windows, both in
    float64; the gradient norm the port's clip saw at every step."""
    from d3il_tpu.data.scaler import Scaler as JScaler
    spec = jregistry.TASKS["avoiding"]
    task_dir = os.path.join(DATA, "avoiding")
    files = []
    for name in ("train_files.pkl", "eval_files.pkl"):
        with open(os.path.join(task_dir, name), "rb") as f:
            files.append(pickle.load(f))
    all_dir = os.path.join(task_dir, "all_data")
    jtrain, jval = (jds.load_task_dataset(all_dir, f, spec.assemble,
                                          spec.max_steps, 1) for f in files)
    jagent, _ = jregistry.make_agent("gmm", jax.random.PRNGKey(0), 4, 2,
                                     JScaler.fit(*jds.all_valid(jtrain)))
    scaler = convert.scaler_from_numpy(jagent.scaler, "cpu")
    params = convert.agent_params_from_numpy("gmm", np_tree(jagent.params),
                                             "cpu")
    jcfg = jbase.TrainConfig(epochs=EPOCHS, batch_size=512, window_size=1,
                             eval_every_n_epochs=1, steps_per_epoch=1)
    with jax.enable_x64(True):
        jtrain, jval = _f64(jtrain), _f64(jval)
        jagent.params = _f64(jagent.params)
        jagent.scaler = _f64(jagent.scaler)
        key = jax.random.PRNGKey(1)
        jbest, jfinal, jhist = jbase.fit(jagent.loss_fn(), jagent.params,
                                         jtrain, jval, jcfg, key)
        jbest, jfinal = np_tree(jbest), np_tree(jfinal)
        # the windows of that run, in the order the port's fit asks for
        # them: each epoch's minibatch, then its validation windows
        windows = []
        n_val = min(4096, jval.n_windows)
        for _ in range(EPOCHS):
            key, k1, k2 = jax.random.split(key, 3)
            for k in jax.random.split(k1, 1):
                windows.append(jds.sample_windows(
                    jtrain, jax.random.split(k)[0], 512, 1))
            windows.append(jds.sample_windows(jval, k2, n_val, 1))
        windows = [tuple(torch.tensor(np.asarray(x)) for x in w)
                   for w in windows]
    assert windows[0][0].dtype == torch.float64

    agent, _ = registry.make_agent(
        "gmm", torch.Generator().manual_seed(0), 4, 2, scaler._replace(**{
            k: v.double() for k, v in scaler._asdict().items()
            if k != "scale_data"}))
    agent.model.double()
    val = ds.load_task_dataset(all_dir, files[1], spec.assemble,
                               spec.max_steps, 1, device="cpu")
    queue = iter(windows)

    def replay(data, generator, batch_size, window_size):
        obs, act = next(queue)
        assert obs.shape == (batch_size, window_size, 4)
        return obs, act

    norms = []
    clip = base.clip_by_global_norm

    def watched_clip(grads, max_norm):
        norms.append(float(clip(grads, max_norm)))
        return norms[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ds, "sample_windows", replay)
        mp.setattr(base, "clip_by_global_norm", watched_clip)
        cfg = base.TrainConfig(epochs=EPOCHS, batch_size=512, window_size=1,
                               eval_every_n_epochs=1, steps_per_epoch=1)
        best, final, hist = base.fit(
            agent.loss_fn(), {k: v.double() for k, v in params.items()},
            None, val, cfg, torch.Generator().manual_seed(1))
    assert next(queue, None) is None
    return (jbest, jfinal, jhist), (best, final, hist), norms


def test_gmm_training_run_matches_jax(runs):
    """32 steps of gmm on avoiding, in float64 on both sides: the loss at
    every step to 1e-8 relative; the validation loss of every epoch to
    1e-8 relative and the same best epoch (both loops' selection rule on
    the same windows); the final and the selected weights to 1e-6
    absolute. In float32 the run is chaotic: one ulp in the JAX package's
    initial weights moves its own loss by up to 3.6e-2 over these steps
    (``python tools/avoiding_protocol_torch.py chaos``), more than the port
    strays from it, so only float64 holds the loop itself; there the
    losses agree to 1e-10 and the weights to 6e-8, the float32 rounding of
    the JAX weights on their way through ``convert``. The gradient norm
    crosses the clip's 10 on 11 of the 32 steps, so clipped and unclipped
    steps are both held."""
    (jbest, jfinal, jhist), (best, final, hist), norms = runs
    assert len(hist) == len(jhist) == EPOCHS
    np.testing.assert_allclose([h["train_loss"] for h in hist],
                               [h["train_loss"] for h in jhist], rtol=1e-8)
    np.testing.assert_allclose([h["val_loss"] for h in hist],
                               [h["val_loss"] for h in jhist], rtol=1e-8)
    pick = lambda h: int(np.argmin([r["val_loss"] for r in h]))
    assert pick(hist) == pick(jhist)
    assert min(norms) < base.GRAD_CLIP_NORM < max(norms), norms
    for mine, theirs in ((final, jfinal), (best, jbest)):
        # convert carries the weights as float32: 6e-8 relative more
        theirs = convert.agent_params_from_numpy("gmm", theirs, "cpu")
        assert set(mine) == set(theirs)
        for k in mine:
            assert mine[k].dtype == torch.float64
            np.testing.assert_allclose(mine[k].numpy(),
                                       theirs[k].double().numpy(), atol=1e-6,
                                       err_msg=k)


def test_validation_leaves_the_training_stream():
    """The port's rule, as the JAX loop's: validation draws from a
    generator of its own, so a run with validation every epoch trains on
    the same minibatches as one without (same losses and final weights,
    exactly), and two runs select alike."""
    rng = np.random.default_rng(0)
    eps = [(rng.normal(size=(T, 4)).astype(np.float32),
            (0.01 * rng.normal(size=(T, 2))).astype(np.float32))
           for T in (30, 40, 25)]
    data, val = ds.build(eps[:2], 40, 1, device="cpu"), \
        ds.build(eps[2:], 40, 1, device="cpu")
    from d3il_tpu_torch.data.scaler import Scaler
    agent, _ = registry.make_agent(
        "gmm", torch.Generator().manual_seed(0), 4, 2,
        Scaler.fit(*ds.all_valid(data), device="cpu"), hidden_dim=16,
        num_hidden_layers=2)
    cfg = base.TrainConfig(epochs=4, batch_size=16, eval_every_n_epochs=1)
    runs = [base.fit(agent.loss_fn(), agent.params, data, v, cfg,
                     torch.Generator().manual_seed(3))
            for v in (None, val, val)]
    (_, f0, h0), (b1, f1, h1), (b2, f2, h2) = runs
    assert [r["train_loss"] for r in h0] == [r["train_loss"] for r in h1]
    assert all(torch.equal(f0[k], f1[k]) for k in f0)
    assert h1 == h2 and all(torch.equal(b1[k], b2[k]) for k in b1)
    assert all("val_loss" in r for r in h1)
