"""Port data layer == the JAX package's: scaler, dataset assembly, windows,
evaluation contexts. Real episodes of data/pushing and NumPy draws from a
seed go through both sides; every comparison states its tolerance.
"""
import os
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_torch_jaxref  # noqa: F401  (thread and TF32 settings)

from d3il_tpu.data import dataset as jds
from d3il_tpu.data.scaler import Scaler as JScaler
from d3il_tpu.eval import contexts as jcontexts
from d3il_tpu_torch import convert
from d3il_tpu_torch.data import dataset as ds
from d3il_tpu_torch.data.scaler import Scaler
from d3il_tpu_torch.eval import contexts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_DATA = os.path.join(ROOT, "data", "pushing", "all_data")


@pytest.fixture(scope="module")
def episodes():
    """Three real pushing demonstrations (reference pickle schema)."""
    with open(os.path.join(ROOT, "data", "pushing", "train_files.pkl"),
              "rb") as f:
        files = pickle.load(f)[:3]
    return [jds.load_episode(os.path.join(ALL_DATA, f)) for f in files]


def test_assemble_pushing_equal(episodes):
    """Pure NumPy on both sides: exact."""
    for ep in episodes:
        for a, b in zip(ds.assemble_pushing(ep), jds.assemble_pushing(ep)):
            assert a.shape[0] > 50
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window", [1, 5])
def test_build_and_rewindow_equal(episodes, window):
    """Padded tensors, masks and the window-start table: exact. max_len 150
    truncates some episodes, so both length branches are taken."""
    eps = [jds.assemble_pushing(ep) for ep in episodes]
    jdata = jds.build(eps, 150, 1)
    data = ds.build(eps, 150, 1, device="cpu")
    if window != 1:
        jdata, data = jds.rewindow(jdata, window), ds.rewindow(data, window)
    for name in ("observations", "actions", "masks", "slices"):
        np.testing.assert_array_equal(getattr(data, name).numpy(),
                                      np.asarray(getattr(jdata, name)),
                                      err_msg=name)
    assert data.n_windows == jdata.n_windows
    for a, b in zip(ds.all_valid(data), jds.all_valid(jdata)):
        np.testing.assert_array_equal(a, b)


def test_sample_windows_gathers_table_rows(episodes):
    """The streams of jax.random and torch.Generator differ, so the sampler
    is held to the table instead: every sampled window is the slice of its
    episode that some row of ``slices`` names, obs and action alike."""
    eps = [jds.assemble_pushing(ep) for ep in episodes]
    data = ds.build(eps, 400, 4, device="cpu")
    obs, act = ds.sample_windows(data, torch.Generator().manual_seed(0), 64, 4)
    assert obs.shape == (64, 4, 10) and act.shape == (64, 4, 2)
    rows = {(i, s): (eps[i][0][s:s + 4], eps[i][1][s:s + 4])
            for i, s in data.slices.tolist()}
    for o, a in zip(obs.numpy(), act.numpy()):
        hits = [k for k, (ro, ra) in rows.items()
                if np.array_equal(ro.astype(np.float32), o)
                and np.array_equal(ra.astype(np.float32), a)]
        assert hits, "a sampled window is not in the table"
    # the same seed gives the same minibatch
    obs2, _ = ds.sample_windows(data, torch.Generator().manual_seed(0), 64, 4)
    assert torch.equal(obs, obs2)


@pytest.mark.parametrize("scale_data", [True, False])
def test_scaler_equal(episodes, scale_data):
    """Statistics are float64 NumPy cast to float32 on both sides (exact);
    the maps are float32 elementwise (1e-6 relative)."""
    obs, act = jds.assemble_pushing(episodes[0])
    js = JScaler.fit(obs, act, scale_data)
    s = Scaler.fit(obs, act, scale_data, device="cpu")
    for name in ("x_mean", "x_std", "y_mean", "y_std", "y_bounds",
                 "x_bounds"):
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      np.asarray(getattr(js, name)))
    rng = np.random.default_rng(0)
    x = obs[:16].astype(np.float32)
    y = (act[:16] * rng.uniform(0.5, 2.0, (16, 2))).astype(np.float32)
    y[3, 0], y[4, 1], y[5, 0] = np.nan, np.inf, -np.inf   # a diverged policy
    for name, arg in (("scale_input", x), ("scale_output", y[:3]),
                      ("inverse_scale_output", y[:3]), ("clip_action", y)):
        got = getattr(s, name)(torch.from_numpy(arg)).numpy()
        want = np.asarray(getattr(js, name)(jnp.asarray(arg)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    assert np.isfinite(s.clip_action(torch.from_numpy(y)).numpy()).all()
    back = convert.scaler_from_numpy(js, "cpu")
    assert back.scale_data == scale_data
    assert torch.equal(back.y_bounds, s.y_bounds)


@pytest.mark.parametrize("name", ["pushing_contexts", "aligning_contexts",
                                  "stacking_contexts",
                                  "stacking_mode_priors"])
def test_reference_contexts_equal(name):
    got, want = getattr(contexts, name)(), getattr(jcontexts, name)()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if name == "pushing_contexts":
        assert got[0].shape == (60, 2) and got[1].shape == (60, 4)


def test_mode_prior_from_demos_equal():
    task_dir = os.path.join(ROOT, "data", "pushing")
    got = contexts.mode_prior_from_demos(task_dir)
    want = jcontexts.mode_prior_from_demos(task_dir)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
