"""Port eval metrics == the JAX package's, on random inputs from a seed.

Every score of ``eval/metrics.py`` is computed by both sides on the same
NumPy draws (including modes of -1, out-of-key modes and contexts without a
success); every value agrees to 1e-5 absolute.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_torch_jaxref  # noqa: F401  (thread and TF32 settings)

from d3il_tpu.eval import metrics as jmetrics
from d3il_tpu_torch.eval import metrics

C, T = 6, 5
TOL = 1e-5


def _succ(rng, shape=(C, T)):
    s = rng.integers(0, 2, size=shape).astype(np.float32)
    if len(shape) == 2:
        s[3] = 0                       # a context with no success
    return s


def _case(name, seed):
    """(args as NumPy, kwargs) of score ``name``."""
    rng = np.random.default_rng(seed)
    if name == "pushing_score":
        modes = rng.integers(-1, 4, size=(C, T)).astype(np.int32)
        return (_succ(rng), modes)
    if name == "avoiding_score":
        return (_succ(rng, (40,)),
                rng.integers(0, 2, size=(40, 9)).astype(np.float32))
    if name == "aligning_score":
        d = rng.random((C, T)).astype(np.float32)
        d[1, 2] = np.nan               # a diverged rollout
        return (_succ(rng), rng.integers(0, 2, size=(C, T)).astype(np.int32),
                d)
    if name == "sorting_score":
        keys = np.array([0b01000000, 0b10000000], np.int32)
        modes = rng.choice(keys, size=(C, T)).astype(np.int32)
        modes[2, 0] = 5                # an out-of-key mode
        return (_succ(rng), modes, keys, np.array([0.7, 0.3], np.float32))
    if name == "stacking_score":
        order = np.stack([rng.permutation(3) for _ in range(C * T)]) \
            .reshape(C, T, 3).astype(np.int32)
        mlen = rng.integers(0, 4, size=(C, T)).astype(np.int32)
        order[np.arange(3)[None, None] >= mlen[..., None]] = -1
        f = lambda m: m.astype(np.float32)
        p1 = np.array([0.5, 0.3, 0.2], np.float32)
        p2 = np.array([0.3, 0.2, 0.2, 0.1, 0.1, 0.1], np.float32)
        return (order, mlen, f(mlen > 2), f(mlen > 0), f(mlen > 1), p1, p2,
                p2[::-1].copy())
    if name == "inserting_score":
        return (_succ(rng), rng.integers(0, 7, size=(C, T)).astype(np.int32))
    raise KeyError(name)


SCORES = ["pushing_score", "avoiding_score", "aligning_score",
          "sorting_score", "stacking_score", "inserting_score"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", SCORES)
def test_score_equal(name, seed):
    args = _case(name, seed)
    want = getattr(jmetrics, name)(*(jnp.asarray(a) for a in args))
    got = getattr(metrics, name)(*(torch.from_numpy(a) for a in args))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=TOL,
                                   err_msg=f"{name}.{k}")


def test_score_takes_numpy_priors():
    """Priors and mode keys may stay NumPy arrays, as the sims pass them."""
    args = _case("sorting_score", 0)
    a = metrics.sorting_score(torch.from_numpy(args[0]),
                              torch.from_numpy(args[1]), args[2], args[3])
    b = metrics.sorting_score(*(torch.from_numpy(x) for x in args))
    assert float(a["kl"]) == float(b["kl"])


@pytest.mark.parametrize("n_modes", [2, 4])
def test_mode_probs_entropy_and_kl_equal(n_modes):
    rng = np.random.default_rng(n_modes)
    modes = rng.integers(-1, n_modes + 1, size=(C, T)).astype(np.int32)
    succ = _succ(rng)
    prior = rng.dirichlet(np.ones(n_modes)).astype(np.float32)
    jp = jmetrics.mode_probs_per_context(jnp.asarray(modes),
                                         jnp.asarray(succ), n_modes)
    p = metrics.mode_probs_per_context(torch.from_numpy(modes),
                                       torch.from_numpy(succ), n_modes)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=TOL)
    np.testing.assert_allclose(float(metrics.entropy(p, n_modes)),
                               float(jmetrics.entropy(jp, n_modes)), atol=TOL)
    for a, b in zip(metrics.entropy_kl_nonzero(p, prior, n_modes),
                    jmetrics.entropy_kl_nonzero(jp, prior, n_modes)):
        np.testing.assert_allclose(float(a), float(b), atol=TOL)
    np.testing.assert_allclose(float(metrics.kl_to_prior(p, prior)),
                               float(jmetrics.kl_to_prior(jp, prior)),
                               atol=TOL)


def test_stacking_prefix_codes_equal():
    order = np.array([[0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 0, 1],
                      [2, 1, 0], [0, -1, -1], [-1, -1, -1]], np.int32)
    for a, b in zip(metrics.stacking_prefix_codes(torch.from_numpy(order)),
                    jmetrics.stacking_prefix_codes(jnp.asarray(order))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
