"""Shared helpers for the port's golden tests (no tests here).

The JAX package (``d3il_tpu``) is the reference; the port
(``d3il_tpu_torch``) runs on the CPU through its kernels' plain versions.
Inputs are made with NumPy from a seed and handed to both sides; every
comparison states its tolerance. Each test file builds the JAX task params
at most once (module-scoped fixtures) and keeps batches and windows tiny.
"""
import numpy as np
import torch

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HOLD_QUAT = np.array([0.0, 1.0, 0.0, 0.0])


def assert_scaled(a, b, atol, name=""):
    """|a - b| / max(|b|max, 1) <= atol, elementwise (the JAX tests' form)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(np.abs(b).max(), 1.0) if b.size else 1.0
    np.testing.assert_allclose(a / scale, b / scale, atol=atol, rtol=0,
                               err_msg=name)


class EagerRef:
    """Stand-in for a Pallas ref holding a jnp array, so that a TPU kernel's
    body can be run op by op on the CPU: ``ref[i]`` reads, ``ref[...] = x``
    writes. ``pallas_call(interpret=True)`` runs the same body, but hands
    XLA the unrolled scalar graph in one piece, which it takes minutes to
    compile on the CPU; op by op the same arithmetic takes seconds."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        assert idx is Ellipsis
        self.value = value


def run_kernel_body(kernel, inputs, n_out):
    """Run a Pallas kernel body eagerly on jnp inputs; returns its outputs
    as NumPy arrays."""
    import jax.numpy as jnp
    outs = [EagerRef() for _ in range(n_out)]
    kernel(*(EagerRef(jnp.asarray(x)) for x in inputs), *outs)
    return [np.asarray(o.value) for o in outs]


def contexts(seed, batch, red_xy=None):
    """Pushing contexts as NumPy (red_xy, red_quat, green_xy, green_quat),
    drawn from the reference context spaces; yaw quats [cos, 0, 0, sin]."""
    rng = np.random.default_rng(seed)
    red = rng.uniform([0.4, -0.15, -90.0], [0.5, 0.0, 90.0], (batch, 3))
    green = rng.uniform([0.55, -0.15, -90.0], [0.65, 0.0, 90.0], (batch, 3))
    if red_xy is not None:
        red[:, :2] = red_xy

    def yaw_quat(deg):
        h = np.deg2rad(deg) / 2
        return np.stack([np.cos(h), 0 * h, 0 * h, np.sin(h)], 1)

    return tuple(x.astype(np.float32) for x in (
        red[:, :2], yaw_quat(red[:, 2]), green[:, :2], yaw_quat(green[:, 2])))


def actions(tcp_xy, dxy=(0.0, 0.0)):
    """[B, 7] setpoints: tcp xy + offset, z 0.12, the rod pointing down."""
    B = tcp_xy.shape[0]
    return np.concatenate([np.asarray(tcp_xy) + np.asarray(dxy),
                           np.full((B, 1), 0.12), np.tile(HOLD_QUAT, (B, 1))],
                          axis=1).astype(np.float32)


def jax_pushing_params(n_substeps, kinematic=False):
    from d3il_tpu.envs import pushing as jpushing
    return jpushing.PushingParams(n_substeps=n_substeps, max_steps=50,
                                  kinematic=kinematic)


def port_pushing_params(jparams):
    from d3il_tpu_torch import convert
    return convert.params_from_numpy(jparams.q_init,
                                     n_substeps=jparams.n_substeps,
                                     max_steps=jparams.max_steps,
                                     kinematic=jparams.kinematic,
                                     device="cpu")


def tiny_agents(name, obs_dim=10, act_dim=2, hidden=16, layers=2, seed=0,
                **kw):
    """The same small agent on both sides: the JAX one from a PRNGKey, the
    port's with the JAX weights and scaler carried across by ``convert``.
    The scaler is fitted on random data with spread in every column."""
    import jax
    from d3il_tpu import registry as jregistry
    from d3il_tpu.data.scaler import Scaler as JScaler
    from d3il_tpu_torch import convert, registry
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(32, obs_dim)).astype(np.float32)
    y = (0.005 * rng.normal(size=(32, act_dim))).astype(np.float32)
    jagent, _ = jregistry.make_agent(
        name, jax.random.PRNGKey(seed), obs_dim, act_dim, JScaler.fit(x, y),
        hidden_dim=hidden, num_hidden_layers=layers, **kw)
    agent, _ = registry.make_agent(
        name, torch.Generator().manual_seed(seed), obs_dim, act_dim,
        convert.scaler_from_numpy(jagent.scaler, "cpu"), hidden_dim=hidden,
        num_hidden_layers=layers, **kw)
    agent.params = convert.agent_params_from_numpy(
        name, jax.tree_util.tree_map(np.asarray, jagent.params), "cpu")
    return jagent, agent
