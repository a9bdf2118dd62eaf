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


def jax_pushing_params(n_substeps):
    from d3il_tpu.envs import pushing as jpushing
    return jpushing.PushingParams(n_substeps=n_substeps, max_steps=50)


def port_pushing_params(jparams):
    from d3il_tpu_torch import convert
    return convert.params_from_numpy(jparams.q_init,
                                     n_substeps=jparams.n_substeps,
                                     max_steps=jparams.max_steps,
                                     device="cpu")
