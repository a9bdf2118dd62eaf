"""Port quaternion / linalg ops and Panda chains == the JAX package.

Random inputs from a NumPy seed go to both sides. Elementwise ops agree to
float32 rounding (1e-6 absolute on unit-scale values); the chains' constant
arrays are built by the same host code and must be equal exactly; FK and
the point Jacobian agree to 1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import assert_scaled

from d3il_tpu.ops import linalg as jlinalg
from d3il_tpu.ops import quat as jquat
from d3il_tpu.robot import chain as jchain
from d3il_tpu.robot import panda as jpanda
from d3il_tpu_torch.ops import linalg, quat
from d3il_tpu_torch.robot import chain, panda

RNG_SEED = 0


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _vecs(rng, n):
    return rng.standard_normal((n, 3)).astype(np.float32)


QUAT_CASES = {
    "normalize": lambda m, r: (m.normalize, (3.0 * _quats(r, 16),)),
    "mul": lambda m, r: (m.mul, (_quats(r, 16), _quats(r, 16))),
    "rotate": lambda m, r: (m.rotate, (_quats(r, 16), _vecs(r, 16))),
    "rotate_inv": lambda m, r: (m.rotate_inv, (_quats(r, 16), _vecs(r, 16))),
    "to_mat": lambda m, r: (m.to_mat, (_quats(r, 16),)),
    "quat_error": lambda m, r: (m.quat_error, (_quats(r, 16), _quats(r, 16))),
    "from_euler": lambda m, r: (m.from_euler, (_vecs(r, 16),)),
    "to_euler": lambda m, r: (m.to_euler, (_quats(r, 16),)),
    "from_axis_angle": lambda m, r: (m.from_axis_angle, (
        _quats(r, 16)[:, 1:] / np.linalg.norm(_quats(r, 16)[:, 1:], axis=1,
                                              keepdims=True),
        r.standard_normal(16).astype(np.float32))),
    "integrate": lambda m, r: (m.integrate, (_quats(r, 16),
                                             10.0 * _vecs(r, 16), 1e-3)),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quat_op_matches(name):
    fn_j, args = QUAT_CASES[name](jquat, np.random.default_rng(RNG_SEED))
    fn_t, _ = QUAT_CASES[name](quat, np.random.default_rng(RNG_SEED))
    conv = lambda a, f: f(a) if isinstance(a, np.ndarray) else a
    ref = np.asarray(fn_j(*(conv(a, jnp.asarray) for a in args)))
    out = fn_t(*(conv(a, torch.from_numpy) for a in args)).numpy()
    # to_euler goes through atan2 near +-pi: compare the angles' sin/cos
    if name == "to_euler":
        out, ref = np.stack([np.sin(out), np.cos(out)]), \
            np.stack([np.sin(ref), np.cos(ref)])
    np.testing.assert_allclose(out, ref, atol=1e-6 if name != "integrate"
                               else 2e-6)


def _spd(rng, n, batch):
    A = rng.standard_normal((batch, n, n))
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("name", ["chol", "inv_spd", "clamped_spd_solve"])
def test_linalg_matches(name):
    rng = np.random.default_rng(1)
    A = _spd(rng, 6, 8)
    b = rng.standard_normal((8, 6)).astype(np.float32)
    if name == "clamped_spd_solve":
        ref = jlinalg.clamped_spd_solve(jnp.asarray(A), jnp.asarray(b), 1e-2)
        out = linalg.clamped_spd_solve(torch.from_numpy(A),
                                       torch.from_numpy(b), 1e-2)
    else:
        ref = getattr(jlinalg, name)(jnp.asarray(A))
        out = getattr(linalg, name)(torch.from_numpy(A))
    # unrolled float32 Cholesky on cond ~1e1 matrices: 1e-5 scaled
    assert_scaled(out.numpy(), np.asarray(ref), 1e-5, name)


CHAINS = {"sim_rod": ("build_sim_chain", ("rod",)),
          "sim_gripper": ("build_sim_chain", ("gripper",)),
          "control": ("build_control_chain", ())}


def _chains(kind):
    fn, args = CHAINS[kind]
    return getattr(jpanda, fn)(*args), getattr(panda, fn)(*args)


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_chain_constants_equal(kind):
    a, b = _chains(kind)
    assert a.names == b.names
    for f in ("parent", "joint_type", "joint_axis", "joint_pos", "body_pos",
              "body_quat", "mass", "com", "inertia", "dof_body", "body_dof",
              "ancestor_mask", "joint_damping", "joint_range"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    if kind == "sim_rod":
        assert (a.nb, a.nv) == (17, 9)
    if kind == "control":
        assert a.nv == 7


@pytest.mark.parametrize("kind", sorted(CHAINS))
def test_fk_and_jacobian_match(kind):
    a, b = _chains(kind)
    rng = np.random.default_rng(2)
    lo = np.maximum(a.joint_range[:, 0], -2.5)
    hi = np.minimum(a.joint_range[:, 1], 2.5)
    q = rng.uniform(lo, hi, (8, a.nv)).astype(np.float32)
    # jitted: one compile instead of one dispatch per primitive
    xp_r, xq_r = jax.jit(jnp.vectorize(
        lambda qq: jchain.fk(a, qq),
        signature="(n)->(b,3),(b,4)"))(jnp.asarray(q))
    xp, xq = chain.fk(b, torch.from_numpy(q))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xp_r), atol=1e-5)
    np.testing.assert_allclose(xq.numpy(), np.asarray(xq_r), atol=1e-5)
    body = a.nb - 1
    J_r = jax.jit(jnp.vectorize(
        lambda qq: jchain.point_jacobian(a, qq, body),
        signature="(n)->(6,n)"))(jnp.asarray(q))
    J = chain.point_jacobian(b, torch.from_numpy(q), body)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_r), atol=1e-5)
