"""The cartesian impedance controller's update (``control/cartesian.step``)
against the JAX package's, and the start-posture search built on it.

``cartesian.step`` runs 200 updates from ``tests/test_controllers.py``'s
inputs (the default posture, a hold pose 0.525 / -0.28 / 0.12 with the rod
down) on both sides, compared after every update. ``_null_converge`` on
the CPU runs the JAX package's form (the update ``iters`` times) and gives
``PushingParams()`` its start posture in well under a second, where K1's
plain version took minutes.
"""
import time

import numpy as np
import jax
import jax.numpy as jnp
import torch

from test_torch_jaxref import assert_scaled
from test_torch_entry import Q_INIT

from d3il_tpu.control import cartesian as jcartesian
from d3il_tpu.control import gains as jgains
from d3il_tpu.ops import linalg as jlinalg
from d3il_tpu.robot import panda as jpanda
from d3il_tpu_torch.control import cartesian, gains
from d3il_tpu_torch.envs import common, pushing
from d3il_tpu_torch.robot import panda

DT = 1e-3
DES_POS = np.array([0.525, -0.28, 0.12], np.float32)
DES_QUAT = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
# scaled tolerances (|a - b| / max(|b|max, 1)) per output: q_des is the
# float32 rounding of the IK iterates; qd_des = dq / dt multiplies it by
# 1e3 and qdd_des = 0.4 dqd / dt by 4e5 (then clipped to +-25), which the
# 200-update run measures at 2.5e-7 / 3.5e-5 / 2.6e-2
STEP_TOLS = {"q_des": 1e-6, "qd_des": 1e-4, "qdd_des": 5e-2}
# PushingParams(device="cpu") without q_init, start-posture search included
PARAMS_SECONDS = 10.0


def test_step_matches_jax_over_200_updates():
    jchain, chain = jpanda.build_control_chain(), panda.build_control_chain()
    jg, g = jgains.CartPosQuatGains(), gains.CartPosQuatGains()
    jstep = jax.jit(lambda s: jcartesian.step(
        jchain, jg, s, jnp.asarray(DES_POS), jnp.asarray(DES_QUAT), DT))
    q0 = np.asarray(jpanda.INIT_QPOS, np.float32)
    js = jcartesian.init_state(jnp.asarray(q0))
    st = cartesian.init_state(torch.as_tensor(q0))
    for i in range(200):
        js, *jout = jstep(js)
        st, *out = cartesian.step(chain, g, st, torch.as_tensor(DES_POS),
                                  torch.as_tensor(DES_QUAT), DT)
        for name, a, b in zip(STEP_TOLS, out, jout):
            assert_scaled(a.numpy(), np.asarray(b), STEP_TOLS[name],
                          f"{name} at update {i}")
        assert_scaled(st.q_virt.numpy(), np.asarray(js.q_virt),
                      STEP_TOLS["q_des"], f"q_virt at update {i}")
    # the posture moved toward the pose (test_controllers.py's premise)
    assert np.abs(st.q_virt.numpy() - q0).max() > 0.05


def test_null_converge_on_the_cpu_matches_jax_q_init_in_seconds():
    """PushingParams(device="cpu") with no q_init runs the full
    4000-update window on the CPU and lands on the JAX package's
    PushingParams.q_init within 2e-6 rad (float32 rounding); the loop's
    early stop at a fixed point gives the state that running every update
    gives, bit for bit."""
    t0 = time.perf_counter()
    params = pushing.PushingParams(device="cpu")
    seconds = time.perf_counter() - t0
    assert seconds < PARAMS_SECONDS, seconds
    np.testing.assert_allclose(params.q_init, Q_INIT, atol=2e-6, rtol=0)
    assert common.NULL_CONVERGE_ITERS == 4000
    # every update run, no stop: 40 updates reach the same state
    q0, _, des_pos, des_quat = params.null_converge_window(
        params.start_ik(), params.init_ee_pos, params.init_ee_quat)
    st = cartesian.init_state(q0[:, 0])
    for _ in range(40):
        st, _, _, _ = cartesian.step(params.ctrl_chain, params.cart_gains,
                                     st, des_pos[:, 0], des_quat[:, 0],
                                     params.dt)
    np.testing.assert_array_equal(st.q_virt.double().numpy(),
                                  params.q_init)


def test_clamped_sym_solve_matches_jax():
    """The controller's clamped solve on random J W J' + reg I systems
    (rank-deficient ones among them), 1e-5 scaled."""
    rng = np.random.default_rng(0)
    for rank in (6, 4, 1):
        J = rng.normal(size=(8, 6, rank)).astype(np.float32)
        A = (J @ J.transpose(0, 2, 1) + 1e-12 * np.eye(6)).astype(np.float32)
        b = rng.normal(size=(8, 6)).astype(np.float32)
        want = jax.vmap(lambda a, y: jlinalg.clamped_spd_solve(a, y, 1e-2))(
            jnp.asarray(A), jnp.asarray(b))
        got = cartesian._clamped_sym_solve(torch.as_tensor(A),
                                           torch.as_tensor(b), 1e-2, 1e2)
        assert_scaled(got.numpy(), np.asarray(want), 1e-5, f"rank {rank}")
