"""Port arm kernels' plain versions == the JAX package's arm kernels.

K2 (arm stage) and K4 (feedforward) at B = 8 against the bodies of the
Pallas kernels, run op by op on the CPU (test_torch_jaxref.EagerRef), K4
also against the jnp feedforward, and K1 (IK window) over a 2-substep window
against the JAX window's jnp reference, with the tolerances of
tests/test_dyn_kernel.py. Inputs are NumPy draws from a seed, handed to both
sides. The CUDA kernels themselves are held against these plain versions by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import torch

from test_torch_jaxref import assert_scaled, run_kernel_body

from d3il_tpu.control.gains import CartPosQuatGains as JCartGains
from d3il_tpu.control.gains import JointPDGains as JPDGains
from d3il_tpu.engine import dyn_kernel as jdyn_kernel
from d3il_tpu.envs import scenes as jscenes
from d3il_tpu.robot import panda as jpanda
from d3il_tpu_torch.control import gains
from d3il_tpu_torch.engine import dyn_kernel
from d3il_tpu_torch.envs import scenes
from d3il_tpu_torch.robot import panda

# a start posture near the pushing task's (rod down over the table)
Q0 = np.array([-0.36, 0.434, -0.131, -2.054, 0.092, 2.485, 0.233])


def _arm_inputs(B, seed):
    rng = np.random.default_rng(seed)
    q = np.concatenate([Q0[:, None] + 0.1 * rng.standard_normal((7, B)),
                        0.02 + 0.01 * rng.random((2, B))])
    qd = 0.3 * rng.standard_normal((9, B))
    q_des = q[:7] + 0.01 * rng.standard_normal((7, B))
    qd_des = 0.1 * rng.standard_normal((7, B))
    tau = rng.standard_normal((7, B))
    sw = np.where(np.arange(B) % 2 == 0, 0.04, 0.0)
    gf = (np.arange(B) % 4 == 1).astype(np.float64)
    return [x.astype(np.float32) for x in (q, qd, q_des, qd_des, tau, sw, gf)]


def _ik_inputs(B, seed):
    rng = np.random.default_rng(seed)
    q_virt = jpanda.INIT_QPOS[:, None] + 0.2 * rng.standard_normal((7, B))
    old_vel = 0.05 * rng.standard_normal((7, B))
    des_pos = np.array([0.5, 0.0, 0.2])[:, None] \
        + 0.05 * rng.standard_normal((3, B))
    des_quat = np.tile(np.array([0.0, 1.0, 0.0, 0.0])[:, None], (1, B))
    return [x.astype(np.float32) for x in (q_virt, old_vel, des_pos, des_quat)]


def _arm_reference(ins):
    """The body of the Pallas arm-stage kernel on the inputs as they are
    ([.., B]: the tile is the whole batch)."""
    kernel, _, _ = jdyn_kernel._make_arm_kernel(jscenes.build_pushing_scene(),
                                                JPDGains())
    return run_kernel_body(kernel, ins, 7)


# test_dyn_kernel.py:73-79: max-scaled absolute error per output
ARM_TOL = {"xpos": 1e-5, "xquat": 1e-5, "axes": 1e-5, "anchors": 1e-5,
           "Minv": 3e-4, "qd_pre": 1e-3, "a_arm": 1e-3}
ARM_NAMES = ("xpos", "xquat", "axes", "anchors", "Minv", "qd_pre", "a_arm")


def test_arm_stage_plain_matches_pallas():
    B = 8
    ins = _arm_inputs(B, 0)
    ref = _arm_reference(ins)
    spec = dyn_kernel.ArmSpec(scenes.build_pushing_scene(),
                              gains.JointPDGains())
    t = [torch.from_numpy(x) for x in ins]
    out = dyn_kernel.arm_stage_bm(spec, *t[:6], t[6] > 0.5)
    for name, a, b in zip(ARM_NAMES, out, ref):
        assert_scaled(a.numpy(), b, ARM_TOL[name], name)


def _ik_reference(n_sub, ins):
    """The JAX window's jnp reference: the cartesian_step_bm scan plus the
    folded model feedforward, which tests/test_dyn_kernel.py holds
    ik_window_bm (interpret) to at the tolerances used below. The
    interpreted Pallas window itself takes about five minutes of CPU for
    this 2-substep window, more than this suite's budget allows for one
    test."""
    import jax
    from d3il_tpu.engine import substep_bm as jsubstep_bm
    chain, gains_j = jpanda.build_control_chain(), JCartGains()
    q_virt, old_vel, des_pos, des_quat = (jnp.asarray(x) for x in ins)
    B = q_virt.shape[-1]

    def body(carry, _):
        qv, ov = carry
        qv, ov, q_des, qd_des, qdd_des = jsubstep_bm.cartesian_step_bm(
            chain, gains_j, qv, ov, des_pos, des_quat, 1e-3)
        return (qv, ov), (q_des, qd_des, qdd_des)

    (qv, ov), (q_des, qd_des, qdd_des) = jax.lax.scan(
        body, (q_virt, old_vel), None, length=n_sub)
    fold = lambda x: jnp.moveaxis(x, 0, 1).reshape(7, n_sub * B)
    tau = jnp.moveaxis(jsubstep_bm.model_feedforward_bm(
        chain, fold(q_des), fold(qd_des), fold(qdd_des)).reshape(7, n_sub, B),
        1, 0)
    return [np.asarray(x) for x in (qv, ov, q_des, qd_des, tau)]


def test_ik_window_plain_matches_jax_window():
    """2-substep window; test_dyn_kernel.py:148-156 tolerances (absolute on
    q_virt / q_des, 3e-2 on the finite-difference velocities, 2e-3 scaled
    on the feedforward torque)."""
    B, n_sub = 8, 2
    ins = _ik_inputs(B, 0)
    qv_r, ov_r, qdes_r, qddes_r, tau_r = _ik_reference(n_sub, ins)
    spec = dyn_kernel.IkSpec(panda.build_control_chain(),
                             gains.CartPosQuatGains(), 1e-3)
    qv, ov, qdes, qddes, tau = dyn_kernel.ik_window_bm(
        spec, n_sub, *(torch.from_numpy(x) for x in ins))
    np.testing.assert_allclose(qv.numpy(), qv_r, atol=3e-5)
    np.testing.assert_allclose(qdes.numpy(), qdes_r, atol=3e-5)
    np.testing.assert_allclose(qddes.numpy(), qddes_r, atol=3e-2)
    np.testing.assert_allclose(ov.numpy(), ov_r, atol=3e-2)
    assert_scaled(tau.numpy(), tau_r, 2e-3, "tau_model")


def _ff_inputs(B, seed):
    """test_dyn_kernel.py:164-166: q uniform in +-1.5, qd ~ N(0, 1),
    qdd ~ 3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return [x.astype(np.float32) for x in (
        rng.uniform(-1.5, 1.5, (7, B)), rng.standard_normal((7, B)),
        3.0 * rng.standard_normal((7, B)))]


def _ff_port(ins):
    spec = dyn_kernel.IkSpec(panda.build_control_chain(),
                             gains.CartPosQuatGains(), 1e-3)
    return dyn_kernel.feedforward_bm(
        spec, *(torch.from_numpy(x) for x in ins)).numpy()


def test_feedforward_plain_matches_pallas():
    """K4 against the body of the Pallas feedforward kernel; 3e-4 scaled
    (test_dyn_kernel.py:169-171)."""
    ins = _ff_inputs(8, 0)
    kernel, _ = jdyn_kernel._make_ff_kernel(jpanda.build_control_chain())
    ref, = run_kernel_body(kernel, ins, 1)
    assert_scaled(_ff_port(ins), ref, 3e-4, "tau")


def test_feedforward_plain_matches_jnp_feedforward():
    """K4 against model_feedforward_bm, the jnp pipeline the JAX package
    holds its kernel to; 3e-4 scaled. B = 16 is the folded width of the IK
    window test above, so the jnp ops compile once for both."""
    from d3il_tpu.engine import substep_bm as jsubstep_bm
    ins = _ff_inputs(16, 1)
    ref = jsubstep_bm.model_feedforward_bm(
        jpanda.build_control_chain(), *(jnp.asarray(x) for x in ins))
    out = _ff_port(ins)
    assert np.abs(out).max() > 1.0        # the torques are not trivially 0
    assert_scaled(out, np.asarray(ref), 3e-4, "tau")


def test_chain_tables_pack_the_chains():
    """The kernels' chain tables carry each chain's arrays."""
    for chain in (panda.build_sim_chain("rod"), panda.build_control_chain()):
        tab = dyn_kernel.pack_chain(chain)
        nb, nv = chain.nb, chain.nv
        assert (tab.nb, tab.nv) == (nb, nv)
        np.testing.assert_array_equal(list(tab.parent)[:nb], chain.parent)
        np.testing.assert_array_equal(list(tab.dof_body)[:nv], chain.dof_body)
        np.testing.assert_allclose(np.array(tab.mass)[:nb], chain.mass,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            np.array(tab.inertia)[:nb].reshape(nb, 3, 3), chain.inertia,
            rtol=1e-6, atol=1e-9)
    scene = scenes.build_pushing_scene()
    arm = dyn_kernel.ArmSpec(scene, gains.JointPDGains()).params
    np.testing.assert_array_equal(np.array(arm.frange), scene.forcerange)
    np.testing.assert_allclose(np.array(arm.damping),
                               scene.robot.joint_damping, rtol=1e-6)
    np.testing.assert_allclose(np.array(arm.pg), gains.JointPDGains().pgain)
    np.testing.assert_allclose(np.array(arm.grav), scene.gravity, rtol=1e-6)
