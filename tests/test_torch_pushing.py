"""A 2-step batched pushing episode: port == ``jax.vmap(pushing.step)``.

Both sides build PushingParams(n_substeps=2) with the JAX package's start
posture (carried across by ``convert.params_from_numpy``), reset B = 4 envs
from the same NumPy contexts and take the same two actions: a hold at the
tcp, then a 1 cm step toward the red box (a policy-sized delta). The JAX side's ``vmap`` runs its
per-env path on the CPU; the port runs its batched window through the
kernels' plain versions. Tolerances are those of tests/test_substep_bm.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import (HOLD_QUAT, actions, assert_scaled, contexts,
                               jax_pushing_params, port_pushing_params)

from d3il_tpu.control import offline_ik as joffline_ik
from d3il_tpu.envs import pushing as jpushing
from d3il_tpu.robot import panda as jpanda
from d3il_tpu_torch import convert
from d3il_tpu_torch.control import offline_ik
from d3il_tpu_torch.envs import pushing
from d3il_tpu_torch.robot import panda

B = 4
SCENE_FIELDS = ("q", "qd", "free_pos", "free_quat", "free_linvel",
                "free_angvel", "warm")


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def pair():
    jparams = jax_pushing_params(n_substeps=2)
    return jparams, port_pushing_params(jparams)


@pytest.fixture(scope="module")
def episode(pair):
    """Reset + 2 steps on both sides; returns [(jax, port, jres, pres)]."""
    jparams, params = pair
    ctx = contexts(7, B, red_xy=np.array([[0.55, -0.26], [0.45, -0.1],
                                          [0.50, -0.24], [0.42, -0.02]]))
    jstate = jax.jit(jax.vmap(lambda c: jpushing.reset(jparams, c)))(
        tuple(jnp.asarray(c) for c in ctx))
    state = pushing.reset(params, tuple(torch.from_numpy(c) for c in ctx))
    out = [(_np_tree(jstate), convert.pushing_state_to_numpy(state), None,
            None)]
    jstep = jax.jit(jax.vmap(lambda s, a: jpushing.step(jparams, s, a)))
    tcp = np.asarray(jax.vmap(lambda s: jparams.tcp_pose(s)[0])(
        jstate.scene))[:, :2]
    to_red = np.asarray(jstate.scene.free_pos)[:, 0, :2] - tcp
    push = 0.01 * to_red / np.linalg.norm(to_red, axis=1, keepdims=True)
    for acts in (actions(tcp), actions(tcp, push)):
        jstate, jres = jstep(jstate, jnp.asarray(acts))
        state, res = pushing.step(params, state, torch.from_numpy(acts))
        out.append((_np_tree(jstate), convert.pushing_state_to_numpy(state),
                    _np_tree(jres), res))
    return out


def _check_state(js, ps, when):
    for name in SCENE_FIELDS:
        # test_substep_bm.py:60-63: max-scaled absolute 3e-4
        assert_scaled(ps["scene"][name], getattr(js.scene, name), 3e-4,
                      f"{when} scene.{name}")
    np.testing.assert_allclose(ps["ctrl"]["q_virt"], js.ctrl.q_virt,
                               atol=1e-4, err_msg=f"{when} q_virt")
    np.testing.assert_allclose(ps["ctrl"]["old_des_vel"], js.ctrl.old_des_vel,
                               atol=2e-3, err_msg=f"{when} old_des_vel")
    for name in ("t", "terminated", "first_visit", "mode", "success"):
        np.testing.assert_array_equal(ps[name], getattr(js, name),
                                      err_msg=f"{when} {name}")


@pytest.mark.parametrize("i", [0, 1, 2], ids=["reset", "step1", "step2"])
def test_state_matches(episode, i):
    js, ps, _, _ = episode[i]
    _check_state(js, ps, ["reset", "step1", "step2"][i])


@pytest.mark.parametrize("i", [1, 2], ids=["step1", "step2"])
def test_step_result_matches(episode, i):
    _, _, jres, res = episode[i]
    # observations and reward are pre-substep state functions: 1e-4 absolute
    np.testing.assert_allclose(res.obs.numpy(), jres.obs, atol=1e-4)
    np.testing.assert_allclose(res.reward.numpy(), jres.reward, atol=1e-4)
    np.testing.assert_array_equal(res.done.numpy(), jres.done)
    np.testing.assert_array_equal(res.info["mode"].numpy(), jres.info["mode"])
    np.testing.assert_array_equal(res.info["success"].numpy(),
                                  jres.info["success"])
    np.testing.assert_allclose(res.info["mean_distance"].numpy(),
                               jres.info["mean_distance"], atol=1e-4)


def test_contact_active_in_episode(episode):
    """The episode exercises the contact solve: box-table rows carry force."""
    _, ps, _, _ = episode[2]
    assert np.abs(ps["scene"]["warm"]).max() > 1e-3


def test_state_round_trips_through_numpy(episode):
    _, ps, _, _ = episode[2]
    state = convert.pushing_state_from_numpy(ps, device="cpu")
    back = convert.pushing_state_to_numpy(state)
    for name in SCENE_FIELDS:
        np.testing.assert_array_equal(back["scene"][name], ps["scene"][name])
    np.testing.assert_array_equal(back["first_visit"], ps["first_visit"])


def test_offline_ik_matches():
    """offline_ik.solve cut to 50 iterations: both take the same float32
    FK path, so the float64 iterates agree to 1e-5 rad."""
    from d3il_tpu_torch.envs import scenes
    a = joffline_ik.solve(jpanda.build_control_chain(), scenes.INIT_EE_POS,
                          scenes.INIT_EE_QUAT, q0=jpanda.INIT_QPOS, it_max=50)
    b = offline_ik.solve(panda.build_control_chain(), scenes.INIT_EE_POS,
                         scenes.INIT_EE_QUAT, q0=panda.INIT_QPOS, it_max=50)
    np.testing.assert_allclose(b, a, atol=1e-5)


def test_null_converge_matches(pair):
    """_null_converge cut to 50 controller updates from a perturbed
    posture: the port's IK window == the JAX controller scan, 1e-4 rad."""
    jparams, params = pair
    q0 = jparams.q_init + np.array([0.05, -0.03, 0.02, 0.04, -0.05, 0.03,
                                    0.06])
    ee_pos, ee_quat = np.array([0.525, -0.28, 0.12]), HOLD_QUAT
    a = jparams._null_converge(q0, ee_pos, ee_quat, iters=50)
    b = params._null_converge(q0, ee_pos, ee_quat, iters=50)
    assert np.abs(a - q0).max() > 1e-3   # the posture moved
    np.testing.assert_allclose(b, a, atol=1e-4)
