"""A 2-step batched pushing episode: port == ``jax.vmap(pushing.step)``,
under full arm dynamics and in kinematic mode, and a 3-step bc rollout
through PushingSim on both sides.

Both sides build PushingParams(n_substeps=2) with the JAX package's start
posture (carried across by ``convert.params_from_numpy``), reset B = 4 envs
from the same NumPy contexts and take the same two actions: a hold at the
tcp, then a 1 cm step toward the red box (a policy-sized delta). The JAX side's ``vmap`` runs its
per-env path on the CPU; the port runs its batched window through the
kernels' plain versions. Tolerances are those of tests/test_substep_bm.py.
Every test that needs the JAX package's PushingParams is in this file, beside
the two module-scoped fixtures that build them (dynamic and kinematic).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import (HOLD_QUAT, actions, assert_scaled, contexts,
                               jax_pushing_params, port_pushing_params,
                               tiny_agents)

from d3il_tpu.control import offline_ik as joffline_ik
from d3il_tpu.envs import pushing as jpushing
from d3il_tpu.eval import metrics as jmetrics
from d3il_tpu.eval import rollout as jrollout
from d3il_tpu.eval import sims as jsims
from d3il_tpu.robot import panda as jpanda
from d3il_tpu_torch import convert
from d3il_tpu_torch.control import offline_ik
from d3il_tpu_torch.envs import pushing
from d3il_tpu_torch.eval import rollout, sims
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
def kin_pair():
    jparams = jax_pushing_params(n_substeps=2, kinematic=True)
    return jparams, port_pushing_params(jparams)


@pytest.fixture(scope="module")
def episode(pair):
    return _run_episode(*pair)


@pytest.fixture(scope="module")
def kin_episode(kin_pair):
    return _run_episode(*kin_pair)


def _run_episode(jparams, params):
    """Reset + 2 steps on both sides; returns [(jax, port, jres, pres)]."""
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


@pytest.mark.parametrize("i", [0, 1, 2], ids=["reset", "step1", "step2"])
def test_kinematic_state_matches(kin_episode, i):
    """kinematic=True: the arm beamed along the IK trajectory, fingers
    rate-limited, K3 with a zero arm inverse mass; same tolerances."""
    js, ps, _, _ = kin_episode[i]
    _check_state(js, ps, ["reset", "step1", "step2"][i])


@pytest.mark.parametrize("i", [1, 2], ids=["step1", "step2"])
def test_kinematic_step_result_matches(kin_episode, i):
    _, _, jres, res = kin_episode[i]
    np.testing.assert_allclose(res.obs.numpy(), jres.obs, atol=1e-4)
    np.testing.assert_allclose(res.reward.numpy(), jres.reward, atol=1e-4)
    np.testing.assert_array_equal(res.done.numpy(), jres.done)
    np.testing.assert_allclose(res.info["mean_distance"].numpy(),
                               jres.info["mean_distance"], atol=1e-4)


def test_kinematic_arm_follows_the_ik_trajectory(kin_episode, episode):
    """What sets the mode apart: after a step the arm sits exactly on the
    controller's virtual posture (no tracking error), the fingers moved by
    at most 0.2 m/s, and the boxes still feel contact."""
    _, ps, _, _ = kin_episode[2]
    np.testing.assert_array_equal(ps["scene"]["q"][:, :7],
                                  ps["ctrl"]["q_virt"])
    assert np.abs(ps["scene"]["qd"][:, 7:]).max() <= 0.2 + 1e-6
    assert np.abs(ps["scene"]["warm"]).max() > 1e-3
    _, pd, _, _ = episode[2]
    assert np.abs(pd["scene"]["q"][:, :7] - pd["ctrl"]["q_virt"]).max() > 0


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


# ---------------------------------------------------------------------------
# the evaluation harness: PushingSim on both sides
# ---------------------------------------------------------------------------

def _sim_contexts():
    """Two contexts (the sims' loader format): one drawn from the context
    space, one with both boxes on their targets, so that its episodes are
    done at the first step and stay frozen from the second."""
    red_xy, red_q, green_xy, green_q = contexts(11, 2)
    red_xy[1], green_xy[1] = (0.42, 0.3), (0.63, 0.3)
    return red_xy, red_q, green_xy, green_q


def _jax_sim_final_state(jsim, jagent, jparams):
    """jsims.PushingSim.test_agent up to the final state (sims.py:137-150)."""
    stepper = jrollout.make_rod_stepper(
        jparams, jpushing.reset, jpushing.step, jpushing.get_observation,
        jagent.policy_apply())
    ctxs = jsims._fixed_or_sampled(
        jsims.ref_contexts.pushing_contexts, jpushing.sample_context,
        jsim.n_contexts, jsim.use_reference_contexts)
    cidx, keys = jsims._grid(jsim.n_contexts,
                             jsim.n_trajectories_per_context, jsim.seed)
    ctx_of = lambda ci: jax.tree_util.tree_map(lambda x: x[ci], ctxs)
    return jsims._run_episodes(stepper, jagent, ctx_of, (cidx, keys),
                               jparams.max_steps, 10)


def test_bc_rollout_through_pushing_sim_matches(kin_pair, monkeypatch):
    """A 3-step bc rollout of 2 contexts x 2 trajectories through
    PushingSim, weights carried across by ``convert``: the final scene agrees
    to 3e-4 scaled, success / mode / t exactly, and the metrics to 1e-5. The
    second context's episodes finish at step 1: their state is the one after
    that step (t == 1), frozen since."""
    jparams, params = kin_pair
    jagent, agent = tiny_agents("bc", hidden=16, layers=2, seed=3)
    ctxs = _sim_contexts()
    monkeypatch.setattr(jsims.ref_contexts, "pushing_contexts", lambda: ctxs)
    monkeypatch.setattr(sims.ref_contexts, "pushing_contexts", lambda: ctxs)
    monkeypatch.setattr(jparams, "max_steps", 3)
    monkeypatch.setattr(params, "max_steps", 3)
    jsim = jsims.PushingSim(n_contexts=2, n_trajectories_per_context=2)
    sim = sims.PushingSim(n_contexts=2, n_trajectories_per_context=2)

    jstate = _np_tree(_jax_sim_final_state(jsim, jagent, jparams))
    state, dones = sim.run_episodes(agent, params)
    ps = convert.pushing_state_to_numpy(state)
    for name in SCENE_FIELDS:
        assert_scaled(ps["scene"][name], getattr(jstate.scene, name), 3e-4,
                      f"final scene.{name}")
    for name in ("t", "terminated", "first_visit", "mode", "success"):
        np.testing.assert_array_equal(ps[name], getattr(jstate, name),
                                      err_msg=name)
    np.testing.assert_array_equal(ps["t"], [3, 3, 1, 1])
    np.testing.assert_array_equal(ps["success"], [False, False, True, True])
    np.testing.assert_array_equal(dones.numpy()[0], [False, False, True, True])
    assert dones.numpy()[-1].all()        # t reaches max_steps - 1
    # sims.py:151-154, on the final state already in hand
    want = {k: float(v) for k, v in jmetrics.pushing_score(
        jnp.asarray(jstate.success, jnp.float32).reshape(2, 2),
        jnp.asarray(jstate.mode).reshape(2, 2)).items()}
    got = sim.score(state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert got["success_rate"] == 0.5


def test_rollout_freezes_every_leaf_of_finished_episodes(kin_pair,
                                                         monkeypatch):
    """Run the same rollout one step longer: the episodes that were done
    keep every leaf of their state, row by row, while the others move on;
    and the clip keeps each xy setpoint within 0.01 m of the last."""
    _, params = kin_pair
    _, agent = tiny_agents("bc", hidden=16, layers=2, seed=3)
    ctxs = _sim_contexts()
    finals, moves = [], []

    def watch(carry, prev=[None]):
        if prev[0] is not None:
            moves.append((carry[2] - prev[0]).abs().max().item())
        prev[0] = carry[2]

    monkeypatch.setattr(params, "max_steps", 50)   # no `done` by horizon
    for T in (2, 3):
        run = rollout.make_rod_rollout(
            params, pushing.reset, pushing.step, pushing.get_observation,
            agent.policy_apply(), max_steps=T)
        cidx = torch.tensor([0, 0, 1, 1])
        state, _ = run(agent.params, agent.init_carry(10, 4),
                       tuple(torch.from_numpy(c)[cidx] for c in ctxs),
                       on_step=watch if T == 3 else None)
        finals.append(convert.pushing_state_to_numpy(state))
    a, b = finals
    for name in SCENE_FIELDS:
        np.testing.assert_array_equal(a["scene"][name][2:],
                                      b["scene"][name][2:], err_msg=name)
    np.testing.assert_array_equal(b["t"], [3, 3, 1, 1])
    assert np.abs(a["scene"]["q"][:2] - b["scene"]["q"][:2]).max() > 0
    assert moves and max(moves) <= 0.01 + 1e-6
