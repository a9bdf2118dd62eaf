"""Aligning in the port against ``jax.vmap(aligning.step)``.

Both sides build AligningParams(n_substeps=2) with the JAX package's start
posture (carried across by ``convert.params_from_numpy``), reset B = 3 envs
from the same NumPy contexts, lower the tray onto the table and take the
same two xyz setpoints: a hold at the tcp, then a 1 cm move toward the tray
and down. The JAX side's
``vmap`` runs its per-env path on the CPU (``phase_single`` for the
contacts); the port runs its batched window through the kernels' plain
versions (K3's general variant on the card: 32 contacts, 96 rows).
Tolerances are tests/test_torch_pushing.py's. A 2-step bc rollout through
AligningSim runs on both sides, and rotation_distance is held on crafted
quaternions.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import (aligning_contexts, assert_scaled,
                               check_chunk_composition, check_rod_state,
                               check_start_pose, np_tree, port_params,
                               rod_expert_step, tiny_agents, xyz_actions)

from d3il_tpu.envs import aligning as jaligning
from d3il_tpu.eval import metrics as jmetrics
from d3il_tpu.eval import rollout as jrollout
from d3il_tpu.eval import sims as jsims
from d3il_tpu_torch import convert
from d3il_tpu_torch.data import experts
from d3il_tpu_torch.envs import aligning
from d3il_tpu_torch.envs.scenes import TABLE_Z
from d3il_tpu_torch.eval import sims

B = 3
FIELDS = ("t", "terminated", "mode", "success", "target_pos", "target_quat")


def _pair(kinematic):
    jparams = jaligning.AligningParams(n_substeps=2, max_steps=50,
                                       kinematic=kinematic)
    return jparams, port_params(jparams, aligning.AligningParams)


@pytest.fixture(scope="module")
def pair():
    return _pair(False)


@pytest.fixture(scope="module")
def kin_pair():
    return _pair(True)


def _run_episode(jparams, params):
    """Reset + 2 steps on both sides; returns [(jax, port, jres, pres)]."""
    ctx = aligning_contexts(5, B)
    jstate = jax.jit(jax.vmap(lambda c: jaligning.reset(jparams, c)))(
        tuple(jnp.asarray(c) for c in ctx))
    state = aligning.reset(params, tuple(torch.from_numpy(c) for c in ctx))
    out = [(np_tree(jstate), convert.state_to_numpy(state), None, None)]
    # the tray starts 9 mm above the table and would not reach it within
    # the test's 9 substeps: lower it on both sides to 0.5 mm into the table
    z = TABLE_Z + 0.01 - 5e-4
    jstate = jstate._replace(scene=jstate.scene._replace(
        free_pos=jstate.scene.free_pos.at[:, 0, 2].set(z)))
    fp = state.scene.free_pos.clone()
    fp[:, 0, 2] = z
    state = state._replace(scene=state.scene._replace(free_pos=fp))
    jstep = jax.jit(jax.vmap(lambda s, a: jaligning.step(jparams, s, a)))
    tcp = np.asarray(jax.vmap(lambda s: jparams.tcp_pose(s)[0])(jstate.scene))
    to_box = np.asarray(jstate.scene.free_pos)[:, 0] - tcp
    move = 0.01 * to_box / np.linalg.norm(to_box, axis=1, keepdims=True)
    for acts in (xyz_actions(tcp), xyz_actions(tcp, move)):
        jstate, jres = jstep(jstate, jnp.asarray(acts))
        state, res = aligning.step(params, state, torch.from_numpy(acts))
        out.append((np_tree(jstate), convert.state_to_numpy(state),
                    np_tree(jres), res))
    return out


@pytest.fixture(scope="module")
def episode(pair):
    return _run_episode(*pair)


@pytest.fixture(scope="module")
def kin_episode(kin_pair):
    return _run_episode(*kin_pair)


def _check_result(jres, res):
    # observations are pre-substep state functions: 1e-4 absolute
    np.testing.assert_allclose(res.obs.numpy(), jres.obs, atol=1e-4)
    np.testing.assert_array_equal(res.done.numpy(), jres.done)
    np.testing.assert_array_equal(res.info["mode"].numpy(), jres.info["mode"])
    np.testing.assert_array_equal(res.info["success"].numpy(),
                                  jres.info["success"])
    np.testing.assert_allclose(res.info["mean_distance"].numpy(),
                               jres.info["mean_distance"], atol=1e-4)


@pytest.mark.parametrize("kinematic", [False, True],
                         ids=["dynamic", "kinematic"])
@pytest.mark.parametrize("i", [0, 1, 2], ids=["reset", "step1", "step2"])
def test_state_matches(request, kinematic, i):
    ep = request.getfixturevalue("kin_episode" if kinematic else "episode")
    js, ps, _, _ = ep[i]
    check_rod_state(js, ps, FIELDS, ["reset", "step1", "step2"][i])


@pytest.mark.parametrize("kinematic", [False, True],
                         ids=["dynamic", "kinematic"])
@pytest.mark.parametrize("i", [1, 2], ids=["step1", "step2"])
def test_step_result_matches(request, kinematic, i):
    ep = request.getfixturevalue("kin_episode" if kinematic else "episode")
    _, _, jres, res = ep[i]
    _check_result(jres, res)


def test_tray_rests_on_the_table_with_contact(episode):
    """The compound tray: the base plate's four rows against the table (the
    first pair of the scene) carry the contact force and the walls' do not;
    the observation is 17 wide; the rod is outside the tray (mode 1)."""
    _, ps, _, res = episode[2]
    assert res.obs.shape == (B, 17)
    warm = np.abs(ps["scene"]["warm"])
    assert warm[:, :4].max() > 1e-3 and warm[:, 4:20].max() == 0.0
    np.testing.assert_array_equal(ps["mode"], [1, 1, 1])


def test_state_round_trips_through_numpy(episode):
    _, ps, _, _ = episode[2]
    state = convert.state_from_numpy(ps, aligning.AligningState, device="cpu")
    back = convert.state_to_numpy(state)
    for name in ("free_pos", "warm"):
        np.testing.assert_array_equal(back["scene"][name], ps["scene"][name])
    np.testing.assert_array_equal(back["target_quat"], ps["target_quat"])


def test_rotation_distance_matches():
    """Random unit quaternions, a pair equal up to sign and one equal up to
    rounding (|<p, q>| may exceed 1 in float32: the clip)."""
    rng = np.random.default_rng(4)
    p = rng.normal(size=(16, 4))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0], q[1] = -p[0], p[1] * (1 + 1e-7)
    p, q = p.astype(np.float32), q.astype(np.float32)
    want = np.asarray(jaligning.rotation_distance(jnp.asarray(p),
                                                  jnp.asarray(q)))
    got = aligning.rotation_distance(torch.from_numpy(p),
                                     torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] == 0.0 and np.isfinite(got).all()


def test_task_constants_match():
    """The port's own copies of the task's constants are the JAX
    package's."""
    for name in ("INIT_EE_POS", "BOX_SPACE", "TARGET_SPACE", "POS_MIN_DIST",
                 "ROT_MIN_DIST", "ROBOT_BOX_DIST"):
        np.testing.assert_array_equal(getattr(aligning, name),
                                      getattr(jaligning, name), err_msg=name)


def test_start_pose_matches(pair):
    check_start_pose(*pair)


def test_sample_context_lies_in_the_context_spaces():
    """The port's sampler draws from the JAX package's context spaces."""
    box_xy, box_q, tgt_xy, tgt_q = aligning.sample_context(
        torch.Generator().manual_seed(0), 256)
    for xy, space in ((box_xy, jaligning.BOX_SPACE),
                      (tgt_xy, jaligning.TARGET_SPACE)):
        assert (xy.numpy() >= space[0]).all() and (xy.numpy() <= space[1]).all()
    for q in (box_q, tgt_q):
        yaw = 2 * np.arctan2(q[:, 3].numpy(), q[:, 0].numpy())
        assert np.abs(yaw).max() <= np.pi / 2 + 1e-6
        np.testing.assert_allclose(q[:, 1:3].numpy(), 0.0, atol=1e-7)


# ---------------------------------------------------------------------------
# the evaluation harness: AligningSim on both sides
# ---------------------------------------------------------------------------

def _sim_contexts():
    """Two contexts: one drawn from the context spaces, one with the target
    on the tray's start pose, so that its episodes are done at the first
    step and stay frozen from the second."""
    box_xy, box_q, tgt_xy, tgt_q = aligning_contexts(8, 2)
    tgt_xy[1], tgt_q[1] = box_xy[1], box_q[1]
    return box_xy, box_q, tgt_xy, tgt_q


def test_bc_rollout_through_aligning_sim_matches(kin_pair, monkeypatch):
    """A 2-step bc rollout of 2 contexts x 2 trajectories through
    AligningSim (xyz setpoints, ``pos_dim=3``), weights carried across by
    ``convert``: the final scene agrees to 3e-4 scaled, success / mode / t
    exactly, and the metrics to 1e-5."""
    jparams, params = kin_pair
    jagent, agent = tiny_agents("bc", obs_dim=20, act_dim=3, hidden=16,
                                layers=2, seed=3)
    ctxs = _sim_contexts()
    monkeypatch.setattr(jsims.ref_contexts, "aligning_contexts", lambda: ctxs)
    monkeypatch.setattr(sims.ref_contexts, "aligning_contexts", lambda: ctxs)
    monkeypatch.setattr(jparams, "max_steps", 2)
    monkeypatch.setattr(params, "max_steps", 2)
    jsim = jsims.AligningSim(n_contexts=2, n_trajectories_per_context=2)
    sim = sims.AligningSim(n_contexts=2, n_trajectories_per_context=2)

    # jsims.AligningSim.test_agent up to the final state (sims.py:170-180)
    stepper = jrollout.make_rod_stepper(
        jparams, jaligning.reset, jaligning.step, jaligning.get_observation,
        jagent.policy_apply(), pos_dim=3)
    jctxs = jsims._fixed_or_sampled(
        jsims.ref_contexts.aligning_contexts, jaligning.sample_context,
        jsim.n_contexts, jsim.use_reference_contexts)
    cidx, keys = jsims._grid(2, 2, jsim.seed)
    ctx_of = lambda ci: jax.tree_util.tree_map(lambda x: x[ci], jctxs)
    jstate = np_tree(jsims._run_episodes(stepper, jagent, ctx_of,
                                         (cidx, keys), 2, 20))
    state, dones = sim.run_episodes(agent, params)
    ps = convert.state_to_numpy(state)
    check_rod_state(jstate, ps, FIELDS, "final")
    np.testing.assert_array_equal(ps["t"], [2, 2, 1, 1])
    np.testing.assert_array_equal(ps["success"], [False, False, True, True])
    np.testing.assert_array_equal(dones.numpy()[0], [False, False, True, True])
    # sims.py:181-189, on the final state already in hand
    pos_d = np.linalg.norm(jstate.scene.free_pos[:, 0] - jstate.target_pos,
                           axis=-1)
    rot_d = np.asarray(jaligning.rotation_distance(
        jnp.asarray(jstate.scene.free_quat[:, 0]),
        jnp.asarray(jstate.target_quat))) / np.pi
    want = {k: float(v) for k, v in jmetrics.aligning_score(
        jnp.asarray(jstate.success, jnp.float32).reshape(2, 2),
        jnp.asarray(jstate.mode).reshape(2, 2),
        jnp.asarray(0.5 * (pos_d + rot_d)).reshape(2, 2)).items()}
    got = sim.score(state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert got["success_rate"] == 0.5
    assert_scaled(got["mean_distance"], want["mean_distance"], 1e-5)


def test_expert_runner_chunk_is_its_steps(kin_pair):
    """One chunk of the aligning expert runner (2 steps, B = 3 in modes 0,
    1, 0, env 0 finished) equals the port's aligning expert step, its env
    step and the rollout's freeze composed step by step, exactly."""
    _, params = kin_pair
    init, chunk = experts.make_aligning_runner(params, chunk_len=2)
    ctx = tuple(torch.from_numpy(c) for c in aligning_contexts(5, B))
    carry0 = init(ctx, np.array([0, 1, 0]))

    def expert(carry, tcp):
        s = carry.env
        es, delta = experts.aligning_expert_step(
            carry.es, carry.des, tcp, s.scene.free_pos[:, 0],
            s.scene.free_quat[:, 0], s.target_pos, s.target_quat,
            carry.extras[0])
        return es, delta, (s.scene.free_pos[:, 0], s.scene.free_quat[:, 0])

    noise = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, B, 3)).astype(np.float32))
    check_chunk_composition(carry0, chunk, rod_expert_step(
        params, aligning.step, expert), noise)
