"""A 2-step batched pushing episode: port == ``jax.vmap(pushing.step)``,
under full arm dynamics and in kinematic mode, and a 3-step bc rollout
through PushingSim on both sides, the port's also sharded over two gloo
processes.

Both sides build PushingParams(n_substeps=2) with the JAX package's start
posture (carried across by ``convert.params_from_numpy``), reset B = 4 envs
from the same NumPy contexts and take the same two actions: a hold at the
tcp, then a 1 cm step toward the red box (a policy-sized delta). The JAX side's ``vmap`` runs its
per-env path on the CPU; the port runs its batched window through the
kernels' plain versions. Tolerances are those of tests/test_substep_bm.py.
Every test that needs the JAX package's PushingParams is in this file, beside
the two module-scoped fixtures that build them (dynamic and kinematic).
"""
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import (HOLD_QUAT, actions, assert_scaled,
                               check_rod_state, contexts, jax_pushing_params,
                               np_tree, port_pushing_params, runner_noise,
                               spawn_ranks, tiny_agents)

from d3il_tpu.control import offline_ik as joffline_ik
from d3il_tpu.data import experts_jax as jexperts
from d3il_tpu.envs import pushing as jpushing
from d3il_tpu.eval import metrics as jmetrics
from d3il_tpu.eval import rollout as jrollout
from d3il_tpu.eval import sims as jsims
from d3il_tpu.robot import panda as jpanda
from d3il_tpu_torch import convert
from d3il_tpu_torch.control import offline_ik
from d3il_tpu_torch.data import experts, gen_demos
from d3il_tpu_torch.envs import pushing
from d3il_tpu_torch.eval import rollout, sims
from d3il_tpu_torch.robot import panda

B = 4
SCENE_FIELDS = ("q", "qd", "free_pos", "free_quat", "free_linvel",
                "free_angvel", "warm")


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
    out = [(np_tree(jstate), convert.state_to_numpy(state), None,
            None)]
    jstep = jax.jit(jax.vmap(lambda s, a: jpushing.step(jparams, s, a)))
    tcp = np.asarray(jax.vmap(lambda s: jparams.tcp_pose(s)[0])(
        jstate.scene))[:, :2]
    to_red = np.asarray(jstate.scene.free_pos)[:, 0, :2] - tcp
    push = 0.01 * to_red / np.linalg.norm(to_red, axis=1, keepdims=True)
    for acts in (actions(tcp), actions(tcp, push)):
        jstate, jres = jstep(jstate, jnp.asarray(acts))
        state, res = pushing.step(params, state, torch.from_numpy(acts))
        out.append((np_tree(jstate), convert.state_to_numpy(state),
                    np_tree(jres), res))
    return out


def _check_state(js, ps, when):
    check_rod_state(js, ps, ("t", "terminated", "first_visit", "mode",
                             "success"), when)


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
    state = convert.state_from_numpy(ps, pushing.PushingState, device="cpu")
    back = convert.state_to_numpy(state)
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


@pytest.fixture(scope="module")
def bc_sim(kin_pair):
    """The bc case of PushingSim: 2 contexts x 2 trajectories, 3 kinematic
    steps; the JAX Sim's final state (its one compile), the port's agent
    with the JAX weights, and the contexts."""
    jparams, _ = kin_pair
    jagent, agent = tiny_agents("bc", hidden=16, layers=2, seed=3)
    ctxs = _sim_contexts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsims.ref_contexts, "pushing_contexts", lambda: ctxs)
        mp.setattr(jparams, "max_steps", 3)
        jsim = jsims.PushingSim(n_contexts=2, n_trajectories_per_context=2)
        jstate = np_tree(_jax_sim_final_state(jsim, jagent, jparams))
    return jstate, agent, ctxs


def _check_bc_sim_state(jstate, state, dones):
    """The final scene to 3e-4 scaled, success / mode / t exactly."""
    ps = convert.state_to_numpy(state)
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


def test_bc_rollout_through_pushing_sim_matches(kin_pair, bc_sim,
                                                monkeypatch):
    """A 3-step bc rollout of 2 contexts x 2 trajectories through
    PushingSim, weights carried across by ``convert``: the final scene agrees
    to 3e-4 scaled, success / mode / t exactly, and the metrics to 1e-5. The
    second context's episodes finish at step 1: their state is the one after
    that step (t == 1), frozen since."""
    _, params = kin_pair
    jstate, agent, ctxs = bc_sim
    monkeypatch.setattr(sims.ref_contexts, "pushing_contexts", lambda: ctxs)
    monkeypatch.setattr(params, "max_steps", 3)
    sim = sims.PushingSim(n_contexts=2, n_trajectories_per_context=2)
    state, dones = sim.run_episodes(agent, params)
    _check_bc_sim_state(jstate, state, dones)
    # sims.py:151-154, on the final state already in hand
    want = {k: float(v) for k, v in jmetrics.pushing_score(
        jnp.asarray(jstate.success, jnp.float32).reshape(2, 2),
        jnp.asarray(jstate.mode).reshape(2, 2)).items()}
    got = sim.score(state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert got["success_rate"] == 0.5


SHARDED_SIM = r"""
import json, pickle, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from d3il_tpu_torch import convert, registry
from d3il_tpu_torch.data.scaler import Scaler
from d3il_tpu_torch.eval import sims
from d3il_tpu_torch.parallel import distributed as pdist

assert pdist.initialize_from_env(device="cpu")
rank, path = dist.get_rank(), sys.argv[1]
with open(path + ".pkl", "rb") as f:
    q_init, ctxs = pickle.load(f)
ck = torch.load(path + ".pt")
sims.ref_contexts.pushing_contexts = lambda: ctxs
params = convert.params_from_numpy(q_init, device="cpu", n_substeps=2,
                                   max_steps=3, kinematic=True)
agent, _ = registry.make_agent("bc", torch.Generator().manual_seed(0), 10, 2,
                               Scaler(**ck["scaler"]), hidden_dim=16,
                               num_hidden_layers=2)
agent.params = ck["params"]
sim = sims.PushingSim(n_contexts=2, n_trajectories_per_context=2)
state, dones = sim.run_episodes(agent, params)    # over the default group
torch.save({"state": state, "dones": dones, "score": sim.score(state)},
           f"{path}.{rank}")
dist.destroy_process_group()
print(json.dumps({"rank": rank}))
"""


def test_bc_pushing_sim_sharded_over_two_ranks_matches(kin_pair, bc_sim,
                                                       tmp_path):
    """The same bc rollout with PushingSim's grid sharded over two gloo
    processes (``parallel/mesh.run_sharded``, two episodes each), against
    the JAX Sim's final state, which ran over conftest's 8 virtual devices:
    on both ranks the whole grid at the tolerances of
    test_bc_rollout_through_pushing_sim_matches."""
    jparams, _ = kin_pair
    jstate, agent, ctxs = bc_sim
    path = str(tmp_path / "case")
    with open(path + ".pkl", "wb") as f:
        pickle.dump((jparams.q_init, ctxs), f)
    torch.save({"params": agent.params,
                "scaler": agent.scaler._asdict()}, path + ".pt")
    assert [o["rank"] for o in spawn_ranks(SHARDED_SIM, 2, path)] == [0, 1]
    want = {k: float(v) for k, v in jmetrics.pushing_score(
        jnp.asarray(jstate.success, jnp.float32).reshape(2, 2),
        jnp.asarray(jstate.mode).reshape(2, 2)).items()}
    for rank in range(2):
        got = torch.load(f"{path}.{rank}", weights_only=False)
        _check_bc_sim_state(jstate, got["state"], got["dones"])
        assert set(got["score"]) == set(want)
        for k in want:
            np.testing.assert_allclose(got["score"][k], want[k], atol=1e-5,
                                       err_msg=k)


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
        finals.append(convert.state_to_numpy(state))
    a, b = finals
    for name in SCENE_FIELDS:
        np.testing.assert_array_equal(a["scene"][name][2:],
                                      b["scene"][name][2:], err_msg=name)
    np.testing.assert_array_equal(b["t"], [3, 3, 1, 1])
    assert np.abs(a["scene"]["q"][:2] - b["scene"]["q"][:2]).max() > 0
    assert moves and max(moves) <= 0.01 + 1e-6


def test_expert_runner_matches_jax(kin_pair):
    """The pushing expert runner, kinematic (demo generation's default):
    B = 2 in modes 0 and 3, chunk_len 2, two chunks through
    ``run_chunked`` on both sides, the port given each env's JAX
    exploration normals: the env state at the tolerances above, the expert
    state's stage, phase and stall exactly and its distances 3e-4 scaled,
    the dones exactly, the logs (setpoint, tcp, box poses) 3e-4 scaled."""
    jparams, params = kin_pair
    n, L = 2, 2
    ctx = contexts(13, n)
    seq_box, seq_tgt = gen_demos.pushing_sequences(np.array([0, 3]))
    keys = jax.random.split(jax.random.PRNGKey(14), n)
    jinit, jchunk = jexperts.make_pushing_runner(jparams, chunk_len=L)
    carry0, fixed_z = jax.jit(jax.vmap(jinit))(
        tuple(jnp.asarray(c) for c in ctx), keys)
    jcw, jlogs, jdones = jexperts.run_chunked(
        jax.jit(jax.vmap(jchunk)),
        (carry0, (jnp.asarray(seq_box), jnp.asarray(seq_tgt), fixed_z)),
        2 * L, L)
    init, chunk = experts.make_pushing_runner(params, chunk_len=L)
    carry, logs, dones = experts.run_chunked(
        chunk, init(tuple(torch.from_numpy(c) for c in ctx), seq_box,
                    seq_tgt), 2 * L, L,
        noise=torch.from_numpy(runner_noise(keys, 2 * L, 2)))
    _check_state(np_tree(jcw[0].env), convert.state_to_numpy(carry.env),
                 "after two chunks")
    jes = np_tree(jcw[0].es)
    for name in ("stage", "phase", "stall", "striking"):
        np.testing.assert_array_equal(getattr(carry.es, name).numpy(),
                                      getattr(jes, name), err_msg=name)
    assert_scaled(carry.es.prev_d.numpy(), jes.prev_d, 3e-4, "prev_d")
    np.testing.assert_array_equal(dones, jdones)
    for got, want, name in zip(logs, jlogs, ("des", "tcp", "pos", "quat")):
        assert_scaled(got, want, 3e-4, name)
    assert np.abs(np.diff(logs[0][..., :2], axis=1)).max() <= 0.011 + 1e-6
