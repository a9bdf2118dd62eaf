"""Avoiding in the port against ``jax.vmap(avoiding.step)``.

The scene has no free body (nf = 0): the rod against six static capsule
obstacles and the table. Both sides build AvoidingParams(n_substeps=2)
with the JAX package's start posture, reset B = 3 envs, put the arm of
the first env into a posture whose rod sits 5 mm inside the first
obstacle (offline IK; the other two keep the start posture) and take the
same two setpoints: a hold at each tcp, then a 1 cm move in +y. The JAX
side's ``vmap`` runs its per-env path on the CPU; the port runs its batched
window through the kernels' plain versions (K3's register variant on the
card: 8 contacts, 24 rows, no free body). Tolerances are
tests/test_torch_pushing.py's, but for the contact forces (``WARM_TOL``).
``capsule_capsule``, the failure predicate and the 9-bit gate encoding are
held on crafted inputs.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import avoiding_contact_posture
from test_torch_jaxref import (HOLD_QUAT, assert_scaled, check_rod_state,
                               check_start_pose, np_tree, port_params,
                               runner_noise, tiny_agents)

from d3il_tpu.data import experts_jax as jexperts
from d3il_tpu.engine import collision as jcollision
from d3il_tpu.envs import avoiding as javoiding
from d3il_tpu.envs import scenes as jscenes
from d3il_tpu_torch import convert
from d3il_tpu_torch.data import experts
from d3il_tpu_torch.engine import collision
from d3il_tpu_torch.envs import avoiding, scenes
from d3il_tpu_torch.eval import sims

B = 3
FIELDS = ("t", "terminated", "mode_encoding", "passed", "success", "failure")
# The contact forces (``warm``) are held to 1e-2 scaled, the rest of the
# scene to 3e-4. At the second dynamic step env 0's rod slides along the
# obstacle on the edge of its friction cone (tangential force = mu x normal
# force), where the force's direction is ill-conditioned in the joints.
# tools/avoiding_warm_spread.py reads the JAX package's own spread there:
# its float32 forces lie 3.5e-3 scaled from its float64 ones and move by
# up to 5.3e-3 when env 0's joints move by 2e-7 rad (float32 rounding at 1
# rad), while the joints agree to 3e-7. The port lies 2.0e-3 from JAX's
# float32 forces and 1.5e-3 from its float64 ones. The first step (no
# sliding) and the kinematic steps stay within 1e-3.
WARM_TOL = 1e-2


def _pair(kinematic):
    jparams = javoiding.AvoidingParams(n_substeps=2, max_steps=50,
                                       kinematic=kinematic)
    return jparams, port_params(jparams, avoiding.AvoidingParams)


@pytest.fixture(scope="module")
def pair():
    return _pair(False)


@pytest.fixture(scope="module")
def kin_pair():
    return _pair(True)


def _run_episode(jparams, params):
    """Reset + 2 steps on both sides; returns [(jax, port, jres, pres)]."""
    jstate = jax.jit(jax.vmap(lambda _: javoiding.reset(jparams)))(
        jnp.zeros(B))
    state = avoiding.reset(params, avoiding.empty_context(B))
    out = [(np_tree(jstate), convert.state_to_numpy(state), None, None)]
    # env 0's arm (and the controller's posture) at the contact posture
    qc = avoiding_contact_posture(params).astype(np.float32)
    q = np.asarray(jstate.scene.q).copy()
    q[0, :7] = qc
    qv = np.asarray(jstate.ctrl.q_virt).copy()
    qv[0] = qc
    jstate = jstate._replace(
        scene=jstate.scene._replace(q=jnp.asarray(q)),
        ctrl=jstate.ctrl._replace(q_virt=jnp.asarray(qv)))
    state = state._replace(
        scene=state.scene._replace(q=torch.from_numpy(q)),
        ctrl=state.ctrl._replace(q_virt=torch.from_numpy(qv)))
    jstep = jax.jit(jax.vmap(lambda s, a: javoiding.step(jparams, s, a)))
    tcp = np.asarray(jax.vmap(lambda s: jparams.tcp_pose(s)[0])(jstate.scene))
    hold = np.concatenate([tcp, np.tile(HOLD_QUAT, (B, 1))], 1)
    move = hold + np.array([0.0, 0.01, 0, 0, 0, 0, 0])
    for acts in (hold, move):
        acts = acts.astype(np.float32)
        jstate, jres = jstep(jstate, jnp.asarray(acts))
        state, res = avoiding.step(params, state, torch.from_numpy(acts))
        out.append((np_tree(jstate), convert.state_to_numpy(state),
                    np_tree(jres), res))
    return out


@pytest.fixture(scope="module")
def episode(pair):
    return _run_episode(*pair)


@pytest.fixture(scope="module")
def kin_episode(kin_pair):
    return _run_episode(*kin_pair)


@pytest.mark.parametrize("kinematic", [False, True],
                         ids=["dynamic", "kinematic"])
@pytest.mark.parametrize("i", [0, 1, 2], ids=["reset", "step1", "step2"])
def test_state_matches(request, kinematic, i):
    ep = request.getfixturevalue("kin_episode" if kinematic else "episode")
    js, ps, _, _ = ep[i]
    check_rod_state(js, ps, FIELDS, ["reset", "step1", "step2"][i],
                    warm_tol=WARM_TOL)


@pytest.mark.parametrize("kinematic", [False, True],
                         ids=["dynamic", "kinematic"])
@pytest.mark.parametrize("i", [1, 2], ids=["step1", "step2"])
def test_step_result_matches(request, kinematic, i):
    ep = request.getfixturevalue("kin_episode" if kinematic else "episode")
    _, _, jres, res = ep[i]
    # observations are pre-substep state functions: 1e-4 absolute
    np.testing.assert_allclose(res.obs.numpy(), jres.obs, atol=1e-4)
    np.testing.assert_array_equal(res.done.numpy(), jres.done)
    for name in ("mode_encoding", "success"):
        np.testing.assert_array_equal(res.info[name].numpy(),
                                      jres.info[name], err_msg=name)


def test_rod_meets_the_obstacle(episode):
    """Env 0's rod is inside the first obstacle: its one rod-obstacle row
    (the scene's third contact, after the rod's two table rows) carries
    force through both steps, the failure predicate fires at the first
    step and ends the episode; the others stay free and running. The scene
    has no free body."""
    for i in (1, 2):
        _, ps, _, res = episode[i]
        warm = np.abs(ps["scene"]["warm"])
        assert warm[0, 2].max() > 1e-3
        assert warm[1:, 2:].max() == 0.0
        assert ps["scene"]["free_pos"].shape == (B, 0, 3)
        np.testing.assert_array_equal(ps["failure"], [True, False, False])
        np.testing.assert_array_equal(res.done.numpy(), [True, False, False])


def test_state_round_trips_through_numpy(episode):
    _, ps, _, _ = episode[2]
    state = convert.state_from_numpy(ps, avoiding.AvoidingState, device="cpu")
    back = convert.state_to_numpy(state)
    for name in ("q", "free_pos", "warm"):
        np.testing.assert_array_equal(back["scene"][name], ps["scene"][name])
    np.testing.assert_array_equal(back["passed"], ps["passed"])


def _segments(rng, n):
    """n seeded capsule pairs (pos, yaw-pitch quat, radius, half-length) and
    two crafted ones: parallel vertical cores side by side (the rod beside
    an obstacle) and two crossing horizontal cores."""
    pos = rng.uniform(-0.1, 0.1, (2, n, 3))
    q = rng.normal(size=(2, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos[:, -2:] = [[[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                   [[0.03, 0.0, 0.125], [0.0, 0.0, 0.01]]]
    h = np.sqrt(0.5)
    q[:, -2:] = [[[1.0, 0, 0, 0], [h, h, 0, 0]],
                 [[1.0, 0, 0, 0], [h, 0, h, 0]]]
    return pos.astype(np.float32), q.astype(np.float32)


def test_capsule_capsule_matches():
    """20 seeded pairs plus a parallel and a crossing one: contact point,
    normal and depth to 1e-5 against the JAX collider."""
    pos, q = _segments(np.random.default_rng(7), 22)
    r_a, hl_a, r_b, hl_b = 0.01, 0.14, 0.025, 0.1
    want = jax.vmap(lambda pa, qa, pb, qb: jcollision.capsule_capsule(
        pa, qa, r_a, hl_a, pb, qb, r_b, hl_b))(*(jnp.asarray(x) for x in (
            pos[0], q[0], pos[1], q[1])))
    got = collision.capsule_capsule(*(torch.from_numpy(x) for x in (
        pos[0], q[0])), r_a, hl_a, *(torch.from_numpy(x) for x in (
            pos[1], q[1])), r_b, hl_b)
    for name in ("pos", "normal", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-5,
                                   err_msg=name)
    # the parallel pair touches over its overlap (depth r_a + r_b - 0.03),
    # the crossing one at its crossing (depth r_a + r_b - 0.01)
    np.testing.assert_allclose(got.depth[-2:, 0].numpy(),
                               [r_a + r_b - 0.03, r_a + r_b - 0.01],
                               atol=1e-6)


def test_rod_collision_matches(pair):
    """The failure predicate on 8 arm postures: the start posture, the
    contact posture and six perturbations of the start (free of every
    obstacle) and of the contact posture (inside)."""
    jparams, params = pair
    rng = np.random.default_rng(2)
    qs = np.zeros((8, 9), np.float32)
    qs[0, :7] = params.q_init
    qs[1, :7] = avoiding_contact_posture(params)
    qs[2:5, :7] = params.q_init + 0.02 * rng.standard_normal((3, 7))
    qs[5:, :7] = qs[1, :7] + 2e-4 * rng.standard_normal((3, 7))
    want = np.asarray(jax.jit(jax.vmap(lambda q: javoiding._rod_collision(
        jparams, types.SimpleNamespace(q=q))))(jnp.asarray(qs)))
    got = avoiding._rod_collision(
        params, types.SimpleNamespace(q=torch.from_numpy(qs))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [False, True] + [False] * 3
                                  + [True] * 3)


def test_check_mode_matches():
    """Tcp tracks from below the first level to beyond the goal at 13
    crafted x: each gate's sides, each obstacle's x exactly (at the level-3
    middle obstacle's x the reference's last branch fires: the quirk it
    keeps) and a track that turns back. The encoding and the passed flags
    after every step, the port over the batch against the JAX function
    vmapped over the envs."""
    f32 = np.float32
    xs = np.array([0.30, 0.45, 0.55, 0.70, 0.40, 0.62, 0.36, 0.50, 0.64,
                   scenes.AVOIDING_L3_TOP_X, scenes.AVOIDING_L3_MID_X,
                   scenes.AVOIDING_L3_BOT_X, scenes.AVOIDING_L2_TOP_X], f32)
    ys = np.linspace(-0.2, 0.4, 31, dtype=f32)
    n = len(xs)
    enc, passed = np.zeros((n, 9), f32), np.zeros((n, 3), bool)
    state = avoiding.AvoidingState(
        scene=None, ctrl=None, t=None, terminated=None,
        mode_encoding=torch.from_numpy(enc), passed=torch.from_numpy(passed),
        success=None, failure=None)
    jcheck = jax.jit(jax.vmap(lambda e, p, tcp: javoiding._check_mode(
        types.SimpleNamespace(tcp_pose=lambda sc: (tcp, None)),
        javoiding.AvoidingState(None, None, None, None, e, p, None, None)
    )[4:6]))
    jenc, jpassed = jnp.asarray(enc), jnp.asarray(passed)
    for k, y in enumerate(ys):
        y_env = np.full(n, y, f32)
        y_env[-1] = ys[min(k, 31 - k)] if k > 20 else y   # turns back
        tcp = np.stack([xs, y_env, np.zeros(n, f32)], 1)
        p = types.SimpleNamespace(
            tcp_pose=lambda sc, t=torch.from_numpy(tcp): (t, None))
        state = avoiding._check_mode(p, state)
        jenc, jpassed = jcheck(jenc, jpassed, jnp.asarray(tcp))
        np.testing.assert_array_equal(state.mode_encoding.numpy(),
                                      np.asarray(jenc), err_msg=f"y {y}")
        np.testing.assert_array_equal(state.passed.numpy(),
                                      np.asarray(jpassed), err_msg=f"y {y}")
    enc = state.mode_encoding.numpy()
    assert enc[10, 8] == 1.0 and enc[10, 6:8].sum() == 0.0    # the quirk
    assert (state.passed.numpy()[:-1]).all()


def test_task_constants_match(pair):
    """The port's own copies of the layout and obstacle table are the JAX
    package's."""
    for name in dir(jscenes):
        if name.startswith("AVOIDING_"):
            assert getattr(scenes, name) == getattr(jscenes, name), name
    np.testing.assert_array_equal(pair[1].obstacles, pair[0].obstacles)
    check_start_pose(*pair)


def test_bc_rollout_through_avoiding_sim(kin_pair):
    """A 3-step bc rollout of 1 x 4 episodes through AvoidingSim: the
    empty context gives the batch, the planar setpoint moves at most 1 cm
    a step at the tcp's height, and the score is in range."""
    _, params = kin_pair
    _, agent = tiny_agents("bc", obs_dim=4, act_dim=2, hidden=16, layers=2,
                           seed=3)
    params = convert.params_from_numpy(params.q_init, avoiding.AvoidingParams,
                                       device="cpu", n_substeps=2, max_steps=3,
                                       kinematic=True)
    sim = sims.AvoidingSim(n_trajectories_per_context=4)
    tcp0 = []
    state, dones = sim.run_episodes(
        agent, params, on_step=lambda c: tcp0.append(c[2].clone()))
    assert state.mode_encoding.shape == (4, 9) and dones.shape == (3, 4)
    assert (torch.diff(torch.stack(tcp0), dim=0).abs() <= 0.01 + 1e-6).all()
    out = sim.score(state)
    assert 0.0 <= out["success_rate"] <= 1.0 and 0.0 <= out["entropy"] <= 1.0


def test_expert_runner_matches_jax(kin_pair):
    """The avoiding expert runner (kinematic, as demo generation runs it):
    B = 2, chunk_len 2, two chunks through ``run_chunked`` on both sides,
    the port given each env's JAX exploration normals: the env state at
    the tolerances above, the waypoint index and the dones exactly, the
    logged setpoints and tcps 3e-4 scaled."""
    jparams, params = kin_pair
    n, L = 2, 2
    rng = np.random.default_rng(4)
    wps = np.stack([experts.avoiding_waypoints(mode, rng)
                    for mode in ((0, 1, 2), (1, 2, 3))])
    keys = jax.random.split(jax.random.PRNGKey(12), n)
    jinit, jchunk = jexperts.make_avoiding_runner(jparams, chunk_len=L)
    carry0, fixed_z = jax.jit(jax.vmap(jinit))(keys)
    jcw, jlogs, jdones = jexperts.run_chunked(
        jax.jit(jax.vmap(jchunk)), (carry0, (jnp.asarray(wps), fixed_z)),
        2 * L, L)
    init, chunk = experts.make_avoiding_runner(params, chunk_len=L)
    carry, logs, dones = experts.run_chunked(
        chunk, init(wps), 2 * L, L,
        noise=torch.from_numpy(runner_noise(keys, 2 * L, 2)))
    check_rod_state(np_tree(jcw[0].env), convert.state_to_numpy(carry.env),
                    FIELDS, "after two chunks")
    np.testing.assert_array_equal(carry.es.k.numpy(), jcw[0].es.k)
    np.testing.assert_array_equal(dones, jdones)
    assert dones.shape == (n, 2 * L)
    for got, want, name in zip(logs, jlogs, ("des", "tcp")):
        assert_scaled(got, want, 3e-4, name)
    assert np.abs(np.diff(logs[0][..., :2], axis=1)).max() <= 0.011 + 1e-6
