"""Stacking in the port against ``jax.vmap(stacking.step)``.

The gripper chain under the joint window: no IK, joint PD toward the
action's setpoint, the gripper law, and contacts that reach the finger
slide joints. Both sides build StackingParams(n_substeps=2) with the JAX
package's start posture and reset B = 3 envs from the same NumPy contexts
(fingers open, 5 joint substeps). Env 0's red box is then put between the
open fingers, 1 mm into the left tip pad, on both sides. Step 1 holds the
joints and closes the gripper (the closing-velocity servo); before step 2
every env's close counter is set one below the grasp threshold, so that
step 2's close command engages the -20 N grasp force. The JAX side's
``vmap`` runs its per-env path on the CPU; the port runs its batched window
through the kernels' plain versions (K3's general variant on the card: 88
contacts, 264 rows, nv 27). Tolerances are tests/test_torch_pushing.py's.
The joint-space controllers, the mode functions and a 2-step bc rollout
through StackingSim are held as well.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import box_between_fingers
from test_torch_jaxref import (assert_scaled, check_chunk_composition,
                               check_rod_state,
                               check_start_pose, np_tree, port_params,
                               tiny_agents)

from d3il_tpu.control import joint_pd as jjoint_pd
from d3il_tpu.envs import stacking as jstacking
from d3il_tpu.eval import contexts as jcontexts
from d3il_tpu.eval import metrics as jmetrics
from d3il_tpu.eval import rollout as jrollout
from d3il_tpu.eval import sims as jsims
from d3il_tpu_torch import convert
from d3il_tpu_torch.control import joint_pd
from d3il_tpu_torch.data import experts
from d3il_tpu_torch.envs import stacking
from d3il_tpu_torch.eval import sims
from d3il_tpu_torch.eval.rollout import _freeze

B = 3
FIELDS = ("grasp", "t", "terminated", "target_xy", "mode", "mode_len",
          "placed", "success")


def _pair(kinematic):
    jparams = jstacking.StackingParams(n_substeps=2, max_steps=50,
                                       kinematic=kinematic)
    return jparams, port_params(jparams, stacking.StackingParams)


def _jax_reset(jparams):
    return jax.jit(jax.vmap(lambda c: jstacking.reset(jparams, c)))


@pytest.fixture(scope="module")
def pair():
    return _pair(False)


@pytest.fixture(scope="module")
def kin_pair():
    return _pair(True)


@pytest.fixture(scope="module")
def jax_reset(pair):
    """JAX's dynamic reset, compiled once for B envs: the dynamic episode
    and the bc rollout share it."""
    return _jax_reset(pair[0])


def stacking_contexts(seed, batch):
    """Contexts as NumPy (xy [B, 4, 2], quat [B, 4, 4]) in the JAX
    package's context spaces, yaw quats [cos, 0, 0, sin]."""
    rng = np.random.default_rng(seed)
    lo, hi = jstacking.SPACES[:, :2], jstacking.SPACES[:, 2:]
    xy = rng.uniform(lo, hi, (batch, 4, 2))
    h = np.deg2rad(rng.uniform(-90.0, 90.0, (batch, 4))) / 2
    quat = np.stack([np.cos(h), 0 * h, 0 * h, np.sin(h)], -1)
    return xy.astype(np.float32), quat.astype(np.float32)


def _run_episode(jparams, params, jreset):
    """Reset + 2 steps on both sides; returns [(jax, port, jres, pres)]."""
    ctx = stacking_contexts(5, B)
    jstate = jreset(tuple(jnp.asarray(c) for c in ctx))
    state = stacking.reset(params, tuple(torch.from_numpy(c) for c in ctx))
    out = [(np_tree(jstate), convert.state_to_numpy(state), None, None)]
    fp = np.asarray(jstate.scene.free_pos).copy()
    fq = np.asarray(jstate.scene.free_quat).copy()
    fp[0, 0] = box_between_fingers(params, state.scene)[0].numpy()
    fq[0, 0] = [1.0, 0.0, 0.0, 0.0]
    jstate = jstate._replace(scene=jstate.scene._replace(
        free_pos=jnp.asarray(fp), free_quat=jnp.asarray(fq)))
    state = state._replace(scene=state.scene._replace(
        free_pos=torch.from_numpy(fp), free_quat=torch.from_numpy(fq)))
    jstep = jax.jit(jax.vmap(lambda s, a: jstacking.step(jparams, s, a)))
    close = np.concatenate([np.asarray(jstate.ctrl_q),
                            np.zeros((B, 1), np.float32)], 1)
    for k in range(2):
        if k == 1:      # one close step short of the grasp force
            g = np.full(B, params.grasp_steps, np.int32)
            jstate = jstate._replace(grasp=jnp.asarray(g))
            state = state._replace(grasp=torch.from_numpy(g))
        jstate, jres = jstep(jstate, jnp.asarray(close))
        state, res = stacking.step(params, state, torch.from_numpy(close))
        out.append((np_tree(jstate), convert.state_to_numpy(state),
                    np_tree(jres), res))
    return out


@pytest.fixture(scope="module")
def episode(pair, jax_reset):
    return _run_episode(*pair, jax_reset)


@pytest.fixture(scope="module")
def kin_episode(kin_pair):
    return _run_episode(*kin_pair, _jax_reset(kin_pair[0]))


@pytest.mark.parametrize("kinematic", [False, True],
                         ids=["dynamic", "kinematic"])
@pytest.mark.parametrize("i", [0, 1, 2], ids=["reset", "step1", "step2"])
def test_state_matches(request, kinematic, i):
    ep = request.getfixturevalue("kin_episode" if kinematic else "episode")
    js, ps, _, _ = ep[i]
    check_rod_state(js, ps, FIELDS, ["reset", "step1", "step2"][i])
    # the held setpoint: the reset's joint positions, then the action's
    assert_scaled(ps["ctrl_q"], js.ctrl_q, 3e-4, "ctrl_q")


@pytest.mark.parametrize("kinematic", [False, True],
                         ids=["dynamic", "kinematic"])
@pytest.mark.parametrize("i", [1, 2], ids=["step1", "step2"])
def test_step_result_matches(request, kinematic, i):
    ep = request.getfixturevalue("kin_episode" if kinematic else "episode")
    _, _, jres, res = ep[i]
    # observations are pre-substep state functions: 1e-4 absolute
    np.testing.assert_allclose(res.obs.numpy(), jres.obs, atol=1e-4)
    np.testing.assert_array_equal(res.done.numpy(), jres.done)
    for name in ("mode", "mode_len", "success", "success_1", "success_2"):
        np.testing.assert_array_equal(res.info[name].numpy(),
                                      jres.info[name], err_msg=name)


def test_fingers_grasp_the_box(episode, pair):
    """Step 1's close command counts 1 and runs the closing servo; step 2's
    passes the threshold and engages the grasp force, under which the free
    fingers (envs 1, 2) close faster. Env 0's box sits on the left tip pad,
    whose rows (pair 6: the tip against the red box) carry force at both
    steps, and the other envs' do not."""
    (_, ps1, _, _), (_, ps2, _, _) = episode[1], episode[2]
    np.testing.assert_array_equal(ps1["grasp"], [1] * B)
    np.testing.assert_array_equal(ps2["grasp"], [pair[1].grasp_steps + 1] * B)
    qd1, qd2 = ps1["scene"]["qd"][:, 7:], ps2["scene"]["qd"][:, 7:]
    assert (qd1 < 0).all() and (qd2[1:] < qd1[1:]).all()
    for ps in (ps1, ps2):
        warm = np.abs(ps["scene"]["warm"])
        assert warm[0, 24:28].max() > 1e-3 and warm[1:, 24:28].max() == 0.0


def test_state_round_trips_through_numpy(episode):
    _, ps, _, _ = episode[2]
    state = convert.state_from_numpy(ps, stacking.StackingState, device="cpu")
    back = convert.state_to_numpy(state)
    for name in ("q", "free_pos", "warm"):
        np.testing.assert_array_equal(back["scene"][name], ps["scene"][name])
    for name in ("ctrl_q", "grasp", "placed"):
        np.testing.assert_array_equal(back[name], ps[name])


def test_joint_pd_matches():
    """PD, the model feedforward and their sum on 5 seeded (q_des, qd_des,
    qdd_des, q, qd) against the JAX functions per env: PD to 1e-5, the
    feedforward to 3e-4 scaled (tests/test_dyn_kernel.py:169-171)."""
    from d3il_tpu.control import gains as jgains
    from d3il_tpu.robot import panda as jpanda
    from d3il_tpu_torch.control import gains
    from d3il_tpu_torch.robot import panda
    rng = np.random.default_rng(11)
    qd_, qdd_ = (rng.normal(size=(5, 7)).astype(np.float32) for _ in "ab")
    q_des = (joint_pd.DEFAULT_SETPOINT
             + 0.3 * rng.normal(size=(5, 7))).astype(np.float32)
    q = (q_des + 0.05 * rng.normal(size=(5, 7))).astype(np.float32)
    qd = rng.normal(size=(5, 7)).astype(np.float32)
    jchain, chain = jpanda.build_control_chain(), panda.build_control_chain()
    jg, g = jgains.JointPDGains(), gains.JointPDGains()
    t = lambda *xs: [torch.from_numpy(x) for x in xs]
    j = lambda *xs: [jnp.asarray(x) for x in xs]
    np.testing.assert_array_equal(joint_pd.DEFAULT_SETPOINT,
                                  jjoint_pd.DEFAULT_SETPOINT)
    np.testing.assert_allclose(
        joint_pd.pd_accel(g, *t(q_des, qd_, q, qd)).numpy(),
        np.asarray(jjoint_pd.pd_accel(jg, *j(q_des, qd_, q, qd))), atol=1e-5)
    ff = jax.jit(jax.vmap(
        lambda a, b, c: jjoint_pd.model_feedforward(jchain, a, b, c)))
    assert_scaled(joint_pd.model_feedforward(chain, *t(q_des, qd_, qdd_)),
                  np.asarray(ff(*j(q_des, qd_, qdd_))), 3e-4, "feedforward")
    tot = jax.jit(jax.vmap(
        lambda *a: jjoint_pd.feedforward_torque(jchain, jg, *a)))
    assert_scaled(
        joint_pd.feedforward_torque(chain, g, *t(q_des, qd_, qdd_, q, qd)),
        np.asarray(tot(*j(q_des, qd_, qdd_, q, qd))), 3e-4, "torque")


def _mode_states(free_pos, target_xy, placed, mode, mode_len):
    """The same crafted states on both sides: the port's batched, the JAX
    package's one per env (only the fields the mode functions read)."""
    port = stacking.StackingState(
        scene=types.SimpleNamespace(free_pos=torch.from_numpy(free_pos)),
        ctrl_q=None, grasp=None, t=None, terminated=None,
        target_xy=torch.from_numpy(target_xy), mode=torch.from_numpy(mode),
        mode_len=torch.from_numpy(mode_len), placed=torch.from_numpy(placed),
        success=None)
    jax_ = [jstacking.StackingState(
        scene=types.SimpleNamespace(free_pos=jnp.asarray(free_pos[b])),
        ctrl_q=None, grasp=None, t=None, terminated=None,
        target_xy=jnp.asarray(target_xy[b]), mode=jnp.asarray(mode[b]),
        mode_len=jnp.asarray(mode_len[b]), placed=jnp.asarray(placed[b]),
        success=None) for b in range(len(mode))]
    return port, jax_


def test_update_mode_and_success_match():
    """Three updates of 40 crafted envs with boxes near the target (some
    placed already, some orders full) and stacked at z 0, 0.06 or 0.12:
    the arrival order, its length, the placed flags and the success
    predicate, the port over the batch against the JAX functions per
    env. At most one box arrives per env and update."""
    rng = np.random.default_rng(4)
    n = 40
    target = rng.uniform([0.4, 0.15], [0.6, 0.25], (n, 2)).astype(np.float32)
    xy = target[:, None] + rng.uniform(-0.09, 0.09, (n, 3, 2))
    z = 0.06 * rng.integers(0, 3, (n, 3))
    free_pos = np.concatenate([xy, z[..., None]], 2).astype(np.float32)
    free_pos[:4, :, 2] = [0.0, 0.06, 0.12]       # stacked: success when close
    free_pos[:4, :, :2] = target[:4, None] + 0.01
    placed = rng.random((n, 3)) < 0.2
    mode_len = placed.sum(1).astype(np.int32)
    mode = np.where(np.arange(3) < mode_len[:, None],
                    rng.integers(0, 3, (n, 3)), -1).astype(np.int32)
    state, jstates = _mode_states(free_pos, target, placed, mode, mode_len)
    got = stacking._success_now(state).numpy()
    want = np.array([bool(jstacking._success_now(js)) for js in jstates])
    np.testing.assert_array_equal(got, want)
    assert got[:4].all() and not got.all()
    arrived = 0
    for _ in range(3):
        before = state.mode_len.clone()
        state = stacking._update_mode(state)
        jstates = [jstacking._update_mode(js) for js in jstates]
        for name in ("mode", "mode_len", "placed"):
            w = np.stack([np.asarray(getattr(js, name)) for js in jstates])
            np.testing.assert_array_equal(getattr(state, name).numpy(), w,
                                          err_msg=name)
        step = (state.mode_len - before).numpy()
        assert set(np.unique(step)) <= {0, 1}
        arrived += step.sum()
    assert arrived > 0


def test_task_constants_and_contexts(pair):
    """The port's own copies of the task's constants are the JAX
    package's, its start pose too, and its sampler draws from the JAX
    package's context spaces."""
    for name in ("INIT_EE_POS", "POS_MIN_DIST", "Z_SEP", "SPACES",
                 "BOX_SIZES"):
        np.testing.assert_array_equal(getattr(stacking, name),
                                      getattr(jstacking, name), err_msg=name)
    assert pair[1].grasp_steps == round(0.5 / (2 * pair[0].dt))
    check_start_pose(*pair)
    xy, quat = stacking.sample_context(torch.Generator().manual_seed(0), 256)
    lo, hi = jstacking.SPACES[:, :2], jstacking.SPACES[:, 2:]
    assert (xy.numpy() >= lo).all() and (xy.numpy() <= hi).all()
    yaw = 2 * np.arctan2(quat[..., 3].numpy(), quat[..., 0].numpy())
    assert np.abs(yaw).max() <= np.pi / 2 + 1e-6


def test_bc_rollout_through_stacking_sim_matches(pair, jax_reset,
                                                 monkeypatch):
    """A 2-step bc rollout of 2 contexts x 1 trajectory through StackingSim
    (the joint-space rollout on the first two shipped contexts) under full
    dynamics, weights carried across by ``convert``: the final scene agrees
    to 3e-4 scaled, the task state exactly, and the metrics against the
    shipped mode priors to 1e-5. The JAX side's episodes start from its
    reset of the shipped contexts, taken with the module's compiled reset
    (B of them; the first two are used) and handed to ``make_joint_stepper``
    as its reset's result, so that its reset compiles once per module."""
    jparams, params = pair
    jagent, agent = tiny_agents("bc", obs_dim=20, act_dim=8, hidden=16,
                                layers=2, seed=3)
    monkeypatch.setattr(jparams, "max_steps", 2)
    monkeypatch.setattr(params, "max_steps", 2)
    sim = sims.StackingSim(n_contexts=2, n_trajectories_per_context=1)

    # jsims.StackingSim.test_agent up to the final state (sims.py:283-293)
    stepper = jrollout.make_joint_stepper(
        jparams, lambda _, reset_state: reset_state, jstacking.step,
        jstacking.get_observation, jstacking.robot_state,
        jagent.policy_apply())
    jctxs = jsims._fixed_or_sampled(jcontexts.stacking_contexts,
                                    jstacking.sample_context, B, True)
    resets = jax_reset(jctxs)
    cidx, keys = jsims._grid(2, 1, 0)
    ctx_of = lambda ci: jax.tree_util.tree_map(lambda x: x[ci], resets)
    jstate = np_tree(jsims._run_episodes(stepper, jagent, ctx_of,
                                         (cidx, keys), 2, 20))
    state, dones = sim.run_episodes(agent, params)
    ps = convert.state_to_numpy(state)
    check_rod_state(jstate, ps, FIELDS, "final")
    np.testing.assert_array_equal(ps["t"], [2, 2])
    assert dones.shape == (2, 2)
    # sims.py:294-310 with the shipped priors
    p1, p2, p3 = jcontexts.stacking_mode_priors()
    C, T = 2, 1
    f32 = lambda x: jnp.asarray(x, jnp.float32).reshape(C, T)
    want = {k: float(v) for k, v in jmetrics.stacking_score(
        jnp.asarray(jstate.mode).reshape(C, T, 3),
        jnp.asarray(jstate.mode_len).reshape(C, T), f32(jstate.success),
        f32(jstate.mode_len > 0), f32(jstate.mode_len > 1),
        p1, p2, p3).items()}
    got = sim.score(state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_expert_runner_chunk_is_its_steps(pair):
    """One chunk of the stacking expert runner (full dynamics, as demo
    generation runs stacking; 2 steps, B = 3, env 0 finished) equals the
    port's stacking expert step (the gates on the physical tcp and the
    measured width), the noisy joint setpoint, its env step and the
    rollout's freeze composed step by step, exactly."""
    _, params = pair
    init, chunk = experts.make_stacking_runner(params, chunk_len=2)
    ctx = tuple(torch.from_numpy(c) for c in stacking_contexts(5, B))
    carry0 = init(ctx, np.array([[0, 1, 2], [2, 0, 1], [1, 2, 0]]))

    def step(carry, z):
        s, done = carry.env, carry.done
        tcp, _ = params.tcp_pose(s.scene)
        width = s.scene.q[:, 7] + s.scene.q[:, 8]
        es, action = experts.stacking_expert_step(
            params.ctrl_chain, carry.es, s.scene.free_pos, s.scene.free_quat,
            s.target_xy, carry.extras[0], tcp_pos=tcp, width_meas=width)
        q = action[:, :7] + torch.where(done[:, None], 0.0,
                                        z * experts.STACK_Q_NOISE)
        ns, res = stacking.step(params, s, torch.cat([q, action[:, 7:]], 1))
        return (carry._replace(env=_freeze(done, ns, s),
                               es=_freeze(done, es, carry.es),
                               done=done | res.done),
                (q, width, s.scene.free_pos, s.scene.free_quat), res.done)

    noise = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, B, 7)).astype(np.float32))
    carry = check_chunk_composition(carry0, chunk, step, noise)
    assert (carry.es.q_des[1:] != carry0.es.q_des[1:]).any()
