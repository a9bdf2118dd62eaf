"""Inserting in the port against the JAX package's ``inserting.step``.

The eighth task: three boxes, the table and 17 maze walls (78 contact
pairs, 270 contacts, 810 rows, nv 27), the largest scene K3's general
variant serves (on the card its compact kernel solves only each env's
active contacts, 18 on the pressed scene). The JAX
package runs it per env (its contact tile is 0: ``jax.vmap(step)`` maps
the per-env step on every backend); the port runs it on its batched
window, here through the kernels' plain versions. The JAX reset and steps
are jitted for one env and called per env (``per_env``): traced under
``vmap`` the same functions take twice as long to trace and ~1.5x to
compile on the CPU, with the same results to 1e-6.
Both sides build InsertingParams(n_substeps=2) at the JAX package's start
posture and reset B = 2 envs from the same NumPy contexts; from that reset
each side takes a hold step at the tcp, then a step of 1 cm toward the
first box, in dynamic and in kinematic mode (one compile of the JAX reset
and one of the JAX step per mode). Tolerances are
tests/test_torch_pushing.py's: observations 1e-4 absolute, the scene 3e-4
max-scaled, but for the joint velocities of the dynamic push (PUSH_QD_TOL
below). A 2-step gmm rollout through InsertingSim runs on both sides from
the reset; the mode functions and the scoring are held on crafted arrays.
"""
import copy
import types
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import (_yaw_quat, actions, check_chunk_composition,
                               check_rod_state, check_start_pose, np_tree,
                               port_params, rod_expert_step, tiny_agents)

from d3il_tpu.engine import contact as jcontact
from d3il_tpu.engine import step as jestep
from d3il_tpu.envs import inserting as jinserting
from d3il_tpu.eval import metrics as jmetrics
from d3il_tpu_torch import convert
from d3il_tpu_torch.data import experts
from d3il_tpu_torch.engine import contact_kernel
from d3il_tpu_torch.envs import inserting
from d3il_tpu_torch.eval import sims

B = 2
FIELDS = ("t", "terminated", "visited", "order", "n_visited", "success")
# The dynamic push's joint velocities (~0.7 rad/s after its 2 ms) are set
# to ~3e-4 by float32 rounding: the controller's window differentiates its
# IK trajectory, and ``python tools/first_push_spread.py`` reads, at this
# file's push, JAX float32 1.4e-4 from JAX float64, JAX float32 with the
# controller's posture moved by one ulp up to 3.4e-4 from itself and 2.8e-4
# from float64, the port 3.5e-4 from JAX float32 and 2.9e-4 from float64.
# Twice the largest self-spread read; the hold and the kinematic steps,
# and every other state field, keep 3e-4.
PUSH_QD_TOL = 7e-4


def inserting_contexts(seed, batch):
    """Contexts as NumPy (xy [B, 3, 2], quat [B, 3, 4]): each box's xy in
    the JAX package's context space and a yaw in [-90, 90] degrees."""
    rng = np.random.default_rng(seed)
    sp = jinserting.CONTEXT_SPACES
    xy = rng.uniform(sp[:, :2], sp[:, 2:], (batch, 3, 2))
    deg = rng.uniform(-90.0, 90.0, (batch, 3))
    return xy.astype(np.float32), _yaw_quat(deg).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jinserting.InsertingParams(n_substeps=2, max_steps=50)


def per_env(fn, *args):
    """``fn``, a jitted JAX function of one env, over the envs of the
    batched pytrees ``args``, its outputs stacked back into a batch."""
    outs = [fn(*jax.tree_util.tree_map(lambda x: x[e], args))
            for e in range(B)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs)


def _steps(jparams, params, jstate, state, out):
    """A hold at the tcp, then 1 cm toward the first box, on both sides
    from (jstate, state); appends (jax, port, jres, pres) per step to
    ``out``; returns the compiled JAX step."""
    jstep = jax.jit(lambda s, a: jinserting.step(jparams, s, a))
    tcp = np.asarray(jax.vmap(lambda s: jparams.tcp_pose(s)[0])(
        jstate.scene))[:, :2]
    to_box = np.asarray(jstate.scene.free_pos)[:, 0, :2] - tcp
    push = 0.01 * to_box / np.linalg.norm(to_box, axis=1, keepdims=True)
    for acts in (actions(tcp), actions(tcp, push)):
        jstate, jres = per_env(jstep, jstate, jnp.asarray(acts))
        state, res = inserting.step(params, state, torch.from_numpy(acts))
        out.append((np_tree(jstate), convert.state_to_numpy(state),
                    np_tree(jres), res))
    return jstep


@pytest.fixture(scope="module")
def dynamic(jparams):
    """(port params, [(jax, port, jres, pres)] for the reset and 2 steps,
    the JAX reset state, the compiled JAX step)."""
    params = port_params(jparams, inserting.InsertingParams)
    ctx = inserting_contexts(3, B)
    jreset = jax.jit(lambda c: jinserting.reset(jparams, c))
    jstate0 = per_env(jreset, tuple(jnp.asarray(c) for c in ctx))
    state0 = inserting.reset(params, tuple(torch.from_numpy(c) for c in ctx))
    out = [(np_tree(jstate0), convert.state_to_numpy(state0), None, None)]
    jstep = _steps(jparams, params, jstate0, state0, out)
    return params, out, jstate0, state0, jstep


@pytest.fixture(scope="module")
def kinematic(jparams, dynamic):
    """The same 2 steps in kinematic mode from the dynamic fixture's reset
    (kinematic selects the engine step only: the same JAX start posture)."""
    jkin = copy.copy(jparams)
    jkin.kinematic = True
    jkin._engine_step = jestep.make_step_fn(jparams.scene,
                                            kinematic_robot=True)
    params = port_params(jkin, inserting.InsertingParams)
    _, out, jstate0, state0, _ = dynamic
    out = out[:1]
    _steps(jkin, params, jstate0, state0, out)
    return out


def _episode(request, mode):
    ep = request.getfixturevalue(mode)
    return ep[1] if mode == "dynamic" else ep


@pytest.mark.parametrize("mode, i", [
    ("dynamic", 0), ("dynamic", 1), ("dynamic", 2), ("kinematic", 1),
    ("kinematic", 2)], ids=["reset", "dynamic-hold", "dynamic-push",
                            "kinematic-hold", "kinematic-push"])
def test_state_matches(request, mode, i):
    js, ps, _, _ = _episode(request, mode)[i]
    qd_tol = PUSH_QD_TOL if (mode, i) == ("dynamic", 2) else 3e-4
    check_rod_state(js, ps, FIELDS, f"{mode} {['reset', 'hold', 'push'][i]}",
                    qd_tol=qd_tol)


@pytest.mark.parametrize("mode", ["dynamic", "kinematic"])
@pytest.mark.parametrize("i", [1, 2], ids=["hold", "push"])
def test_step_result_matches(request, mode, i):
    """Observation and reward (pre-substep state functions) 1e-4 absolute,
    done and every info entry (the mean distance 1e-4)."""
    _, _, jres, res = _episode(request, mode)[i]
    np.testing.assert_allclose(res.obs.numpy(), jres.obs, atol=1e-4)
    np.testing.assert_allclose(res.reward.numpy(), jres.reward, atol=1e-4)
    np.testing.assert_array_equal(res.done.numpy(), jres.done)
    assert set(res.info) == set(jres.info)
    for k, v in jres.info.items():
        if k == "mean_distance":
            np.testing.assert_allclose(res.info[k].numpy(), v, atol=1e-4)
        else:
            np.testing.assert_array_equal(res.info[k].numpy(), v, err_msg=k)
    assert res.obs.shape == (B, 11)


def test_scene_takes_the_general_variant(dynamic):
    """The scene's pairs, contacts and dofs are the JAX scene's
    (contact.build_meta); K3's general variant (the compact kernel) runs
    its evaluation batch of 240 envs at 57,584 B per env, four envs per
    block, up to 95 active contacts per env in shared memory; the reset
    leaves the boxes on the table."""
    params, ep, _, _, _ = dynamic
    jmeta = jcontact.build_meta(jinserting.build_inserting_scene())
    meta = params.statics.meta
    assert len(params.scene.pairs) == 78
    assert (meta.ncon, meta.nv, meta.n_iters) == (jmeta.ncon, jmeta.nv,
                                                  jmeta.n_iters) \
        == (270, 27, 25)
    assert [(p.geom_a.name, p.geom_b.name) for p in params.scene.pairs] == \
        [(p.geom_a.name, p.geom_b.name)
         for p in jinserting.build_inserting_scene().pairs]
    assert contact_kernel.smem_bytes(meta, 240) == 57584
    geo = params.statics.contact.geometry(240)
    assert (geo.variant, geo.envs_per_block, geo.smem_per_block) == \
        (2, 4, 230336)
    assert geo.cap == 95
    z = ep[0][1]["scene"]["free_pos"][..., 2]
    np.testing.assert_allclose(z, -0.019 + 0.025, atol=2e-3)


def test_task_constants_match():
    for name in ("TARGETS", "CONTEXT_SPACES", "_MODE_LUT"):
        np.testing.assert_array_equal(getattr(inserting, name),
                                      getattr(jinserting, name), err_msg=name)
    assert inserting.MAZE_WALLS == jinserting.MAZE_WALLS
    assert inserting.TARGET_MIN_DIST == jinserting.TARGET_MIN_DIST


def test_start_pose_matches(jparams, dynamic):
    check_start_pose(jparams, dynamic[0])


def test_sample_context_lies_in_the_context_spaces():
    """Box i of every env lies in the JAX package's space i, with a yaw in
    [-90, 90] degrees about z; over 256 envs both ends of each range are
    approached."""
    xy, quat = inserting.sample_context(torch.Generator().manual_seed(1), 256)
    assert xy.shape == (256, 3, 2) and quat.shape == (256, 3, 4)
    sp = jinserting.CONTEXT_SPACES
    x = xy.numpy()
    assert ((x >= sp[:, :2]) & (x <= sp[:, 2:])).all()
    span = (x.max(0) - x.min(0)) / (sp[:, 2:] - sp[:, :2])
    assert (span > 0.95).all()
    q = quat.numpy()
    yaw = 2 * np.arctan2(q[..., 3], q[..., 0])
    assert np.abs(yaw).max() <= np.pi / 2 + 1e-6
    assert np.abs(yaw).max() > 0.95 * np.pi / 2
    np.testing.assert_allclose(q[..., 1:3], 0.0, atol=1e-7)


# ---------------------------------------------------------------------------
# the mode functions on crafted arrays (no physics)
# ---------------------------------------------------------------------------

class _Scene(NamedTuple):
    free_pos: object


def test_update_mode_matches():
    """Four updates of 32 envs whose boxes sit on or near their targets at
    random: the JAX function per env (under a jitted vmap), the port's over
    the batch. Env 0's blue and red boxes reach their targets in the same
    update and are appended in the r, g, b scan order: red first."""
    rng = np.random.default_rng(4)
    Bc, T = 32, jinserting.TARGETS
    params = types.SimpleNamespace(targets=torch.as_tensor(T,
                                                           dtype=torch.float32))
    jp = types.SimpleNamespace(targets=jnp.asarray(T, jnp.float32))
    jupdate = jax.jit(jax.vmap(lambda fp, v, o, n: jinserting._update_mode(
        jp, jinserting.InsertingState(_Scene(fp), None, None, None, v, o, n,
                                      None))[4:7]))
    visited = np.zeros((Bc, 3), bool)
    order = np.full((Bc, 3), -1, np.int32)
    n = np.zeros(Bc, np.int32)
    state = inserting.InsertingState(
        None, None, None, None, torch.from_numpy(visited),
        torch.from_numpy(order), torch.from_numpy(n), None)
    jst = (visited, order, n)
    for u in range(4):
        near = rng.random((Bc, 3)) < 0.3
        if u == 0:
            near[0] = [True, False, True]
        off = rng.normal(size=(Bc, 3, 3)) * 0.003
        far = rng.normal(size=(Bc, 3, 3)) * 0.05 + 0.03
        free_pos = (T + np.where(near[..., None], off, far)).astype(
            np.float32)
        state = inserting._update_mode(params, state._replace(
            scene=_Scene(torch.from_numpy(free_pos))))
        jst = tuple(np.asarray(x) for x in jupdate(jnp.asarray(free_pos),
                                                    *jst))
        for name, want in zip(("visited", "order", "n_visited"), jst):
            np.testing.assert_array_equal(getattr(state, name).numpy(), want,
                                          err_msg=f"update {u} {name}")
        if u == 0:
            assert state.order[0].tolist() == [0, 2, -1]
    assert (state.n_visited == 3).any() and (state.n_visited < 3).any()


def test_decode_mode_matches():
    """Every first-two order of three placed boxes, and orders of fewer
    placed boxes (mode 0)."""
    orders = np.array([[0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 0, 1],
                       [2, 1, 0], [1, -1, -1], [2, 0, -1], [-1, -1, -1]],
                      np.int32)
    n = np.array([3] * 6 + [1, 2, 0], np.int32)
    want = np.asarray(jax.vmap(jinserting.decode_mode)(jnp.asarray(orders),
                                                        jnp.asarray(n)))
    got = inserting.decode_mode(torch.from_numpy(orders),
                                torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 2, 3, 4, 5, 6, 0, 0, 0])


def test_inserting_sim_scores_like_jax():
    """InsertingSim.score on fixed orders of 4 contexts x 6 trajectories
    against the JAX package's inserting_score over its decode_mode: 1e-6."""
    rng = np.random.default_rng(6)
    C, T = 4, 6
    order = np.stack([rng.permutation(3) for _ in range(C * T)]).astype(
        np.int32)
    n = rng.integers(0, 4, C * T).astype(np.int32)
    order[np.arange(3)[None] >= n[:, None]] = -1
    success = (n == 3) & (rng.random(C * T) < 0.8)
    state = types.SimpleNamespace(order=torch.from_numpy(order),
                                  n_visited=torch.from_numpy(n),
                                  success=torch.from_numpy(success))
    got = sims.InsertingSim(n_contexts=C,
                            n_trajectories_per_context=T).score(state)
    modes = jax.vmap(jinserting.decode_mode)(jnp.asarray(order),
                                             jnp.asarray(n))
    want = {k: float(v) for k, v in jmetrics.inserting_score(
        jnp.asarray(success, jnp.float32).reshape(C, T),
        jnp.asarray(modes).reshape(C, T)).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert 0 < got["success_rate"] < 1 and got["entropy"] > 0


# ---------------------------------------------------------------------------
# the evaluation harness: InsertingSim on both sides
# ---------------------------------------------------------------------------

def test_gmm_rollout_through_inserting_sim_matches(jparams, dynamic,
                                                   monkeypatch):
    """A 2-step rollout of a one-component gmm agent (hidden 16; its only
    noise is 1e-4 of its std) over 2 contexts x 1 trajectory through
    InsertingSim under full dynamics, weights carried across by
    ``convert``. The JAX side starts from the episode fixture's reset of
    the same contexts and steps through its compiled step: the JAX
    stepper's body (eval/rollout.py make_rod_stepper) over the batch, the
    JAX policy and step per episode. The final scene agrees to 3e-4 scaled, the
    order record exactly, and the metrics to 1e-6."""
    params, _, jstate, _, jstep = dynamic
    jagent, agent = tiny_agents("gmm", obs_dim=13, act_dim=2, hidden=16,
                                layers=2, seed=3, n_gaussians=1)
    ctx = inserting_contexts(3, B)
    monkeypatch.setattr(
        sims.InsertingSim, "contexts",
        lambda self, p: tuple(torch.from_numpy(c) for c in ctx))
    monkeypatch.setattr(params, "max_steps", 2)
    sim = sims.InsertingSim(n_contexts=B, n_trajectories_per_context=1)
    state, dones = sim.run_episodes(agent, params)

    japply = jax.jit(jagent.policy_apply())
    pcs = [jagent.init_carry(13, k) for k in jax.random.split(
        jax.random.PRNGKey(1), B)]
    tcp = np.asarray(jax.vmap(lambda s: jparams.tcp_pose(s)[0])(
        jstate.scene))
    prev_pos, fixed_z = tcp[:, :2], tcp[:, 2:3]
    prev_obs = np.asarray(jax.vmap(
        lambda s: jinserting.get_observation(jparams, s))(jstate))
    for _ in range(2):
        deltas = []
        for e in range(B):
            pcs[e], d = japply(jagent.params, pcs[e], jnp.asarray(
                np.concatenate([prev_pos[e], prev_obs[e]])))
            deltas.append(np.asarray(d))
        prev_pos = np.clip(np.stack(deltas), -0.01, 0.01) + prev_pos
        act = np.concatenate([prev_pos, fixed_z, np.tile(
            [0.0, 1.0, 0.0, 0.0], (B, 1))], axis=1).astype(np.float32)
        jstate, jres = per_env(jstep, jstate, jnp.asarray(act))
        prev_obs = np.asarray(jres.obs)
    ps = convert.state_to_numpy(state)
    check_rod_state(np_tree(jstate), ps, FIELDS, "final")
    np.testing.assert_array_equal(ps["t"], [2, 2])
    # the horizon of 2 ends the port's episodes at the second step (the
    # JAX step was compiled at its params' horizon of 50)
    np.testing.assert_array_equal(dones.numpy(), [[False, False],
                                                  [True, True]])
    modes = jax.vmap(jinserting.decode_mode)(jstate.order, jstate.n_visited)
    want = {k: float(v) for k, v in jmetrics.inserting_score(
        jnp.asarray(jstate.success, jnp.float32).reshape(B, 1),
        jnp.asarray(modes).reshape(B, 1)).items()}
    got = sim.score(state)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_expert_runner_chunk_is_its_steps(dynamic):
    """One chunk of the inserting expert runner (2 steps, B = 2 in two
    orders, env 0 finished) equals the port's inserting expert step (the
    env's visited flags), its env step and the rollout's freeze composed
    step by step, exactly."""
    params = dynamic[0]
    init, chunk = experts.make_inserting_runner(params, chunk_len=2)
    ctx = tuple(torch.from_numpy(c) for c in inserting_contexts(3, B))
    carry0 = init(ctx, np.array([[0, 1, 2], [2, 1, 0]]))

    def expert(carry, tcp):
        s = carry.env
        es, delta = experts.inserting_expert_step(
            carry.es, carry.des, tcp[:, :2], s.scene.free_pos, s.visited,
            carry.extras[0], push_depth=experts.PUSH_DEPTH_DYN)
        return es, delta, (s.scene.free_pos, s.scene.free_quat)

    noise = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, B, 2)).astype(np.float32))
    check_chunk_composition(carry0, chunk, rod_expert_step(
        params, inserting.step, expert), noise)
