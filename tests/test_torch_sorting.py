"""Sorting with 2 boxes in the port against ``jax.vmap(sorting.step)``.

Both sides build SortingParams(2, n_substeps=2) with the JAX package's start
posture, reset B = 2 envs from the same NumPy contexts (the boxes start
inside the platform and pop out of it over the 60 hold substeps) and take
the same two setpoints: a hold at the tcp, then a 1 cm step toward the
first box. The JAX side's ``vmap`` runs its per-env path on the CPU; the
port runs its batched window through the kernels' plain versions (K3's
general variant on the card: 28 contacts, 84 rows). Tolerances are
tests/test_torch_pushing.py's. A 2-step bc rollout through SortingSim runs
on both sides, and the mode functions are held on crafted arrays.
"""
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import (actions, check_chunk_composition,
                               check_rod_state, check_start_pose, np_tree,
                               port_params, rod_expert_step, sorting_contexts,
                               tiny_agents)

from d3il_tpu.envs import sorting as jsorting
from d3il_tpu.eval import contexts as jcontexts
from d3il_tpu.eval import metrics as jmetrics
from d3il_tpu.eval import rollout as jrollout
from d3il_tpu.eval import sims as jsims
from d3il_tpu_torch import convert
from d3il_tpu_torch.data import experts
from d3il_tpu_torch.envs import sorting
from d3il_tpu_torch.eval import sims

B = 2
FIELDS = ("t", "terminated", "mode", "mode_step", "finished_box", "success")


def _pair(kinematic):
    jparams = jsorting.SortingParams(2, n_substeps=2, max_steps=50,
                                     kinematic=kinematic)
    return jparams, port_params(jparams, sorting.SortingParams, num_boxes=2)


@pytest.fixture(scope="module")
def pair():
    return _pair(False)


@pytest.fixture(scope="module")
def kin_pair():
    return _pair(True)


def run_episode(jparams, params, ctx, n_steps):
    """Reset + n_steps on both sides; returns [(jax, port, jres, pres)]."""
    jstate = jax.jit(jax.vmap(lambda c: jsorting.reset(jparams, c)))(
        tuple(jnp.asarray(c) for c in ctx))
    state = sorting.reset(params, tuple(torch.from_numpy(c) for c in ctx))
    out = [(np_tree(jstate), convert.state_to_numpy(state), None, None)]
    jstep = jax.jit(jax.vmap(lambda s, a: jsorting.step(jparams, s, a)))
    tcp = np.asarray(jax.vmap(lambda s: jparams.tcp_pose(s)[0])(
        jstate.scene))[:, :2]
    to_box = np.asarray(jstate.scene.free_pos)[:, 0, :2] - tcp
    push = 0.01 * to_box / np.linalg.norm(to_box, axis=1, keepdims=True)
    for acts in (actions(tcp), actions(tcp, push))[:n_steps]:
        jstate, jres = jstep(jstate, jnp.asarray(acts))
        state, res = sorting.step(params, state, torch.from_numpy(acts))
        out.append((np_tree(jstate), convert.state_to_numpy(state),
                    np_tree(jres), res))
    return out


def check_result(jres, res):
    # observations are pre-substep state functions: 1e-4 absolute
    np.testing.assert_allclose(res.obs.numpy(), jres.obs, atol=1e-4)
    np.testing.assert_array_equal(res.done.numpy(), jres.done)
    np.testing.assert_array_equal(res.info["mode"].numpy(), jres.info["mode"])
    np.testing.assert_array_equal(res.info["success"].numpy(),
                                  jres.info["success"])


@pytest.fixture(scope="module")
def episode(pair):
    return run_episode(*pair, sorting_contexts(3, B, 2), 2)


@pytest.fixture(scope="module")
def kin_episode(kin_pair):
    return run_episode(*kin_pair, sorting_contexts(3, B, 2), 2)


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
    check_result(jres, res)


def test_boxes_rest_on_the_platform(episode):
    """Over the 60 hold substeps the platform's contact rows push the boxes
    up from z = 0.05, inside it, to its top (z = 0.1 plus the box's
    half-extent 0.03, less what the soft contact still yields), where they
    rise on, off contact."""
    _, ps, _, res = episode[0]
    z = ps["scene"]["free_pos"][..., 2]
    assert ((z > 0.115) & (z < 0.135)).all()
    assert (ps["scene"]["free_linvel"][..., 2] > 0).all()


def test_task_constants_match():
    """The port's own copies of the task's constants are the JAX
    package's."""
    for name in ("INIT_EE_POS", "RED_TARGET", "BLUE_TARGET", "RED_ZONE",
                 "BLUE_ZONE", "CONTEXT_SPACES"):
        np.testing.assert_array_equal(getattr(sorting, name),
                                      getattr(jsorting, name), err_msg=name)


def test_start_pose_matches(pair):
    check_start_pose(*pair)


@pytest.mark.parametrize("num_boxes", [2, 4, 6])
def test_sample_context_takes_one_region_per_box(num_boxes):
    """Each box of each env lies in one of the JAX package's 6 spawn
    regions, no two boxes of an env in the same one, with a yaw in
    [-90, 90] degrees; over 256 envs every region is taken."""
    xy, quat = sorting.sample_context(torch.Generator().manual_seed(1), 256,
                                      num_boxes)
    assert xy.shape == (256, num_boxes, 2) and quat.shape == (256, num_boxes, 4)
    sp = jsorting.CONTEXT_SPACES
    p = xy.numpy()[:, :, None]
    inside = ((p >= sp[:, :2]) & (p <= sp[:, 2:])).all(-1)  # [B, n, 6]
    assert (inside.sum(-1) == 1).all()
    region = inside.argmax(-1)
    assert all(len(set(r)) == num_boxes for r in region.tolist())
    assert set(region.ravel().tolist()) == set(range(6))
    q = quat.numpy()
    yaw = 2 * np.arctan2(q[..., 3], q[..., 0])
    assert np.abs(yaw).max() <= np.pi / 2 + 1e-6
    np.testing.assert_allclose(q[..., 1:3], 0.0, atol=1e-7)


# ---------------------------------------------------------------------------
# the mode functions on crafted arrays (no physics)
# ---------------------------------------------------------------------------

def test_in_zone_matches():
    """Points in, out and on the zones' edges (the test is strict)."""
    rng = np.random.default_rng(0)
    xy = rng.uniform([0.25, 0.15], [0.75, 0.45], (64, 2)).astype(np.float32)
    xy[:4] = [[0.3, 0.3], [0.4, 0.22], [0.5, 0.41], [0.4, 0.3]]
    for zone in (sorting.RED_ZONE, sorting.BLUE_ZONE):
        want = np.asarray(jsorting._in_zone(jnp.asarray(xy),
                                            jnp.asarray(zone, jnp.float32)))
        got = sorting._in_zone(torch.from_numpy(xy), zone).numpy()
        np.testing.assert_array_equal(got, want)
    assert not got[:3].any()


@pytest.mark.parametrize("num_boxes", [2, 4, 6])
def test_decode_mode_matches(num_boxes):
    """Bits of the first num_boxes entries, an unfilled -1 counting 1."""
    mode = np.random.default_rng(num_boxes).integers(-1, 2, (32, 6))
    mode = mode.astype(np.int32)
    want = np.asarray(jax.vmap(lambda m: jsorting.decode_mode(m, num_boxes))(
        jnp.asarray(mode)))
    got = sorting.decode_mode(torch.from_numpy(mode), num_boxes).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorting.decode_mode(torch.full((6,), -1, dtype=torch.int32),
                               2).item() == 128 + 64


@pytest.mark.parametrize("num_boxes", [2, 4, 6])
def test_update_mode_matches(num_boxes):
    """Three updates of 48 crafted envs with boxes over both zones, some
    boxes finished already and mode_step from 0 to 6: the JAX function per
    env, the port's over the batch. At most one box finishes per env and
    update, the closest unfinished one to its color's target."""
    rng = np.random.default_rng(10 + num_boxes)
    n, Bc = num_boxes, 48
    xy = rng.uniform([0.25, 0.15], [0.75, 0.45], (Bc, n, 2)).astype(np.float32)
    free_pos = np.concatenate([xy, np.zeros((Bc, n, 1), np.float32)], 2)
    finished = np.zeros((Bc, 6), bool)
    finished[:, :n] = rng.random((Bc, n)) < 0.25
    mode_step = rng.integers(0, 7, Bc).astype(np.int32)
    mode = np.where(np.arange(6) < mode_step[:, None],
                    rng.integers(0, 2, (Bc, 6)), -1).astype(np.int32)
    params = convert.params_from_numpy(np.zeros(7), sorting.SortingParams,
                                       device="cpu", num_boxes=n)
    state = sorting.SortingState(
        scene=types.SimpleNamespace(free_pos=torch.from_numpy(free_pos)),
        ctrl=None, t=None, terminated=None, mode=torch.from_numpy(mode),
        mode_step=torch.from_numpy(mode_step),
        finished_box=torch.from_numpy(finished), success=None)
    jp = types.SimpleNamespace(num_boxes=n)
    jstates = [jsorting.SortingState(
        scene=types.SimpleNamespace(free_pos=jnp.asarray(free_pos[b])),
        ctrl=None, t=None, terminated=None, mode=jnp.asarray(mode[b]),
        mode_step=jnp.asarray(mode_step[b]),
        finished_box=jnp.asarray(finished[b]), success=None)
        for b in range(Bc)]
    credited = 0
    for _ in range(3):
        before = state.mode_step.clone()
        state = sorting._update_mode(params, state)
        jstates = [jsorting._update_mode(jp, js) for js in jstates]
        for name in ("mode", "mode_step", "finished_box"):
            want = np.stack([np.asarray(getattr(js, name)) for js in jstates])
            np.testing.assert_array_equal(getattr(state, name).numpy(), want,
                                          err_msg=name)
        step = (state.mode_step - before).numpy()
        assert set(np.unique(step)) <= {0, 1}
        credited += step.sum()
    assert credited > 0


# ---------------------------------------------------------------------------
# the evaluation harness: SortingSim on both sides
# ---------------------------------------------------------------------------

def _sim_contexts():
    """Two contexts: one drawn from the context spaces, one with the red box
    in the red zone and the blue box in the blue zone (off the platform), so
    that its episodes are done at the first step and stay frozen."""
    xy, quat = sorting_contexts(9, 2, 2)
    xy[1] = [sorting.RED_TARGET, sorting.BLUE_TARGET]
    return xy, quat


def test_bc_rollout_through_sorting_sim_matches(pair, monkeypatch):
    """A 2-step bc rollout of 2 contexts x 2 trajectories through
    SortingSim under full dynamics, weights carried across by ``convert``,
    both sides fed the same contexts (the sims sample theirs from different
    generators): the final scene agrees to 3e-4 scaled, the mode record
    exactly, and the metrics, against the demo-derived prior of
    ``data/sorting_2`` on both sides, to 1e-5."""
    jparams, params = pair
    jagent, agent = tiny_agents("bc", obs_dim=10, act_dim=2, hidden=16,
                                layers=2, seed=3)
    ctxs = _sim_contexts()
    monkeypatch.setattr(
        sims.SortingSim, "contexts",
        lambda self, p: tuple(torch.from_numpy(c) for c in ctxs))
    monkeypatch.setattr(jparams, "max_steps", 2)
    monkeypatch.setattr(params, "max_steps", 2)
    sim = sims.SortingSim(num_boxes=2, n_contexts=2,
                          n_trajectories_per_context=2)

    # jsims.SortingSim.test_agent up to the final state (sims.py:240-251)
    stepper = jrollout.make_rod_stepper(
        jparams, jsorting.reset, jsorting.step, jsorting.get_observation,
        jagent.policy_apply())
    jctxs = tuple(jnp.asarray(c) for c in ctxs)
    cidx, keys = jsims._grid(2, 2, 0)
    ctx_of = lambda ci: jax.tree_util.tree_map(lambda x: x[ci], jctxs)
    jstate = jsims._run_episodes(stepper, jagent, ctx_of, (cidx, keys), 2, 10)
    state, dones = sim.run_episodes(agent, params)
    ps = convert.state_to_numpy(state)
    check_rod_state(np_tree(jstate), ps, FIELDS, "final")
    np.testing.assert_array_equal(ps["t"], [2, 2, 1, 1])
    np.testing.assert_array_equal(ps["success"], [False, False, True, True])
    np.testing.assert_array_equal(dones.numpy()[0], [False, False, True, True])
    # sims.py:252-267 with the demo prior of data/sorting_2
    modes = jax.vmap(lambda m: jsorting.decode_mode(m, 2))(jstate.mode)
    keys_, prior = jcontexts.mode_prior_from_demos(os.path.join(
        os.path.dirname(jcontexts.REF_DIR), "sorting_2"))
    want = {k: float(v) for k, v in jmetrics.sorting_score(
        jnp.asarray(jstate.success, jnp.float32).reshape(2, 2),
        jnp.asarray(modes).reshape(2, 2), keys_, prior).items()}
    got = sim.score(state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert got["success_rate"] == 0.5
    # the second context's episodes credited one box (one a step), the red
    # one (both sit on their targets; the argmin takes the first)
    np.testing.assert_array_equal(ps["mode"][2:, :2], [[0, -1], [0, -1]])


def test_uniform_prior_matches():
    for n in (2, 4, 6):
        keys, prior = sims.sorting_uniform_prior(n)
        jkeys, jprior = jsims.sorting_uniform_prior(n)
        np.testing.assert_array_equal(keys, jkeys)
        np.testing.assert_allclose(prior, jprior)


def test_expert_runner_chunk_is_its_steps(kin_pair):
    """One chunk of the sorting expert runner (2 boxes, 2 steps, B = 2,
    env 0 finished) equals the port's sorting expert step, its env step
    and the rollout's freeze composed step by step, exactly."""
    _, params = kin_pair
    init, chunk = experts.make_sorting_runner(params, chunk_len=2)
    ctx = tuple(torch.from_numpy(c) for c in sorting_contexts(3, B, 2))
    carry0 = init(ctx, np.array([[0, 1], [1, 0]]))

    def expert(carry, tcp):
        s = carry.env
        es, delta = experts.sorting_expert_step(
            carry.es, carry.des, tcp[:, :2], s.scene.free_pos,
            carry.extras[0], 1, push_depth=experts.PUSH_DEPTH)
        return es, delta, (s.scene.free_pos, s.scene.free_quat)

    noise = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, B, 2)).astype(np.float32))
    check_chunk_composition(carry0, chunk, rod_expert_step(
        params, sorting.step, expert), noise)
