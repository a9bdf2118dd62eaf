"""The port's batched expert steps against ``jax.vmap`` of the JAX ones
(``d3il_tpu/data/experts_jax.py``): avoiding, pushing (kinematic and
dynamic keyword sets), sorting (2 and 4 boxes, both keyword sets),
inserting, aligning, stacking and its ``_ik_toward``.

Each case is one step of B = 8 envs from seeded NumPy inputs placed so that
the phases and branches fire (an env at its approach point, behind its box,
at a finished stage, with a box in the corridor, ...). The discrete state
(``stage``, ``phase``, ``wp``, ``hold``, ``k``, ...) must be equal and the
setpoint outputs within 1e-6 (metres; radians for stacking's joint
setpoint). The experts are chains of threshold gates, so every case first
shows its gates clear of their thresholds: under 4 random +-1e-5
perturbations of every continuous input the JAX step keeps its discrete
state and moves no output by more than 1e-3 (no hidden branch flips).
Every JAX function is jitted under ``vmap``: stacking's step with its
10-iteration IK scan compiles in ~3 s on the CPU, where run op by op (under
``jax.disable_jit()``) each call takes ~9 s.

The runners' wiring is held against the JAX runners with both expert steps
and env steps replaced by recording fakes (no scene is built, and the JAX
runner runs op by op): per runner family and keyword set, the expert's
arguments and keywords, the env step's action, the logs and the next carry.
"""
import functools
import itertools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from d3il_tpu.data import experts_jax as jex
from d3il_tpu.robot import panda as jpanda
from d3il_tpu_torch.data import experts as ex
from d3il_tpu_torch.robot import panda
from test_torch_jaxref import runner_noise

B = 8
TOL = 1e-6          # setpoint outputs: metres (radians for stacking)
DELTA = 1e-5        # gate clearance shown by perturbation
JUMP = 1e-3         # no output moves more than this under DELTA
RED_T, GREEN_T = np.array([0.42, 0.3]), np.array([0.63, 0.3])


def _t(x):
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return torch.from_numpy(x.copy())
    if np.issubdtype(x.dtype, np.integer):
        return torch.from_numpy(x.astype(np.int32))
    return torch.from_numpy(x.astype(np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(out):
    state, y = out
    return list(state), np.asarray(y)


def check_clear(jfn, args, seed=0):
    """The JAX step's discrete state is unchanged and no output moves more
    than JUMP under 4 random +-DELTA perturbations of every float input."""
    base_state, base_y = _leaves(_np(jfn(*args)))
    rng = np.random.default_rng(seed)
    for _ in range(4):
        pert = jax.tree_util.tree_map(
            lambda a: a + DELTA * rng.choice([-1.0, 1.0], a.shape).astype(
                np.float32) if np.asarray(a).dtype == np.float32 else a,
            args)
        st, y = _leaves(_np(jfn(*pert)))
        for a, b in zip(st, base_state):
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, atol=JUMP)
        np.testing.assert_allclose(y, base_y, atol=JUMP)


def compare(jout, out):
    """Discrete state equal, floats within TOL; returns the JAX state."""
    jstate, jy = _np(jout)
    state, y = out
    for name, a, b in zip(jstate._fields, jstate, state):
        b = b.numpy()
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=TOL, err_msg=name)
    np.testing.assert_allclose(y.numpy(), jy, atol=TOL)
    return jstate


def run_case(jfn, fn, args, jstate_cls, state_cls, seed=0):
    """args: (state as a tuple of NumPy arrays, the other inputs); the JAX
    function vmapped over envs and jitted, the port's on tensors."""
    st, rest = args
    jargs = (jstate_cls(*map(jnp.asarray, st)),) + tuple(
        jnp.asarray(a) for a in rest)
    jv = jax.jit(jax.vmap(jfn))
    check_clear(jv, jargs, seed)
    out = fn(state_cls(*map(_t, st)), *map(_t, rest))
    return compare(jv(*jargs), out)


def _perm_rows(rng, n, k):
    return np.stack([rng.permutation(k) for _ in range(n)]).astype(np.int32)


# ---------------------------------------------------------------- avoiding

def test_avoiding_waypoints_equal():
    for mode in itertools.product(range(2), range(3), range(4)):
        a = ex.avoiding_waypoints(mode, np.random.default_rng(5))
        b = jex.avoiding_waypoints(mode, np.random.default_rng(5))
        np.testing.assert_array_equal(a, b)


def test_avoiding_expert_step():
    rng = np.random.default_rng(0)
    wps = np.stack([ex.avoiding_waypoints(
        ((i % 2), (i // 2) % 3, (i // 6) % 4), rng) for i in range(B)])
    k = np.array([0, 1, 2, 3, 4, 5, 5, 2], np.int32)
    wp = wps[np.arange(B), k]
    # half the envs within the 3 cm advance radius of their waypoint
    tcp = wp + rng.normal(0, 0.01, (B, 2)) * (np.arange(B) % 2)[:, None] \
        + (1 - np.arange(B) % 2)[:, None] * rng.choice([-1, 1], (B, 2)) \
        * 0.05
    lag = np.array([0.01, 0.05, 0.1, 0.02, 0.06, 0.2, 0.0, 0.04])
    ang = rng.uniform(0, 2 * np.pi, B)
    des = tcp + lag[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)
    st = run_case(jex.avoiding_expert_step, ex.avoiding_expert_step,
                  ((k,), (des, tcp, wps)), jex.AvoidingExpertState,
                  ex.AvoidingExpertState)
    assert (st.k > k).any() and (st.k == k).any()


# ---------------------------------------------------------------- pushing

SEQ_BOX = np.array([[0, 1], [1, 0], [0, 1], [1, 0]], np.int32)
SEQ_TGT = np.array([[RED_T, GREEN_T], [GREEN_T, RED_T], [GREEN_T, RED_T],
                    [RED_T, GREEN_T]], np.float32)


def pushing_inputs(seed, dyn):
    """Per env a situation: far away, at the approach point, behind the
    box on the push line, box at its target, finished, stalled, another
    box in the way, off the push line."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([
        np.stack([rng.uniform(0.4, 0.5, B), rng.uniform(-0.15, 0.0, B)], 1),
        np.stack([rng.uniform(0.55, 0.65, B), rng.uniform(-0.15, 0.0, B)],
                 1)], 1)
    modes = rng.integers(0, 4, B)
    seq_box, seq_tgt = SEQ_BOX[modes], SEQ_TGT[modes]
    stage = np.array([0, 0, 1, 0, 2, 0, 0, 1], np.int32)
    phase = np.array([0, 0, 1, 1, 0, 1, 0, 1], np.int32)
    stall = np.array([0, 0, 3, 0, 0, 51 if dyn else 36, 0, 10], np.int32)
    b = seq_box[np.arange(B), np.minimum(stage, 1)]
    tgt = seq_tgt[np.arange(B), np.minimum(stage, 1)]
    bpos = boxes[np.arange(B), b]
    u = (tgt - bpos) / np.linalg.norm(tgt - bpos, axis=1, keepdims=True)
    perp_u = np.stack([-u[:, 1], u[:, 0]], 1)
    app_back = 0.095 if dyn else 0.065
    tcp = np.stack([rng.uniform(0.3, 0.7, B), rng.uniform(-0.35, -0.25, B)],
                   1)
    tcp[1] = bpos[1] - u[1] * app_back + 0.004 * perp_u[1]     # approach
    tcp[2] = bpos[2] - u[2] * 0.06 + 0.005 * perp_u[2]         # behind
    boxes[3, b[3]] = tgt[3] + np.array([0.01, -0.012])        # at target
    tcp[3] = boxes[3, b[3]] - u[3] * 0.05
    tcp[5] = bpos[5] - u[5] * 0.045 + 0.003 * perp_u[5]        # stalled
    other = 1 - b[6]                                           # in the way
    boxes[6, other] = 0.5 * (tcp[6] + bpos[6] - u[6] * app_back) \
        + 0.02 * perp_u[6]
    tcp[7] = bpos[7] - u[7] * 0.05 + 0.09 * perp_u[7]          # off line
    des = tcp + rng.normal(0, 0.01, (B, 2))
    des[1] = tcp[1] + 0.01                  # inside the dynamic tension gate
    des[2] = tcp[2] + 0.012 * u[2]
    d_tgt = np.linalg.norm(tgt - boxes[np.arange(B), b], axis=1)
    prev_d = d_tgt + np.where(np.arange(B) % 2 == 0, 0.01, -0.01)
    st = (stage, phase, stall, prev_d.astype(np.float32),
          np.zeros(B, np.int32), np.zeros((B, 2), np.float32))
    return st, (des, tcp, boxes, seq_box, seq_tgt)


@pytest.mark.parametrize("dyn", [False, True], ids=["kinematic", "dynamic"])
def test_pushing_expert_step(dyn):
    """Both keyword sets of the runners (the dynamic one with the gate that
    ignores near_r)."""
    kw = dict(ex.PUSH_KW_DYNAMIC if dyn else ex.PUSH_KW_KINEMATIC,
              push_depth=ex.PUSH_DEPTH_DYN if dyn else ex.PUSH_DEPTH)
    args = pushing_inputs(1, dyn)
    st = run_case(functools.partial(jex.pushing_expert_step, **kw),
                  functools.partial(ex.pushing_expert_step, **kw), args,
                  jex.PushExpertState, ex.PushExpertState)
    assert set(st.phase.tolist()) == {0, 1}
    assert (st.stage > args[0][0]).any()


# ---------------------------------------------------------------- sorting

def sorting_inputs(seed, n):
    """Boxes on the platform (z 0.08), one ejected past y 0.215, one
    dropped (z 0.03); tcps at approach points or far; some x legs done."""
    rng = np.random.default_rng(seed)
    half = n // 2
    xy = np.stack([rng.uniform(0.3, 0.7, (B, n)),
                   rng.uniform(-0.25, 0.1, (B, n))], -1)
    z = np.full((B, n, 1), 0.08)
    boxes = np.concatenate([xy, z], -1)
    order = _perm_rows(rng, B, n)
    stage = rng.integers(0, n, B).astype(np.int32)
    stage[7] = n
    b = order[np.arange(B), np.minimum(stage, n - 1)]
    boxes[1, b[1], 1] = 0.25                       # ejected
    boxes[2, b[2], 1:] = [0.18, 0.03]              # dropped
    zone_x = np.where(b < half, 0.4, 0.625)
    boxes[3, b[3], 0] = zone_x[3] + 0.004          # x leg done
    boxes[4, b[4], :2] = [zone_x[4] - 0.1, -0.1]
    if n > 2:                                      # a box in the corridor
        o = order[4, (np.minimum(stage[4], n - 1) + 1) % n]
        boxes[4, o, :2] = [zone_x[4] - 0.05, 0.05]
    prev_b = np.where(np.arange(B) % 3 == 0, -1, b).astype(np.int32)
    phase = rng.integers(0, 4, B).astype(np.int32)
    bpos = boxes[np.arange(B), b, :2]
    tcp = np.stack([rng.uniform(0.3, 0.7, B), rng.uniform(-0.3, -0.25, B)],
                   1)
    ux = np.stack([np.sign(zone_x - bpos[:, 0]), np.zeros(B)], 1)
    tcp[5] = bpos[5] - ux[5] * 0.065 + 0.005       # at the x approach
    tcp[6] = bpos[6] - ux[6] * 0.058
    des = tcp + rng.normal(0, 0.01, (B, 2))
    return (stage, phase, prev_b), (des, tcp, boxes, order)


@pytest.mark.parametrize("n,dyn", [(2, False), (2, True), (4, False),
                                   (4, True)],
                         ids=["2-kinematic", "2-dynamic", "4-kinematic",
                              "4-dynamic"])
def test_sorting_expert_step(n, dyn):
    kw = dict(ex.SORT_KW_DYNAMIC) if dyn else dict(push_depth=ex.PUSH_DEPTH)
    st_in, rest = sorting_inputs(2 + n, n)
    half = n // 2
    st = run_case(functools.partial(jex.sorting_expert_step, half=half, **kw),
                  functools.partial(ex.sorting_expert_step, half=half, **kw),
                  (st_in, rest), jex.SortingExpertState,
                  ex.SortingExpertState)
    assert (st.stage > st_in[0]).any()
    assert len(set(st.phase.tolist())) >= 2


# ---------------------------------------------------------------- inserting

def inserting_inputs(seed):
    """Boxes at waypoints (advance), on the gate axis or off it, placed
    boxes with the rod at the retreat point, finished episodes."""
    rng = np.random.default_rng(seed)
    routes, retreats = ex.INSERT_ROUTES, ex.INSERT_RETREATS
    boxes = np.concatenate([np.stack([rng.uniform(0.35, 0.7, (B, 3)),
                                      rng.uniform(-0.2, 0.05, (B, 3))], -1),
                            np.full((B, 3, 1), 0.006)], -1)
    order = _perm_rows(rng, B, 3)
    stage = np.array([0, 1, 2, 0, 1, 3, 0, 2], np.int32)
    wp = np.array([0, 1, 1, 2, 0, 0, 1, 2], np.int32)
    phase = np.array([0, 1, 0, 1, 2, 0, 2, 0], np.int32)
    visited = np.zeros((B, 3), bool)
    b = order[np.arange(B), np.minimum(stage, 2)]
    boxes[0, b[0], :2] = routes[b[0], 0] + [0.01, 0.01]        # advance
    boxes[1, b[1], :2] = routes[b[1], 1] + [0.003, 0.002]      # on axis
    boxes[2, b[2], :2] = routes[b[2], 1] + [0.02, 0.02]        # off axis
    boxes[3, b[3], :2] = routes[b[3], 2] + [0.02, 0.02]        # restage
    visited[4, b[4]] = True                                    # retreat
    visited[6, b[6]] = True
    tcp = np.stack([rng.uniform(0.35, 0.7, B), rng.uniform(-0.25, 0.1, B)],
                   1)
    tcp[4] = retreats[b[4]] + [0.01, 0.005]
    visited[5] = True
    bpos = boxes[np.arange(B), b, :2]
    to_wp = routes[b, wp] - bpos
    u = to_wp / np.linalg.norm(to_wp, axis=1, keepdims=True)
    tcp[7] = bpos[7] - u[7] * 0.065 + 0.004                   # approach
    tcp[1] = bpos[1] - u[1] * 0.05
    des = tcp + rng.normal(0, 0.01, (B, 2))
    return (stage, wp, phase), (des, tcp, boxes, visited, order)


def test_inserting_expert_step():
    st_in, rest = inserting_inputs(3)
    st = run_case(jex.inserting_expert_step, ex.inserting_expert_step,
                  (st_in, rest), jex.InsertingExpertState,
                  ex.InsertingExpertState)
    assert (st.stage > st_in[0]).any() and (st.wp != st_in[1]).any()
    assert set(st.phase.tolist()) >= {0, 1, 2}


# ---------------------------------------------------------------- aligning

def _yaw_quat(yaw):
    return np.stack([np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw),
                     np.sin(yaw / 2)], -1)


def aligning_inputs(seed):
    """Both modes; travel, descend and work phases; yaw errors inside and
    outside the rotation hysteresis band; aligned trays."""
    rng = np.random.default_rng(seed)
    tray = np.concatenate([np.stack([rng.uniform(0.4, 0.6, B),
                                     rng.uniform(-0.2, 0.0, B)], 1),
                           np.full((B, 1), 0.02)], 1)
    yaw = rng.uniform(-1.5, 1.5, B)
    tgt = tray + np.concatenate([rng.normal(0, 0.06, (B, 2)),
                                 np.zeros((B, 1))], 1)
    dyaw = np.array([0.3, -0.2, 0.08, 0.01, 0.5, -0.6, 0.03, 0.2])
    tgt[3, :2] = tray[3, :2] + 0.005                   # aligned
    mode = np.array([0, 1, 0, 1, 0, 1, 1, 0], np.int32)
    phase = np.array([0, 0, 1, 2, 2, 2, 2, 2], np.int32)
    rotating = np.array([0, 0, 0, 0, 1, 1, 0, 1], bool)
    wall = rng.integers(0, 4, B).astype(np.int32)
    entry = tray[:, :2] + np.where(mode[:, None] == 0, 0.0, [0.0, -0.09])
    des = np.concatenate([tray[:, :2] + rng.normal(0, 0.05, (B, 2)),
                          np.full((B, 1), 0.17)], 1)
    des[0, :2] = entry[0] + 0.003                      # at entry
    des[0, 2] = 0.25
    des[1, 2] = 0.25
    des[2, :2] = entry[2]
    des[2, 2] = 0.171                                  # low enough
    tcp = des + rng.normal(0, 0.01, (B, 3))
    st = (phase, rotating, wall)
    return st, (des, tcp, tray, _yaw_quat(yaw), tgt, _yaw_quat(yaw + dyaw),
                mode)


def test_aligning_expert_step():
    st_in, rest = aligning_inputs(4)
    st = run_case(jex.aligning_expert_step, ex.aligning_expert_step,
                  (st_in, rest), jex.AligningExpertState,
                  ex.AligningExpertState)
    assert set(st.phase.tolist()) == {0, 1, 2}
    assert st.rotating.any() and not st.rotating.all()


# ---------------------------------------------------------------- stacking

@pytest.fixture(scope="module")
def chains():
    return jpanda.build_control_chain(), panda.build_control_chain()


Q_STACK = np.array([0.0, 0.2, 0.0, -2.2, 0.0, 2.4, 0.785])


def test_ik_toward_matches(chains):
    """_ik_toward's 10 DLS iterations for 6 envs, per-env rates: q within
    TOL radians."""
    jchain, chain = chains
    rng = np.random.default_rng(6)
    n = 6
    q = (Q_STACK + rng.normal(0, 0.1, (n, 7))).astype(np.float32)
    pos = np.stack([rng.uniform(0.4, 0.6, n), rng.uniform(-0.15, 0.15, n),
                    rng.uniform(0.02, 0.25, n)], 1).astype(np.float32)
    h = rng.uniform(-0.7, 0.7, n)
    quat = np.stack([np.zeros(n), np.cos(h), np.sin(h), np.zeros(n)],
                    1).astype(np.float32)
    rate = np.where(np.arange(n) % 2 == 0, 0.02, 0.05).astype(np.float32)
    want = jax.jit(jax.vmap(lambda a, b, c, r: jex._ik_toward(
        jchain, a, b, c, rate=r)))(q, pos, quat, rate)
    got = ex._ik_toward(chain, _t(q), _t(pos), _t(quat), rate=_t(rate))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert (np.abs(np.asarray(want) - q).max(axis=1) > 1e-3).all()


def stacking_inputs(seed):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([np.stack([rng.uniform(0.35, 0.65, (B, 3)),
                                      rng.uniform(-0.2, 0.2, (B, 3))], -1),
                            np.full((B, 3, 1), 0.011)], -1)
    quat = _yaw_quat(rng.uniform(-1.5, 1.5, (B, 3)))
    target = np.stack([rng.uniform(0.4, 0.6, B), rng.uniform(-0.2, 0.2, B)],
                      1)
    order = _perm_rows(rng, B, 3)
    stage = np.array([0, 1, 2, 0, 1, 2, 3, 0], np.int32)
    phase = np.array([0, 1, 2, 2, 5, 6, 0, 7], np.int32)
    hold = np.array([0, 0, 21, 5, 0, 9, 0, 0], np.int32)
    q_des = (Q_STACK + rng.normal(0, 0.05, (B, 7))).astype(np.float32)
    b = order[np.arange(B), np.minimum(stage, 2)]
    bp = boxes[np.arange(B), b]
    tcp = np.stack([rng.uniform(0.35, 0.65, B), rng.uniform(-0.2, 0.2, B),
                    rng.uniform(0.05, 0.25, B)], 1)
    tcp[0] = [bp[0, 0] + 0.005, bp[0, 1], 0.22]          # reached hover
    tcp[1] = [bp[1, 0] + 0.004, bp[1, 1], 0.05]          # descending
    tcp[4] = [target[4, 0], target[4, 1] + 0.003, 0.14]  # placing
    tcp[7] = [target[7, 0], target[7, 1], 0.215]         # retreat reached
    width = np.array([0.08, 0.08, 0.01, 0.04, 0.03, 0.0, 0.08, 0.08])
    return ((stage, phase, hold, q_des),
            (boxes, quat, target, order, tcp, width))


def test_stacking_expert_step(chains):
    jchain, chain = chains
    st_in, rest = stacking_inputs(7)
    jst = jex.StackingExpertState(*map(jnp.asarray, st_in))
    jrest = tuple(jnp.asarray(np.asarray(a, np.int32 if a.dtype.kind in "iu"
                                         else np.float32)) for a in rest)
    jfn = jax.jit(jax.vmap(
        lambda s, bp, bq, t, o, tcp, w: jex.stacking_expert_step(
            jchain, s, bp, bq, t, o, tcp_pos=tcp, width_meas=w)))
    check_clear(jfn, (jst,) + jrest)
    out = ex.stacking_expert_step(chain, ex.StackingExpertState(
        *map(_t, st_in)), *map(_t, rest[:4]), tcp_pos=_t(rest[4]),
        width_meas=_t(rest[5]))
    st = compare(jfn(jst, *jrest), out)
    assert (st.phase != st_in[1]).any() and (st.stage > st_in[0]).any()
    assert (st.phase == 0).sum() >= 2      # a wrap and a missed grasp


# ------------------------------------------------ the runners' wiring

class _Scene(NamedTuple):
    q: object
    free_pos: object
    free_quat: object


class _State(NamedTuple):
    scene: _Scene
    t: object
    target_pos: object
    target_quat: object
    visited: object
    target_xy: object


class _Res(NamedTuple):
    done: object


class _Params:
    """What a runner reads of its Params, with no scene built."""
    device = "cpu"
    ctrl_chain = object()       # handed to the stacking expert as it is

    def __init__(self, kinematic, num_boxes):
        self.kinematic, self.num_boxes = kinematic, num_boxes

    @staticmethod
    def tcp_pose(scene):
        return scene.q[..., :3] + 0.1, scene.q[..., 3:7]


def _fake_env_step(calls):
    """An env step (JAX per env, or the port's batched) that records its
    state and action: the scene moves and an env whose t is odd ends."""
    def step(params, state, action):
        calls.append((state, action))
        scene = state.scene._replace(q=state.scene.q + 0.01,
                                     free_pos=state.scene.free_pos * 1.01)
        return (state._replace(scene=scene, t=state.t + 1),
                _Res(done=state.t % 2 == 1))
    return step


def _fake_expert(calls, jax_side):
    """An expert step that records its arguments: every expert-state leaf
    bumped, a setpoint delta of 0.5 (tcp - des) + 0.003 (stacking: the
    joint setpoint + 0.01 and half the measured width)."""
    def bump(x):
        if jax_side:
            if x.dtype == jnp.bool_:
                return ~x
            return x + (1 if jnp.issubdtype(x.dtype, jnp.integer) else 0.5)
        if x.dtype == torch.bool:
            return ~x
        return x + (0.5 if x.is_floating_point() else 1)

    def step(*args, **kw):
        calls.append((args, kw))
        if "width_meas" in kw:
            es, width = args[1], kw["width_meas"]
            out = (jnp.concatenate([es.q_des + 0.01, width[None] * 0.5])
                   if jax_side else
                   torch.cat([es.q_des + 0.01, width[:, None] * 0.5], 1))
        else:
            es, des, tcp = args[:3]
            out = 0.5 * (tcp[..., :des.shape[-1]] - des) + 0.003
        return type(es)(*map(bump, es)), out
    return step


# runner, env module, kinematic, boxes, setpoint dims, noise dims
WIRING = {"avoiding": ("avoiding", "avoiding", True, 1, 2, 2),
          "pushing": ("pushing", "pushing", True, 2, 2, 2),
          "pushing_dynamic": ("pushing", "pushing", False, 2, 2, 2),
          "sorting_2": ("sorting", "sorting", True, 2, 2, 2),
          "sorting_2_dynamic": ("sorting", "sorting", False, 2, 2, 2),
          "inserting": ("inserting", "inserting", True, 3, 2, 2),
          "inserting_dynamic": ("inserting", "inserting", False, 3, 2, 2),
          "aligning": ("aligning", "aligning", True, 1, 3, 3),
          "stacking": ("stacking", "stacking", False, 3, 0, 7)}


def _wiring_inputs(case, rng, n=3):
    """n envs of a fake state (env 0 done, env 1 ending this step), the
    port's initial expert state, setpoint, fixed z and per-env extras."""
    kind, _, _, nb, d, _ = WIRING[case]
    f32 = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    state = _State(_Scene(f32(n, 9), f32(n, nb, 3), f32(n, nb, 4)),
                   np.arange(n, dtype=np.int32), f32(n, 3), f32(n, 4),
                   rng.random((n, 3)) < 0.5, f32(n, 2))
    init = {"avoiding": lambda: ex.AvoidingExpertState(
                k=torch.tensor([0, 2, 5], dtype=torch.int32)),
            "pushing": lambda: ex.init_push_expert_state(n),
            "sorting": lambda: ex.init_sorting_expert_state(n),
            "inserting": lambda: ex.init_inserting_expert_state(n),
            "aligning": lambda: ex.init_aligning_expert_state(n),
            "stacking": lambda: ex.init_stacking_expert_state(
                torch.from_numpy(state.scene.q[:, :7].copy()))}[kind]()
    extras = {"avoiding": lambda: (f32(n, 6, 2),),
              "pushing": lambda: (_perm_rows(rng, n, 2), f32(n, 2, 2)),
              "sorting": lambda: (_perm_rows(rng, n, nb),),
              "inserting": lambda: (_perm_rows(rng, n, 3),),
              "aligning": lambda: (np.array([0, 1, 0], np.int32),),
              "stacking": lambda: (_perm_rows(rng, n, 3),)}[kind]()
    return state, init, f32(n, d), f32(n, 1), extras


def _same(j, t, b, what):
    """The JAX runner's argument ``j`` (one env) against the port's ``t``
    (env b of the batch): NamedTuples field by field, arrays by value
    (within 1e-7) and shape, anything else equal."""
    if isinstance(j, tuple):
        assert isinstance(t, tuple) and len(j) == len(t), what
        assert getattr(j, "_fields", None) == getattr(t, "_fields", None), \
            what
        for k, (a, c) in enumerate(zip(j, t)):
            _same(a, c, b, f"{what}[{k}]")
    elif isinstance(j, (jax.Array, np.ndarray)):
        t = (t.numpy() if torch.is_tensor(t) else np.asarray(t))[b]
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype.kind == j.dtype.kind, \
            (what, t.shape, j.shape, t.dtype, j.dtype)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-7, err_msg=what)
    else:
        assert j is t or j == t, (what, j, t)


@pytest.mark.parametrize("case", list(WIRING))
def test_runner_wiring_matches_jax(case, monkeypatch):
    """One step of each port runner against the JAX runner (run op by op
    under jax.disable_jit(), one env at a time) with the expert step and
    the env step replaced by recording fakes and no scene built: the
    expert gets the same arguments and keywords (the dynamic keyword sets
    against the dicts the JAX runners write), the env step the same
    action, and the logs, dones and next carry (env 0, done, frozen) are
    the same, within 1e-7."""
    import importlib
    kind, env_name, kinematic, nb, d, nd = WIRING[case]
    rng = np.random.default_rng(5)
    state, es, des, fixed_z, extras = _wiring_inputs(case, rng)
    n = len(des)
    done = np.array([True] + [False] * (n - 1))
    keys = [jax.random.PRNGKey(11 + b) for b in range(n)]
    params = _Params(kinematic, nb)
    calls = {k: [] for k in ("jx", "je", "tx", "te")}
    monkeypatch.setattr(jex, f"{kind}_expert_step",
                        _fake_expert(calls["jx"], True))
    monkeypatch.setattr(ex, f"{kind}_expert_step",
                        _fake_expert(calls["tx"], False))
    monkeypatch.setattr(importlib.import_module(f"d3il_tpu.envs.{env_name}"),
                        "step", _fake_env_step(calls["je"]))
    monkeypatch.setattr(importlib.import_module(
        f"d3il_tpu_torch.envs.{env_name}"), "step",
        _fake_env_step(calls["te"]))

    _, jchunk = getattr(jex, f"make_{kind}_runner")(params, 1)
    jes_cls = getattr(jex, type(es).__name__)
    jout = []
    with jax.disable_jit():
        for b in range(n):
            row = lambda x: jnp.asarray(np.asarray(x)[b])
            carry = jex.EpCarry(jax.tree_util.tree_map(row, state),
                                jes_cls(**{f: row(getattr(es, f))
                                           for f in jes_cls._fields}),
                                row(des), jnp.asarray(done[b]), keys[b])
            rest = tuple(row(x) for x in extras)
            cw = {"aligning": rest[0], "stacking": rest[0]}.get(
                kind, rest + (row(fixed_z),))
            jout.append(jchunk((carry, cw)))

    _, chunk = getattr(ex, f"make_{kind}_runner")(params, 1)
    tt = lambda x: torch.from_numpy(np.asarray(x).copy())
    carry = ex.EpCarry(jax.tree_util.tree_map(tt, state), es, tt(des),
                       tt(done), tuple(map(tt, extras)),
                       tt(fixed_z) if d == 2 else torch.zeros((n, 0)))
    tcarry, tlogs, tdones = chunk(
        carry, torch.from_numpy(runner_noise(keys, 1, nd)))

    assert len(calls["jx"]) == len(calls["je"]) == n
    assert len(calls["tx"]) == len(calls["te"]) == 1
    (targs, tkw), (tstate, taction) = calls["tx"][0], calls["te"][0]
    for b in range(n):
        jargs, jkw = calls["jx"][b]
        assert len(jargs) == len(targs) and set(jkw) == set(tkw), \
            (len(jargs), len(targs), sorted(jkw), sorted(tkw))
        _same(jargs, targs, b, "expert args")
        for k in jkw:
            _same(jkw[k], tkw[k], b, f"expert {k}=")
        jstate, jaction = calls["je"][b]
        _same(jstate, tstate, b, "env step state")
        _same(jaction, taction, b, "env step action")
        (jcarry, _), jlogs, jdones = jout[b]
        assert len(jlogs) == len(tlogs)
        _same(tuple(x[0] for x in jlogs), tuple(x[0] for x in tlogs), b,
              "logs")
        _same(jdones[0], tdones[0], b, "dones")
        _same(jcarry[:4], tuple(tcarry[:4]), b, "next carry")
    assert tcarry.done.tolist() == [True, True] + [False] * (n - 2)
