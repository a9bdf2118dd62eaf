"""Scripted experts for demo generation, batched over envs.

Counterpart of ``d3il_tpu/data/experts_jax.py``. Each expert step is the
JAX state machine over explicit integer phases, written for a batch: every
tensor has a leading env axis where the JAX functions are per env under
``vmap``, and per-env lookups (``order[stage]``, ``seq_box[stage]``,
``INSERT_ROUTES[box, wp]``, ``boxes[b]``) are gathers on that axis.

A runner is ``init(...) -> carry`` and ``chunk(carry, noise=None) ->
(carry, logs, dones)``: ``chunk`` advances every env ``chunk_len`` steps of
the batched ``envs/<task>.step``; finished envs are frozen in every leaf of
the env state and the expert state. The exploration noise of each step
comes from one ``torch.Generator`` or from the draws passed in (``[T, B,
d]`` unit normals). ``run_chunked`` syncs with the host once per chunk and
stops when every env is done or at ``max_steps``.

The JAX behaviour is kept as it is, including the dynamic-mode pushing
engage gate, whose 0.045 tension and 0.016 perpendicular bounds ignore
``near_r``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from d3il_tpu_torch.envs import scenes
from d3il_tpu_torch.eval.rollout import _freeze
from d3il_tpu_torch.ops import quat as quat_ops
from d3il_tpu_torch.robot import chain as chain_mod
from d3il_tpu_torch.robot.panda import JOINT_POS_MAX, JOINT_POS_MIN

_CONSTS: dict = {}


def _const(name: str, values, device) -> torch.Tensor:
    """A float32 constant on ``device``, copied there once."""
    key = (name, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(np.asarray(values, np.float32),
                                       device=device)
    return _CONSTS[key]


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _col(x):
    """A per-env [B] value as a [B, 1] column (a Python number as is)."""
    return x[:, None] if torch.is_tensor(x) else x


def _rows(x, idx):
    """x[e, idx[e]] for every env e: x [B, n, ...], idx [B]."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def _step_toward(cur, tgt, step):
    step = _col(step)
    return cur + torch.clamp(tgt - cur, -step, step)


def _limit_lead(nxt, tcp, max_lead):
    """Cap how far the setpoint leads the physical tcp."""
    ahead = nxt - tcp
    d = _norm(ahead)
    capped = tcp + ahead / _col(torch.clamp(d, min=1e-9)) * _col(max_lead)
    return torch.where(_col(d > max_lead), capped, nxt)


def _yaw_of(quat):
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def _wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


def _i32(x):
    return x.to(torch.int32)


def _first_true(mask):
    """Index of the first True along the last axis (0 where none)."""
    return torch.argmax(mask.to(torch.float32), dim=-1)


# ---------------------------------------------------------------- avoiding

class AvoidingExpertState(NamedTuple):
    k: torch.Tensor  # [B] waypoint index


def avoiding_waypoints(mode, rng: np.random.Generator) -> np.ndarray:
    """Host helper: the 6 corridor waypoints for a (g1, g2, g3) gate
    mode."""
    L1_X = {0: 0.42, 1: 0.58}
    L2_X = {0: 0.35, 1: 0.5, 2: 0.65}
    L3_X = {0: 0.27, 1: 0.425, 2: 0.575, 3: 0.73}
    g1, g2, g3 = mode
    j = lambda: rng.uniform(-0.012, 0.012)
    x1, x2, x3 = L1_X[g1] + j(), L2_X[g2] + j(), L3_X[g3] + j()
    return np.array([
        [x1, scenes.AVOIDING_L1_Y - 0.07],
        [x1, scenes.AVOIDING_L1_Y + 0.08],
        [x2, scenes.AVOIDING_L2_Y - 0.07],
        [x2, scenes.AVOIDING_L2_Y + 0.08],
        [x3, scenes.AVOIDING_L3_Y - 0.07],
        [x3, scenes.AVOIDING_GOAL_Y + 0.03],
    ], np.float32)


def avoiding_expert_step(st: AvoidingExpertState, des_xy, tcp_xy,
                         waypoints):
    """Lag-band regulation along the waypoints [B, 6, 2]."""
    wp = _rows(waypoints, st.k)
    adv = (_norm(wp - tcp_xy) < 0.03) & (st.k < waypoints.shape[1] - 1)
    k = st.k + _i32(adv)
    wp = _rows(waypoints, k)
    lag = _norm(des_xy - tcp_xy)
    step = torch.where(lag < 0.035, 0.010,
                       torch.where(lag < 0.08, 0.005, 0.001))
    delta = _step_toward(des_xy, wp, step) - des_xy
    return AvoidingExpertState(k=k), delta


# ---------------------------------------------------------------- pushing

class PushExpertState(NamedTuple):
    stage: torch.Tensor       # [B] which (box, target) pair
    phase: torch.Tensor       # [B] 0 approach, 1 push
    stall: torch.Tensor       # [B] push steps without progress (dynamic)
    prev_d: torch.Tensor      # [B]
    striking: torch.Tensor    # [B]
    strike_end: torch.Tensor  # [B, 2]


def init_push_expert_state(batch: int, device=None) -> PushExpertState:
    i0 = torch.zeros(batch, dtype=torch.int32, device=device)
    return PushExpertState(
        stage=i0, phase=i0.clone(), stall=i0.clone(),
        prev_d=torch.full((batch,), 1e3, device=device),
        striking=i0.clone(), strike_end=torch.zeros((batch, 2),
                                                    device=device))


PUSH_APPROACH = 0.065
PUSH_STOP = 0.032
PUSH_DEPTH = 0.033       # kinematic indent: the rod 7 mm inside the face
PUSH_DEPTH_DYN = 0.020   # dynamic: the indent sets the impedance push force


def _route_around(des_xy, tcp_xy, approach_pt, obstacles, active,
                  block_r: float = 0.075, detour_r: float = 0.11,
                  app_step: float = 0.01, app_lead: float = 0.03,
                  bounds=None):
    """The first active obstacle (obstacles [B, n, 2], active [B, n])
    blocking the straight line to the approach point -> a detour point;
    then the paced, braked approach carrot toward it. ``bounds``: (lo, hi)
    device tensors [2] of the work area (a detour outside flips sides)."""
    v = approach_pt - tcp_xy
    L = _norm(v) + 1e-9
    w = v / L[:, None]
    perp = torch.stack([-w[:, 1], w[:, 0]], dim=-1)
    found = torch.zeros_like(L, dtype=torch.bool)
    target = approach_pt
    for j in range(obstacles.shape[1]):
        ob = obstacles[:, j]
        tproj_raw = _dot(ob - tcp_xy, v) / (L * L)
        tproj = torch.clamp(tproj_raw, 0, 1)
        closest = tcp_xy + tproj[:, None] * v
        # an obstacle blocks only when it lies ahead along the travel
        blocking = active[:, j] & (tproj_raw > 0) \
            & (_norm(closest - ob) < block_r) & (_norm(ob - tcp_xy) < L)
        side = torch.where(_dot(tcp_xy - ob, perp) >= 0, 1.0, -1.0)
        detour = ob + perp * side[:, None] * detour_r
        if bounds is not None:
            lo, hi = bounds
            outside = ((detour < lo) | (detour > hi)).any(dim=-1)
            detour = torch.where(outside[:, None],
                                 ob - perp * side[:, None] * detour_r, detour)
        use = blocking & ~found
        found = found | blocking
        target = torch.where(use[:, None], detour, target)
    nxt = _step_toward(des_xy, target, app_step)
    # approach braking: shrink the lead as the rod closes in
    lead_eff = torch.clamp(0.5 * _norm(target - tcp_xy) + 0.025,
                           max=app_lead)
    return _limit_lead(nxt, tcp_xy, lead_eff)


def pushing_expert_step(st: PushExpertState, des_xy, tcp_xy, boxes_xy,
                        seq_box, seq_tgt, push_depth=PUSH_DEPTH,
                        push_step=0.006, lead=0.04,
                        app_step=0.01, app_lead=0.03,
                        strike_depth=None, strike_lead=0.12,
                        strike_radius=0.16, near_r=0.015,
                        block_r=0.075, detour_r=0.11):
    """seq_box [B, 2] int, seq_tgt [B, 2, 2]: each env's (box, target)
    order. ``strike_depth`` set selects the dynamic mode: the deeper
    staging point, the line-anchored carried push, the progress watchdog's
    longer grace, and the engage gate on the tension |des - tcp| < 0.045
    and the perpendicular offset < 0.016 (``near_r`` is not read there)."""
    dev = des_xy.device
    stage = torch.clamp(st.stage, max=1)
    b = _rows(seq_box, stage)
    tgt = _rows(seq_tgt, stage)
    bpos = _rows(boxes_xy, b)
    to_tgt = tgt - bpos
    d_tgt = _norm(to_tgt)
    u = to_tgt / (d_tgt + 1e-9)[:, None]

    stage_done = d_tgt < PUSH_STOP
    dyn = strike_depth is not None
    app_back = (PUSH_APPROACH + 0.03) if dyn else PUSH_APPROACH
    approach_pt = bpos - u * app_back
    rel = tcp_xy - bpos
    along = _dot(rel, u)
    perp = _norm(rel - along[:, None] * u)
    if dyn:
        behind = (along > -app_back - 0.045) & (along < -0.038)
        near = behind & (perp < 0.016) & (_norm(des_xy - tcp_xy) < 0.045)
    else:
        near = (_norm(approach_pt - tcp_xy) < near_r) & (along < -0.05)
    phase = torch.where(stage_done, 0, torch.where(near, 1, st.phase))
    phase = _i32(phase)

    # rod out of pushing position: re-approach
    if dyn:
        bad = (phase == 1) & ((along > 0.005) | (perp > 0.08))
    else:
        bad = (phase == 1) & ((along > -0.005) | (perp > 0.05))
    phase = _i32(torch.where(bad & ~near, 0, phase))

    # route around every box, the target box included
    others = torch.ones(boxes_xy.shape[:2], dtype=torch.bool, device=dev)
    push_bounds = (_const("push_lo", [0.33, -0.42], dev),
                   _const("push_hi", [0.76, 0.42], dev)) if dyn else None
    nxt_app = _route_around(des_xy, tcp_xy, approach_pt, boxes_xy, others,
                            block_r=block_r, detour_r=detour_r,
                            app_step=app_step, app_lead=app_lead,
                            bounds=push_bounds)
    if dyn:
        # behind the box but off the push line: pull laterally onto it
        depth_c = torch.clamp(along, -app_back - 0.02, -0.055)
        align_pt = bpos + u * depth_c[:, None]
        nxt_align = _limit_lead(_step_toward(des_xy, align_pt, app_step),
                                tcp_xy, 0.045)
        nxt_app = torch.where((behind & ~near)[:, None], nxt_align, nxt_app)
    if strike_depth is None:
        # kinematic: the box-anchored carrot at a fixed indent
        push_pt = bpos - u * push_depth
        nxt_push = _limit_lead(_step_toward(des_xy, push_pt, push_step),
                               tcp_xy, lead)
    else:
        # dynamic: the line-anchored carried push, slow catch, fast carry,
        # the carrot mirrored across the push line and capped
        # strike_radius short of the target
        lead_eff = torch.where(along < -0.052, 0.032, strike_lead)
        s_carrot = torch.minimum(along + lead_eff, d_tgt - strike_radius)
        perp_vec = rel - along[:, None] * u
        nxt_push = bpos + u * s_carrot[:, None] - perp_vec

    # progress watchdog
    progressing = d_tgt < st.prev_d - 5e-4
    count = (phase == 1) & ~progressing
    if dyn:
        count = count & (d_tgt > 0.09)
    stall = _i32(torch.where(count, st.stall + 1, 0))
    stalled = stall > (50 if dyn else 35)
    phase = _i32(torch.where(stalled, 0, phase))
    stall = _i32(torch.where(stalled, 0, stall))

    nxt = torch.where((phase == 1)[:, None], nxt_push, nxt_app)
    new_stage = st.stage + _i32(stage_done)
    delta = torch.where((stage_done | (st.stage >= 2))[:, None],
                        torch.zeros_like(nxt), nxt - des_xy)
    return PushExpertState(
        stage=torch.clamp(new_stage, max=2),
        phase=_i32(torch.where(stage_done, 0, phase)), stall=stall,
        prev_d=torch.where(stage_done, 1e3, d_tgt),
        striking=_i32(torch.where(stage_done, 0, st.striking)),
        strike_end=st.strike_end), delta


# ---------------------------------------------------------------- sorting

class SortingExpertState(NamedTuple):
    stage: torch.Tensor   # [B] which box in `order`
    phase: torch.Tensor   # [B] 0 approach_x, 1 push_x, 2 approach_y, 3 push_y
    prev_b: torch.Tensor  # [B] box worked last step


def init_sorting_expert_state(batch: int, device=None):
    i0 = torch.zeros(batch, dtype=torch.int32, device=device)
    return SortingExpertState(stage=i0, phase=i0.clone(),
                              prev_b=torch.full_like(i0, -1))


SORT_DONE_Y = 0.215
SORT_RED_X = 0.4
SORT_BLUE_X = 0.625


def sorting_expert_step(st: SortingExpertState, des_xy, tcp_xy, boxes_pos,
                        order, half, push_depth=PUSH_DEPTH,
                        pstep_slow=0.006, pstep_fast=0.010,
                        lead_slow=0.04, lead_fast=0.05,
                        app_step=0.01, app_lead=0.03, near_r=0.015,
                        dyn=False, dyn_adv=0.09, x_ok_r=0.015,
                        block_r=0.075, detour_r=0.11):
    """Two-leg push per box: align x to the zone center, then eject toward
    (x_zone, 0.30) over the +y platform edge. order [B, n] int
    permutations; boxes 0..half-1 red; boxes_pos [B, n, 3]."""
    dev = des_xy.device
    n = order.shape[1]
    boxes_xy = boxes_pos[..., :2]
    stage = torch.clamp(st.stage, max=n - 1)
    b = _rows(order, stage)
    bp3 = _rows(boxes_pos, b)
    zone_x = lambda box: torch.where(box < half, SORT_RED_X, SORT_BLUE_X)

    dropped = (bp3[:, 2] < 0.06) & (bp3[:, 1] > 0.15)
    ejected = bp3[:, 1] > SORT_DONE_Y
    if dyn:
        ejected = ejected & ((zone_x(b) - bp3[:, 0]).abs() < 0.09)
    box_done = ejected | dropped
    stage2 = torch.clamp(st.stage + _i32(box_done), max=n)
    finished = stage2 >= n
    b = _rows(order, torch.clamp(stage2, max=n - 1))
    bpos = _rows(boxes_xy, b)

    # another live box in the push corridor ahead: eject it first
    active = (boxes_pos[..., 2] > 0.06) & (boxes_xy[..., 1] < SORT_DONE_Y)
    aim_b = torch.stack([zone_x(b), torch.full_like(bpos[:, 0], 0.30)], -1)
    u_b = (aim_b - bpos) / (_norm(aim_b - bpos) + 1e-9)[:, None]
    rel = boxes_xy - bpos[:, None]
    proj = _dot(rel, u_b[:, None])
    perp = _norm(rel - proj[..., None] * u_b[:, None])
    active = active.scatter(1, b.long()[:, None], False)
    blocking = active & (proj > 0.01) & (proj < 0.45) & (perp < 0.085)
    b = torch.where(blocking.any(dim=1), _i32(_first_true(blocking)), b)
    bpos = _rows(boxes_xy, b)
    phase = _i32(torch.where(box_done | (b != st.prev_b), 0, st.phase))

    x_tgt = zone_x(b)
    dx = x_tgt - bpos[:, 0]
    x_ok = dx.abs() < x_ok_r
    ux = torch.stack([torch.sign(dx), torch.zeros_like(dx)], -1)
    aim = torch.stack([x_tgt, torch.full_like(x_tgt, 0.30)], -1)
    to_aim = aim - bpos
    uy = to_aim / (_norm(to_aim) + 1e-9)[:, None]
    phase = _i32(torch.where((phase == 0) & x_ok, 2, phase))
    phase = _i32(torch.where((phase == 1) & x_ok, 2, phase))
    u = torch.where((phase >= 2)[:, None], uy, ux)

    approach_pt = bpos - u * PUSH_APPROACH
    near = _norm(approach_pt - tcp_xy) < near_r
    in_approach = (phase == 0) | (phase == 2)
    phase = _i32(torch.where(in_approach & near, phase + 1, phase))

    sort_bounds = (_const("sort_lo", [0.28, -0.28], dev),
                   _const("sort_hi", [0.72, 0.28], dev)) if dyn else None
    nxt_app = _route_around(des_xy, tcp_xy, approach_pt, boxes_xy,
                            boxes_pos[..., 2] > 0.06,
                            block_r=block_r, detour_r=detour_r,
                            app_step=app_step, app_lead=app_lead,
                            bounds=sort_bounds)
    # speed through the edge so momentum carries the box clear of the lip
    near_edge = (phase == 3) & (bpos[:, 1] > 0.12)
    pstep = torch.where(near_edge, pstep_fast, pstep_slow)
    lead = torch.where(near_edge, lead_fast, lead_slow)
    push_pt = bpos - u * push_depth
    nxt_push = _limit_lead(_step_toward(des_xy, push_pt, pstep), tcp_xy,
                           lead)
    in_push = (phase == 1) | (phase == 3)
    if dyn:
        # the line-anchored carried push (see pushing_expert_step)
        rel_b = tcp_xy - bpos
        along_b = _dot(rel_b, u)
        dist_aim = torch.where(phase >= 2, _norm(aim - bpos), dx.abs())
        margin = torch.where(phase >= 2, 0.02, 0.058)
        adv_eff = torch.where(along_b < -0.052, 0.032, dyn_adv)
        s_carrot = torch.minimum(along_b + adv_eff, dist_aim - margin)
        perp_vec_b = rel_b - along_b[:, None] * u
        nxt_push = bpos + u * s_carrot[:, None] - perp_vec_b
        # rod slipped past the box: drop back to approach
        slipped = in_push & (along_b > -0.005)
        phase = _i32(torch.where(slipped, phase - 1, phase))
        in_push = in_push & ~slipped
    nxt = torch.where(in_push[:, None], nxt_push, nxt_app)
    if dyn:
        # keep the carrot over the platform
        nxt = torch.clamp(nxt, _const("sort_nlo", [0.26, -0.30], dev),
                          _const("sort_nhi", [0.74, 0.30], dev))
    delta = torch.where((finished | box_done)[:, None], torch.zeros_like(nxt),
                        nxt - des_xy)
    return SortingExpertState(stage=stage2, phase=phase, prev_b=b), delta


# ---------------------------------------------------------------- inserting

class InsertingExpertState(NamedTuple):
    stage: torch.Tensor   # [B] index into `order` (0..2; 3 = finished)
    wp: torch.Tensor      # [B] waypoint index along the current box's route
    phase: torch.Tensor   # [B] 0 approach, 1 push, 2 retreat


def init_inserting_expert_state(batch: int, device=None):
    i0 = torch.zeros(batch, dtype=torch.int32, device=device)
    return InsertingExpertState(stage=i0, wp=i0.clone(), phase=i0.clone())


# Per-target push routes (box i -> target i): the gap between the maze
# diagonals, a stage before the chamber gate, the slow gate insertion.
INSERT_ROUTES = np.array([
    [[0.525, 0.11], [0.465, 0.276], [0.3575, 0.276]],   # left chamber
    [[0.525, 0.11], [0.525, 0.30], [0.525, 0.4535]],    # middle chamber
    [[0.525, 0.11], [0.585, 0.276], [0.6925, 0.276]],   # right chamber
], np.float32)

# Rod pull-back point after each insertion.
INSERT_RETREATS = np.array([
    [0.47, 0.23], [0.525, 0.30], [0.58, 0.23]], np.float32)


def inserting_expert_step(st: InsertingExpertState, des_xy, tcp_xy,
                          boxes_pos, visited, order, push_depth=PUSH_DEPTH):
    """order [B, 3]: the insertion order; visited [B, 3] bool from the env
    state. Each box is pushed along INSERT_ROUTES[box]; the env's visited
    flag ends a stage."""
    dev = des_xy.device
    routes = _const("insert_routes", INSERT_ROUTES, dev)
    retreats = _const("insert_retreats", INSERT_RETREATS, dev)
    n = 3
    b = _rows(order, torch.clamp(st.stage, max=n - 1)).long()
    finished = st.stage >= n

    # current box placed -> back the rod out, then the next box
    phase = _i32(torch.where(_rows(visited, b) & (st.phase != 2), 2,
                             st.phase))
    ret_pt = retreats[b]
    ret_done = (phase == 2) & (_norm(tcp_xy - ret_pt) < 0.03)
    stage2 = torch.clamp(st.stage + _i32(ret_done), max=n)
    wp_i = _i32(torch.where(ret_done, 0, st.wp))
    phase = _i32(torch.where(ret_done, 0, phase))
    b = _rows(order, torch.clamp(stage2, max=n - 1)).long()
    bpos = _rows(boxes_pos, b)[:, :2]

    # waypoint advance, with the gate-axis hysteresis
    wp = routes[b, wp_i.long()]
    axis_off = torch.where(b == 1, (bpos[:, 0] - 0.525).abs(),
                           (bpos[:, 1] - 0.276).abs())
    near_wp = _norm(bpos - wp) < 0.035
    adv = ((wp_i == 0) & near_wp) | \
          ((wp_i == 1) & near_wp & (axis_off < 0.008))
    wp_i = wp_i + _i32(adv)
    wp_i = _i32(torch.where((wp_i == 2) & (axis_off > 0.015)
                            & ~_rows(visited, b), 1, wp_i))
    phase = _i32(torch.where(adv & (phase != 2), 0, phase))
    wp = routes[b, wp_i.long()]

    to_wp = wp - bpos
    u = to_wp / (_norm(to_wp) + 1e-9)[:, None]
    approach_pt = bpos - u * PUSH_APPROACH
    near = _norm(approach_pt - tcp_xy) < 0.015
    phase = _i32(torch.where((phase == 0) & near, 1, phase))
    rel = tcp_xy - bpos
    along = _dot(rel, u)
    perp = _norm(rel - along[:, None] * u)
    bad = (phase == 1) & ((along > -0.005) | (perp > 0.05))
    phase = _i32(torch.where(bad, 0, phase))

    final = wp_i >= 2
    pstep = torch.where(final, 0.004, 0.006)
    lead = torch.where(final, 0.03, 0.04)
    push_pt = bpos - u * push_depth
    nxt_push = _limit_lead(_step_toward(des_xy, push_pt, pstep), tcp_xy,
                           lead)
    nxt_app = _route_around(des_xy, tcp_xy, approach_pt, boxes_pos[..., :2],
                            ~visited)
    nxt_ret = _limit_lead(_step_toward(des_xy, ret_pt, 0.008), tcp_xy, 0.05)

    nxt = torch.where((phase == 2)[:, None], nxt_ret,
                      torch.where((phase == 1)[:, None], nxt_push, nxt_app))
    # keep the rod inside the board area
    nxt = torch.clamp(nxt, _const("insert_lo", [0.30, -0.27], dev),
                      _const("insert_hi", [0.75, 0.47], dev))
    delta = torch.where(finished[:, None], torch.zeros_like(nxt),
                        nxt - des_xy)
    return InsertingExpertState(stage=stage2, wp=wp_i, phase=phase), delta


# ---------------------------------------------------------------- aligning

class AligningExpertState(NamedTuple):
    phase: torch.Tensor     # [B] 0 travel, 1 descend, 2 work
    rotating: torch.Tensor  # [B] bool: in a rotation stint
    wall: torch.Tensor      # [B] latched wall of the current rotate stint


def init_aligning_expert_state(batch: int, device=None):
    i0 = torch.zeros(batch, dtype=torch.int32, device=device)
    return AligningExpertState(phase=i0, rotating=torch.zeros_like(
        i0, dtype=torch.bool), wall=i0.clone())


ALIGN_R_IN = 0.040
ALIGN_R_OUT = 0.062
ALIGN_Z_HIGH = 0.25
ALIGN_Z_LOW = 0.17      # the rod tip on the tray walls, off the plate
_WALLS = [[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]


def aligning_expert_step(st: AligningExpertState, des_pos, tcp_pos,
                         tray_pos, tray_quat, tgt_pos, tgt_quat, mode):
    """mode [B] 0: work from inside the tray; 1: from outside. Alternates a
    translate press (a wall center, in the tray frame) with a rotate press
    (a wall at a lateral offset), with hysteresis on the yaw error."""
    dev = des_pos.device
    c = tray_pos[:, :2]
    yaw = _yaw_of(tray_quat)
    dyaw = _wrap(_yaw_of(tgt_quat) - yaw)
    dp = tgt_pos[:, :2] - c
    dpn = _norm(dp)
    pos_ok = dpn < 0.012
    rot_ok = dyaw.abs() < 0.10
    inside = mode == 0

    entry = torch.where(inside[:, None], c,
                        c + _const("align_entry", [0.0, -0.09], dev))
    at_entry = _norm(des_pos[:, :2] - entry) <= 0.008
    low = des_pos[:, 2] <= ALIGN_Z_LOW + 0.004
    phase = _i32(torch.where(st.phase == 0, _i32(at_entry), st.phase))
    phase = _i32(torch.where((phase == 1) & low, 2, phase))

    z = lambda v: torch.full_like(entry[:, :1], v)
    hover = torch.cat([entry, z(ALIGN_Z_HIGH)], dim=1)
    dive = torch.cat([entry, z(ALIGN_Z_LOW)], dim=1)
    d_travel = _step_toward(des_pos, hover, 0.01) - des_pos
    d_descend = _step_toward(des_pos, dive, 0.008) - des_pos

    ca, sa = torch.cos(yaw), torch.sin(yaw)
    rot = lambda v: torch.stack([ca * v[:, 0] - sa * v[:, 1],
                                 sa * v[:, 0] + ca * v[:, 1]], -1)
    c_ob = c[:, None]                     # the tray as a routing obstacle
    tray_active = (~inside)[:, None]

    rotating = torch.where(st.rotating, dyaw.abs() > 0.05,
                           dyaw.abs() > 0.12)

    # translate: axis-aligned legs in the tray frame, pressing a wall center
    dpl = torch.stack([ca * dp[:, 0] + sa * dp[:, 1],
                       -sa * dp[:, 0] + ca * dp[:, 1]], -1)    # Rm' dp
    axis = torch.argmax(dpl.abs(), dim=-1)
    sgn_t = torch.sign(_rows(dpl, axis))
    dir_local = torch.nn.functional.one_hot(axis, 2).to(dp.dtype) \
        * sgn_t[:, None]
    u_t = rot(dir_local)
    rad = torch.where(inside, ALIGN_R_IN, ALIGN_R_OUT)
    indent = torch.where(dpn < 0.03, 0.004, 0.012)
    tstep = torch.where(dpn < 0.05, 0.003, 0.006)
    contact = torch.where(inside[:, None], c + u_t * rad[:, None],
                          c - u_t * rad[:, None])
    goal2 = contact + u_t * indent[:, None]
    ahead = _dot(tcp_pos[:, :2] - c, u_t) > 0.02
    nxt_direct = _limit_lead(_step_toward(des_pos[:, :2], goal2, tstep),
                             tcp_pos[:, :2], 0.035)
    nxt_orbit = _route_around(des_pos[:, :2], tcp_pos[:, :2], goal2, c_ob,
                              tray_active, block_r=0.095, detour_r=0.14)
    nxt_t = torch.where((~inside & ahead)[:, None], nxt_orbit, nxt_direct)

    # rotate: press the wall whose push moves the tray toward the target,
    # latched while it still does
    sgn = torch.sign(dyaw)
    off = torch.where(inside, 0.030, 0.040)
    wall_x = torch.where(inside, 0.045 - 0.010 + 0.004, 0.055 + 0.010 - 0.004)
    e_loc = _const("align_walls", _WALLS, dev)
    n_world = torch.stack([ca[:, None] * e_loc[:, 0] - sa[:, None]
                           * e_loc[:, 1],
                           sa[:, None] * e_loc[:, 0] + ca[:, None]
                           * e_loc[:, 1]], -1)          # [B, 4, 2]
    u_dp = dp / (dpn + 1e-9)[:, None]
    push_sign = torch.where(inside, 1.0, -1.0)
    k_best = torch.argmax(push_sign[:, None] * _dot(n_world, u_dp[:, None]),
                          dim=-1)
    held_push = push_sign[:, None] * _rows(n_world, st.wall)
    stale = _dot(held_push, u_dp) < -0.15
    k_wall = _i32(torch.where(st.rotating & rotating & ~stale, st.wall,
                              _i32(k_best)))
    e_k = e_loc[k_wall.long()]
    t_k = torch.stack([-e_k[:, 1], e_k[:, 0]], -1)
    o = torch.where(inside, -sgn, sgn) * off
    press_local = e_k * wall_x[:, None] + t_k * o[:, None]
    press = c + rot(press_local)
    nxt_r_direct = _limit_lead(_step_toward(des_pos[:, :2], press, 0.005),
                               tcp_pos[:, :2], 0.03)
    nxt_r_orbit = _route_around(des_pos[:, :2], tcp_pos[:, :2], press, c_ob,
                                tray_active, block_r=0.095, detour_r=0.14)
    blocked = _dot(tcp_pos[:, :2] - c, press - c) < 0
    nxt_r = torch.where((~inside & blocked)[:, None], nxt_r_orbit,
                        nxt_r_direct)

    nxt2 = torch.where(rotating[:, None], nxt_r, nxt_t)
    d_work = torch.cat([nxt2 - des_pos[:, :2], z(0.0)], dim=1)
    d_work = torch.where((pos_ok & rot_ok)[:, None], torch.zeros_like(d_work),
                         d_work)
    delta = torch.where((phase == 0)[:, None], d_travel,
                        torch.where((phase == 1)[:, None], d_descend,
                                    d_work))
    return AligningExpertState(phase=phase, rotating=rotating,
                               wall=k_wall), delta


# ---------------------------------------------------------------- stacking

class StackingExpertState(NamedTuple):
    stage: torch.Tensor   # [B] which box in the order (0..2; 3 = finished)
    phase: torch.Tensor   # [B] 0 hover, 1 descend, 2 close, 3 lift, 4 carry,
    #                       5 place, 6 open, 7 retreat
    hold: torch.Tensor    # [B] dwell counter for close/open
    q_des: torch.Tensor   # [B, 7] joint setpoint the expert maintains


def init_stacking_expert_state(q_des) -> StackingExpertState:
    i0 = torch.zeros(q_des.shape[0], dtype=torch.int32, device=q_des.device)
    return StackingExpertState(stage=i0, phase=i0.clone(), hold=i0.clone(),
                               q_des=q_des)


STACK_Z_HOVER = 0.22
STACK_Z_GRASP = 0.018    # the tip pads on the resting box's center
STACK_HOLD_CLOSE = 22    # > the env's 0.5 s close_fingers servo window
STACK_HOLD_OPEN = 10
_STACK_TOL = [0.02, 0.006, 1.0, 0.02, 0.015, 0.006, 1.0, 0.02]


def _ik_toward(ctrl_chain, q, tgt_pos, tgt_quat, iters: int = 10,
               lr: float = 0.002, rate=0.05):
    """Rate-limited DLS IK tracking for a batch: move q [B, 7] a bounded
    step (``rate``: a number or [B]) toward the target EE pose. Each of the
    ``iters`` iterations solves the 6 x 6 system J J' + 1e-6 I."""
    ee = ctrl_chain.body_index("panda_grasptarget")
    dev = q.device
    lo = _const("q_min", JOINT_POS_MIN, dev)
    hi = _const("q_max", JOINT_POS_MAX, dev)
    eye = 1e-6 * torch.eye(6, dtype=q.dtype, device=dev)
    q0 = q
    for _ in range(iters):
        xpos, xquat = chain_mod.fk(ctrl_chain, q)
        cur_q = xquat[:, ee]
        flip = torch.where(((cur_q - tgt_quat) ** 2).sum(-1)
                      > ((cur_q + tgt_quat) ** 2).sum(-1), -1.0, 1.0)
        dqt = tgt_quat * flip[:, None]
        pos_err = torch.clamp(tgt_pos - xpos[:, ee], -0.02, 0.02)
        quat_err = torch.clamp(quat_ops.quat_error(cur_q, dqt), -0.1, 0.1)
        err = torch.cat([pos_err * 200.0, quat_err * 30.0], dim=-1)
        J = chain_mod.point_jacobian(ctrl_chain, q, ee,
                                     fk_cache=(xpos, xquat))[..., :7]
        A = J @ J.transpose(-1, -2) + eye
        qd = (J.transpose(-1, -2)
              @ torch.linalg.solve(A, err[..., None]))[..., 0]
        nrm = _norm(qd)
        qd = torch.where((nrm > 3.0)[:, None],
                         qd * 3.0 / torch.clamp(nrm, min=1e-9)[:, None], qd)
        q = torch.clamp(q + lr * qd, lo, hi)
    dq = q - q0
    n = _norm(dq)[:, None]
    rate = _col(rate)
    return q0 + torch.where(n > rate, dq * rate / torch.clamp(n, min=1e-9),
                            dq)


def stacking_expert_step(ctrl_chain, st: StackingExpertState, box_pos,
                         box_quat, target_xy, order, tcp_pos=None,
                         width_meas=None):
    """One step of the pick-and-place expert: (state, action [B, 8] =
    [q_des, width_cmd]). tcp_pos: the physical grasptarget [B, 3] (phase
    advance gates on the real arm); width_meas [B]: the measured finger
    opening (fully closed after the close dwell: the grasp missed, retry
    from hover)."""
    dev = box_pos.device
    ee = ctrl_chain.body_index("panda_grasptarget")
    stage = torch.clamp(st.stage, max=2)
    b = _rows(order, stage)
    bp = _rows(box_pos, b)
    yaw = _yaw_of(_rows(box_quat, b))
    # grasp-yaw symmetry: square boxes pi/2; the blue box pi, its gripper
    # yaw turned 90 degrees to close across its 0.06 x-axis
    yaw_sq = _wrap(yaw + math.pi / 4) % (math.pi / 2) - math.pi / 4
    yb = _wrap(yaw + math.pi / 2)
    yaw_bl = torch.where(yb > math.pi / 2, yb - math.pi,
                         torch.where(yb < -math.pi / 2, yb + math.pi, yb))
    h = torch.where(b == 2, yaw_bl, yaw_sq) / 2.0
    zero = torch.zeros_like(h)
    tgt_quat = torch.stack([zero, torch.cos(h), torch.sin(h), zero], -1)

    z_stack = 0.02 + 0.062 * stage.to(bp.dtype)
    zc = lambda v: torch.full_like(zero, v)
    bx, by = bp[:, 0], bp[:, 1]
    tx, ty = target_xy[:, 0], target_xy[:, 1]
    wp_tab = torch.stack([
        torch.stack([bx, by, zc(STACK_Z_HOVER)], -1),      # 0 hover
        torch.stack([bx, by, zc(STACK_Z_GRASP)], -1),      # 1 descend
        torch.stack([bx, by, zc(STACK_Z_GRASP)], -1),      # 2 close
        torch.stack([bx, by, zc(STACK_Z_HOVER)], -1),      # 3 lift
        torch.stack([tx, ty, zc(STACK_Z_HOVER)], -1),      # 4 carry
        torch.stack([tx, ty, z_stack], -1),                # 5 place
        torch.stack([tx, ty, z_stack], -1),                # 6 open
        torch.stack([tx, ty, zc(STACK_Z_HOVER)], -1),      # 7 retreat
    ], dim=1)
    wp = _rows(wp_tab, st.phase)
    tol = _const("stack_tol", _STACK_TOL, dev)[st.phase.long()]

    wp_ik, rate = wp, 0.05
    if tcp_pos is not None:
        # vertical pick/place approach: hold altitude while off center
        des_ph = (st.phase == 1) | (st.phase == 5)
        xy_err = _norm(tcp_pos[:, :2] - wp[:, :2])
        z_gate = torch.maximum(
            wp[:, 2], tcp_pos[:, 2] - 0.8 * torch.clamp(0.012 - xy_err, 0.0,
                                                        0.012))
        z_gate = torch.clamp(z_gate, max=STACK_Z_HOVER)
        wp_ik = torch.cat([wp[:, :2], torch.where(des_ph, z_gate,
                                                  wp[:, 2])[:, None]], 1)
        # slow the virtual trajectory near the workpiece
        rate = torch.where(des_ph & (tcp_pos[:, 2] < 0.12), 0.02, 0.05)

    dwell = (st.phase == 2) | (st.phase == 6)
    q_new = _ik_toward(ctrl_chain, st.q_des, wp_ik, tgt_quat, rate=rate)
    q_des = torch.where((dwell | (st.stage >= 3))[:, None], st.q_des, q_new)

    if tcp_pos is None:
        tcp_pos = chain_mod.fk(ctrl_chain, q_des)[0][:, ee]
    reached = _norm(tcp_pos - wp) < tol

    hold_lim = torch.where(st.phase == 2, STACK_HOLD_CLOSE, STACK_HOLD_OPEN)
    hold = _i32(torch.where(dwell, st.hold + 1, 0))
    advance = torch.where(dwell, hold >= hold_lim, reached) & (st.stage < 3)
    missed = width_meas < 0.02 if width_meas is not None \
        else torch.zeros_like(advance)
    retry = advance & (st.phase == 2) & missed
    phase = _i32(torch.where(advance, st.phase + 1, st.phase))
    phase = _i32(torch.where(retry, 0, phase))
    wrap = phase > 7
    stage2 = st.stage + _i32(wrap)
    phase = _i32(torch.where(wrap, 0, phase))

    # the gripper: open through descend; closed from close to place
    width = torch.where((phase >= 2) & (phase <= 5), 0.0, 0.08)
    action = torch.cat([q_des, width[:, None]], dim=1)
    return StackingExpertState(stage=stage2, phase=phase, hold=hold,
                               q_des=q_des), action


# ------------------------------------------------------------ batched runs
#
# A runner is (init, chunk): ``init`` resets the envs and builds the
# episode carry, ``chunk`` advances chunk_len env steps. The host loops
# over chunks and stops once every env is done.

CHUNK = 50

# Exploration noise on the EXECUTED setpoint (and logged, so the action
# labels hold it): the experts correct it, which puts recovery behaviour in
# the datasets.
DES_NOISE = 0.0015
STACK_Q_NOISE = 0.002
_DOWN = [0.0, 1.0, 0.0, 0.0]


class EpCarry(NamedTuple):
    env: object           # the task's env state
    es: object            # the expert state
    des: torch.Tensor     # [B, d] executed setpoint (stacking: [B, 0])
    done: torch.Tensor    # [B] bool
    extras: tuple         # per-env expert inputs (routes, orders, modes)
    fixed_z: torch.Tensor  # [B, 1] the planar tasks' setpoint height


def _chunk_fn(step_once, chunk_len: int, generator, noise_dim: int):
    """chunk(carry, noise=None) -> (carry, logs, dones): chunk_len steps;
    ``noise`` [chunk_len, B, noise_dim] unit normals (from generator unless
    given); logs a tuple of [chunk_len, B, ...] tensors, dones [chunk_len,
    B]."""
    def chunk(carry, noise=None):
        logs, dones = [], []
        shape = (carry.done.shape[0], noise_dim)
        for i in range(chunk_len):
            z = noise[i] if noise is not None else torch.randn(
                shape, generator=generator, device=carry.done.device)
            carry, log, done = step_once(carry, z)
            logs.append(log)
            dones.append(done)
        return (carry, tuple(torch.stack(x) for x in zip(*logs)),
                torch.stack(dones))
    return chunk


def _rod_step(params, env, expert):
    """One planar (or, with a 3-d setpoint, xyz) step of a rod task:
    expert(carry, tcp) -> (es, delta, extra logs); noisy setpoint clipped
    to +-0.011 m per axis; frozen where done."""
    dev = params.device
    down = _const("down", _DOWN, dev)

    def step_once(carry, z):
        state, es, des, done = carry.env, carry.es, carry.des, carry.done
        tcp, _ = params.tcp_pose(state.scene)
        es2, delta, more = expert(carry, tcp)
        des2 = torch.where(done[:, None], des,
                           des + torch.clamp(delta + z * DES_NOISE,
                                             -0.011, 0.011))
        planar = des.shape[1] == 2
        pos = torch.cat([des2, carry.fixed_z], 1) if planar else des2
        log = (pos, tcp) + more
        action = torch.cat([pos, down.expand(pos.shape[0], 4)], dim=1)
        ns, res = env.step(params, state, action)
        return (carry._replace(env=_freeze(done, ns, state),
                               es=_freeze(done, es2, es), des=des2,
                               done=done | res.done), log, res.done)

    return step_once


def _boxes_log(state):
    return (state.scene.free_pos, state.scene.free_quat)


def _rod_init(params, state, es, extras, pos_dim=2):
    tcp0, _ = params.tcp_pose(state.scene)
    done = torch.zeros(tcp0.shape[0], dtype=torch.bool, device=tcp0.device)
    return EpCarry(state, es, tcp0[:, :pos_dim].contiguous(), done, extras,
                   tcp0[:, 2:3].contiguous())


def make_avoiding_runner(params, chunk_len: int = CHUNK, generator=None):
    """init(waypoints [B, 6, 2]); logs (des [B, 3], tcp [B, 3])."""
    from d3il_tpu_torch.envs import avoiding as env

    def init(waypoints):
        waypoints = torch.as_tensor(waypoints, dtype=torch.float32,
                                    device=params.device)
        B = waypoints.shape[0]
        state = env.reset(params, env.empty_context(B, params.device))
        es = AvoidingExpertState(
            k=torch.zeros(B, dtype=torch.int32, device=params.device))
        return _rod_init(params, state, es, (waypoints,))

    def expert(carry, tcp):
        es, delta = avoiding_expert_step(carry.es, carry.des, tcp[:, :2],
                                         carry.extras[0])
        return es, delta, ()

    return init, _chunk_fn(_rod_step(params, env, expert), chunk_len,
                           generator, 2)


PUSH_KW_KINEMATIC = dict(push_step=0.006, lead=0.04, app_step=0.01,
                         app_lead=0.03)
PUSH_KW_DYNAMIC = dict(push_step=0.011, lead=0.05, app_step=0.011,
                       app_lead=0.11, strike_depth=-0.06, strike_lead=0.09,
                       strike_radius=0.058, near_r=0.045,
                       block_r=0.095, detour_r=0.13)


def make_pushing_runner(params, chunk_len: int = CHUNK, generator=None):
    """init(context, seq_box [B, 2], seq_tgt [B, 2, 2]); logs (des, tcp,
    free_pos, free_quat)."""
    from d3il_tpu_torch.envs import pushing as env
    depth = PUSH_DEPTH if params.kinematic else PUSH_DEPTH_DYN
    kw = PUSH_KW_KINEMATIC if params.kinematic else PUSH_KW_DYNAMIC

    def init(context, seq_box, seq_tgt):
        state = env.reset(params, context)
        B = state.t.shape[0]
        dev = params.device
        extras = (torch.as_tensor(seq_box, dtype=torch.int32, device=dev),
                  torch.as_tensor(seq_tgt, dtype=torch.float32, device=dev))
        return _rod_init(params, state, init_push_expert_state(B, dev),
                         extras)

    def expert(carry, tcp):
        es, delta = pushing_expert_step(
            carry.es, carry.des, tcp[:, :2],
            carry.env.scene.free_pos[..., :2], *carry.extras,
            push_depth=depth, **kw)
        return es, delta, _boxes_log(carry.env)

    return init, _chunk_fn(_rod_step(params, env, expert), chunk_len,
                           generator, 2)


SORT_KW_DYNAMIC = dict(push_depth=0.045, pstep_slow=0.011, pstep_fast=0.011,
                       lead_slow=0.06, lead_fast=0.075, app_step=0.011,
                       app_lead=0.08, near_r=0.045, dyn=True, dyn_adv=0.09,
                       x_ok_r=0.03, block_r=0.105, detour_r=0.15)


def make_sorting_runner(params, chunk_len: int = CHUNK, generator=None):
    """init(context, order [B, n]); logs (des, tcp, free_pos, free_quat)."""
    from d3il_tpu_torch.envs import sorting as env
    half = params.num_boxes // 2
    kw = dict(push_depth=PUSH_DEPTH) if params.kinematic else SORT_KW_DYNAMIC

    def init(context, order):
        state = env.reset(params, context)
        dev = params.device
        order = torch.as_tensor(order, dtype=torch.int32, device=dev)
        return _rod_init(params, state, init_sorting_expert_state(
            order.shape[0], dev), (order,))

    def expert(carry, tcp):
        es, delta = sorting_expert_step(carry.es, carry.des, tcp[:, :2],
                                        carry.env.scene.free_pos,
                                        carry.extras[0], half, **kw)
        return es, delta, _boxes_log(carry.env)

    return init, _chunk_fn(_rod_step(params, env, expert), chunk_len,
                           generator, 2)


def make_inserting_runner(params, chunk_len: int = CHUNK, generator=None):
    """init(context, order [B, 3]); logs (des, tcp, free_pos, free_quat)."""
    from d3il_tpu_torch.envs import inserting as env
    depth = PUSH_DEPTH if params.kinematic else PUSH_DEPTH_DYN

    def init(context, order):
        state = env.reset(params, context)
        dev = params.device
        order = torch.as_tensor(order, dtype=torch.int32, device=dev)
        return _rod_init(params, state, init_inserting_expert_state(
            order.shape[0], dev), (order,))

    def expert(carry, tcp):
        es, delta = inserting_expert_step(
            carry.es, carry.des, tcp[:, :2], carry.env.scene.free_pos,
            carry.env.visited, carry.extras[0], push_depth=depth)
        return es, delta, _boxes_log(carry.env)

    return init, _chunk_fn(_rod_step(params, env, expert), chunk_len,
                           generator, 2)


def make_aligning_runner(params, chunk_len: int = CHUNK, generator=None):
    """init(context, mode [B]); the xyz setpoint; logs (des [B, 3], tcp,
    tray pos, tray quat)."""
    from d3il_tpu_torch.envs import aligning as env

    def init(context, mode):
        state = env.reset(params, context)
        dev = params.device
        mode = torch.as_tensor(mode, dtype=torch.int32, device=dev)
        return _rod_init(params, state, init_aligning_expert_state(
            mode.shape[0], dev), (mode,), pos_dim=3)

    def expert(carry, tcp):
        s = carry.env
        es, delta = aligning_expert_step(
            carry.es, carry.des, tcp, s.scene.free_pos[:, 0],
            s.scene.free_quat[:, 0], s.target_pos, s.target_quat,
            carry.extras[0])
        return es, delta, (s.scene.free_pos[:, 0], s.scene.free_quat[:, 0])

    return init, _chunk_fn(_rod_step(params, env, expert), chunk_len,
                           generator, 3)


def make_stacking_runner(params, chunk_len: int = CHUNK, generator=None):
    """init(context, order [B, 3]); joint-space actions with noise on the
    executed q_des; logs (q_des [B, 7], gripper width [B], free_pos,
    free_quat)."""
    from d3il_tpu_torch.envs import stacking as env
    chain = params.ctrl_chain

    def init(context, order):
        state = env.reset(params, context)
        dev = params.device
        order = torch.as_tensor(order, dtype=torch.int32, device=dev)
        B = order.shape[0]
        es = init_stacking_expert_state(state.scene.q[:, :7].clone())
        return EpCarry(state, es, torch.zeros((B, 0), device=dev),
                       torch.zeros(B, dtype=torch.bool, device=dev),
                       (order,), torch.zeros((B, 0), device=dev))

    def step_once(carry, z):
        state, es, done = carry.env, carry.es, carry.done
        tcp_pos, _ = params.tcp_pose(state.scene)
        width_meas = state.scene.q[:, 7] + state.scene.q[:, 8]
        es2, action = stacking_expert_step(
            chain, es, state.scene.free_pos, state.scene.free_quat,
            state.target_xy, carry.extras[0], tcp_pos=tcp_pos,
            width_meas=width_meas)
        # the executed (and logged) joint setpoint carries the noise
        q_noise = torch.where(done[:, None], torch.zeros_like(z),
                              z * STACK_Q_NOISE)
        action = torch.cat([action[:, :7] + q_noise, action[:, 7:]], 1)
        log = (action[:, :7], width_meas) + _boxes_log(state)
        ns, res = env.step(params, state, action)
        return (carry._replace(env=_freeze(done, ns, state),
                               es=_freeze(done, es2, es),
                               done=done | res.done), log, res.done)

    return init, _chunk_fn(step_once, chunk_len, generator, 7)


def run_chunked(chunk, carry, max_steps: int, chunk_len: int = CHUNK,
                noise=None):
    """Advance the carry chunk by chunk until every env is done (or
    max_steps), one host sync per chunk. ``noise`` [T, B, d]: every step's
    unit normals (from the runner's generator unless given). Returns
    (carry, logs [B, T, ...] NumPy, dones [B, T] NumPy)."""
    logs_parts, dones_parts = [], []
    steps = 0
    while steps < max_steps:
        part = None if noise is None else noise[steps:steps + chunk_len]
        carry, logs, dones = chunk(carry, part)
        logs_parts.append(logs)
        dones_parts.append(dones)
        steps += chunk_len
        if bool(dones.any(dim=0).all()):
            break
    logs = tuple(torch.cat(x, dim=0).movedim(0, 1).cpu().numpy()
                 for x in zip(*logs_parts))
    dones = torch.cat(dones_parts, dim=0).movedim(0, 1).cpu().numpy()
    return carry, logs, dones
