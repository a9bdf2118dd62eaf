"""Action kind ``pushing_expert``: the pushing task's scripted expert, the
traffic of D3IL's demonstration runs (``make_pushing_runner`` of the
program's ``data/experts.py``), in a closed loop.

Each env pushes its two boxes onto the two targets in an order drawn as
the demonstrations draw it (the box nearer the start first, 20 % flipped;
the targets' assignment a coin flip): approach behind the box, then the
line-anchored carried push of the dynamic mode (the box-anchored carrot of
the kinematic mode). The executed setpoint carries the demonstrations'
exploration noise (``noise_m``, unit normals from a generator of the
run's seed) and is clipped to ``clip_m`` a step per axis.

The expert reads the tcp's xy from the observation and the boxes from the
state, as the demonstration runner reads them from the env. A frozen
copy of ``pushing_expert_step`` and ``_route_around`` at commit 03a1e77,
its imports rewritten.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark import traffic
from benchmark.actions.expert_ops import (const, dot, i32, limit_lead, norm,
                                          phase_shares, rows, step_toward)
from benchmark.reference.envs import scenes
from benchmark.reference.robot import chain as chain_mod


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
PUSH_KW_KINEMATIC = dict(push_step=0.006, lead=0.04, app_step=0.01,
                         app_lead=0.03)
PUSH_KW_DYNAMIC = dict(push_step=0.011, lead=0.05, app_step=0.011,
                       app_lead=0.11, strike_depth=-0.06, strike_lead=0.09,
                       strike_radius=0.058, near_r=0.045,
                       block_r=0.095, detour_r=0.13)
# each mode's (first box, second box); the targets in the same order
SEQ_BOX = [[0, 1], [1, 0], [0, 1], [1, 0]]


def _route_around(des_xy, tcp_xy, approach_pt, obstacles, active,
                  block_r: float = 0.075, detour_r: float = 0.11,
                  app_step: float = 0.01, app_lead: float = 0.03,
                  bounds=None):
    """The first active obstacle (obstacles [B, n, 2], active [B, n])
    blocking the straight line to the approach point -> a detour point;
    then the paced, braked approach carrot toward it. ``bounds``: (lo, hi)
    device tensors [2] of the work area (a detour outside flips sides)."""
    v = approach_pt - tcp_xy
    L = norm(v) + 1e-9
    w = v / L[:, None]
    perp = torch.stack([-w[:, 1], w[:, 0]], dim=-1)
    found = torch.zeros_like(L, dtype=torch.bool)
    target = approach_pt
    for j in range(obstacles.shape[1]):
        ob = obstacles[:, j]
        tproj_raw = dot(ob - tcp_xy, v) / (L * L)
        tproj = torch.clamp(tproj_raw, 0, 1)
        closest = tcp_xy + tproj[:, None] * v
        # an obstacle blocks only when it lies ahead along the travel
        blocking = active[:, j] & (tproj_raw > 0) \
            & (norm(closest - ob) < block_r) & (norm(ob - tcp_xy) < L)
        side = torch.where(dot(tcp_xy - ob, perp) >= 0, 1.0, -1.0)
        detour = ob + perp * side[:, None] * detour_r
        if bounds is not None:
            lo, hi = bounds
            outside = ((detour < lo) | (detour > hi)).any(dim=-1)
            detour = torch.where(outside[:, None],
                                 ob - perp * side[:, None] * detour_r, detour)
        use = blocking & ~found
        found = found | blocking
        target = torch.where(use[:, None], detour, target)
    nxt = step_toward(des_xy, target, app_step)
    # approach braking: shrink the lead as the rod closes in
    lead_eff = torch.clamp(0.5 * norm(target - tcp_xy) + 0.025,
                           max=app_lead)
    return limit_lead(nxt, tcp_xy, lead_eff)


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
    b = rows(seq_box, stage)
    tgt = rows(seq_tgt, stage)
    bpos = rows(boxes_xy, b)
    to_tgt = tgt - bpos
    d_tgt = norm(to_tgt)
    u = to_tgt / (d_tgt + 1e-9)[:, None]

    stage_done = d_tgt < PUSH_STOP
    dyn = strike_depth is not None
    app_back = (PUSH_APPROACH + 0.03) if dyn else PUSH_APPROACH
    approach_pt = bpos - u * app_back
    rel = tcp_xy - bpos
    along = dot(rel, u)
    perp = norm(rel - along[:, None] * u)
    if dyn:
        behind = (along > -app_back - 0.045) & (along < -0.038)
        near = behind & (perp < 0.016) & (norm(des_xy - tcp_xy) < 0.045)
    else:
        near = (norm(approach_pt - tcp_xy) < near_r) & (along < -0.05)
    phase = torch.where(stage_done, 0, torch.where(near, 1, st.phase))
    phase = i32(phase)

    # rod out of pushing position: re-approach
    if dyn:
        bad = (phase == 1) & ((along > 0.005) | (perp > 0.08))
    else:
        bad = (phase == 1) & ((along > -0.005) | (perp > 0.05))
    phase = i32(torch.where(bad & ~near, 0, phase))

    # route around every box, the target box included
    others = torch.ones(boxes_xy.shape[:2], dtype=torch.bool, device=dev)
    push_bounds = (const("push_lo", [0.33, -0.42], dev),
                   const("push_hi", [0.76, 0.42], dev)) if dyn else None
    nxt_app = _route_around(des_xy, tcp_xy, approach_pt, boxes_xy, others,
                            block_r=block_r, detour_r=detour_r,
                            app_step=app_step, app_lead=app_lead,
                            bounds=push_bounds)
    if dyn:
        # behind the box but off the push line: pull laterally onto it
        depth_c = torch.clamp(along, -app_back - 0.02, -0.055)
        align_pt = bpos + u * depth_c[:, None]
        nxt_align = limit_lead(step_toward(des_xy, align_pt, app_step),
                               tcp_xy, 0.045)
        nxt_app = torch.where((behind & ~near)[:, None], nxt_align, nxt_app)
    if strike_depth is None:
        # kinematic: the box-anchored carrot at a fixed indent
        push_pt = bpos - u * push_depth
        nxt_push = limit_lead(step_toward(des_xy, push_pt, push_step),
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
    stall = i32(torch.where(count, st.stall + 1, 0))
    stalled = stall > (50 if dyn else 35)
    phase = i32(torch.where(stalled, 0, phase))
    stall = i32(torch.where(stalled, 0, stall))

    nxt = torch.where((phase == 1)[:, None], nxt_push, nxt_app)
    new_stage = st.stage + i32(stage_done)
    delta = torch.where((stage_done | (st.stage >= 2))[:, None],
                        torch.zeros_like(nxt), nxt - des_xy)
    return PushExpertState(
        stage=torch.clamp(new_stage, max=2),
        phase=i32(torch.where(stage_done, 0, phase)), stall=stall,
        prev_d=torch.where(stage_done, 1e3, d_tgt),
        striking=i32(torch.where(stage_done, 0, st.striking)),
        strike_end=st.strike_end), delta


class PushingExpert:
    """The expert of one run: its state, its plan and its noise."""

    def __init__(self, p: dict, params, state, seed: int):
        sc = state.scene
        dev = sc.q.device
        B = sc.q.shape[0]
        self.noise_m, self.clip_m = float(p["noise_m"]), float(p["clip_m"])
        self.kw = dict(PUSH_KW_KINEMATIC if params.kinematic
                       else PUSH_KW_DYNAMIC)
        self.kw["push_depth"] = (PUSH_DEPTH if params.kinematic
                                 else PUSH_DEPTH_DYN)
        gen = traffic.generator(seed, "pushing_expert.plan", dev)
        flip, swap = torch.rand((2, B), generator=gen, device=dev)
        start = torch.as_tensor(scenes.INIT_EE_POS[:2], dtype=torch.float32,
                                device=dev)
        d = norm(sc.free_pos[:, :, :2] - start)            # [B, 2]
        red_first = (d[:, 0] < d[:, 1]) ^ (flip < 0.2)
        swap = swap < 0.5
        mode = torch.where(red_first, torch.where(swap, 2, 0),
                           torch.where(swap, 3, 1))
        t1 = list(scenes.PUSHING_TARGET_1[:2])
        t2 = list(scenes.PUSHING_TARGET_2[:2])
        self.seq_box = torch.tensor(SEQ_BOX, dtype=torch.int32,
                                    device=dev)[mode]
        self.seq_tgt = torch.tensor([[t1, t2], [t2, t1], [t2, t1], [t1, t2]],
                                    dtype=torch.float32, device=dev)[mode]
        # the setpoint starts at the tcp of the reset and keeps its height
        robot = scenes.build_pushing_scene().robot
        tcp0 = chain_mod.fk(robot, sc.q)[0][:, robot.body_index("tcp")]
        self.des = tcp0[:, :2].contiguous()
        self.tail = torch.cat(
            [tcp0[:, 2:3], torch.tensor([0.0, 1.0, 0.0, 0.0], device=dev)
             .expand(B, 4)], dim=1)
        self.es = init_push_expert_state(B, dev)
        self.gen = traffic.generator(seed, "pushing_expert.noise", dev)

    def action(self, state, obs, k: int):
        tcp = obs[:, :2]
        self.es, delta = pushing_expert_step(
            self.es, self.des, tcp, state.scene.free_pos[..., :2],
            self.seq_box, self.seq_tgt, **self.kw)
        z = torch.randn(self.des.shape, generator=self.gen,
                        device=self.des.device)
        self.des = self.des + torch.clamp(delta + z * self.noise_m,
                                          -self.clip_m, self.clip_m)
        return torch.cat([self.des, self.tail], dim=1)

    def summary(self):
        """Device tensors of the expert's phase: the share of envs pushing
        (phase 1) and the share past their first box (stage >= 1)."""
        return {"push": phase_shares(self.es.phase, 2)[1],
                "second_box": (self.es.stage >= 1).float().mean()}


def make(p: dict, env, params, state, seed: int):
    return PushingExpert(p, params, state, seed)
