"""Scene state, the batched narrow phase and the per-env physics step.

Counterpart of ``d3il_tpu/engine/step.py`` and of
``substep_bm.narrow_phase_bm``. The JAX package runs its colliders per env
under ``vmap``; here they run over the env batch directly, and the batched
physics step is the window in ``engine/substep_bm.py``. ``make_step_fn``
is the per-env API (one env's state, no batch axis): smooth dynamics,
the narrow phase and the contact phase (K3 at a batch of one) and
semi-implicit Euler, built from the batched blocks at B = 1.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from d3il_tpu_torch.engine import collision
from d3il_tpu_torch.engine import contact as contact_mod
from d3il_tpu_torch.engine.model import (BOX, CAPSULE, PLANE, SPHERE,
                                         SceneModel)
from d3il_tpu_torch.ops import linalg as linalg_ops
from d3il_tpu_torch.ops import quat as quat_ops
from d3il_tpu_torch.robot import chain as chain_mod


class SceneState(NamedTuple):
    """Scene state; every field has the env batch first (the per-env API,
    ``make_step_fn``, takes one env's, without it)."""
    q: torch.Tensor            # [B, 9] robot joint positions
    qd: torch.Tensor           # [B, 9]
    free_pos: torch.Tensor     # [B, nf, 3]
    free_quat: torch.Tensor    # [B, nf, 4]
    free_linvel: torch.Tensor  # [B, nf, 3] world frame
    free_angvel: torch.Tensor  # [B, nf, 3] body-local frame
    warm: torch.Tensor         # [B, ncon, 3] contact-force warm start


def init_state(scene: SceneModel, q, free_pos, free_quat) -> SceneState:
    """Zero-velocity state from q [B, nv], free_pos [B, nf, 3],
    free_quat [B, nf, 4]."""
    B = q.shape[0]
    nf = scene.n_free
    z3 = q.new_zeros((B, nf, 3))
    return SceneState(q=q, qd=torch.zeros_like(q), free_pos=free_pos,
                      free_quat=free_quat, free_linvel=z3,
                      free_angvel=z3.clone(),
                      warm=q.new_zeros((B, scene.ncon_max, 3)))


def _geom_world_pose(g, xpos, xquat, free_pos, free_quat):
    """World pose [B, 3] / [B, 4] of a geom (robot-attached, free or static)."""
    gpos = free_pos.new_tensor(np.asarray(g.pos, np.float64))
    gquat = free_pos.new_tensor(np.asarray(g.quat, np.float64))
    B = free_pos.shape[0]
    if g.free_idx >= 0:
        bp, bq = free_pos[:, g.free_idx], free_quat[:, g.free_idx]
    elif g.body >= 0:
        bp, bq = xpos[:, g.body], xquat[:, g.body]
    else:
        return gpos.expand(B, 3), gquat.expand(B, 4)
    return bp + quat_ops.rotate(bq, gpos), quat_ops.mul(bq, gquat.expand(B, 4))


def _pair_contacts(pair, pa, qa, pb, qb):
    ta, tb = pair.geom_a.gtype, pair.geom_b.gtype
    sa = pa.new_tensor(np.asarray(pair.geom_a.size, np.float64))
    sb = pa.new_tensor(np.asarray(pair.geom_b.size, np.float64))

    def plane_normal(q):
        return quat_ops.rotate(q, pa.new_tensor([0.0, 0.0, 1.0]))

    if (ta, tb) == (BOX, PLANE):
        return collision.box_plane(pa, qa, sa[:3], pb, plane_normal(qb))
    if (ta, tb) == (BOX, BOX):
        return collision.box_box(pa, qa, sa[:3], pb, qb, sb[:3])
    if (ta, tb) == (CAPSULE, BOX):
        return collision.capsule_box(pa, qa, sa[0], sa[1], pb, qb, sb[:3])
    if (ta, tb) == (CAPSULE, PLANE):
        return collision.capsule_plane(pa, qa, sa[0], sa[1], pb,
                                       plane_normal(qb))
    if (ta, tb) == (CAPSULE, CAPSULE):
        return collision.capsule_capsule(pa, qa, sa[0], sa[1], pb, qb, sb[0],
                                         sb[1])
    if (ta, tb) == (SPHERE, PLANE):
        return collision.sphere_plane(pa, sa[0], pb, plane_normal(qb))
    if (ta, tb) == (SPHERE, BOX):
        return collision.sphere_box(pa[:, None], sa[0], pb[:, None],
                                    qb[:, None], sb[:3])
    if (ta, tb) == (SPHERE, SPHERE):       # two zero-length capsules
        return collision.capsule_capsule(pa, qa, sa[0], 0.0, pb, qb, sb[0],
                                         0.0)
    raise ValueError(f"unhandled pair {(ta, tb)}")


def narrow_phase(scene: SceneModel, xpos, xquat, free_pos, free_quat):
    """All colliders of the scene's static pair list.

    xpos [B, nb, 3], xquat [B, nb, 4] (robot FK); free_pos [B, nf, 3],
    free_quat [B, nf, 4]. Returns Contacts with pos/normal [B, ncon, 3] and
    depth [B, ncon], pair-major in the order of ``scene.pairs``."""
    out = []
    for pair in scene.pairs:
        pa, qa = _geom_world_pose(pair.geom_a, xpos, xquat, free_pos,
                                  free_quat)
        pb, qb = _geom_world_pose(pair.geom_b, xpos, xquat, free_pos,
                                  free_quat)
        out.append(_pair_contacts(pair, pa, qa, pb, qb))
    return collision._stack(*out)


def _contact_rows(scene: SceneModel, state: SceneState, fk_cache):
    """One env's colliders: (Contacts with pos / normal [ncon, 3] and depth
    [ncon], the ContactPair of each row)."""
    xpos, xquat = fk_cache
    c = narrow_phase(scene, xpos[None], xquat[None], state.free_pos[None],
                     state.free_quat[None])
    metas = [pair for pair in scene.pairs for _ in range(pair.max_points)]
    return collision.Contacts(*(x[0] for x in c)), metas


def make_step_fn(scene: SceneModel, kinematic_robot: bool = False):
    """The per-env step function step(state, ctrl, dyn=None) -> state.

    ``ctrl`` is the robot's torques [nv_r]; with ``kinematic_robot`` the arm
    follows an externally set joint trajectory instead (ctrl = [q, qd],
    [2 nv_r]) and is an infinite-mass collider for the free bodies.
    ``dyn``: optional (fk_cache, M_arm, bias_arm) of
    ``chain.dynamics(robot, q, qd, gravity)`` at the pre-step state, shared
    with the caller's gravity compensation."""
    robot = scene.robot
    nv_r = robot.nv
    nf = scene.n_free
    h = scene.dt
    contact_phase = (contact_mod.make_contact_phase(scene) if scene.pairs
                     else None)

    def step(state: SceneState, ctrl, dyn=None) -> SceneState:
        f64 = lambda a: state.q.new_tensor(np.asarray(a, np.float64))
        g = f64(scene.gravity)
        lo, hi = f64(robot.joint_range[:, 0]), f64(robot.joint_range[:, 1])

        if kinematic_robot:
            state = state._replace(q=ctrl[:nv_r], qd=ctrl[nv_r:2 * nv_r])
            fk_cache = chain_mod.fk(robot, state.q)
            Minv_arm = state.q.new_zeros((nv_r, nv_r))
            a_smooth_arm = state.q.new_zeros(nv_r)
        else:
            if dyn is None:
                dyn = chain_mod.dynamics(robot, state.q, state.qd,
                                         scene.gravity)
            fk_cache, M_arm, bias_arm = dyn
            fr = f64(scene.forcerange)
            tau = torch.minimum(torch.maximum(ctrl, fr[:, 0]), fr[:, 1])
            f_arm = tau - bias_arm
            Minv_arm = linalg_ops.inv_spd(
                M_arm + h * torch.diag(f64(robot.joint_damping)))

        def integrate_arm(qfrc_arm):
            # (M + hD) v' = M v + h (tau - bias + qfrc_con); then the joint
            # range hard stop
            rhs = M_arm @ state.qd + h * (f_arm + qfrc_arm)
            qd_new = Minv_arm @ rhs
            q_new = state.q + h * qd_new
            out = (q_new < lo) | (q_new > hi)
            return (torch.minimum(torch.maximum(q_new, lo), hi),
                    torch.where(out, 0.0, qd_new))

        m_f = f64(scene.free_mass)
        I_f = f64(scene.free_inertia).reshape(nf, 3)
        f_free_ang = -torch.linalg.cross(state.free_angvel,
                                         I_f * state.free_angvel, dim=-1)

        def free_update(fcon_lin, fcon_ang):
            linvel = state.free_linvel + h * (g + fcon_lin)
            angvel = state.free_angvel + h * ((f_free_ang + fcon_ang) / I_f)
            return dict(free_pos=state.free_pos + h * linvel,
                        free_quat=quat_ops.integrate(state.free_quat, angvel,
                                                     h),
                        free_linvel=linvel, free_angvel=angvel)

        if not scene.pairs:
            free = free_update(0.0, 0.0) if nf else {}
            if kinematic_robot:
                return state._replace(**free)
            q_new, qd_new = integrate_arm(0.0)
            return state._replace(q=q_new, qd=qd_new, **free)

        contacts, _ = _contact_rows(scene, state, fk_cache)
        v_all = torch.cat([state.qd, torch.cat(
            [state.free_linvel, state.free_angvel], dim=1).reshape(-1)])
        if not kinematic_robot:
            a_smooth_arm = Minv_arm @ f_arm         # (M + hD)^-1 f
        a_free = torch.cat([g.expand(nf, 3), f_free_ang / I_f],
                           dim=1).reshape(-1)
        axes, anchors = chain_mod._dof_frames(robot, *fk_cache)
        f, qfrc = contact_phase(
            contacts.pos, contacts.normal, contacts.depth, axes, anchors,
            Minv_arm, v_all, torch.cat([a_smooth_arm, a_free]),
            state.free_pos, state.free_quat, state.warm)

        if kinematic_robot:
            q_new, qd_new = state.q, state.qd
        else:
            q_new, qd_new = integrate_arm(qfrc[:nv_r])
        free = {}
        if nf:
            fcon = qfrc[nv_r:].reshape(nf, 6)
            free = free_update(fcon[:, :3] / m_f[:, None], fcon[:, 3:])
        return state._replace(q=q_new, qd=qd_new, warm=f, **free)

    return step
