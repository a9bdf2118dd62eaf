"""Scene state and the batched narrow phase (frozen copy of the port's
``engine/step.py`` without its per-env step): the colliders run over the
env batch; the batched physics step is the window in
``engine/substep_bm.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.engine import collision
from benchmark.reference.engine.model import (BOX, CAPSULE, PLANE, SPHERE,
                                         SceneModel)
from benchmark.reference.ops import quat as quat_ops


class SceneState(NamedTuple):
    """Scene state; every field has the env batch first."""
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
