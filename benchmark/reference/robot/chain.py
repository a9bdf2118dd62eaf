"""Fixed-topology articulated chains: the host-side builder and torch FK.

Counterpart of ``d3il_tpu/robot/chain.py``. ``Chain`` and ``ChainBuilder``
are host NumPy (a copy of the JAX package's builder, so both packages build
bit-identical constant arrays); ``fk``, ``_dof_frames``,
``point_jacobian``, ``point_jacobian_batch``, ``dynamics`` and the
dynamics terms built on it (``mass_matrix``, ``bias_forces``,
``gravity_forces``, ``coriolis_forces``) run on torch tensors with any
leading batch shape. ``dynamics`` is the JAX package's form (the body
Jacobians and their time derivatives), which the per-env step uses; the
batched window's dynamics (RNEA, CRBA) live in ``engine/dyn_scalar.py``
and its CUDA kernels.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.ops import quat as quat_ops

# joint types
FIXED, HINGE, SLIDE = 0, 1, 2


@dataclass(frozen=True, eq=False)
class Chain:
    """Static description of a single serial/tree chain (host NumPy)."""

    names: tuple
    parent: np.ndarray        # [nb] int, -1 for root's parent (world)
    joint_type: np.ndarray    # [nb] int in {FIXED, HINGE, SLIDE}
    joint_axis: np.ndarray    # [nb, 3]
    joint_pos: np.ndarray     # [nb, 3] anchor in body frame
    body_pos: np.ndarray      # [nb, 3] frame offset from parent
    body_quat: np.ndarray     # [nb, 4] wxyz
    mass: np.ndarray          # [nb]
    com: np.ndarray           # [nb, 3] in body frame
    inertia: np.ndarray       # [nb, 3, 3] about com, body frame
    dof_body: np.ndarray      # [nv] body index of each dof
    body_dof: np.ndarray      # [nb] dof index of body's joint, -1 if fixed
    ancestor_mask: np.ndarray  # [nb, nv] 1.0 if dof j is on path to body i
    joint_damping: np.ndarray  # [nv]
    joint_range: np.ndarray    # [nv, 2]

    @property
    def nb(self) -> int:
        return len(self.names)

    @property
    def nv(self) -> int:
        return len(self.dof_body)

    def body_index(self, name: str) -> int:
        return self.names.index(name)


def _rpy_to_quat(rpy):
    r, p, y = rpy
    cr, sr = math.cos(r / 2), math.sin(r / 2)
    cp, sp = math.cos(p / 2), math.sin(p / 2)
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    return np.array([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ])


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class ChainBuilder:
    """Imperative builder for Chain topologies."""

    def __init__(self):
        self._bodies = []

    def add_body(self, name, parent, pos=(0, 0, 0), quat=(1, 0, 0, 0),
                 joint_type=FIXED, joint_axis=(0, 0, 1), joint_pos=(0, 0, 0),
                 mass=0.0, com=(0, 0, 0), inertia=None, damping=0.0,
                 joint_range=(-1e9, 1e9)):
        if inertia is None:
            inertia = np.zeros((3, 3))
        self._bodies.append(dict(
            name=name, parent=parent, pos=np.asarray(pos, np.float64),
            quat=np.asarray(quat, np.float64), joint_type=joint_type,
            joint_axis=np.asarray(joint_axis, np.float64),
            joint_pos=np.asarray(joint_pos, np.float64),
            mass=float(mass), com=np.asarray(com, np.float64),
            inertia=np.asarray(inertia, np.float64), damping=float(damping),
            joint_range=np.asarray(joint_range, np.float64)))
        return self

    def build(self) -> Chain:
        names = tuple(b["name"] for b in self._bodies)
        idx = {n: i for i, n in enumerate(names)}
        nb = len(names)
        parent = np.array([idx[b["parent"]] if b["parent"] is not None else -1
                           for b in self._bodies], np.int32)
        joint_type = np.array([b["joint_type"] for b in self._bodies], np.int32)
        dof_body, body_dof = [], np.full(nb, -1, np.int32)
        damping, jrange = [], []
        for i, b in enumerate(self._bodies):
            if b["joint_type"] != FIXED:
                body_dof[i] = len(dof_body)
                dof_body.append(i)
                damping.append(b["damping"])
                jrange.append(b["joint_range"])
        nv = len(dof_body)
        ancestor = np.zeros((nb, nv), np.float64)
        for i in range(nb):
            j = i
            while j >= 0:
                if body_dof[j] >= 0:
                    ancestor[i, body_dof[j]] = 1.0
                j = parent[j]
        return Chain(
            names=names, parent=parent, joint_type=joint_type,
            joint_axis=np.stack([b["joint_axis"] for b in self._bodies]),
            joint_pos=np.stack([b["joint_pos"] for b in self._bodies]),
            body_pos=np.stack([b["pos"] for b in self._bodies]),
            body_quat=np.stack([b["quat"] for b in self._bodies]),
            mass=np.array([b["mass"] for b in self._bodies]),
            com=np.stack([b["com"] for b in self._bodies]),
            inertia=np.stack([b["inertia"] for b in self._bodies]),
            dof_body=np.array(dof_body, np.int32), body_dof=body_dof,
            ancestor_mask=ancestor,
            joint_damping=np.array(damping, np.float64),
            joint_range=np.stack(jrange) if jrange else np.zeros((0, 2)),
        )


# ---------------------------------------------------------------------------
# Kinematics on torch tensors ([..., nv] joint vectors)
# ---------------------------------------------------------------------------

def _const(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), dtype=like.dtype,
                           device=like.device)


def fk(chain: Chain, q: torch.Tensor):
    """Forward kinematics: q [..., nv] -> (xpos [..., nb, 3], xquat [..., nb, 4]).

    MuJoCo frame semantics: child frame offset (body_pos, body_quat) from
    the parent, then the joint transform about ``joint_pos`` (hinge) or
    along ``joint_axis`` (slide). Composed parent to child in body order."""
    bq = _const(chain.body_quat, q)
    bp = _const(chain.body_pos, q)
    axis = _const(chain.joint_axis, q)
    anchor = _const(chain.joint_pos, q)
    is_hinge = _const(chain.joint_type == HINGE, q)[:, None]
    is_slide = _const(chain.joint_type == SLIDE, q)[:, None]
    qdof = q[..., np.maximum(chain.body_dof, 0)][..., None]    # [..., nb, 1]

    theta = (is_hinge * qdof)[..., 0]
    jq = quat_ops.from_axis_angle(axis, theta)
    lq = quat_ops.mul(bq, jq)
    lp = (bp + quat_ops.rotate(bq, anchor) - quat_ops.rotate(lq, anchor)
          + quat_ops.rotate(bq, axis) * (is_slide * qdof))
    xq, xp = [], []
    for b in range(chain.nb):
        p = int(chain.parent[b])
        if p < 0:
            xq.append(lq[..., b, :])
            xp.append(lp[..., b, :])
        else:
            xq.append(quat_ops.mul(xq[p], lq[..., b, :]))
            xp.append(xp[p] + quat_ops.rotate(xq[p], lp[..., b, :]))
    return torch.stack(xp, dim=-2), torch.stack(xq, dim=-2)


def _dof_frames(chain: Chain, xpos, xquat):
    """World-frame axis and anchor of every dof: ([..., nv, 3], [..., nv, 3])."""
    bi = chain.dof_body
    qb, pb = xquat[..., bi, :], xpos[..., bi, :]
    axes = quat_ops.rotate(qb, _const(chain.joint_axis[bi], xpos))
    anchors = pb + quat_ops.rotate(qb, _const(chain.joint_pos[bi], xpos))
    return axes, anchors


def point_jacobian(chain: Chain, q: torch.Tensor, body: int, offset=None,
                   fk_cache=None):
    """[..., 6, nv] geometric Jacobian [linear; angular] of a point on
    ``body`` (offset in the body frame, default the frame origin)."""
    xpos, xquat = fk(chain, q) if fk_cache is None else fk_cache
    point = xpos[..., body, :]
    if offset is not None:
        point = point + quat_ops.rotate(xquat[..., body, :],
                                        _const(offset, xpos))
    axes, anchors = _dof_frames(chain, xpos, xquat)
    mask = _const(chain.ancestor_mask[body], q)[:, None]            # [nv, 1]
    is_hinge = _const(chain.joint_type[chain.dof_body] == HINGE, q)[:, None]
    jp_h = quat_ops.cross(axes, point[..., None, :] - anchors)
    jp = mask * (is_hinge * jp_h + (1 - is_hinge) * axes)
    jr = mask * is_hinge * axes
    return torch.cat([jp.transpose(-1, -2), jr.transpose(-1, -2)], dim=-2)


def point_jacobian_batch(chain: Chain, q: torch.Tensor, body_idx, points,
                         fk_cache):
    """Geometric Jacobians of a batch of world points, each on its own
    body: ``body_idx`` [..., n] (integer), ``points`` [..., n, 3] in world
    coordinates, ``fk_cache`` = ``fk(chain, q)``. Returns (Jp [..., n, 3, nv],
    Jr [..., n, 3, nv])."""
    xpos, xquat = fk_cache
    axes, anchors = _dof_frames(chain, xpos, xquat)                # [..,nv,3]
    idx = torch.as_tensor(body_idx, dtype=torch.long, device=q.device)
    mask = _const(chain.ancestor_mask, q)[idx][..., None]         # [..,n,nv,1]
    is_hinge = _const(chain.joint_type[chain.dof_body] == HINGE, q)[:, None]
    ax = axes[..., None, :, :]
    jp_h = quat_ops.cross(ax, points[..., :, None, :]
                          - anchors[..., None, :, :])             # [..,n,nv,3]
    jp = mask * (is_hinge * jp_h + (1 - is_hinge) * ax)
    jr = mask * is_hinge * ax
    return jp.transpose(-1, -2), jr.transpose(-1, -2)


def _body_jacobians(chain: Chain, q: torch.Tensor, qd: torch.Tensor):
    """COM Jacobians of all bodies, Jp and Jr [..., nb, nv, 3] (one row of
    each per dof), their time derivatives along qd, and the FK."""
    xpos, xquat = fk(chain, q)
    coms = xpos + quat_ops.rotate(xquat, _const(chain.com, q))
    axes, anchors = _dof_frames(chain, xpos, xquat)                # [..,nv,3]
    anc = _const(chain.ancestor_mask, q)
    mask = anc[..., None]                                          # [nb,nv,1]
    is_hinge = _const(chain.joint_type[chain.dof_body] == HINGE, q)[:, None]
    ax = axes[..., None, :, :]
    arm = coms[..., :, None, :] - anchors[..., None, :, :]         # [..,nb,nv,3]
    jp = mask * (is_hinge * quat_ops.cross(ax, arm) + (1 - is_hinge) * ax)
    jr = mask * is_hinge * ax
    # d/dt: an axis turns with its body, a_j' = w_body(j) x a_j; an anchor
    # moves with its body's point velocity; a COM with Jp qd
    along = lambda J: torch.einsum("...bkc,...k->...bc", J, qd)
    w, vc = along(jr), along(jp)                                   # [..,nb,3]
    a_dot = quat_ops.cross(w[..., chain.dof_body, :], axes)       # [..,nv,3]
    dd = anchors[..., :, None, :] - anchors[..., None, :, :]       # [..,nv,nv,3]
    j_anchor = anc[chain.dof_body][..., None] * (
        is_hinge * quat_ops.cross(ax, dd) + (1 - is_hinge) * ax)
    p_dot = along(j_anchor)                                        # [..,nv,3]
    ad = a_dot[..., None, :, :]
    djp = mask * (is_hinge * (quat_ops.cross(ad, arm) + quat_ops.cross(
        ax, vc[..., :, None, :] - p_dot[..., None, :, :]))
        + (1 - is_hinge) * ad)
    djr = mask * is_hinge * ad
    return (jp, jr), (djp, djr), (w, xpos, xquat)


def dynamics(chain: Chain, q: torch.Tensor, qd: torch.Tensor,
             gravity=(0.0, 0.0, -9.81)):
    """FK, mass matrix and bias forces from the body Jacobians and their
    time derivatives along qd: ((xpos [..., nb, 3], xquat [..., nb, 4]),
    M [..., nv, nv], bias [..., nv]) with bias = C(q, qd) qd + g(q),
    MuJoCo's qfrc_bias."""
    (jp, jr), (djp, djr), (w, xpos, xquat) = _body_jacobians(chain, q, qd)
    g = _const(gravity, q)
    m = _const(chain.mass, q)
    R = quat_ops.to_mat(xquat)
    Iw = R @ _const(chain.inertia, q) @ R.transpose(-1, -2)        # [..,nb,3,3]
    M = (torch.einsum("...bkc,b,...blc->...kl", jp, m, jp)
         + torch.einsum("...bkc,...bcd,...bld->...kl", jr, Iw, jr))
    along = lambda J: torch.einsum("...bkc,...k->...bc", J, qd)
    f_lin = m[:, None] * (along(djp) - g)
    Iw_v = lambda v: (Iw @ v[..., None])[..., 0]
    f_ang = Iw_v(along(djr)) + quat_ops.cross(w, Iw_v(w))
    return (xpos, xquat), M, (torch.einsum("...bkc,...bc->...k", jp, f_lin)
                              + torch.einsum("...bkc,...bc->...k", jr, f_ang))


def mass_matrix(chain: Chain, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrix M(q) [..., nv, nv] (CRBA's result)."""
    return dynamics(chain, q, torch.zeros_like(q))[1]


def bias_forces(chain: Chain, q: torch.Tensor, qd: torch.Tensor,
                gravity=(0.0, 0.0, -9.81)) -> torch.Tensor:
    """C(q, qd) qd + g(q) [..., nv], with the sign of MuJoCo's qfrc_bias and
    pinocchio's rnea(q, v, 0): the generalized force that holds the chain
    at zero acceleration."""
    return dynamics(chain, q, qd, gravity)[2]


def gravity_forces(chain: Chain, q: torch.Tensor,
                   gravity=(0.0, 0.0, -9.81)) -> torch.Tensor:
    """g(q) [..., nv]: the generalized gravity compensation torques."""
    return bias_forces(chain, q, torch.zeros_like(q), gravity)


def coriolis_forces(chain: Chain, q: torch.Tensor,
                    qd: torch.Tensor) -> torch.Tensor:
    """C(q, qd) qd [..., nv] without gravity: the bias forces with gravity
    off (with qd = 0 every velocity term vanishes, so nothing is left to
    subtract)."""
    return bias_forces(chain, q, qd, gravity=(0.0, 0.0, 0.0))
