"""Batched narrow-phase colliders.

Counterpart of ``d3il_tpu/engine/collision.py``, written over a leading env
batch instead of under ``vmap``: poses are ``[B, 3]`` / ``[B, 4]``, a geom's
size is a constant ``[3]`` tensor, and each collider returns a fixed number
of candidate contacts ``pos [B, k, 3]``, ``normal [B, k, 3]``,
``depth [B, k]``. Inactive slots carry depth < 0 and are masked by the
solver. Normals push geom A away from geom B.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ops import quat as quat_ops


class Contacts(NamedTuple):
    pos: torch.Tensor     # [B, k, 3]
    normal: torch.Tensor  # [B, k, 3] unit, pushes A away from B
    depth: torch.Tensor   # [B, k] penetration depth (>0 means touching)


def _stack(*contacts):
    return Contacts(pos=torch.cat([c.pos for c in contacts], dim=-2),
                    normal=torch.cat([c.normal for c in contacts], dim=-2),
                    depth=torch.cat([c.depth for c in contacts], dim=-1))


def _dot(a, b):
    return (a * b).sum(-1)


def _box_corners(like):
    return like.new_tensor([[sx, sy, sz] for sx in (-1.0, 1.0)
                            for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)])


def box_plane(box_pos, box_quat, half_size, plane_pos, plane_normal):
    """Box (A) vs infinite plane (B): the 4 deepest corners."""
    corners = box_pos[:, None] + quat_ops.rotate(
        box_quat[:, None], _box_corners(box_pos) * half_size)      # [B, 8, 3]
    depth = _dot(plane_pos, plane_normal)[..., None] \
        - _dot(corners, plane_normal[:, None])                      # [B, 8]
    idx = torch.sort(-depth, dim=-1, stable=True).indices[:, :4]
    return Contacts(
        pos=torch.gather(corners, 1, idx[..., None].expand(-1, -1, 3)),
        normal=plane_normal[:, None].expand(-1, 4, -1),
        depth=torch.gather(depth, 1, idx))


def sphere_plane(pos, radius, plane_pos, plane_normal):
    """Sphere (A) vs plane: one contact; poses [..., 3]."""
    d = _dot(pos - plane_pos, plane_normal)
    depth = radius - d
    cpos = pos - plane_normal * (d - 0.5 * depth)[..., None]
    return Contacts(pos=cpos[..., None, :], normal=plane_normal[..., None, :],
                    depth=depth[..., None])


def capsule_plane(pos, quat, radius, half_len, plane_pos, plane_normal):
    """Capsule (A) vs plane: 2 contacts, one per core endpoint."""
    axis = quat_ops.rotate(quat, pos.new_tensor([0.0, 0.0, 1.0]))
    ends = torch.stack([pos + half_len * axis, pos - half_len * axis], dim=1)
    d = _dot(ends - plane_pos[:, None], plane_normal[:, None])       # [B, 2]
    depth = radius - d
    cpos = ends - plane_normal[:, None] * (d - 0.5 * depth)[..., None]
    return Contacts(pos=cpos, normal=plane_normal[:, None].expand(-1, 2, -1),
                    depth=depth)


def sphere_box(sp_pos, radius, box_pos, box_quat, half_size):
    """Sphere (A) vs box (B), one contact per sphere; all pose arguments
    share their leading dims ([..., 3] / [..., 4])."""
    p = quat_ops.rotate_inv(box_quat, sp_pos - box_pos)
    c = torch.minimum(torch.maximum(p, -half_size), half_size)
    delta = p - c
    dist_out = torch.linalg.vector_norm(delta, dim=-1)
    inside = dist_out < 1e-9
    face_dist = half_size - p.abs()
    k = torch.argmin(face_dist, dim=-1, keepdim=True)
    pk = torch.gather(p, -1, k)
    onehot = torch.zeros_like(p).scatter_(-1, k, 1.0)
    n_in = onehot * (torch.sign(pk) + (pk == 0).to(p.dtype))
    n_out = delta / dist_out.clamp_min(1e-9)[..., None]
    n_local = torch.where(inside[..., None], n_in, n_out)
    depth = torch.where(inside, radius + torch.gather(face_dist, -1, k)[..., 0],
                        radius - dist_out)
    surf = torch.where(inside[..., None], p, c)
    n_world = quat_ops.rotate(box_quat, n_local)
    cpos = quat_ops.rotate(box_quat, surf) + box_pos - 0.0 * n_world
    return Contacts(pos=cpos, normal=n_world, depth=depth)


def capsule_box(cap_pos, cap_quat, radius, half_len, box_pos, box_quat,
                half_size, iters: int = 4, n_seed: int = 9):
    """Capsule (A) vs box (B): up to 2 contacts.

    The two deepest of ``n_seed`` depth samples along the core segment seed
    a closest-point fixed-point iteration; interior witnesses stay put
    (see the JAX counterpart for why depth seeding matters)."""
    axis_w = quat_ops.rotate(cap_quat, cap_pos.new_tensor([0.0, 0.0, 1.0]))
    p0 = quat_ops.rotate_inv(box_quat, cap_pos - half_len * axis_w - box_pos)
    p1 = quat_ops.rotate_inv(box_quat, cap_pos + half_len * axis_w - box_pos)
    seg = p1 - p0
    seg_len2 = _dot(seg, seg).clamp_min(1e-12)

    def clip_box(x):
        return torch.minimum(torch.maximum(x, -half_size), half_size)

    ts0 = torch.linspace(0.0, 1.0, n_seed, dtype=cap_pos.dtype,
                         device=cap_pos.device)
    pts0 = p0[:, None] + ts0[None, :, None] * seg[:, None]          # [B, n, 3]
    cs0 = clip_box(pts0)
    dist_out = torch.linalg.vector_norm(pts0 - cs0, dim=-1)
    inside = dist_out < 1e-9
    face_dist = (half_size - pts0.abs()).amin(dim=-1)
    score = torch.where(inside, radius + face_dist, radius - dist_out)
    i1 = torch.argmax(score, dim=-1, keepdim=True)
    i2 = torch.argmax(score.scatter(-1, i1, float("-inf")), dim=-1,
                      keepdim=True)
    ts = ts0[torch.cat([i1, i2], dim=-1)]                            # [B, 2]

    for _ in range(iters):
        pts = p0[:, None] + ts[..., None] * seg[:, None]
        cs = clip_box(pts)
        stay = (pts == cs).all(dim=-1)
        t_new = (_dot(cs - p0[:, None], seg[:, None])
                 / seg_len2[:, None]).clamp(0.0, 1.0)
        ts = torch.where(stay, ts, t_new)
    pts = p0[:, None] + ts[..., None] * seg[:, None]
    world = quat_ops.rotate(box_quat[:, None], pts) + box_pos[:, None]
    return sphere_box(world, radius, box_pos[:, None], box_quat[:, None],
                      half_size)


def capsule_capsule(pos_a, quat_a, r_a, hl_a, pos_b, quat_b, r_b, hl_b):
    """Capsule (A) vs capsule (B): one contact at the closest points of the
    core segments (the clamped segment-segment solve). Poses [..., 3] /
    [..., 4]; radii and half-lengths scalars."""
    z = pos_a.new_tensor([0.0, 0.0, 1.0])
    ua, ub = quat_ops.rotate(quat_a, z), quat_ops.rotate(quat_b, z)
    a0, a1 = pos_a - hl_a * ua, pos_a + hl_a * ua
    b0, b1 = pos_b - hl_b * ub, pos_b + hl_b * ub
    d1, d2, r = a1 - a0, b1 - b0, a0 - b0
    a, e, f = _dot(d1, d1), _dot(d2, d2), _dot(d2, r)
    b, c = _dot(d1, d2), _dot(d1, r)
    denom = (a * e - b * b).clamp_min(1e-12)
    s = ((b * f - c * e) / denom).clamp(0.0, 1.0)
    t = ((b * s + f) / e.clamp_min(1e-12)).clamp(0.0, 1.0)
    s = ((b * t - c) / a.clamp_min(1e-12)).clamp(0.0, 1.0)
    pa, pb = a0 + s[..., None] * d1, b0 + t[..., None] * d2
    delta = pa - pb
    dist = torch.linalg.vector_norm(delta, dim=-1)
    n = delta / dist.clamp_min(1e-9)[..., None]
    depth = r_a + r_b - dist
    cpos = pb + n * (r_b - 0.5 * depth)[..., None]
    return Contacts(pos=cpos[..., None, :], normal=n[..., None, :],
                    depth=depth[..., None])


def box_box(pos_a, quat_a, half_a, pos_b, quat_b, half_b):
    """Box A vs box B: face-normal SAT (6 axes) + incident-face clipping,
    4 contacts, inactive slots depth < 0."""
    Ra = quat_ops.to_mat(quat_a)                                     # [B,3,3]
    Rb = quat_ops.to_mat(quat_b)
    d = pos_b - pos_a
    axes = torch.cat([Ra.transpose(-1, -2), Rb.transpose(-1, -2)], dim=-2)
    proj_a = (axes @ Ra).abs() @ half_a
    proj_b = (axes @ Rb).abs() @ half_b
    sep = (axes @ d[..., None])[..., 0].abs() - (proj_a + proj_b)    # [B, 6]

    best = torch.argmax(sep, dim=-1)
    bidx = torch.arange(sep.shape[0], device=sep.device)
    pen = -sep[bidx, best]
    axis = axes[bidx, best]
    axis = axis * torch.sign(_dot(axis, d) + 1e-12)[:, None]

    a_ref = (best < 3)
    a3, a33 = a_ref[:, None], a_ref[:, None, None]
    R_ref = torch.where(a33, Ra, Rb)
    R_inc = torch.where(a33, Rb, Ra)
    p_ref = torch.where(a3, pos_a, pos_b)
    p_inc = torch.where(a3, pos_b, pos_a)
    h_ref = torch.where(a3, half_a, half_b)
    h_inc = torch.where(a3, half_b, half_a)
    n_ref = axis * torch.where(a3, 1.0, -1.0)

    n_local = (R_ref.transpose(-1, -2) @ n_ref[..., None])[..., 0]
    k = torch.argmax(n_local.abs(), dim=-1, keepdim=True)
    sign_k = torch.sign(torch.gather(n_local, -1, k))
    n_inc_local = (R_inc.transpose(-1, -2) @ (-n_ref)[..., None])[..., 0]
    ki = torch.argmax(n_inc_local.abs(), dim=-1, keepdim=True)
    sign_ki = torch.sign(torch.gather(n_inc_local, -1, ki))

    onehot_ki = torch.zeros_like(n_local).scatter_(-1, ki, 1.0)
    u1 = torch.roll(onehot_ki, 1, dims=-1)
    u2 = torch.roll(onehot_ki, 2, dims=-1)
    face_center = sign_ki * onehot_ki * h_inc
    hu1 = _dot(u1, h_inc)[:, None]
    hu2 = _dot(u2, h_inc)[:, None]
    signs = pos_a.new_tensor([[1, 1], [1, -1], [-1, 1], [-1, -1]])
    corners_local = face_center[:, None] + signs @ torch.stack(
        [u1 * hu1, u2 * hu2], dim=1)                                 # [B,4,3]
    corners_w = p_inc[:, None] + corners_local @ R_inc.transpose(-1, -2)

    corners_ref = (corners_w - p_ref[:, None]) @ R_ref
    onehot_k = torch.zeros_like(n_local).scatter_(-1, k, 1.0)
    t1 = torch.roll(onehot_k, 1, dims=-1)
    t2 = torch.roll(onehot_k, 2, dims=-1)
    lim1 = _dot(t1, h_ref)[:, None]
    lim2 = _dot(t2, h_ref)[:, None]
    c1 = torch.minimum(torch.maximum(_dot(corners_ref, t1[:, None]), -lim1),
                       lim1)
    c2 = torch.minimum(torch.maximum(_dot(corners_ref, t2[:, None]), -lim2),
                       lim2)
    ck = _dot(corners_ref, onehot_k[:, None])
    clipped_ref = (c1[..., None] * t1[:, None] + c2[..., None] * t2[:, None]
                   + ck[..., None] * onehot_k[:, None])
    depth = _dot(h_ref, onehot_k)[:, None] - sign_k * ck
    clipped_w = p_ref[:, None] + clipped_ref @ R_ref.transpose(-1, -2)
    n_world = torch.where(a3, -n_ref, n_ref)
    depth = torch.where((pen > 0)[:, None], depth, -torch.ones_like(depth))
    return Contacts(pos=clipped_w, normal=n_world[:, None].expand(-1, 4, -1),
                    depth=depth)
