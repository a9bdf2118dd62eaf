"""Batched camera renderer (ray-primitive rasterizer) on the device.

Counterpart of ``d3il_tpu/vision/renderer.py``: one ray per pixel, a slab
test against each box of the scene, the floor plane, a z-buffer and
Lambert shading, [res, res, 3] float32 in [0, 1] per view. The JAX package
renders one view and is ``vmap``ped; here every function takes a batch of
B scenes ([B, G] boxes) and renders [B, res, res] views in one pass.

The z-buffer runs over the G boxes one at a time ([B, R] depth and winner
index, R = res * res rays) instead of materialising [B, R, G + 1, 3]
normals: at B = 480 on sorting_6 that tensor alone is ~584 MB per camera.
A strictly smaller depth replaces the winner, so ties keep the lower index
(the first-index ``argmin`` over [boxes..., floor] of the JAX renderer),
and only the winning box's normal is computed, by its own slab test, which
gives the values that picking it from all the boxes' normals gives.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from d3il_tpu_torch.ops import quat as quat_ops

# reference cage cam (e.g. pushing.py:30-45): pos [1.05, 0, 1.2], 30deg tilt
BP_CAM_POS = np.array([1.05, 0.0, 1.2])
BP_CAM_QUAT = np.array([0.6830127, 0.1830127, 0.1830127, 0.683012])
BP_CAM_FOVY = 45.0
# inhand cam (panda_rod_invisible.xml 'rgbd': fovy 60); the task views
# place it above the tcp, looking down
INHAND_CAM_FOVY = 60.0


class RenderGeom(NamedTuple):
    """A batch of box sets (capsules are drawn as boxes: the images carry
    the scene's information, not its looks)."""
    pos: torch.Tensor      # [B, G, 3]
    quat: torch.Tensor     # [B, G, 4]
    half: torch.Tensor     # [B, G, 3]
    color: torch.Tensor    # [B, G, 3]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                           else x, dtype=torch.float32, device=device)


def camera_rays(cam_pos, cam_quat, fovy_deg: float, res: int):
    """Ray origins and unit directions of a pinhole camera (MuJoCo
    convention: it looks along -z of its frame, y up). cam_pos [..., 3],
    cam_quat [..., 4] -> origins, dirs [..., res * res, 3], the pixels row
    by row from the top left."""
    dev = cam_pos.device
    half = torch.tan(torch.deg2rad(torch.tensor(float(fovy_deg))) / 2)
    lin = torch.linspace(-half.item(), half.item(), res, device=dev)
    # x right, y down -> flip (jnp.meshgrid's default "xy" indexing)
    u = lin[None, :].expand(res, res)
    v = (-lin)[:, None].expand(res, res)
    dirs_cam = torch.stack([u, v, -torch.ones_like(u)], dim=-1).reshape(-1, 3)
    dirs = quat_ops.rotate(cam_quat[..., None, :], dirs_cam)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return torch.broadcast_tensors(cam_pos[..., None, :], dirs)


def _slab(o, d, pos, quat, half):
    """Slab test of rays o, d [B, R, 3] against one box per ray batch (pos,
    half [B, 1 or R, 3], quat [B, 1 or R, 4]) in the box's frame -> (t [B,
    R], inf where missed; tmin [B, R, 3]; the local direction dl)."""
    ol = quat_ops.rotate_inv(quat, o - pos)
    dl = quat_ops.rotate_inv(quat, d)
    inv = 1.0 / torch.where(dl.abs() < 1e-9, torch.sign(dl) * 1e-9 + 1e-12,
                            dl)
    t1 = (-half - ol) * inv
    t2 = (half - ol) * inv
    tmin = torch.minimum(t1, t2)
    t_near = tmin.amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    hit = (t_near < t_far) & (t_far > 0)
    return torch.where(hit, t_near.clamp_min(0.0), math.inf), tmin, dl


def _box_normal(o, d, pos, quat, half):
    """World normal of the entering slab (the first-index argmax of tmin)
    of each ray's box: [B, R, 3]."""
    _, tmin, dl = _slab(o, d, pos, quat, half)
    axis = tmin.argmax(dim=-1, keepdim=True)
    sign = -torch.sign(torch.gather(dl, -1, axis))
    n_local = F.one_hot(axis[..., 0], 3).to(dl.dtype) * sign
    return quat_ops.rotate(quat, n_local)


def _gather_rows(x, idx):
    """x [B, G, k] picked per ray by idx [B, R] -> [B, R, k]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def render_rgbds(geoms: RenderGeom, cam_pos, cam_quat, fovy: float,
                 res: int = 96, light_dir=(-0.3, 0.3, -0.9),
                 bg=(0.26, 0.58, 0.51), floor_z: float = -0.019,
                 floor_color=(0.8, 0.655, 0.45)):
    """Render one camera view of each of the B scenes with all channels:
    (rgb [B, res, res, 3] in [0, 1], depth [B, res, res] ray distance in
    meters (inf where no hit), seg [B, res, res] int32 geom index, G = the
    floor, -1 = background). cam_pos [3] or [B, 3], cam_quat [4] or
    [B, 4]."""
    dev = geoms.pos.device
    B, G = geoms.pos.shape[:2]
    o, d = camera_rays(_f32(cam_pos, dev), _f32(cam_quat, dev), fovy, res)
    if o.ndim == 2:
        o, d = o[None], d[None]
    R = o.shape[1]

    # floor plane z = floor_z, index G
    denom = d[..., 2]
    t_floor = (floor_z - o[..., 2]) / torch.where(denom.abs() < 1e-9,
                                                  -1e-9, denom)
    t_floor = torch.where(t_floor > 0, t_floor, math.inf).expand(B, R)
    best_t = torch.full((B, R), math.inf, device=dev)
    best = torch.zeros((B, R), dtype=torch.int64, device=dev)
    for g in range(G):
        t, _, _ = _slab(o, d, geoms.pos[:, g, None], geoms.quat[:, g, None],
                        geoms.half[:, g, None])
        nearer = t < best_t
        best_t = torch.where(nearer, t, best_t)
        best = torch.where(nearer, g, best)
    nearer = t_floor < best_t
    best_t = torch.where(nearer, t_floor, best_t)
    best = torch.where(nearer, G, best)
    hit = torch.isfinite(best_t)

    box = best.clamp(max=G - 1)
    n_box = _box_normal(o, d, _gather_rows(geoms.pos, box),
                        _gather_rows(geoms.quat, box),
                        _gather_rows(geoms.half, box))
    n_best = torch.where((best == G)[..., None],
                         torch.tensor([0.0, 0.0, 1.0], device=dev), n_box)
    colors = torch.cat([geoms.color,
                        _f32(floor_color, dev).expand(B, 1, 3)], dim=1)
    c_best = _gather_rows(colors, best)

    ld = _f32(light_dir, dev)
    ld = ld / torch.linalg.vector_norm(ld)
    lam = torch.clamp(-(n_best * ld).sum(dim=-1), 0.0, 1.0)
    img = c_best * (0.55 + 0.45 * lam)[..., None]
    img = torch.where(hit[..., None], img, _f32(bg, dev))
    seg = torch.where(hit, best, -1).to(torch.int32)
    return (img.reshape(B, res, res, 3), best_t.reshape(B, res, res),
            seg.reshape(B, res, res))


def render(geoms: RenderGeom, cam_pos, cam_quat, fovy: float, res: int = 96,
           **kw):
    """RGB-only views -> [B, res, res, 3] float32 in [0, 1]."""
    rgb, _, _ = render_rgbds(geoms, cam_pos, cam_quat, fovy, res, **kw)
    return rgb


def point_cloud(depth, cam_pos, cam_quat, fovy: float):
    """Depth images [B, res, res] -> world-frame point clouds
    [B, res * res, 3], each point along its camera ray (0 along the ray
    where nothing was hit)."""
    B, res = depth.shape[0], depth.shape[1]
    dev = depth.device
    o, d = camera_rays(_f32(cam_pos, dev), _f32(cam_quat, dev), fovy, res)
    t = depth.reshape(B, -1, 1)
    return o + torch.where(torch.isfinite(t), t, 0.0) * d


def _batched(x, B: int, device) -> torch.Tensor:
    """[n, k] scene constants (or a tensor already [B, n, k]) ->
    [B, n, k] float32."""
    x = _f32(x, device)
    return x.expand(B, *x.shape) if x.ndim == 2 else x


def scene_geoms(free_pos, free_quat, free_half, free_colors,
                static_pos, static_quat, static_half, static_colors,
                rod_pos=None, rod_quat=None) -> RenderGeom:
    """Assemble the B scenes' boxes [free bodies, statics, the rod] from
    env state (free_pos [B, F, 3], free_quat [B, F, 4]) and scene constants
    ([n, k], or [B, n, k] where they vary per env). The rod (rod_pos
    [B, 3], rod_quat [4] or [B, 4]) is drawn as a thin box."""
    B, dev = free_pos.shape[0], free_pos.device
    parts = [[free_pos, free_quat, _batched(free_half, B, dev),
              _batched(free_colors, B, dev)],
             [_batched(x, B, dev) for x in (static_pos, static_quat,
                                            static_half, static_colors)]]
    if rod_pos is not None:
        rq = _f32(rod_quat, dev)
        parts.append([rod_pos[:, None], rq.expand(B, 4)[:, None],
                      _f32([[0.01, 0.01, 0.14]], dev).expand(B, 1, 3),
                      _f32([[0.8, 0.8, 0.85]], dev).expand(B, 1, 3)])
    return RenderGeom(*(torch.cat(xs, dim=1) for xs in zip(*parts)))
