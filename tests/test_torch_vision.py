"""The port's renderer, task views and image encoder against the JAX
package's (d3il_tpu/vision).

The JAX renderer draws one view and is ``vmap``ped over the scenes; the
port draws the batch in one pass. Tolerances: the segmentation agrees on at
least 99.8 % of the pixels (a ray grazing a box edge may land on either
side of it in float32), and RGB and depth agree within 1e-5 on every pixel
whose segmentation agrees; the point clouds within 1e-5. Each task view at
res 32 on B = 3 observations: RGB within 1e-5 on at least 99.8 % of the
pixels of both cameras, the low-dim channel exactly. The encoder, with the
Flax weights (a tree of ``jax.eval_shape`` shapes filled from a seed,
``test_torch_jaxref.flax_params``) carried across by ``convert``: 1e-4 max-scaled at res 96 (a
3 x 3 map under the SpatialSoftmax) on B = 2 asymmetric images, and at res
32, where every stride-2 layer pads asymmetrically (SAME), the ResNet18
trunk's feature map. Every JAX function is compiled once.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import assert_scaled, flax_params

from d3il_tpu.vision import encoder as jencoder
from d3il_tpu.vision import renderer as jR
from d3il_tpu.vision import taskviews as jviews
from d3il_tpu_torch import convert
from d3il_tpu_torch.vision import encoder, renderer as R, taskviews

SEG_AGREE = 0.998


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _scenes(seed, B=3, G=5):
    """B scenes of G boxes of various sizes, yaws and tilts, some
    overlapping, on the table in front of the bp camera."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([0.35, -0.25, 0.0], [0.7, 0.25, 0.08], (B, G, 3))
    axis = rng.normal(size=(B, G, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(-np.pi, np.pi, (B, G, 1))
    quat = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis], -1)
    half = rng.uniform(0.01, 0.06, (B, G, 3))
    color = rng.uniform(0.1, 1.0, (B, G, 3))
    return tuple(x.astype(np.float32) for x in (pos, quat, half, color))


def _jax_views(scenes, cam_pos, cam_quat, fovy, res):
    """The JAX renderer vmapped over the scenes (and the camera poses
    where they vary per scene)."""
    per_cam = np.ndim(cam_pos) == 2
    fn = jax.jit(jax.vmap(
        lambda p, q, h, c, cp, cq: jR.render_rgbds(
            jR.RenderGeom(p, q, h, c), cp, cq, fovy, res),
        in_axes=(0, 0, 0, 0, 0 if per_cam else None, None)))
    out = fn(*map(jnp.asarray, scenes), jnp.asarray(cam_pos, jnp.float32),
             jnp.asarray(cam_quat, jnp.float32))
    return [np.asarray(x) for x in out]


def check_views(got, want, what):
    """Port (rgb, depth, seg) against JAX's: seg agreement, then RGB and
    depth on the agreeing pixels."""
    rgb, depth, seg = (x.numpy() for x in got)
    jrgb, jdepth, jseg = want
    assert rgb.shape == jrgb.shape and seg.dtype == np.int32, what
    same = seg == jseg
    assert same.mean() >= SEG_AGREE, (what, same.mean())
    np.testing.assert_allclose(rgb[same], jrgb[same], atol=1e-5, rtol=0,
                               err_msg=what)
    assert (np.isinf(depth[same]) == np.isinf(jdepth[same])).all(), what
    hit = same & np.isfinite(jdepth)
    np.testing.assert_allclose(depth[hit], jdepth[hit], atol=1e-5, rtol=0,
                               err_msg=what)
    return seg


def test_renderer_matches_jax():
    """Both cameras at res 64 on 3 scenes of 5 boxes: the bp camera (one
    pose for all) and the inhand camera at a pose per scene."""
    scenes = _scenes(0)
    geoms = R.RenderGeom(*map(_t, scenes))
    res = 64
    seg = check_views(
        R.render_rgbds(geoms, R.BP_CAM_POS, R.BP_CAM_QUAT, R.BP_CAM_FOVY,
                       res),
        _jax_views(scenes, jR.BP_CAM_POS, jR.BP_CAM_QUAT, jR.BP_CAM_FOVY,
                   res), "bp")
    # every box of scene 0 and the floor are seen
    assert set(range(6)) <= set(np.unique(seg[0])), np.unique(seg[0])
    ih_pos = np.array([[0.5, 0.0, 0.45], [0.45, -0.1, 0.4],
                       [0.6, 0.1, 0.5]], np.float32)
    check_views(
        R.render_rgbds(geoms, _t(ih_pos), (1.0, 0.0, 0.0, 0.0),
                       R.INHAND_CAM_FOVY, res),
        _jax_views(scenes, ih_pos, [1.0, 0.0, 0.0, 0.0],
                   jR.INHAND_CAM_FOVY, res), "inhand")


def test_coincident_boxes_keep_the_first():
    """Two boxes at one pose, of two colours: every ray that hits them
    gives the lower index and its colour, as the JAX renderer's
    first-index argmin does."""
    pos = np.array([[[0.5, 0.0, 0.03]] * 2], np.float32)
    quat = np.array([[[1.0, 0.0, 0.0, 0.0]] * 2], np.float32)
    half = np.full((1, 2, 3), 0.05, np.float32)
    color = np.array([[[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)
    scenes = (pos, quat, half, color)
    got = R.render_rgbds(R.RenderGeom(*map(_t, scenes)), R.BP_CAM_POS,
                         R.BP_CAM_QUAT, R.BP_CAM_FOVY, 32)
    want = _jax_views(scenes, jR.BP_CAM_POS, jR.BP_CAM_QUAT,
                      jR.BP_CAM_FOVY, 32)
    seg = check_views(got, want, "ties")
    assert (seg == 0).sum() > 10 and not (seg == 1).any()


def test_point_cloud_matches_jax():
    """The bp camera's depth unprojected: 1e-5 (JAX's depth unprojected by
    JAX, the port's by the port; no-hit rays give the camera origin)."""
    scenes = _scenes(1, B=2)
    res = 48
    _, depth, _ = R.render_rgbds(R.RenderGeom(*map(_t, scenes)),
                                 R.BP_CAM_POS, R.BP_CAM_QUAT, R.BP_CAM_FOVY,
                                 res)
    got = R.point_cloud(depth, R.BP_CAM_POS, R.BP_CAM_QUAT,
                        R.BP_CAM_FOVY).numpy()
    cam = jnp.asarray(jR.BP_CAM_POS, jnp.float32), \
        jnp.asarray(jR.BP_CAM_QUAT, jnp.float32)
    want = np.stack([np.asarray(jR.point_cloud(jnp.asarray(d.numpy()), *cam,
                                               jR.BP_CAM_FOVY))
                     for d in depth])
    assert got.shape == (2, res * res, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # a hit lies on a box or the floor: z at or above the table
    assert got[..., 2].min() > -0.019 - 1e-4


def test_camera_rays_layout():
    """xy meshgrid indexing: the first row of pixels looks up (+y of the
    camera), the first column left (-x); directions are unit vectors."""
    o, d = R.camera_rays(torch.zeros(3), torch.tensor([1.0, 0, 0, 0]), 60.0,
                         8)
    jo, jd = jR.camera_rays(jnp.zeros(3), jnp.array([1.0, 0, 0, 0]), 60.0, 8)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    grid = d.reshape(8, 8, 3)
    assert grid[0, 0, 0] < 0 < grid[0, 0, 1] and grid[7, 7, 1] < 0
    np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=-1).numpy(),
                               1.0, atol=1e-6)


def _task_obs(task, seed, B=3):
    """Policy observations of ``task`` from a seed: tcp and boxes on the
    table, yaws as tan in [-1, 1] (aligning: positions and quaternions)."""
    rng = np.random.default_rng(seed)
    xy = lambda n: rng.uniform([0.35, -0.25], [0.65, 0.25], (B, n, 2))
    tan = lambda n: rng.uniform(-1.0, 1.0, (B, n, 1))
    if task == "aligning":
        p = np.concatenate([xy(4), rng.uniform(0.0, 0.15, (B, 4, 1))], 2)
        q = rng.normal(size=(B, 2, 4))
        obs = np.concatenate([p[:, 0], p[:, 1], p[:, 2], q[:, 0], p[:, 3],
                              q[:, 1]], 1)
    else:
        n = {"avoiding": 0, "pushing": 2}[task] if "_" not in task \
            else int(task.split("_")[1])
        boxes = np.concatenate([xy(n), tan(n)], 2).reshape(B, -1)
        obs = np.concatenate([xy(2).reshape(B, 4), boxes], 1)
    return obs.astype(np.float32)


@pytest.mark.parametrize("task", jviews.VISION_TASKS)
def test_task_view_matches_jax(task):
    obs = _task_obs(task, 3)
    res = 32
    bp, ih, low = taskviews.make_render_obs(task, res)(_t(obs))
    jbp, jih, jlow = jax.jit(jax.vmap(jviews.make_render_obs(task, res)))(
        jnp.asarray(obs))
    for got, want, cam in ((bp, jbp, "bp"), (ih, jih, "inhand")):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (3, res, res, 3)
        agree = (np.abs(got - want) <= 1e-5).all(-1)
        assert agree.mean() >= SEG_AGREE, (cam, agree.mean())
        assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_array_equal(low.numpy(), np.asarray(jlow))
    assert low.shape[1] == taskviews.low_dim_size(task) \
        == jviews.low_dim_size(task)


def test_views_show_the_scene():
    """Sorting_2's boxes are seen by the bp camera in their colours, and
    the inhand view moves with the tcp."""
    obs = _task_obs("sorting_2", 4, B=2)
    obs[1] = obs[0]
    obs[1, 2] += 0.05
    bp, ih, _ = taskviews.make_render_obs("sorting_2", 96)(_t(obs))
    red = (bp[..., 0] > 0.5) & (bp[..., 1] < 0.2) & (bp[..., 2] < 0.2)
    blue = (bp[..., 2] > 0.5) & (bp[..., 0] < 0.2)
    assert (red.sum(dim=(1, 2)) > 3).all() and (blue.sum(dim=(1, 2)) > 3).all()
    assert not torch.equal(bp[0], bp[1])      # the rod moved
    assert (ih[0] - ih[1]).abs().sum() > 1.0


# ---- the encoder ------------------------------------------------------------

def _encoder_pair(res, seed=0):
    """A Flax MultiImageObsEncoder and the port's with its weights."""
    jenc = jencoder.MultiImageObsEncoder()
    img = jnp.zeros((1, res, res, 3))
    jp = flax_params(jax.eval_shape(jenc.init, jax.random.PRNGKey(0), img,
                                    img, jnp.zeros((1, 4))), seed)
    sd = {}
    for i, cam in enumerate(("bp.", "ih.")):
        convert._camera_encoder(jp["params"][f"CameraEncoder_{i}"], cam, sd,
                                "cpu")
    enc = encoder.MultiImageObsEncoder(
        generator=torch.Generator().manual_seed(seed))
    enc.load_state_dict(sd)
    return jenc, jp, enc


def _images(seed, B, res):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (B, res, res, 3)).astype(np.float32),
            rng.uniform(0, 1, (B, res, res, 3)).astype(np.float32),
            rng.normal(size=(B, 4)).astype(np.float32))


@pytest.mark.parametrize("res", [96, 32])
def test_encoder_matches_flax(res):
    """With the Flax weights, 1e-4 max-scaled: at res 96 the
    MultiImageObsEncoder (both cameras on a 3 x 3 map under the
    SpatialSoftmax, the low-dim concat); at res 32 the ResNet18 trunk's
    1 x 1 feature map, whose stride-2 layers all pad SAME asymmetrically
    (16 -> 8 -> 4 -> 2 -> 1 after the stem's 32 -> 16)."""
    jenc, jp, enc = _encoder_pair(res)
    bp, ih, low = _images(res, 2, res)
    with torch.no_grad():
        if res == 96:
            want = jax.jit(jenc.apply)(jp, bp, ih, low)
            got = enc(_t(bp), _t(ih), _t(low))
            assert got.shape == (2, 2 * 64 + 4)
        else:
            want = jax.jit(jencoder.ResNet18(32).apply)(
                {"params": jp["params"]["CameraEncoder_0"]["ResNet18_0"]}, bp)
            got = enc.bp.trunk(_t(bp).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            assert got.shape == (2, 1, 1, 256)
    assert_scaled(got.numpy(), np.asarray(want), 1e-4)


def test_same_padding_is_xla_s():
    """SAME pads: the stem on 96 (2, 3), a 3x3/2 conv on 24 (0, 1), the
    1x1/2 shortcut (0, 0), the 3x3/1 convs (1, 1), the pool on 48 (0, 1)."""
    assert encoder._same_pad(96, 7, 2) == (2, 3)
    assert encoder._same_pad(24, 3, 2) == (0, 1)
    assert encoder._same_pad(24, 1, 2) == (0, 0)
    assert encoder._same_pad(12, 3, 1) == (1, 1)
    assert encoder._same_pad(48, 3, 2) == (0, 1)


def test_encoder_init_follows_flax():
    """The port's initial conv weights follow Flax's default kernel law,
    LeCun normal truncated at 2 std (std sqrt(1 / fan_in) within 3 %,
    nothing beyond the cut; the dense form is held to a Flax layer in
    tests/test_torch_agents.py); GroupNorm scale 1, bias 0; the
    SpatialSoftmax conv's bias 0."""
    enc = encoder.MultiImageObsEncoder(
        generator=torch.Generator().manual_seed(0))
    w = enc.bp.trunk.blocks[7].conv1.weight.detach().numpy()   # 3x3, 256
    assert abs(w.std() * np.sqrt(9 * 256) - 1) < 0.03
    assert np.abs(w).max() <= 2 * np.sqrt(1 / (9 * 256)) / 0.8796 + 1e-7
    gn = enc.ih.trunk.blocks[0].gn1
    assert gn.eps == 1e-6 and gn.num_groups == 16
    assert (gn.weight == 1).all() and (gn.bias == 0).all()
    assert (enc.bp.kp.conv.bias == 0).all() and enc.bp.trunk.stem.bias is None
