"""The port's tooling against the JAX package's: ``ops/spline``,
``utils/channel_logger``, ``utils/logging.profile_trace`` and
``tools/render_video_torch.py``.

The channel logger's three cases are ``tests/test_channel_logger.py``'s
(the robot and object channels over a 12-step episode, the interval
downsampling with the trim, the headless plot) on a synthetic episode made
with NumPy from a seed, logged on both sides: the JAX logger recording
inside a jitted scan under ``vmap`` over 3 envs, the port's over a leading
batch axis with its step counter held as a tensor. The video tool's demo
replay is held against the JAX tool's frames (``taskviews`` at 16 x 16).
"""
import importlib.util
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import torch
from scipy.interpolate import make_interp_spline

from d3il_tpu import registry as jregistry
from d3il_tpu.engine import step as jstep
from d3il_tpu.ops import spline as jspline
from d3il_tpu.utils import channel_logger as jcl
from d3il_tpu.vision import taskviews as jviews
from d3il_tpu_torch.engine import step as estep
from d3il_tpu_torch.ops import spline
from d3il_tpu_torch.utils import channel_logger as cl
from d3il_tpu_torch.utils import logging as run_logging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a frame's uint8 value truncates a float that agrees within 1e-5
# (tests/test_torch_vision.py), so a pixel may sit one level apart; the
# share of pixels within one level, as SEG_AGREE there
FRAME_AGREE = 0.998


def test_spline_and_profile_trace(tmp_path):
    """The quintic p2p trajectory against the JAX one (4e-6: the two
    float32 linspace grids of u round apart by up to 2e-6) and scipy's
    degree-5 B-spline with zero end derivatives (2e-6, as
    tests/test_spline.py); the blends and p2p_eval against JAX (1e-6); a
    profile trace written."""
    duration, dt = 0.5, 1e-3
    a = np.array([0.1, -0.3, 1.2], np.float32)
    b = np.array([0.9, 0.4, -0.5], np.float32)
    ours = spline.p2p_trajectory(torch.as_tensor(a), torch.as_tensor(b),
                                 duration, dt).numpy()
    want = np.asarray(jspline.p2p_trajectory(jnp.asarray(a), jnp.asarray(b),
                                             duration, dt))
    np.testing.assert_allclose(ours, want, atol=4e-6, rtol=0)
    t = np.linspace(0, duration, int(duration / dt) + 1)
    for i in range(3):
        bc = [(1, 0.0), (2, 0.0)]
        bs = make_interp_spline(x=[0, duration], y=[a[i], b[i]],
                                bc_type=(bc, bc), k=5)
        np.testing.assert_allclose(ours[:, i], bs(t), atol=2e-6)
    u = torch.linspace(-0.2, 1.2, 29)
    for fn, jfn in ((spline.quintic_blend, jspline.quintic_blend),
                    (spline.quintic_blend_vel, jspline.quintic_blend_vel)):
        np.testing.assert_allclose(fn(u).numpy(),
                                   np.asarray(jfn(jnp.asarray(u.numpy()))),
                                   atol=1e-6, rtol=0)
    for tt in (0.0, 0.3, 1.0, 1.5):
        for x, y in zip(spline.p2p_eval(torch.zeros(1), torch.ones(1), 1.0,
                                        tt),
                        jspline.p2p_eval(jnp.zeros(1), jnp.ones(1), 1.0, tt)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)

    trace_dir = str(tmp_path / "trace")
    with run_logging.profile_trace(trace_dir) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None and any(
        f.endswith(".pt.trace.json") for f in os.listdir(trace_dir))
    with run_logging.profile_trace(None) as prof:
        assert prof is None


def _episode(T, B, ncon, seed=0):
    """B envs' T-step synthetic pushing episodes as NumPy scene fields."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=(T, B) + s).astype(np.float32)
    return dict(q=f(9), qd=f(9), free_pos=f(2, 3), free_quat=f(2, 4),
                free_linvel=f(2, 3), free_angvel=f(2, 3), warm=f(ncon, 3))


def _tcp(s):
    """A stand-in tcp pose of the state, alike on both sides."""
    return s.q[..., :3] * 2.0, s.q[..., 3:7] * 0.5


def test_channel_logger_cases_match_jax(tmp_path):
    T, B = 12, 3
    ep = _episode(T, B, 18)
    names = ["red-box", "green-box"]
    # case 1: the robot and object channels recorded every step
    jchans = jcl.robot_channels(_tcp) + jcl.object_channels(names)
    chans = cl.robot_channels(_tcp) + cl.object_channels(names)
    jstates = jstep.SceneState(**{k: jnp.asarray(v) for k, v in ep.items()})
    j0 = jax.tree.map(lambda x: x[0, 0], jstates)
    jinit, jrecord, jexport = jcl.make_logger(jchans, T, example_state=j0)

    @jax.jit
    def jrun(states):           # states [T, B, ...]
        def one(env_states):
            def body(bufs, inp):
                t, s = inp
                return jrecord(bufs, t, s), None
            bufs, _ = jax.lax.scan(body, jinit(), (jnp.arange(T),
                                                   env_states))
            return bufs
        return jax.vmap(one, in_axes=1)(states)

    jbufs = jrun(jstates)
    states = [estep.SceneState(**{k: torch.as_tensor(v[t])
                                  for k, v in ep.items()}) for t in range(T)]
    init, record, export = cl.make_logger(chans, T, example_state=states[0],
                                          batch_dims=1)
    bufs = init()
    for t, s in enumerate(states):
        bufs = record(bufs, torch.tensor(t), s)
    log = export(bufs, length=T)
    assert set(log) == {"robot", "red-box", "green-box"}
    assert log["robot"]["j_pos"].shape == (B, T, 7)
    assert log["red-box"]["quat"].shape == (B, T, 4)
    for e in range(B):
        jlog = jexport(jax.tree.map(lambda x: x[e], jbufs), length=T)
        for g in jlog:
            for field, arr in jlog[g].items():
                np.testing.assert_array_equal(log[g][field][e], arr,
                                              err_msg=f"{g}.{field} env {e}")

    # case 2: every third step recorded, trimmed to a 7-step episode
    jch = [jcl.Channel("robot.t", lambda s: s.q[0])]
    ch = [cl.Channel("robot.t", lambda s: s.q[0])]
    jinit, jrecord, jexport = jcl.make_logger(jch, 10, interval=3,
                                              example_state=j0)
    p0 = estep.SceneState(*(x[0] for x in states[0]))
    init, record, export = cl.make_logger(ch, 10, interval=3,
                                          example_state=p0)
    jbufs, bufs = jinit(), init()
    for t in range(10):
        q = np.asarray(ep["q"][t, 0]).copy()
        q[0] = t
        jbufs = jrecord(jbufs, jnp.int32(t), j0._replace(q=jnp.asarray(q)))
        bufs = record(bufs, t, p0._replace(q=torch.as_tensor(q)))
    got, want = export(bufs, length=7), jexport(jbufs, length=7)
    np.testing.assert_array_equal(got["robot"]["t"], want["robot"]["t"])
    np.testing.assert_array_equal(got["robot"]["t"], [0.0, 3.0, 6.0])

    # case 3: the headless plot
    path = str(tmp_path / "log.png")
    cl.plot({"robot": {"c_pos": log["robot"]["c_pos"][0]}}, path)
    assert os.path.getsize(path) > 0


def test_render_video_demo_frames_match_jax(tmp_path):
    """The first pushing demo's replay, every second step, 3 frames at
    16 x 16: the port's frames against the JAX tool's (taskviews jitted
    per observation), and a GIF written."""
    spec = importlib.util.spec_from_file_location(
        "render_video_torch", os.path.join(ROOT, "tools",
                                           "render_video_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    data = os.path.join(ROOT, "data")
    frames = tool.demo_frames("pushing", data=data, res=16, every=2,
                              max_frames=3, device="cpu")
    task_dir = os.path.join(data, "pushing")
    with open(os.path.join(task_dir, "train_files.pkl"), "rb") as f:
        fn = pickle.load(f)[0]
    with open(os.path.join(task_dir, "all_data", fn), "rb") as f:
        obs, _ = jregistry.TASKS["pushing"].assemble(pickle.load(f))
    render = jax.jit(jviews.make_render_obs("pushing", res=16))
    want = np.stack([(np.asarray(render(jnp.asarray(obs[t]))[0]) * 255)
                     .astype(np.uint8) for t in range(0, 6, 2)])
    assert frames.shape == want.shape == (3, 16, 16, 3)
    assert frames.dtype == np.uint8
    close = (np.abs(frames.astype(int) - want.astype(int)) <= 1).all(-1)
    assert close.mean() >= FRAME_AGREE, close.mean()
    assert len(np.unique(frames.reshape(-1, 3), axis=0)) > 3   # a scene
    out = str(tmp_path / "demo.gif")
    tool.write_gif(frames, out)
    assert os.path.getsize(out) > 0
