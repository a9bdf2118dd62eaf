"""Shared helpers for the port's golden tests (no tests here).

The JAX package (``d3il_tpu``) is the reference; the port
(``d3il_tpu_torch``) runs on the CPU through its kernels' plain versions.
Inputs are made with NumPy from a seed and handed to both sides; every
comparison states its tolerance. Each test file builds the JAX task params
at most once (module-scoped fixtures) and keeps batches and windows tiny.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HOLD_QUAT = np.array([0.0, 1.0, 0.0, 0.0])
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn_ranks(script: str, n: int, *args, timeout=300):
    """``python -c script *args`` as n OS processes joined through the
    D3IL_* variables (``parallel/distributed.initialize_from_env``; gloo on
    the CPU, one thread each); returns each rank's last stdout line as
    JSON, in rank order. A worker that fails fails the test with its
    output; none outlives the call."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for pid in range(n):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   D3IL_COORD_ADDR=f"127.0.0.1:{port}",
                   D3IL_NUM_PROCS=str(n), D3IL_PROC_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, *args], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def assert_scaled(a, b, atol, name=""):
    """|a - b| / max(|b|max, 1) <= atol, elementwise (the JAX tests' form)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(np.abs(b).max(), 1.0) if b.size else 1.0
    np.testing.assert_allclose(a / scale, b / scale, atol=atol, rtol=0,
                               err_msg=name)


class EagerRef:
    """Stand-in for a Pallas ref holding a jnp array, so that a TPU kernel's
    body can be run op by op on the CPU: ``ref[i]`` reads, ``ref[...] = x``
    writes. ``pallas_call(interpret=True)`` runs the same body, but hands
    XLA the unrolled scalar graph in one piece, which it takes minutes to
    compile on the CPU; op by op the same arithmetic takes seconds."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        assert idx is Ellipsis
        self.value = value


def run_kernel_body(kernel, inputs, n_out):
    """Run a Pallas kernel body eagerly on jnp inputs; returns its outputs
    as NumPy arrays."""
    import jax.numpy as jnp
    outs = [EagerRef() for _ in range(n_out)]
    kernel(*(EagerRef(jnp.asarray(x)) for x in inputs), *outs)
    return [np.asarray(o.value) for o in outs]


def contexts(seed, batch, red_xy=None):
    """Pushing contexts as NumPy (red_xy, red_quat, green_xy, green_quat),
    drawn from the reference context spaces; yaw quats [cos, 0, 0, sin]."""
    rng = np.random.default_rng(seed)
    red = rng.uniform([0.4, -0.15, -90.0], [0.5, 0.0, 90.0], (batch, 3))
    green = rng.uniform([0.55, -0.15, -90.0], [0.65, 0.0, 90.0], (batch, 3))
    if red_xy is not None:
        red[:, :2] = red_xy

    return tuple(x.astype(np.float32) for x in (
        red[:, :2], _yaw_quat(red[:, 2]), green[:, :2], _yaw_quat(green[:, 2])))


def _yaw_quat(deg):
    h = np.deg2rad(deg) / 2
    return np.stack([np.cos(h), 0 * h, 0 * h, np.sin(h)], -1)


def aligning_contexts(seed, batch):
    """Aligning contexts as NumPy (box_xy, box_quat, target_xy,
    target_quat), drawn from the reference context spaces."""
    rng = np.random.default_rng(seed)
    box = rng.uniform([0.4, -0.25, -90.0], [0.6, -0.1, 90.0], (batch, 3))
    tgt = rng.uniform([0.4, 0.2, -90.0], [0.6, 0.35, 90.0], (batch, 3))
    return tuple(x.astype(np.float32) for x in (
        box[:, :2], _yaw_quat(box[:, 2]), tgt[:, :2], _yaw_quat(tgt[:, 2])))


def sorting_contexts(seed, batch, num_boxes):
    """Sorting contexts as NumPy (xy [B, n, 2], quat [B, n, 4]): a point and
    a yaw in each of the JAX package's 6 spawn regions, permuted per env,
    the first n."""
    from d3il_tpu.envs.sorting import CONTEXT_SPACES
    rng = np.random.default_rng(seed)
    lo, hi = CONTEXT_SPACES[:, :2], CONTEXT_SPACES[:, 2:]
    xy = rng.uniform(lo, hi, (batch, 6, 2))
    deg = rng.uniform(-90.0, 90.0, (batch, 6))
    perm = np.stack([rng.permutation(6)[:num_boxes] for _ in range(batch)])
    rows = np.arange(batch)[:, None]
    return (xy[rows, perm].astype(np.float32),
            _yaw_quat(deg[rows, perm]).astype(np.float32))


def actions(tcp_xy, dxy=(0.0, 0.0)):
    """[B, 7] setpoints: tcp xy + offset, z 0.12, the rod pointing down."""
    B = tcp_xy.shape[0]
    return np.concatenate([np.asarray(tcp_xy) + np.asarray(dxy),
                           np.full((B, 1), 0.12), np.tile(HOLD_QUAT, (B, 1))],
                          axis=1).astype(np.float32)


def xyz_actions(tcp, dxyz=(0.0, 0.0, 0.0)):
    """[B, 7] setpoints: tcp xyz + offset, the rod pointing down."""
    B = tcp.shape[0]
    return np.concatenate([np.asarray(tcp) + np.asarray(dxyz),
                           np.tile(HOLD_QUAT, (B, 1))],
                          axis=1).astype(np.float32)


def port_params(jparams, params_cls, **kw):
    """The port's Params of a rod task at the JAX Params' start posture,
    window, horizon and mode, on the CPU."""
    from d3il_tpu_torch import convert
    return convert.params_from_numpy(
        jparams.q_init, params_cls, device="cpu",
        n_substeps=jparams.n_substeps, max_steps=jparams.max_steps,
        kinematic=jparams.kinematic, **kw)


def check_start_pose(jparams, params):
    """A rod task's start pose in the port is the JAX package's, and the
    start-posture search's offline IK there, cut to 50 iterations as
    tests/test_torch_pushing.py holds it at pushing's pose, agrees to
    1e-5 rad."""
    from d3il_tpu.control import offline_ik as joffline_ik
    from d3il_tpu.robot import panda as jpanda
    from d3il_tpu_torch.control import offline_ik
    from d3il_tpu_torch.robot import panda
    np.testing.assert_array_equal(params.init_ee_pos, jparams.init_ee_pos)
    np.testing.assert_array_equal(params.init_ee_quat, jparams.init_ee_quat)
    a = joffline_ik.solve(jparams.ctrl_chain, jparams.init_ee_pos,
                          jparams.init_ee_quat, q0=jpanda.INIT_QPOS, it_max=50)
    b = offline_ik.solve(params.ctrl_chain, params.init_ee_pos,
                         params.init_ee_quat, q0=panda.INIT_QPOS, it_max=50)
    np.testing.assert_allclose(b, a, atol=1e-5)


def np_tree(x):
    """A JAX pytree as NumPy arrays."""
    import jax
    return jax.tree_util.tree_map(np.asarray, x)


def check_rod_state(js, ps, fields, when, warm_tol=3e-4, qd_tol=3e-4):
    """A rod task's state, port (``convert.state_to_numpy``) against JAX:
    the scene max-scaled to 3e-4 (tests/test_substep_bm.py:60-63; the
    contact forces ``warm`` to ``warm_tol``, the joint velocities ``qd`` to
    ``qd_tol``), the controller's q_virt 1e-4 and old_des_vel 2e-3
    absolute, and ``fields`` of the task's own state exactly."""
    tols = {"warm": warm_tol, "qd": qd_tol}
    for name in ("q", "qd", "free_pos", "free_quat", "free_linvel",
                 "free_angvel", "warm"):
        assert_scaled(ps["scene"][name], getattr(js.scene, name),
                      tols.get(name, 3e-4), f"{when} scene.{name}")
    if "ctrl" in ps:    # stacking's joint controller keeps no IK state
        np.testing.assert_allclose(ps["ctrl"]["q_virt"], js.ctrl.q_virt,
                                   atol=1e-4, err_msg=f"{when} q_virt")
        np.testing.assert_allclose(ps["ctrl"]["old_des_vel"],
                                   js.ctrl.old_des_vel, atol=2e-3,
                                   err_msg=f"{when} old_des_vel")
    for name in fields:
        np.testing.assert_array_equal(ps[name], getattr(js, name),
                                      err_msg=f"{when} {name}")


def jax_pushing_params(n_substeps, kinematic=False):
    from d3il_tpu.envs import pushing as jpushing
    return jpushing.PushingParams(n_substeps=n_substeps, max_steps=50,
                                  kinematic=kinematic)


def port_pushing_params(jparams):
    from d3il_tpu_torch.envs import pushing
    return port_params(jparams, pushing.PushingParams)


def tiny_agents(name, obs_dim=10, act_dim=2, hidden=16, layers=2, seed=0,
                **kw):
    """The same small agent on both sides: the JAX one from a PRNGKey, the
    port's with the JAX weights and scaler carried across by ``convert``.
    The scaler is fitted on random data with spread in every column."""
    import jax
    from d3il_tpu import registry as jregistry
    from d3il_tpu.data.scaler import Scaler as JScaler
    from d3il_tpu_torch import convert, registry
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(32, obs_dim)).astype(np.float32)
    y = (0.005 * rng.normal(size=(32, act_dim))).astype(np.float32)
    jagent, _ = jregistry.make_agent(
        name, jax.random.PRNGKey(seed), obs_dim, act_dim, JScaler.fit(x, y),
        hidden_dim=hidden, num_hidden_layers=layers, **kw)
    agent, _ = registry.make_agent(
        name, torch.Generator().manual_seed(seed), obs_dim, act_dim,
        convert.scaler_from_numpy(jagent.scaler, "cpu"), hidden_dim=hidden,
        num_hidden_layers=layers, **kw)
    agent.params = convert.agent_params_from_numpy(
        name, jax.tree_util.tree_map(np.asarray, jagent.params), "cpu")
    return jagent, agent


def flax_params(shapes, seed):
    """A Flax parameter tree of ``shapes`` (``jax.eval_shape`` of a
    module's init: no XLA compile) filled from a NumPy seed: kernels of
    std 1 / sqrt(fan_in), GroupNorm / LayerNorm scales 1 + N(0, 0.1^2),
    everything else (biases, position embeddings, query tokens) of std
    0.05, so that a misplaced scale or bias shows."""
    import math
    import jax
    rng = np.random.default_rng(seed)

    def one(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        std = 1 / math.sqrt(np.prod(s.shape[:-1])) if name == "kernel" \
            else 0.05
        return (std * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def runner_noise(keys, steps, dim):
    """The unit normals a JAX expert runner draws for its exploration noise,
    [steps, B, dim]: each env's carry key split once per step (``key, kn =
    split(key)``), ``normal(kn, (dim,))``."""
    import jax
    out = []
    for key in keys:
        zs = []
        for _ in range(steps):
            key, kn = jax.random.split(key)
            zs.append(np.asarray(jax.random.normal(kn, (dim,))))
        out.append(np.stack(zs))
    return np.stack(out, axis=1)


def rod_expert_step(params, env_step, expert):
    """One step of a rod task's expert runner, composed here from the
    port's expert step (``expert(carry, tcp) -> (es, delta, extra logs)``),
    its env step and the rollout's ``_freeze``: noisy setpoint clipped to
    +-0.011 m, planar (the carry's fixed z) or xyz."""
    from d3il_tpu_torch.data import experts
    from d3il_tpu_torch.eval.rollout import _freeze
    down = torch.tensor(HOLD_QUAT, dtype=torch.float32)

    def step(carry, z):
        s, done = carry.env, carry.done
        tcp, _ = params.tcp_pose(s.scene)
        es, delta, more = expert(carry, tcp)
        des = torch.where(done[:, None], carry.des, carry.des + torch.clamp(
            delta + z * experts.DES_NOISE, -0.011, 0.011))
        pos = torch.cat([des, carry.fixed_z], 1) if des.shape[1] == 2 \
            else des
        action = torch.cat([pos, down.expand(pos.shape[0], 4)], 1)
        ns, res = env_step(params, s, action)
        return (carry._replace(env=_freeze(done, ns, s),
                               es=_freeze(done, es, carry.es), des=des,
                               done=done | res.done),
                (pos, tcp) + more, res.done)

    return step


def _tensor_leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    return [x for t in tree for x in _tensor_leaves(t)]


def check_chunk_composition(carry0, chunk, step, noise):
    """One chunk of a port runner from ``carry0`` (its env 0 marked done)
    equals ``step`` composed over the chunk's steps, exactly: every carry
    leaf, log and done; env 0's env and expert state stay frozen, the
    others move."""
    done = torch.zeros_like(carry0.done)
    done[0] = True
    carry0 = carry0._replace(done=done)
    carry, logs, dones = chunk(carry0, noise)
    c, mlogs, mdones = carry0, [], []
    for z in noise:
        c, log, d = step(c, z)
        mlogs.append(log)
        mdones.append(d)
    for a, b in zip(_tensor_leaves(carry), _tensor_leaves(c)):
        assert torch.equal(a, b)
    for a, b in zip(logs, [torch.stack(x) for x in zip(*mlogs)]):
        assert torch.equal(a, b)
    assert torch.equal(dones, torch.stack(mdones))
    new, old = (_tensor_leaves((x.env, x.es)) for x in (carry, carry0))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(new, old))
    assert not all(torch.equal(a[1:], b[1:]) for a, b in zip(new, old))
    return carry
