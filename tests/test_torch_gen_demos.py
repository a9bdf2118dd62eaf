"""The port's demo pipeline (``d3il_tpu_torch/data/gen_demos.py``) against
``tools/gen_demos.py``: the same mode and order choices from the same
contexts, and the same pickles and split files from the same rollout.

The JAX pipeline runs through its ``main`` with its runners, its
``run_chunked`` and its task's Params replaced by fakes: the fakes capture
the contexts and the orders or modes the JAX code built, and hand back
seeded NumPy logs, dones and a final state (some episodes failed, some
done early). No env is built or compiled on either side. The port's
choose-and-write half then takes the same contexts, logs and state.
"""
import importlib
import importlib.util
import os
import pickle
import sys
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import jax
import pytest

from d3il_tpu.data import experts_jax as jex
from d3il_tpu_torch.data import gen_demos as gd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, SEED = 12, 7, 3
TASKS = ["avoiding", "pushing", "aligning", "sorting_2", "sorting_4",
         "stacking", "inserting"]
ENV_PARAMS = {"avoiding": ("avoiding", "AvoidingParams"),
              "pushing": ("pushing", "PushingParams"),
              "aligning": ("aligning", "AligningParams"),
              "sorting": ("sorting", "SortingParams"),
              "stacking": ("stacking", "StackingParams"),
              "inserting": ("inserting", "InsertingParams")}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_demos", os.path.join(ROOT, "tools", "gen_demos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FakeCarry(NamedTuple):
    env: object


def fake_rollout(task, rng):
    """Logs [N, T, ...], dones [N, T] and a final state for ``task``."""
    f = lambda *s: rng.normal(size=(N, T) + s).astype(np.float32)
    nb = int(task.split("_")[1]) if task.startswith("sorting") else 3
    if task == "avoiding":
        logs = (f(3), f(3))
    elif task == "aligning":
        logs = (f(3), f(3), f(3), f(4))
    elif task == "stacking":
        logs = (f(7), f(), f(3, 3), f(3, 4))
    else:
        nb = 2 if task == "pushing" else nb
        logs = (f(3), f(3), f(nb, 3), f(nb, 4))
    dones = np.zeros((N, T), bool)
    ends = rng.integers(2, T + 3, N)             # > T: never done
    for i, e in enumerate(ends):
        dones[i, min(e, T - 1):] = e < T
    state = SimpleNamespace(success=rng.random(N) < 0.7)
    if task == "avoiding":
        state.mode_encoding = (rng.random((N, 9)) < 0.5).astype(np.float32)
    elif task.startswith("sorting"):
        state.mode = rng.integers(-1, 2, (N, 6)).astype(np.int32)
    elif task == "aligning":
        state.target_pos = rng.normal(size=(N, 3)).astype(np.float32)
        state.target_quat = rng.normal(size=(N, 4)).astype(np.float32)
    elif task == "stacking":
        state.mode = rng.integers(-1, 3, (N, 3)).astype(np.int32)
        state.mode_len = (state.mode >= 0).sum(1).astype(np.int32)
    elif task == "inserting":
        state.order = np.stack([rng.permutation(3) for _ in range(N)]) \
            .astype(np.int32)
        state.n_visited = rng.integers(0, 4, N).astype(np.int32)
    return logs, dones, state


def run_jax_pipeline(monkeypatch, task, out):
    """tools/gen_demos.py main() on fakes; returns what it captured."""
    jtool = _jax_tool()
    logs, dones, state = fake_rollout(task, np.random.default_rng(5))
    got = {}
    planar = task not in ("aligning", "stacking")

    def make_runner(params, chunk_len=jex.CHUNK):
        def init(*args):
            got["init_args"] = args
            carry = FakeCarry(env=None)
            return (carry, np.zeros((N, 1), np.float32)) if planar else carry

        def chunk(cw):
            raise AssertionError("the fake rollout runs no chunk")
        init.fake = chunk.fake = True
        return init, chunk

    def run_chunked(chunk_v, cw, max_steps, chunk_len=jex.CHUNK):
        got["extras"] = cw[1]
        return (FakeCarry(env=state), cw[1]), logs, dones

    real_jit, real_vmap = jax.jit, jax.vmap
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f if getattr(
        f, "fake", False) else real_jit(f, *a, **k))
    monkeypatch.setattr(jax, "vmap", lambda f, *a, **k: f if getattr(
        f, "fake", False) else real_vmap(f, *a, **k))
    kind = task.split("_")[0]
    monkeypatch.setattr(jex, f"make_{kind}_runner", make_runner)
    monkeypatch.setattr(jex, "run_chunked", run_chunked)
    mod, cls = ENV_PARAMS[kind]
    monkeypatch.setattr(importlib.import_module(f"d3il_tpu.envs.{mod}"), cls,
                        lambda *a, **k: SimpleNamespace(max_steps=T))
    monkeypatch.setattr(sys, "argv", [
        "gen_demos.py", "--task", task, "--n", str(N), "--out", str(out),
        "--seed", str(SEED)])
    jtool.main()
    monkeypatch.undo()
    return got, logs, dones, state


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same_episode(a, b, name):
    assert set(a) == set(b), name
    assert type(a["mode"]) is type(b["mode"]), name
    np.testing.assert_array_equal(np.asarray(a["mode"]),
                                  np.asarray(b["mode"]), err_msg=name)
    for ch in a:
        if ch == "mode":
            continue
        assert set(a[ch]) == set(b[ch]), (name, ch)
        for k in a[ch]:
            assert a[ch][k].dtype == b[ch][k].dtype == np.float32
            np.testing.assert_array_equal(a[ch][k], b[ch][k],
                                          err_msg=f"{name} {ch} {k}")


def _contexts(task, got):
    if task == "avoiding":
        return ()
    return tuple(np.asarray(c) for c in got["init_args"][0])


def _captured_extras(task, got):
    """What the JAX pipeline handed its runner, in plan()'s order."""
    ex = got["extras"]
    if task == "pushing":
        return ex[0], ex[1]
    if task in ("aligning", "stacking"):
        return (ex,)
    return (ex[0],)


@pytest.mark.parametrize("task", TASKS)
def test_pipeline_writes_what_the_jax_pipeline_writes(monkeypatch, tmp_path,
                                                      task):
    """Same contexts -> the same orders or modes; the same logs and final
    state -> the same episode pickles (keys, float32 channels, mode) and
    the same train/eval split; each episode has the keys and trailing
    shapes of a shipped pickle of data/<task>."""
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    got, logs, dones, state = run_jax_pipeline(monkeypatch, task, jax_out)

    extras = gd.plan(task, _contexts(task, got), N, SEED)
    want = _captured_extras(task, got)
    mine = extras[1:] if task == "pushing" else extras
    for a, b in zip(mine, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    port_dir = port_out / task
    all_dir = port_dir / "all_data"
    all_dir.mkdir(parents=True)
    files = gd.write(task, str(all_dir), logs, dones, state, extras)
    gd.write_split(str(port_dir), files, SEED)

    jdir = jax_out / task
    assert sorted(files) == sorted(os.listdir(jdir / "all_data"))
    assert 0 < len(files) < N
    for name in files:
        _assert_same_episode(_load(all_dir / name),
                             _load(jdir / "all_data" / name), name)
    for split in ("train_files.pkl", "eval_files.pkl"):
        assert _load(port_dir / split) == _load(jdir / split), split

    shipped_dir = os.path.join(ROOT, "data", task, "all_data")
    shipped = _load(os.path.join(shipped_dir, sorted(os.listdir(
        shipped_dir))[0]))
    mine = _load(all_dir / files[0])
    assert set(mine) == set(shipped)
    for ch in mine:
        if ch == "mode":
            continue
        assert set(mine[ch]) == set(shipped[ch]), ch
        for k in mine[ch]:
            assert mine[ch][k].shape[1:] == np.asarray(
                shipped[ch][k]).shape[1:], (ch, k)


def test_split_of_nothing_writes_nothing(tmp_path):
    assert gd.write_split(str(tmp_path), [], 0) is None
    assert os.listdir(tmp_path) == []


def test_episode_length_is_through_the_first_done():
    assert gd.ep_len(np.array([False, False, True, True])) == 3
    assert gd.ep_len(np.array([False, False])) == 2
