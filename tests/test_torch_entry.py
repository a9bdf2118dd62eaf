"""The port's entry scripts on the CPU: train, save, evaluate, reload.

``run_train_torch.run_one`` trains a small gmm agent on the real
``data/pushing`` demonstrations for one short epoch, saves it and evaluates
it; ``run_eval_torch.load_agent`` rebuilds it and gives the same rollout.
The task's params are cut to a 2-substep window with a known start posture
(the start-posture search is minutes of plain PyTorch on the CPU).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_jaxref  # noqa: F401  (thread and TF32 settings)

import run_eval_torch
import run_train_torch
from d3il_tpu_torch import registry
from d3il_tpu_torch.eval import sims

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the pushing task's start posture (the JAX package's PushingParams.q_init)
Q_INIT = np.array([-0.36010373, 0.43400675, -0.13117754, -2.05403185,
                   0.09223454, 2.48476696, 0.23339309])


@pytest.fixture
def small_task(monkeypatch):
    spec = dataclasses.replace(registry.TASKS["pushing"],
                               params_kw={"n_substeps": 2, "q_init": Q_INIT})
    monkeypatch.setitem(registry.TASKS, "pushing", spec)
    return spec


@pytest.fixture
def trained(small_task, tmp_path):
    ckpt = str(tmp_path / "pushing_gmm.pt")
    args = run_train_torch.make_args(
        task="pushing", agent="gmm", device="cpu", epochs=1, hidden=32,
        layers=2, n_contexts=2, n_trajs=2, eval_max_steps=3, kinematic=True,
        ckpt=ckpt, data=os.path.join(ROOT, "data"))
    return args, run_train_torch.run_one(args), ckpt


def test_train_saves_evaluates_and_prints_a_row(trained):
    args, row, ckpt = trained
    assert os.path.exists(ckpt)
    assert {"task", "agent", "seed", "eval_mode", "train_seconds",
            "final_train_loss", "success_rate", "entropy", "score",
            "eval_seconds", "device"} <= set(row)
    assert row["eval_mode"] == "kinematic" and row["device"] == "cpu"
    assert np.isfinite(row["final_train_loss"])
    assert all(0.0 <= row[k] <= 1.0
               for k in ("success_rate", "entropy", "score"))
    json.dumps(row)
    # the task's tuned defaults were applied under the explicit overrides
    assert run_train_torch.make_args(task="pushing").n_trajs == 16


def test_eval_reloads_the_same_agent(trained, small_task):
    """load_agent gives back the weights and scaler that were saved, and the
    same seed gives the same rollout and metrics."""
    args, row, ckpt = trained
    spec, agent, meta = run_eval_torch.load_agent(ckpt, "cpu")
    assert (meta["task"], meta["agent"], meta["hidden"]) == \
        ("pushing", "gmm", 32)
    assert agent.model.K == 8 and agent.window_size == 1
    out = run_train_torch.evaluate(spec, agent, args)
    for k in ("success_rate", "entropy", "score"):
        assert out[k] == row[k]
    # same weights -> the same final state as a second load
    params = spec.make_params(kinematic=True, max_steps=2, device="cpu")
    sim = sims.PushingSim(n_contexts=2, n_trajectories_per_context=2)
    a, _ = sim.run_episodes(agent, params)
    _, agent2, _ = run_eval_torch.load_agent(ckpt, "cpu")
    b, _ = sim.run_episodes(agent2, params)
    assert torch.equal(a.scene.free_pos, b.scene.free_pos)
    assert torch.equal(a.ctrl.q_virt, b.ctrl.q_virt)
    assert all(torch.equal(agent.params[k], agent2.params[k])
               for k in agent.params)


def test_resume_dir_continues_training(small_task, tmp_path):
    kw = dict(task="pushing", agent="bc", device="cpu", hidden=16, layers=2,
              skip_eval=True, resume_dir=str(tmp_path), ckpt_every=1,
              data=os.path.join(ROOT, "data"))
    run_train_torch.run_one(run_train_torch.make_args(epochs=1, **kw))
    assert os.path.exists(tmp_path / "state.pt")
    row = run_train_torch.run_one(run_train_torch.make_args(epochs=2, **kw))
    full = run_train_torch.run_one(run_train_torch.make_args(
        epochs=2, **dict(kw, resume_dir=None)))
    assert row["final_train_loss"] == full["final_train_loss"]


def test_cli_rejects_what_is_not_ported():
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "run_train_torch.py"), "--task",
         "stacking", "--device", "cpu"], capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0 and "invalid choice" in r.stderr
