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


# the other tasks' start postures (the JAX package's Params.q_init;
# avoiding starts at pushing's pose)
Q_INIT_TASK = {
    "aligning": np.array([-0.40412223, 0.32504207, -0.20123088, -1.84203374,
                          0.07952347, 2.16244817, 0.14624882]),
    "sorting_4": np.array([-0.33100116, 0.24833255, -0.19925672, -1.95236027,
                           0.06261307, 2.19832397, 0.22458877]),
    "avoiding": Q_INIT,
    "stacking": np.array([-8.73528734e-07, -4.12198342e-02, 7.97928294e-07,
                          -2.18946218e+00, 3.53404417e-08, 2.15303779e+00,
                          7.85398126e-01]),
    "inserting": Q_INIT,    # pushing's start pose
}


def test_registry_lists_the_ported_tasks():
    """All eight tasks, with the JAX registry's dims, horizons and
    workloads; a task the registry lacks raises the KeyError that names the
    ported."""
    assert sorted(registry.TASKS) == ["aligning", "avoiding", "inserting",
                                      "pushing", "sorting_2", "sorting_4",
                                      "sorting_6", "stacking"]
    dims = {k: (t.obs_dim, t.act_dim, t.max_steps, t.sim_name)
            for k, t in registry.TASKS.items()}
    assert dims == {"avoiding": (4, 2, 250, "AvoidingSim"),
                    "pushing": (10, 2, 400, "PushingSim"),
                    "aligning": (20, 3, 400, "AligningSim"),
                    "sorting_2": (10, 2, 700, "SortingSim"),
                    "sorting_4": (16, 2, 700, "SortingSim"),
                    "sorting_6": (22, 2, 700, "SortingSim"),
                    "stacking": (20, 8, 1000, "StackingSim"),
                    "inserting": (13, 2, 2000, "InsertingSim")}
    for n in (2, 4, 6):
        spec = registry.TASKS[f"sorting_{n}"]
        assert spec.params_kw == {"num_boxes": n}
        assert spec.make_sim().num_boxes == n
    for k in ("aligning", "sorting_2"):
        assert registry.TASKS[k].train_kw == {"epochs": 100, "n_contexts": 60,
                                              "n_trajs": 8}
    assert registry.TASKS["inserting"].train_kw == {
        "epochs": 100, "n_contexts": 30, "n_trajs": 8}
    # avoiding: the reference's 480 trajectories from its one (empty)
    # context; stacking: 60 x 18 at the training window 5
    assert registry.TASKS["avoiding"].train_kw == {
        "epochs": 80, "n_contexts": 1, "n_trajs": 480}
    assert registry.TASKS["stacking"].train_kw == {
        "epochs": 100, "n_contexts": 60, "n_trajs": 18, "window": 5}
    with pytest.raises(KeyError, match="not ported.*'stacking'"):
        registry.TASKS["sorting_8"]


@pytest.mark.parametrize("task", ["aligning", "sorting_4", "avoiding",
                                  "stacking", "inserting"])
def test_train_and_eval_rod_task(task, monkeypatch, tmp_path):
    """run_train_torch trains a tiny gmm agent on the task's demonstrations
    for one epoch, saves it and evaluates it through the task's Sim (2
    contexts x 1 trajectory, 2 steps of a 2-substep window, full arm
    dynamics, the given start posture); run_eval_torch reloads it and gives
    the same metrics. Stacking trains at its window of 5 and rolls out in
    joint space; avoiding's two contexts are both its empty one."""
    spec = dataclasses.replace(
        registry.TASKS[task],
        params_kw=dict(registry.TASKS[task].params_kw, n_substeps=2,
                       q_init=Q_INIT_TASK[task]))
    monkeypatch.setitem(registry.TASKS, task, spec)
    ckpt = str(tmp_path / f"{task}_gmm.pt")
    args = run_train_torch.make_args(
        task=task, agent="gmm", device="cpu", epochs=1, hidden=16, layers=2,
        n_contexts=2, n_trajs=1, eval_max_steps=2, ckpt=ckpt,
        data=os.path.join(ROOT, "data"), log_dir=str(tmp_path / "runs"))
    row = run_train_torch.run_one(args)
    # --log-dir: the run's JSONL stream, start, one epoch, the row, end
    with open(tmp_path / "runs" / f"{task}_gmm_s0.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["event"] for e in events] == ["start", "epoch", "result", "end"]
    assert {k: events[2][k] for k in row} == row
    assert row["task"] == task and row["eval_mode"] == "dynamic"
    assert np.isfinite(row["final_train_loss"])
    assert 0.0 <= row["success_rate"] <= 1.0
    # sorting scores SR - KL against the demo prior, stacking per prefix,
    # aligning reports the final distance to the target, inserting the
    # pushing convention
    assert ("kl" in row) == task.startswith("sorting")
    assert ("kl_3" in row) == (task == "stacking")
    assert ("mean_distance" in row) == (task == "aligning")
    assert args.window == (5 if task == "stacking" else 1)
    spec2, agent, meta = run_eval_torch.load_agent(ckpt, "cpu")
    assert meta["task"] == task and spec2 is spec
    out = run_train_torch.evaluate(spec2, agent, args)
    for k in out.keys() - {"eval_seconds"}:
        assert out[k] == row[k], k


def test_cli_rejects_what_is_not_ported():
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "run_train_torch.py"), "--agent",
         "lstm_gmm_vision", "--device", "cpu"], capture_output=True,
        text=True, timeout=120)
    assert r.returncode != 0 and "invalid choice" in r.stderr


def test_vision_trains_selects_saves_and_reloads(small_task, tmp_path,
                                                 capsys):
    """run_vision_torch.py's CLI with --device cpu: bc_vision (96 x 96
    images, heads 16 x 2) trained 2 epochs of 2 steps on data/pushing, a
    rollout selection eval after each (1 context x 2 trajectories, 2
    kinematic steps), then the final evaluation of the selected weights,
    one JSON row; run_eval_torch.load_agent rebuilds the agent with its
    render_fn from the checkpoint, and the same seed gives the same
    metrics."""
    import run_vision_torch
    ckpt = str(tmp_path / "pushing_bc_vision.pt")
    run_vision_torch.main([
        "--task", "pushing", "--agent", "bc_vision", "--device", "cpu",
        "--epochs", "2", "--eval-every", "1", "--steps-per-epoch", "2",
        "--batch-size", "8", "--hidden", "16", "--layers", "2",
        "--select-contexts", "1", "--select-trajs", "2", "--n-contexts", "1",
        "--n-trajs", "2", "--eval-max-steps", "2", "--kinematic",
        "--ckpt", ckpt, "--data", os.path.join(ROOT, "data")])
    out = capsys.readouterr().out
    assert out.count("[select] epoch") == 2
    row = json.loads(out.strip().splitlines()[-1])
    assert (row["task"], row["agent"], row["device"]) == \
        ("pushing", "bc_vision", "cpu")
    assert row["selected_epoch"] in (1, 2)
    assert all(0.0 <= row[k] <= 1.0
               for k in ("success_rate", "entropy", "score",
                         "selected_success"))
    spec, agent, meta = run_eval_torch.load_agent(ckpt, "cpu")
    assert type(agent).__name__ == "VisionBCAgent" and meta["hidden"] == 16
    bp, ih, low = agent.render_fn(torch.zeros((1, 10)))
    assert bp.shape == ih.shape == (1, 96, 96, 3) and low.shape == (1, 4)
    args = run_vision_torch.make_args(
        task="pushing", device="cpu", n_contexts=1, n_trajs=2,
        eval_max_steps=2, kinematic=True)
    again = run_train_torch.evaluate(spec, agent, args)
    for k in ("success_rate", "entropy", "score"):
        assert again[k] == row[k], k


@pytest.mark.parametrize("agent", ["bet_mlp", "ddpm"])
def test_train_saves_and_reloads_agent(agent, small_task, tmp_path):
    """A k-means agent (its bins saved beside the weights and restored in
    their order) and a diffusion agent (EMA weights, its step count in the
    checkpoint) trained for one epoch through run_train_torch at width 16,
    then rebuilt by run_eval_torch.load_agent: the same weights, bins and
    hyperparameters, and the same kinematic rollout of 2 x 1 episodes for 2
    steps from one seed."""
    ckpt = str(tmp_path / f"{agent}.pt")
    args = run_train_torch.make_args(
        task="pushing", agent=agent, device="cpu", epochs=1, hidden=16,
        layers=2, ddpm_steps=4, skip_eval=True, ckpt=ckpt,
        data=os.path.join(ROOT, "data"))
    row = run_train_torch.run_one(args)
    assert np.isfinite(row["final_train_loss"])
    spec, loaded, meta = run_eval_torch.load_agent(ckpt, "cpu")
    assert (meta["agent"], meta["hidden"], meta["ddpm_steps"]) == \
        (agent, 16, 4)
    saved = torch.load(ckpt, weights_only=True)
    assert all(torch.equal(loaded.params[k], v)
               for k, v in saved["params"].items())
    if agent == "bet_mlp":
        assert torch.equal(loaded.centers, saved["centers"])
    else:
        assert loaded.n_timesteps == 4
    params = spec.make_params(kinematic=True, max_steps=2, device="cpu")
    sim = sims.PushingSim(n_contexts=2, n_trajectories_per_context=1)
    a, _ = sim.run_episodes(loaded, params)
    _, again, _ = run_eval_torch.load_agent(ckpt, "cpu")
    b, _ = sim.run_episodes(again, params)
    assert torch.isfinite(a.scene.free_pos).all()
    assert torch.equal(a.scene.free_pos, b.scene.free_pos)
