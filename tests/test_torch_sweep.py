"""The port's benchmark sweep (run_benchmark_torch.py) and the flags it
drives in run_train_torch.py.

Two pushing rows at one epoch run through ``run_benchmark_torch.main`` with
``_run_row`` replaced by the same row in this process: its command line
(``row_argv``) parsed by ``run_train_torch.parse_args``, as the row's
subprocess would, then ``run_train_torch.run_one``, on the registry patched
as tests/test_torch_entry.py patches it (a 2-substep window at the JAX
package's start posture); a subprocess would not see that patch. Then a
second sweep skips both rows, a failed row is recorded with its error and
run again by the next sweep, and tools/make_results.py renders the rows.
"""
import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_entry import Q_INIT

import run_benchmark_torch
import run_train_torch
from d3il_tpu_torch import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")


@pytest.fixture
def small_pushing(monkeypatch):
    spec = dataclasses.replace(registry.TASKS["pushing"],
                               params_kw={"n_substeps": 2, "q_init": Q_INIT})
    monkeypatch.setitem(registry.TASKS, "pushing", spec)
    return spec


def _in_process(over):
    """A row as its subprocess runs it: run_train_torch's command line
    parsed (the task's train_kw under the flags given), then run_one."""
    argv = run_benchmark_torch.row_argv(over)
    assert argv[1].endswith("run_train_torch.py")
    return json.loads(json.dumps(run_train_torch.run_one(
        run_train_torch.parse_args(argv[2:]))))


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_sweep_runs_skips_retries_and_renders(small_pushing, tmp_path,
                                              monkeypatch, capsys):
    calls = []

    def row(over):
        calls.append(over)
        if over["seed"] == 2 and len(calls) == 3:
            raise RuntimeError("row subprocess failed (rc 1)")
        return _in_process(over)

    monkeypatch.setattr(run_benchmark_torch, "_run_row", row)
    out = str(tmp_path / "sweep")
    argv = ["--tasks", "pushing", "--agents", "bc", "--seeds", "0", "1",
            "--epochs", "1", "--n-contexts", "2", "--n-trajs", "2",
            "--eval-max-steps", "2", "--kinematic", "--device", "cpu",
            "--data", DATA, "--out", out]
    run_benchmark_torch.main(argv)
    path = os.path.join(out, "results.jsonl")
    rows = _rows(path)
    assert [(r["task"], r["agent"], r["seed"]) for r in rows] == \
        [("pushing", "bc", 0), ("pushing", "bc", 1)]
    for r in rows:
        assert r["device"] == "cpu" and r["eval_mode"] == "kinematic"
        assert r["wall_seconds"] > 0 and np.isfinite(r["final_train_loss"])
        assert all(0.0 <= r[k] <= 1.0
                   for k in ("success_rate", "entropy", "score"))
    # the row's flags over the task's train_kw (epochs 100, 30 x 16)
    assert calls[0]["epochs"] == 1 and calls[0]["n_trajs"] == 2
    assert os.path.exists(os.path.join(out, "pushing_bc_s0.jsonl"))

    # a second sweep skips the recorded rows; seed 2 fails and is recorded
    capsys.readouterr()
    run_benchmark_torch.main(argv[:7] + ["2"] + argv[7:])
    said = capsys.readouterr().out
    assert "[done] pushing bc seed 0" in said
    assert "[done] pushing bc seed 1" in said
    rows = _rows(path)
    assert len(calls) == 3 and len(rows) == 3
    assert rows[2]["seed"] == 2 and "row subprocess failed" in \
        rows[2]["error"]
    # the next sweep runs the failed row again, and only it
    run_benchmark_torch.main(argv[:7] + ["2"] + argv[7:])
    rows = _rows(path)
    assert len(calls) == 4 and calls[3]["seed"] == 2
    assert "error" not in rows[3] and rows[3]["seed"] == 2
    assert run_benchmark_torch.load_done(path) == {
        ("pushing", "bc", s) for s in (0, 1, 2)}

    # tools/make_results.py renders the rows, --in and --out explicit
    spec = importlib.util.spec_from_file_location(
        "make_results", os.path.join(ROOT, "tools", "make_results.py"))
    mr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mr)
    md = str(tmp_path / "RESULTS.md")
    monkeypatch.setattr(sys, "argv", ["make_results.py", "--in", path,
                                      "--out", md])
    mr.main()
    text = open(md).read()
    assert "## pushing" in text
    table = [ln for ln in text.splitlines() if ln.startswith("| bc")]
    assert len(table) == 1 and "| 3 | kinematic |" in table[0]


def test_sweep_command_line_and_missing_dataset(tmp_path, capsys):
    """A row's command line gives run_train_torch.py's parse the args that
    make_args gives in process (the task's train_kw under the row's flags);
    the defaults; a task without a dataset is skipped by name."""
    over = dict(task="avoiding", agent="gmm", seed=3, data=DATA,
                kinematic=False, log_dir=str(tmp_path), device="cpu",
                epochs=2)
    parsed = vars(run_train_torch.parse_args(
        run_benchmark_torch.row_argv(over)[2:]))
    assert parsed == vars(run_train_torch.make_args(**over))
    assert parsed["n_trajs"] == 480 and parsed["n_contexts"] == 1
    args = run_benchmark_torch._parser().parse_args([])
    assert (args.out, args.device, args.tasks) == \
        ("results_torch", "cuda", ["avoiding"])
    run_benchmark_torch.main(["--tasks", "sorting_4", "--data",
                              str(tmp_path), "--out", str(tmp_path / "o")])
    said = capsys.readouterr().out
    assert "[skip] sorting_4: no dataset" in said
    assert "tools/gen_demos_torch.py" in said


def test_train_flags_max_len_no_kinematic_and_task(monkeypatch):
    """--max-len pads the demonstrations to it (the dataset loader gets it
    and the tensors have it); --no-kinematic undoes --kinematic; the task
    defaults to avoiding, as in run_train.py."""
    args = run_train_torch.parse_args(["--kinematic", "--no-kinematic"])
    assert args.task == "avoiding" and args.kinematic is False
    assert run_train_torch.parse_args([]).max_len is None
    seen = []
    load = run_train_torch.ds.load_task_dataset

    def spy(data_dir, files, assemble_fn, max_len, *a, **kw):
        seen.append(max_len)
        return load(data_dir, files, assemble_fn, max_len, *a, **kw)

    monkeypatch.setattr(run_train_torch.ds, "load_task_dataset", spy)
    gen = torch.Generator().manual_seed(0)
    args = run_train_torch.parse_args(
        ["--task", "avoiding", "--agent", "bc", "--max-len", "120",
         "--device", "cpu", "--data", DATA])
    _, _, _, train, val = run_train_torch.build_agent_and_data(args, gen)
    assert seen == [120, 120]
    assert train.observations.shape[1] == val.observations.shape[1] == 120
    seen.clear()
    args = run_train_torch.parse_args(["--task", "avoiding", "--device",
                                       "cpu", "--data", DATA])
    run_train_torch.build_agent_and_data(args, gen)
    assert seen == [registry.TASKS["avoiding"].max_steps] * 2
