"""The entry points over every local device (``parallel/distributed.py``
``local_world`` and ``run_on_local_devices``), on two gloo ranks of the
CPU, each an OS process of its own (``spawn``, one thread a rank), against
one process.

* ``run_train_torch.main``, bc, one epoch on a cut of ``data/pushing``,
  ``--skip-eval``, with ``local_world`` patched to 2: the weights within
  atol 2e-4 and the losses within rtol 2e-4 of the one-process run (the
  JAX test's bars, ``tests/test_parallel.py:73-109``); exactly one
  checkpoint, one log file with one start record and one JSON line, whose
  ``ranks`` is 2.
* ``run_eval_torch.run`` on that checkpoint, 2 contexts x 2 trajectories
  and 2 dynamic steps of pushing (a 2-substep window at the JAX package's
  start posture, as ``tests/test_torch_entry.py`` cuts it; the patch and
  the recording of the Sim's final states are made in every rank's
  process): the same metrics and the gathered states within 1e-5, the
  rows' ``ranks`` 1 and 2.
* A rank that raises fails the call within 60 s and no rank outlives it;
  ``local_world`` and the one-process form.

The workers import only the port and this file, which imports no JAX.
"""
import contextlib
import dataclasses
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import run_eval_torch
import run_train_torch
from d3il_tpu_torch import registry
from d3il_tpu_torch.agents import base
from d3il_tpu_torch.eval import sims
from d3il_tpu_torch.parallel import distributed as pdist
from d3il_tpu_torch.parallel import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the pushing task's start posture (the JAX package's PushingParams.q_init)
Q_INIT = np.array([-0.36010373, 0.43400675, -0.13117754, -2.05403185,
                   0.09223454, 2.48476696, 0.23339309])
TRAIN_ARGV = ["--task", "pushing", "--agent", "bc", "--epochs", "1",
              "--hidden", "32", "--layers", "2", "--skip-eval",
              "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def cut_data(tmp_path_factory):
    """data/pushing cut to 8 training and 2 validation episodes."""
    src = os.path.join(ROOT, "data", "pushing")
    root = tmp_path_factory.mktemp("data")
    os.makedirs(root / "pushing")
    os.symlink(os.path.join(src, "all_data"), root / "pushing" / "all_data")
    for name, n in (("train_files.pkl", 8), ("eval_files.pkl", 2)):
        with open(os.path.join(src, name), "rb") as f:
            files = pickle.load(f)[:n]
        with open(root / "pushing" / name, "wb") as f:
            pickle.dump(files, f)
    return str(root)


def _train(argv, out, capfd):
    """run_train_torch.main into ``out``; its printed lines and records."""
    os.makedirs(out)
    capfd.readouterr()
    run_train_torch.main(argv + ["--ckpt", os.path.join(out, "ckpt", "a.pt"),
                                 "--log-dir", os.path.join(out, "log")])
    said = capfd.readouterr().out.splitlines()
    logs = os.listdir(os.path.join(out, "log"))
    with open(os.path.join(out, "log", logs[0])) as f:
        records = [json.loads(line) for line in f]
    return said, logs, records


@pytest.fixture(scope="module")
def one_process(cut_data, tmp_path_factory):
    """The one-process run of TRAIN_ARGV: checkpoint, row and records."""
    out = str(tmp_path_factory.mktemp("one") / "run")
    args = run_train_torch.parse_args(TRAIN_ARGV + ["--data", cut_data])
    assert pdist.local_world(args.device) == 1
    os.makedirs(out)
    args.ckpt = os.path.join(out, "a.pt")
    args.log_dir = os.path.join(out, "log")
    row = run_train_torch.run_one(args)
    (log,) = os.listdir(args.log_dir)
    with open(os.path.join(args.log_dir, log)) as f:
        records = [json.loads(line) for line in f]
    return args.ckpt, row, records


def _losses(records):
    return [r["train_loss"] for r in records if r["event"] == "epoch"]


def test_train_entry_over_two_ranks_matches_one_process(
        cut_data, one_process, tmp_path, monkeypatch, capfd):
    ckpt_1, row_1, records_1 = one_process
    monkeypatch.setattr(pdist, "local_world", lambda device=None: 2)
    out = str(tmp_path / "two")
    said, logs, records = _train(TRAIN_ARGV + ["--data", cut_data], out,
                                 capfd)
    rows = [json.loads(s) for s in said if s.startswith("{")]
    assert len(rows) == 1, said
    # both ranks trained; rank 0 alone saved, logged and printed
    assert sum(s.startswith("training done") for s in said) == 2, said
    assert sum(s.startswith("checkpoint saved:") for s in said) == 1, said
    assert os.listdir(os.path.join(out, "ckpt")) == ["a.pt"]
    assert len(logs) == 1
    assert [r["event"] for r in records].count("start") == 1, records
    assert [r["event"] for r in records][-2:] == ["result", "end"]
    row = rows[0]
    assert (row["task"], row["agent"], row["device"], row["ranks"]) == \
        ("pushing", "bc", "cpu", 2)
    assert row_1["ranks"] == 1
    np.testing.assert_allclose(row["final_train_loss"],
                               row_1["final_train_loss"], rtol=2e-4)
    assert len(_losses(records)) == len(_losses(records_1)) == 1
    np.testing.assert_allclose(_losses(records), _losses(records_1),
                               rtol=2e-4)
    got = base.load_checkpoint(os.path.join(out, "ckpt", "a.pt"),
                               device="cpu")["params"]
    want = base.load_checkpoint(ckpt_1, device="cpu")["params"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=2e-4, err_msg=k)


@contextlib.contextmanager
def _cut_pushing(seen):
    """Pushing at a 2-substep window from the JAX package's start posture,
    and every rollout's (final state, dones) appended to ``seen``."""
    spec = registry.TASKS["pushing"]
    run_episodes = sims._TaskSim.run_episodes

    def record(self, *a, **kw):
        seen.append(run_episodes(self, *a, **kw))
        return seen[-1]

    registry.TASKS["pushing"] = dataclasses.replace(
        spec, params_kw={"n_substeps": 2, "q_init": Q_INIT})
    sims._TaskSim.run_episodes = record
    try:
        yield
    finally:
        registry.TASKS["pushing"] = spec
        sims._TaskSim.run_episodes = run_episodes


def _eval_rank(argv):
    """One rank of run_eval_torch's path: its row, the gathered final
    state of the rollout as NumPy arrays, and the world size."""
    seen = []
    with _cut_pushing(seen):
        row = run_eval_torch.run(run_eval_torch._parser().parse_args(argv))
    (state, dones), = seen
    return (row, [x.numpy() for x in pmesh.tree_leaves((state, dones))],
            pmesh.data_mesh(device="cpu").world)


def test_eval_entry_over_two_ranks_matches_one_process(one_process):
    ckpt = one_process[0]
    argv = ["--ckpt", ckpt, "--n-contexts", "2", "--n-trajs", "2",
            "--eval-max-steps", "2", "--device", "cpu"]
    row_1, states_1, world_1 = _eval_rank(argv)
    row_2, states_2, world_2 = pdist.run_on_local_devices(
        _eval_rank, argv, nprocs=2, device="cpu")
    assert (world_1, world_2) == (1, 2)
    assert [row.pop("ranks") for row in (row_1, row_2)] == [1, 2]
    for row in (row_1, row_2):
        row.pop("eval_seconds")
    assert row_2 == row_1
    assert [s.shape for s in states_2] == [s.shape for s in states_1]
    assert states_1[0].shape[0] == 4
    for a, b in zip(states_2, states_1):
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), atol=1e-5)


def _fail_on_rank_1(pid_dir):
    """Rank 1 raises once both ranks have joined the group; rank 0 would
    go on for ten minutes."""
    rank = dist.get_rank()
    with open(os.path.join(pid_dir, f"{rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(600)


def test_failing_rank_fails_the_call_and_local_world(tmp_path, monkeypatch):
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="rank 1 fails"):
        pdist.run_on_local_devices(_fail_on_rank_1, str(tmp_path), nprocs=2,
                                   device="cpu")
    assert time.perf_counter() - t0 < 60
    pids = sorted(tmp_path.glob("*.pid"))
    assert [p.name for p in pids] == ["0.pid", "1.pid"]
    for p in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(int(p.read_text()), 0)
    # one rank runs in this process, with no process group
    assert pdist.run_on_local_devices(os.getpid, nprocs=1, device="cpu") == \
        os.getpid()
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        pdist.run_on_local_devices(os.getpid, nprocs=0, device="cpu")
    # every visible card for "cuda", one rank for a named card or the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("D3IL_COORD_ADDR", raising=False)
    assert [pdist.local_world(d) for d in (None, "cuda", "cuda:1", "cpu")] \
        == [4, 4, 1, 1]
    monkeypatch.setenv("D3IL_COORD_ADDR", "127.0.0.1:1")
    assert pdist.local_world("cuda") == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.delenv("D3IL_COORD_ADDR")
    assert pdist.local_world("cuda") == 1
