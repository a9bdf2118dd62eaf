"""Multi-seed benchmark sweep with the PyTorch port.

  python run_benchmark_torch.py --tasks avoiding pushing --agents bc gmm \
      --seeds 0 1 2 --out results_torch
  python tools/make_results.py --in results_torch/results.jsonl \
      --out results_torch/RESULTS.md

Counterpart of run_benchmark.py for d3il_tpu_torch, with the same flags
plus --device (default cuda). Every (task, agent, seed) row trains and
evaluates in its own subprocess of run_train_torch.py, with the task's
tuned defaults (registry.TaskSpec.train_kw) under the flags given here,
and appends its metrics row (the JAX package's schema, plus
wall_seconds and the row's own ranks, the number of ranks it ran on:
every visible GPU, as a JAX row uses every local chip) to
<out>/results.jsonl. Rows already recorded are skipped, so the sweep
resumes; a row that failed carries an "error" and runs again. A
stochastic agent's metrics depend on the number of ranks as well as the
seed (run_train_torch.py says why), so one results file holds rows of one
rank count: a sweep that would run on another count stops.
Its own output directory keeps it apart from the JAX package's results/.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from d3il_tpu_torch import registry  # noqa: E402
from d3il_tpu_torch.parallel import distributed as pdist  # noqa: E402


def row_argv(over: dict) -> list:
    """The run_train_torch.py command line of one row: a flag per set
    value, a bare flag per true boolean."""
    cmd = [sys.executable, os.path.join(ROOT, "run_train_torch.py")]
    for k, v in over.items():
        if isinstance(v, bool):
            if v:
                cmd.append(f"--{k.replace('_', '-')}")
        elif v is not None:
            cmd += [f"--{k.replace('_', '-')}", str(v)]
    return cmd


def _run_row(over: dict) -> dict:
    """One (task, agent, seed) row in a subprocess: a fault that leaves the
    CUDA context unusable ends that process only, not the later rows. The
    row is the last line the subprocess prints."""
    proc = subprocess.run(row_argv(over), capture_output=True, text=True,
                          timeout=7200)
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(
            f"row subprocess failed (rc {proc.returncode}):\n"
            + (proc.stderr or "")[-800:])
    return json.loads(lines[-1])


def load_done(path, ranks=1):
    """(task, agent, seed) of every recorded row; rows with an "error" are
    left out, so that the next sweep runs them again. A recorded row that
    ran on another number of ranks than ``ranks`` (a row without the field
    ran on one) stops the sweep."""
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "error" in r:
                    continue
                if r.get("ranks", 1) != ranks:
                    raise SystemExit(
                        f"{path} holds rows run on {r.get('ranks', 1)} "
                        f"ranks, this sweep runs on {ranks}: give another "
                        "--out, or choose the cards with "
                        "CUDA_VISIBLE_DEVICES or --device cuda:<k>")
                done.add((r.get("task"), r.get("agent"), r.get("seed")))
    return done


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", nargs="+", default=["avoiding"],
                    choices=sorted(registry.TASKS))
    ap.add_argument("--agents", nargs="+", default=["bc"],
                    choices=sorted(registry.AGENTS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--out", default="results_torch")
    ap.add_argument("--data", default="data")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the per-task tuned epoch count")
    ap.add_argument("--n-contexts", type=int, default=None,
                    help="override the per-task eval context count")
    ap.add_argument("--n-trajs", type=int, default=None,
                    help="override the per-task eval trajectories")
    ap.add_argument("--eval-max-steps", type=int, default=None,
                    help="cap the eval episode horizon")
    ap.add_argument("--kinematic", action="store_true", default=False)
    ap.add_argument("--rerun", action="store_true",
                    help="recompute rows already in results.jsonl")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "results.jsonl")
    # each row's subprocess starts this many ranks (run_train_torch.main)
    done = load_done(path, pdist.local_world(args.device))
    if args.rerun:
        done = set()

    for task in args.tasks:
        if not os.path.exists(os.path.join(args.data, task,
                                           "train_files.pkl")):
            print(f"[skip] {task}: no dataset under {args.data}/{task} "
                  f"(run tools/gen_demos_torch.py first)")
            continue
        for agent in args.agents:
            for seed in args.seeds:
                if (task, agent, seed) in done:
                    print(f"[done] {task} {agent} seed {seed}")
                    continue
                over = dict(task=task, agent=agent, seed=seed, data=args.data,
                            kinematic=args.kinematic, log_dir=args.out,
                            device=args.device)
                for k in ("epochs", "n_contexts", "n_trajs",
                          "eval_max_steps"):
                    if getattr(args, k) is not None:
                        over[k] = getattr(args, k)
                t0 = time.time()
                print(f"[run ] {task} {agent} seed {seed}", flush=True)
                try:
                    row = _run_row(over)
                except Exception:
                    traceback.print_exc()
                    row = {"task": task, "agent": agent, "seed": seed,
                           "error": traceback.format_exc(limit=1)[-400:]}
                row["wall_seconds"] = round(time.time() - t0, 1)
                with open(path, "a") as f:
                    f.write(json.dumps(row) + "\n")
                print(f"[row ] {json.dumps(row)}", flush=True)


if __name__ == "__main__":
    main()
