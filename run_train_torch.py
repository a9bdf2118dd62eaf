"""Train + evaluate an agent on a task with the PyTorch port.

  python run_train_torch.py --task pushing --agent gmm --epochs 100
  python run_train_torch.py --task avoiding --agent gmm --epochs 60 \
      --ckpt ckpts/av.pt --skip-eval --log-dir runs
  python run_train_torch.py --task pushing --agent bc --device cpu \
      --epochs 2 --n-contexts 2 --n-trajs 2 --eval-max-steps 3 --kinematic

Counterpart of run_train.py for d3il_tpu_torch (d3il_tpu_torch/registry.py
lists the ported tasks and agents). Pipeline: load demonstration pickles ->
padded device tensors -> Scaler -> minibatch training -> batched on-device
rollout evaluation (all episodes in lockstep) -> success/entropy metrics +
checkpoint. Evaluation runs the full arm dynamics by default; pass
--kinematic for the fast kinematic-arm mode. Runs on the GPU unless
--device cpu is given: on every visible GPU (CUDA_VISIBLE_DEVICES chooses
them), one rank per card joined by NCCL, as run_train.py uses every local
chip; --device cuda:<k> runs on card k alone. Every rank trains on its
share of each minibatch and rolls out its share of the episodes; rank 0
alone writes the checkpoint and the log, and prints the row, whose
``ranks`` is the number of ranks it ran on. An agent that draws noise
(gmm, ddpm, beso, ...) draws it from a generator of each rank's own, so
one --seed gives another model and other metrics on another number of
cards (run_train.py draws one stream whatever its chip count); a
deterministic agent (bc) agrees across card counts to float rounding.
Pass --device cuda:0 to reproduce a one-card run on a host with more.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from d3il_tpu_torch import registry  # noqa: E402
from d3il_tpu_torch.agents import base as agent_base  # noqa: E402
from d3il_tpu_torch.data import dataset as ds  # noqa: E402
from d3il_tpu_torch.data.scaler import Scaler  # noqa: E402
from d3il_tpu_torch.envs.common import resolve_device  # noqa: E402
from d3il_tpu_torch.parallel import distributed as pdist  # noqa: E402
from d3il_tpu_torch.utils import logging as run_logging  # noqa: E402


def agent_kwargs(name: str, window: int, hidden: int, layers: int,
                 chunk: int = 8, ddpm_steps: int = 16) -> dict:
    """Per-agent constructor kwargs from the generic hyperparameters (shared
    by training and checkpoint-restore so run_eval_torch rebuilds
    identically)."""
    registry.AGENTS[name]      # raises for an agent that is not ported
    kw = dict(window_size=window)
    if name in ("bc", "cvae", "gmm", "ibc", "beso", "ddpm") or \
            name.endswith("_vision"):
        kw.update(hidden_dim=hidden, num_hidden_layers=layers)
    if name in ("act", "ddpm_encdec", "act_vision", "ddpm_encdec_vision"):
        kw["chunk"] = chunk
        if window != 1:
            print(f"warning: --window {window} has no effect for {name} "
                  "(single-obs chunk policies)")
    if name in ("ddpm", "ddpm_encdec", "ddpm_vision", "ddpm_encdec_vision"):
        kw["n_timesteps"] = ddpm_steps
    if name in ("gpt_bc", "gpt_bc_vision"):
        kw["window_size"] = max(window, 5)
    return kw


def vision_kwargs(task: str, name: str) -> dict:
    """A vision agent's task render_fn (both cameras at 96 x 96) and its
    low-dim width; nothing for the state agents."""
    if not registry.AGENTS[name].vision:
        return {}
    from d3il_tpu_torch.vision import taskviews
    return {"render_fn": taskviews.make_render_obs(task),
            "low_dim": taskviews.low_dim_size(task)}


def build_agent_and_data(args, generator):
    """Load the task dataset, fit the Scaler, construct the agent."""
    spec = registry.TASKS[args.task]
    device = generator.device
    task_dir = os.path.join(args.data, args.task)
    with open(os.path.join(task_dir, "train_files.pkl"), "rb") as f:
        train_files = pickle.load(f)
    with open(os.path.join(task_dir, "eval_files.pkl"), "rb") as f:
        eval_files = pickle.load(f)
    all_dir = os.path.join(task_dir, "all_data")
    max_len = args.max_len or spec.max_steps
    train_data = ds.load_task_dataset(all_dir, train_files, spec.assemble,
                                      max_len, args.window, device=device)
    val_data = ds.load_task_dataset(all_dir, eval_files, spec.assemble,
                                    max_len, args.window, device=device)
    x, y = ds.all_valid(train_data)
    scaler = Scaler.fit(x, y, device=device)
    obs_dim, act_dim = x.shape[-1], y.shape[-1]
    if (obs_dim, act_dim) != (spec.obs_dim, spec.act_dim):
        raise ValueError(f"dataset dims ({obs_dim},{act_dim}) != spec "
                         f"({spec.obs_dim},{spec.act_dim})")
    print(f"dataset: {len(train_files)} train eps, {train_data.n_windows} "
          f"windows, obs {obs_dim} act {act_dim}")

    kw = agent_kwargs(args.agent, args.window, args.hidden, args.layers,
                      args.chunk, args.ddpm_steps)
    # the task's tuned overrides for this agent trump the generic CLI
    # hyperparameters; the checkpoint keeps them as agent_extra
    extra = dict(spec.agent_kw.get(args.agent, {}))
    kw.update(extra)
    args.agent_extra = extra
    kw.update(vision_kwargs(args.task, args.agent))
    acts_scaled = None
    if registry.AGENTS[args.agent].needs_actions:
        acts_scaled = scaler.scale_output(torch.as_tensor(y, device=device))
    agent, ema = registry.make_agent(args.agent, generator, obs_dim, act_dim,
                                     scaler, acts_scaled, **kw)
    # chunked and windowed agents train on wider windows
    want_window = getattr(agent, "train_window", None) or agent.window_size
    if want_window != args.window:
        args.window = want_window
        train_data = ds.rewindow(train_data, args.window)
        val_data = ds.rewindow(val_data, args.window)
    return spec, agent, ema, train_data, val_data


def evaluate(spec, agent, args):
    params = spec.make_params(kinematic=args.kinematic,
                              max_steps=args.eval_max_steps or spec.max_steps,
                              device=args.device)
    sim = spec.make_sim(seed=args.seed, n_contexts=args.n_contexts,
                        n_trajectories_per_context=args.n_trajs)
    t0 = time.time()
    out = sim.test_agent(agent, params=params)
    out["eval_seconds"] = round(time.time() - t0, 1)
    return out


def make_args(**overrides) -> argparse.Namespace:
    """Programmatic entry: the CLI defaults as a Namespace, with per-task
    tuned settings (registry.TaskSpec.train_kw) and explicit overrides
    applied on top."""
    args = _parser().parse_args([])
    task = overrides.get("task", args.task)
    for k, v in registry.TASKS[task].train_kw.items():
        setattr(args, k, v)
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def save_agent(args, agent):
    """Checkpoint ``agent.params`` with what run_eval_torch.load_agent
    rebuilds the agent from: the run's hyperparameters, the scaler and
    BeT's bins."""
    extra = {"meta": {
        "task": args.task, "agent": args.agent, "seed": args.seed,
        "window": args.window, "hidden": args.hidden,
        "layers": args.layers, "chunk": args.chunk,
        "ddpm_steps": args.ddpm_steps,
        "agent_extra": getattr(args, "agent_extra", {}),
        "scale_data": bool(agent.scaler.scale_data)},
        "scaler": {k: v for k, v in agent.scaler._asdict().items()
                   if k != "scale_data"}}
    if hasattr(agent, "centers"):
        extra["centers"] = agent.centers
    agent_base.save_checkpoint(args.ckpt, agent.params, extra=extra)
    print("checkpoint saved:", args.ckpt)


def run_one(args) -> dict:
    """Train + evaluate one (task, agent, seed); returns the metrics row.
    Under a process group every rank calls it; rank 0 alone writes the
    checkpoint and the log."""
    device = resolve_device(args.device)
    lead = pdist.process_index() == 0
    generator = torch.Generator(device=device).manual_seed(args.seed)
    spec, agent, ema, train_data, val_data = build_agent_and_data(
        args, generator)

    logger = run_logging.RunLogger(
        run_dir=args.log_dir if lead else None,
        name=f"{args.task}_{args.agent}_s{args.seed}")
    cfg = agent_base.TrainConfig(epochs=args.epochs,
                                 batch_size=args.batch_size,
                                 window_size=args.window,
                                 eval_every_n_epochs=10, ema_decay=ema)
    t0 = time.time()
    best, final, hist = agent_base.fit(
        agent.loss_fn(), agent.params, train_data, val_data, cfg, generator,
        log_every=10, callback=logger.epoch_callback,
        checkpoint_dir=args.resume_dir, checkpoint_every=args.ckpt_every)
    train_seconds = round(time.time() - t0, 1)
    print(f"training done in {train_seconds:.1f}s, "
          f"final loss {hist[-1]['train_loss']:.5f}")
    agent.params = best
    if args.ckpt and lead:
        save_agent(args, agent)

    result = {}
    if not args.skip_eval:
        result = evaluate(spec, agent, args)
    row = {"task": args.task, "agent": args.agent, "seed": args.seed,
           "eval_mode": "kinematic" if args.kinematic else "dynamic",
           "data": args.data, "device": str(device),
           "date": time.strftime("%Y-%m-%d", time.gmtime()),
           "ranks": pdist.process_count(), "train_seconds": train_seconds,
           "final_train_loss": round(float(hist[-1]["train_loss"]), 6),
           **result}
    logger.log({"event": "result", **row})
    logger.close()
    return row


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="avoiding",
                    choices=sorted(registry.TASKS))
    ap.add_argument("--agent", default="bc", choices=sorted(registry.AGENTS))
    ap.add_argument("--data", default="data")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--window", type=int, default=1)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=None,
                    help="pad length of the demonstration tensors "
                    "(default: the task's horizon)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="action chunk of act and ddpm_encdec")
    ap.add_argument("--ddpm-steps", type=int, default=16,
                    help="diffusion steps of ddpm and ddpm_encdec")
    ap.add_argument("--n-contexts", type=int, default=15)
    ap.add_argument("--n-trajs", type=int, default=4,
                    help="trajectories per context (avoiding: its one "
                    "empty context)")
    ap.add_argument("--eval-max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kinematic", action="store_true", default=False,
                    help="fast kinematic-arm eval (default: full dynamics)")
    ap.add_argument("--no-kinematic", dest="kinematic", action="store_false")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-dir", default=None,
                    help="directory of the run's JSONL metric stream")
    ap.add_argument("--resume-dir", default=None,
                    help="mid-run checkpoint dir: resumes full train state")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="epochs between mid-run checkpoints (0: off)")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """The command line's args, with the task's tuned defaults applied to
    every arg it does not pass (checked against the flags given, not by
    default-equality, so an explicit `--window 1` can force the parser
    default over train_kw)."""
    argv = sys.argv[1:] if argv is None else argv
    args = _parser().parse_args(argv)
    passed = {a.split("=", 1)[0] for a in argv if a.startswith("--")}
    for k, v in registry.TASKS[args.task].train_kw.items():
        if "--" + k.replace("_", "-") not in passed:
            setattr(args, k, v)
    return args


def main(argv=None):
    args = parse_args(argv)
    row = pdist.run_on_local_devices(run_one, args,
                                     nprocs=pdist.local_world(args.device),
                                     device=args.device)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
