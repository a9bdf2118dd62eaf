"""Vision training with rollout-based model selection, on the PyTorch port.

  python run_vision_torch.py --task sorting_2 --agent bc_vision
  python run_vision_torch.py --task pushing --agent gmm_vision --epochs 30 \
      --eval-every 5 --ckpt ckpts/push_gmm_vision.pt
  python run_vision_torch.py --task pushing --agent bc_vision --device cpu \
      --epochs 2 --eval-every 1 --steps-per-epoch 2 --batch-size 8 \
      --select-contexts 1 --select-trajs 2 --n-contexts 1 --n-trajs 2 \
      --eval-max-steps 2 --kinematic

Counterpart of run_vision.py for d3il_tpu_torch: train epochs, and every
``--eval-every`` epochs run a reduced rollout evaluation (``--select-contexts``
x ``--select-trajs`` episodes) with the current weights (the EMA track where
the agent has one), keeping the weights with the best success rate: model
selection on rollout success, not validation loss. The final evaluation
runs the task's full workload on the selected weights; ``--ckpt`` saves
them in the form run_eval_torch.py reloads.

The vision agents render both cameras on the device from the state
observation (d3il_tpu_torch/vision/taskviews.py), so training reads the
ordinary state datasets and evaluation runs the ordinary batched sims.
Runs on the GPU unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from d3il_tpu_torch import registry  # noqa: E402
from d3il_tpu_torch.agents import base as agent_base  # noqa: E402
from d3il_tpu_torch.envs.common import resolve_device  # noqa: E402
import run_train_torch  # noqa: E402


def _parser():
    ap = run_train_torch._parser()
    ap.set_defaults(agent="bc_vision", task="sorting_2")
    ap.add_argument("--eval-every", type=int, default=10,
                    help="epochs between rollout-based selection evals")
    ap.add_argument("--select-contexts", type=int, default=10)
    ap.add_argument("--select-trajs", type=int, default=2)
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="minibatch steps per epoch (default: the windows "
                    "over the batch size)")
    return ap


def make_args(**overrides) -> argparse.Namespace:
    """Programmatic entry: the CLI defaults with the task's tuned settings
    (registry.TaskSpec.train_kw) and explicit overrides on top."""
    args = _parser().parse_args([])
    task = overrides.get("task", args.task)
    for k, v in registry.TASKS[task].train_kw.items():
        setattr(args, k, v)
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def run(args) -> dict:
    """Train with rollout-based selection, save, evaluate; returns the
    metrics row."""
    if not registry.AGENTS[args.agent].vision:
        raise ValueError(f"--agent {args.agent} is not a vision agent")
    device = resolve_device(args.device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    spec, agent, ema, train_data, val_data = \
        run_train_torch.build_agent_and_data(args, generator)

    sel_args = argparse.Namespace(
        kinematic=args.kinematic, eval_max_steps=args.eval_max_steps,
        seed=args.seed, device=args.device, n_contexts=args.select_contexts,
        n_trajs=args.select_trajs)
    best = {"success": -1.0, "params": None, "epoch": -1}

    def select(epoch, params, rec):
        if (epoch + 1) % args.eval_every != 0:
            return
        agent.params = params
        sr = run_train_torch.evaluate(spec, agent, sel_args).get(
            "success_rate", 0.0)
        print(f"[select] epoch {epoch + 1}: success {sr:.3f} "
              f"(best {best['success']:.3f} @ {best['epoch'] + 1})")
        if sr > best["success"]:
            best.update(success=sr, epoch=epoch,
                        params={k: v.detach().clone()
                                for k, v in params.items()})

    cfg = agent_base.TrainConfig(epochs=args.epochs,
                                 batch_size=args.batch_size,
                                 window_size=args.window,
                                 steps_per_epoch=args.steps_per_epoch,
                                 eval_every_n_epochs=10, ema_decay=ema)
    t0 = time.time()
    _, final, _ = agent_base.fit(agent.loss_fn(), agent.params, train_data,
                                 val_data, cfg, generator, log_every=5,
                                 callback=select)
    train_seconds = round(time.time() - t0, 1)
    agent.params = best["params"] if best["epoch"] >= 0 else final

    if args.ckpt:
        run_train_torch.save_agent(args, agent)
    result = {} if args.skip_eval else run_train_torch.evaluate(spec, agent,
                                                                args)
    return {"task": args.task, "agent": args.agent, "seed": args.seed,
            "device": str(device), "train_seconds": train_seconds,
            "selected_epoch": best["epoch"] + 1,
            "selected_success": best["success"], **result}


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    # the task's tuned defaults for any flag not given on the command line
    argv = sys.argv[1:] if argv is None else argv
    passed = {a.split("=", 1)[0] for a in argv if a.startswith("--")}
    for k, v in registry.TASKS[args.task].train_kw.items():
        if "--" + k.replace("_", "-") not in passed:
            setattr(args, k, v)
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
