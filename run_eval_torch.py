"""Evaluate a trained checkpoint of the PyTorch port without retraining.

  python run_eval_torch.py --ckpt ckpts/pushing_bc.pt --n-contexts 30 --n-trajs 16

Counterpart of run_eval.py for d3il_tpu_torch: loads the checkpoint written
by run_train_torch.py --ckpt (params + scaler statistics + agent
hyperparameters), rebuilds the agent, and runs the batched on-device
evaluation sim. Runs on the GPU unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from d3il_tpu_torch import registry  # noqa: E402
from d3il_tpu_torch.agents import base as agent_base  # noqa: E402
from d3il_tpu_torch.data.scaler import Scaler  # noqa: E402
from d3il_tpu_torch.envs.common import resolve_device  # noqa: E402
import run_train_torch  # noqa: E402


def load_agent(ckpt_path: str, device=None):
    """Rebuild the trained agent from a run_train_torch.py checkpoint."""
    device = resolve_device(device)
    ck = agent_base.load_checkpoint(ckpt_path, device=device)
    meta = ck["meta"]
    scaler = Scaler(scale_data=bool(meta["scale_data"]), **ck["scaler"])
    spec = registry.TASKS[meta["task"]]
    kw = run_train_torch.agent_kwargs(
        meta["agent"], int(meta["window"]), int(meta["hidden"]),
        int(meta["layers"]), int(meta.get("chunk", 8)),
        int(meta.get("ddpm_steps", 16)))
    # the per-(task, agent) overrides the run trained with (e.g. the
    # transformer backbone of pushing's beso)
    kw.update(meta.get("agent_extra", {}))
    kw.update(run_train_torch.vision_kwargs(meta["task"], meta["agent"]))
    centers = ck.get("centers")
    agent, _ = registry.make_agent(
        meta["agent"], torch.Generator(device=device).manual_seed(0),
        spec.obs_dim, spec.act_dim, scaler, centers, **kw)
    agent.params = ck["params"]
    if centers is not None:
        # the stored bins verbatim: a k-means refit over them returns the
        # same set in another order, which the trained heads do not match
        agent.centers = centers
    return spec, agent, meta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--n-contexts", type=int, default=None)
    ap.add_argument("--n-trajs", type=int, default=None)
    ap.add_argument("--eval-max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kinematic", action="store_true", default=False)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args()

    spec, agent, meta = load_agent(args.ckpt, args.device)
    tk = spec.train_kw
    eargs = argparse.Namespace(
        kinematic=args.kinematic, eval_max_steps=args.eval_max_steps,
        seed=args.seed, device=args.device,
        n_contexts=args.n_contexts or tk.get("n_contexts", 15),
        n_trajs=args.n_trajs or tk.get("n_trajs", 8))
    out = run_train_torch.evaluate(spec, agent, eargs)
    print(json.dumps({"task": meta["task"], "agent": meta["agent"],
                      "seed": int(meta["seed"]), **out}))


if __name__ == "__main__":
    main()
