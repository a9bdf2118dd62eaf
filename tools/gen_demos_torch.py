"""Generate demonstration datasets with the port's scripted experts.

Counterpart of tools/gen_demos.py for d3il_tpu_torch: the experts run
batched on the device (d3il_tpu_torch/data/experts.py), every episode of a
task in lockstep, and each successful episode is written as a reference
pickle under <out>/<task>/all_data with train/eval split files beside it.
Runs on the GPU unless --device cpu is given.

Usage:
  python tools/gen_demos_torch.py --task pushing --n 120 --out build/demos
  python tools/gen_demos_torch.py --task stacking --n 24 --out build/demos
  python tools/gen_demos_torch.py --task avoiding --n 4 --out /tmp/demos \
      --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from d3il_tpu_torch.data import gen_demos  # noqa: E402
from d3il_tpu_torch.envs.common import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True, choices=gen_demos.TASKS)
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--out", required=True,
                    help="dataset root; writes <out>/<task>/")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dynamic", type=int, default=0,
                    help="1: full-dynamics arm for the rod tasks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    task_dir = os.path.join(args.out, args.task)
    all_dir = os.path.join(task_dir, "all_data")
    files, info = gen_demos.generate(args.task, args.n, all_dir, args.seed,
                                     kinematic=not args.dynamic,
                                     device=device)
    print(f"batch of {args.n} rolled out in {info['rollout_seconds']:.1f}s, "
          f"success {info['success']:.2f}")
    split = gen_demos.write_split(task_dir, files, args.seed)
    if split is None:
        print("no successful episodes; nothing written")
    else:
        print(f"wrote {len(split[0])} train + {len(split[1])} eval episodes "
              f"to {task_dir}")
    print(json.dumps(info))


if __name__ == "__main__":
    main()
