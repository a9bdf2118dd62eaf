"""Convert a checkpoint of the JAX package's run_train.py into one that
run_eval_torch.py loads, so that one set of weights is evaluated in both
packages' windows.

    python run_train.py --task avoiding --agent gmm --epochs 60 \
        --skip-eval --ckpt build/av_jax
    python tools/jax_ckpt_to_torch.py build/av_jax build/av_jax.pt
    python run_eval_torch.py --ckpt build/av_jax.pt --n-trajs 48 --seed 1

Runs on the CPU (the JAX checkpoint is an orbax tree); the output is a
plain ``torch.save`` file, read anywhere the port runs. Every agent of
``convert.PORTED_AGENTS`` converts, the ten vision agents too (e.g.
``run_train.py --task sorting_2 --agent bc_vision``); run_eval_torch.py
rebuilds their render_fn from the task. run_vision.py's checkpoints hold
the weights alone, without the run's metadata, and do not convert.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="orbax checkpoint directory of run_train.py")
    ap.add_argument("dst", help="port checkpoint file to write")
    args = ap.parse_args()
    import torch
    from d3il_tpu.agents import base as jbase
    from d3il_tpu_torch import convert
    from d3il_tpu_torch.agents import base
    ck = jbase.load_checkpoint(args.src)
    m = ck["meta"]
    if m["agent"] not in convert.PORTED_AGENTS:
        raise SystemExit(f"convert carries the weights of "
                         f"{list(convert.PORTED_AGENTS)}, not {m['agent']}")
    params = convert.agent_params_from_numpy(
        str(m["agent"]), ck["params"], device="cpu")
    meta = {"task": str(m["task"]), "agent": str(m["agent"]),
            "seed": int(m["seed"]), "window": int(m["window"]),
            "hidden": int(m["hidden"]), "layers": int(m["layers"]),
            "chunk": int(m["chunk"]), "ddpm_steps": int(m["ddpm_steps"]),
            # e.g. pushing's beso backbone; orbax gives numbers back as
            # NumPy scalars
            "agent_extra": {str(k): v.item() if hasattr(v, "item") else v
                            for k, v in m.get("agent_extra", {}).items()},
            "scale_data": bool(m["scale_data"])}
    scaler = {k: torch.as_tensor(np.array(v, np.float32))
              for k, v in ck["scaler"].items()}
    extra = {"meta": meta, "scaler": scaler}
    if "centers" in ck:
        extra["centers"] = torch.as_tensor(np.array(ck["centers"],
                                                    np.float32))
    base.save_checkpoint(args.dst, params, extra=extra)
    print(f"wrote {args.dst}: {meta}")


if __name__ == "__main__":
    main()
