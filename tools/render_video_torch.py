"""Render an episode to an animated GIF with the PyTorch port.

  python tools/render_video_torch.py --task pushing --out build/pushing.gif
  python tools/render_video_torch.py --task pushing --ckpt build/pu.pt \
      --out build/policy.gif
  python tools/render_video_torch.py --task sorting_2 --device cpu \
      --res 64 --max-frames 20 --out build/s2.gif

Counterpart of tools/render_video.py. Without --ckpt it replays the first
training demonstration of <data>/<task>: each frame is the bp camera's
view of a recorded observation (vision/taskviews.make_render_obs), all
frames rendered in one batch. With --ckpt (a run_train_torch.py
checkpoint, loaded by run_eval_torch.load_agent) the policy rolls out one
episode from the first context of the task's evaluation set through the
task's Cartesian-delta stepper, under full arm dynamics, and every
--every-th step is rendered. Tasks with a camera view: avoiding, pushing,
aligning, sorting_2/4/6. Runs on the GPU unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from d3il_tpu_torch import registry  # noqa: E402
from d3il_tpu_torch.envs.common import resolve_device  # noqa: E402
from d3il_tpu_torch.vision import taskviews  # noqa: E402


def to_uint8(bp) -> np.ndarray:
    """Rendered images in [0, 1] -> uint8 frames [n, res, res, 3]."""
    return (bp * 255).to(torch.uint8).cpu().numpy()


def write_gif(frames, path, fps=20):
    """frames [n, H, W, 3] uint8 -> an animated GIF at ``path``."""
    from PIL import Image
    imgs = [Image.fromarray(np.asarray(f)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    print(f"wrote {path}: {len(imgs)} frames {imgs[0].size}")


def demo_frames(task, data="data", res=192, every=2, max_frames=200,
                device=None):
    """Frames of the first training demonstration's observations, every
    ``every``-th step, at most ``max_frames``."""
    device = resolve_device(device)
    task_dir = os.path.join(data, task)
    with open(os.path.join(task_dir, "train_files.pkl"), "rb") as f:
        fn = pickle.load(f)[0]
    with open(os.path.join(task_dir, "all_data", fn), "rb") as f:
        ep = pickle.load(f)
    obs, _ = registry.TASKS[task].assemble(ep)
    obs = np.asarray(obs, np.float32)[:max_frames * every:every]
    render = taskviews.make_render_obs(task, res=res)
    bp, _, _ = render(torch.as_tensor(obs, device=device))
    return to_uint8(bp)


def policy_frames(ckpt, res=192, every=2, max_frames=200, device=None):
    """Frames of one policy episode from the first evaluation context of
    the checkpoint's task, every ``every``-th step."""
    import run_eval_torch
    from d3il_tpu_torch.eval import rollout
    device = resolve_device(device)
    spec, agent, _ = run_eval_torch.load_agent(ckpt, device)
    env = spec.env()
    sim = spec.make_sim(seed=0, n_contexts=1, n_trajectories_per_context=1)
    T = min(spec.max_steps, max_frames * every)
    params = spec.make_params(max_steps=T, device=device)
    init, body = rollout.make_rod_stepper(
        params, env.reset, env.step, env.get_observation,
        agent.policy_apply(torch.Generator(device=device).manual_seed(1)),
        pos_dim=sim.pos_dim)
    ctx = tuple(x[:1] for x in sim.contexts(params))
    render = taskviews.make_render_obs(spec.name, res=res)
    carry = init(agent.init_carry(sim.obs_dim(), 1), ctx)
    frames = []
    with torch.no_grad():
        for t in range(T):
            carry = body(agent.params, carry)
            if t % every == 0:
                obs = env.get_observation(params, carry[0])
                # the policy's view: the previous absolute action first
                bp, _, _ = render(torch.cat([carry[2], obs], dim=1))
                frames.append(to_uint8(bp)[0])
    return np.stack(frames[:max_frames])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="pushing",
                    choices=taskviews.VISION_TASKS)
    ap.add_argument("--data", default="data")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default="build/episode.gif")
    ap.add_argument("--res", type=int, default=192)
    ap.add_argument("--every", type=int, default=2,
                    help="render every Nth env step")
    ap.add_argument("--max-frames", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    if args.ckpt:
        frames = policy_frames(args.ckpt, args.res, args.every,
                               args.max_frames, args.device)
    else:
        frames = demo_frames(args.task, args.data, args.res, args.every,
                             args.max_frames, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_gif(frames, args.out)
    return frames


if __name__ == "__main__":
    main()
