"""The training protocol of tests/test_e2e_avoiding.py on both packages,
seed by seed, with both sets of weights scored in the port's window.

    python tools/avoiding_protocol_torch.py train-jax --seeds 0-19 --out build/avproto
    python tools/avoiding_protocol_torch.py train-port --seeds 0-19 --out build/avproto
    python tools/avoiding_protocol_torch.py eval --out build/avproto
    python tools/avoiding_protocol_torch.py table --out build/avproto
    python tools/avoiding_protocol_torch.py chaos

The protocol (``tests/test_e2e_avoiding.py:30-47``): data/avoiding's
training split at the task's 250 steps, window 1, no validation; the
scaler fitted on it; the registry's gmm at its defaults; 60 epochs at batch
512; the final weights. Seed s initialises the agent from seed 2s and
trains from seed 2s + 1, so seed 0 is the test's PRNGKey(0) / PRNGKey(1).

``train-jax`` trains with the JAX package on the CPU and writes each
seed's weights as a checkpoint of the port (``jax_s<seed>.pt``, through
``convert``, as tools/jax_ckpt_to_torch.py does); ``train-port`` trains
with the port (``port_s<seed>.pt``; the card unless ``--device cpu``).
``eval`` scores every checkpoint in ``--out`` in the port's window at full
arm dynamics: AvoidingSim's 480 episodes of 250 steps each, all of them in
one batched rollout of (checkpoints x 480) rows, block i under checkpoint
i's weights with the policy noise of AvoidingSim(seed=s)
(``sims.policy_generator``), one generator per block. It writes ``eval.json``; ``table`` prints the
per-seed table, the tallies against the test's bars (success >= 0.35,
entropy >= 0.05) and Fisher's exact p of each tally, port against JAX.
``chaos`` (the CPU) shows how far one ulp carries in float32 training,
through each package's own ``fit``.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DATA = os.path.join(ROOT, "data", "avoiding")
EPOCHS, BATCH, EPISODES = 60, 512, 480
BARS = {"success_rate": 0.35, "entropy": 0.05}
META = {"task": "avoiding", "agent": "gmm", "window": 1, "hidden": 256,
        "layers": 4, "chunk": 8, "ddpm_steps": 16, "agent_extra": {},
        "scale_data": True}


def seeds(text: str) -> list:
    """"0-19" or "0,3,5" -> a list of ints."""
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(x) for x in text.split(",")]


def train_files():
    with open(os.path.join(DATA, "train_files.pkl"), "rb") as f:
        return pickle.load(f)


def save(path, seed, params, scaler):
    """A checkpoint that run_eval_torch.load_agent reads; ``scaler`` is
    either package's."""
    import torch
    from d3il_tpu_torch.agents import base
    f32 = lambda v: (v.detach().to("cpu", torch.float32) if torch.is_tensor(v)
                     else torch.as_tensor(np.array(v, np.float32)))
    base.save_checkpoint(path, params, extra={
        "meta": dict(META, seed=seed),
        "scaler": {k: f32(v) for k, v in scaler._asdict().items()
                   if k != "scale_data"}})


def train_jax(seed: int, out: str):
    import jax
    from d3il_tpu import registry
    from d3il_tpu.agents import base as jbase
    from d3il_tpu.data import dataset as jds
    from d3il_tpu.data.scaler import Scaler
    from d3il_tpu_torch import convert
    spec = registry.TASKS["avoiding"]
    data = jds.load_task_dataset(os.path.join(DATA, "all_data"),
                                 train_files(), spec.assemble,
                                 spec.max_steps, 1)
    x, y = jds.all_valid(data)
    scaler = Scaler.fit(x, y)
    agent, _ = registry.make_agent("gmm", jax.random.PRNGKey(2 * seed), 4, 2,
                                   scaler)
    cfg = jbase.TrainConfig(epochs=EPOCHS, batch_size=BATCH, window_size=1,
                            eval_every_n_epochs=100)
    _, final, hist = jbase.fit(agent.loss_fn(), agent.params, data, None,
                               cfg, jax.random.PRNGKey(2 * seed + 1))
    params = convert.agent_params_from_numpy(
        "gmm", jax.tree_util.tree_map(np.asarray, final), device="cpu")
    save(os.path.join(out, f"jax_s{seed}.pt"), seed, params, scaler)
    return hist[-1]["train_loss"]


def train_port(seed: int, out: str, device):
    import torch
    from d3il_tpu_torch import registry
    from d3il_tpu_torch.agents import base
    from d3il_tpu_torch.data import dataset as ds
    from d3il_tpu_torch.data.scaler import Scaler
    spec = registry.TASKS["avoiding"]
    data = ds.load_task_dataset(os.path.join(DATA, "all_data"),
                                train_files(), spec.assemble,
                                spec.max_steps, 1, device=device)
    x, y = ds.all_valid(data)
    scaler = Scaler.fit(x, y, device=device)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    agent, _ = registry.make_agent("gmm", gen(2 * seed), 4, 2, scaler)
    cfg = base.TrainConfig(epochs=EPOCHS, batch_size=BATCH, window_size=1,
                           eval_every_n_epochs=100)
    _, final, hist = base.fit(agent.loss_fn(), agent.params, data, None,
                              cfg, gen(2 * seed + 1))
    save(os.path.join(out, f"port_s{seed}.pt"), seed, final, scaler)
    return hist[-1]["train_loss"]


def evaluate(out: str, device, episodes=EPISODES, max_steps=None):
    """Every checkpoint of ``out`` in one batched rollout (see the module
    docstring); returns one row per checkpoint. ``episodes`` and
    ``max_steps`` cut the rollout for a rehearsal on the CPU."""
    import torch
    import run_eval_torch
    from d3il_tpu_torch.envs import avoiding
    from d3il_tpu_torch.eval import rollout, sims
    from d3il_tpu_torch.parallel import mesh as pmesh
    names = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
    agents = [run_eval_torch.load_agent(os.path.join(out, f), device)
              for f in names]
    params = sims.avoiding_params(device=device)      # full dynamics, 250
    if max_steps:
        params.max_steps = max_steps
    n = len(agents) * episodes
    blocks = [slice(i * episodes, (i + 1) * episodes)
              for i in range(len(agents))]
    applies = [a.policy_apply(sims.policy_generator(int(meta["seed"]),
                                                    device))
               for _, a, meta in agents]

    def policy(_, carry, obs):
        parts = [apply(a.params, pmesh.tree_map(lambda x: x[b], carry),
                       obs[b])
                 for apply, (_, a, _), b in zip(applies, agents, blocks)]
        return (_cat([c for c, _ in parts]),
                torch.cat([act for _, act in parts]))

    run = rollout.make_rod_rollout(params, avoiding.reset, avoiding.step,
                                   avoiding.get_observation, policy)
    carry0 = _cat([a.init_carry(4, episodes) for _, a, _ in agents])
    t0 = time.perf_counter()
    state, _ = run(None, carry0, avoiding.empty_context(n, device))
    if state.t.is_cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sim = sims.AvoidingSim()
    rows = []
    for f, (_, _, meta), b in zip(names, agents, blocks):
        score = sim.score(pmesh.tree_map(lambda x: x[b], state))
        rows.append({"side": f.split("_")[0], "seed": int(meta["seed"]),
                     **score})
    return rows, seconds


def _cat(carries):
    """Row-wise concatenation of like-shaped policy carries."""
    import torch
    from d3il_tpu_torch.parallel import mesh as pmesh
    joined = iter([torch.cat(xs) for xs in
                   zip(*[pmesh.tree_leaves(c) for c in carries])])
    return pmesh.tree_map(lambda _: next(joined), carries[0])


def chaos(steps: int = 32):
    """How far one ulp carries in float32 training (the CPU, both
    packages): ``steps`` one-step epochs of each package's ``fit`` from
    seed 0's JAX weights, the port's fed the minibatches that the JAX
    ``fit`` draws from PRNGKey(1); the port against the JAX package, and
    each against itself started from weights moved by one ulp
    (x (1 +- 6e-8)). Prints the relative loss difference at every step and
    the largest weight difference."""
    from unittest import mock
    import jax
    import torch
    from d3il_tpu import registry as jregistry
    from d3il_tpu.agents import base as jbase
    from d3il_tpu.data import dataset as jds
    from d3il_tpu.data.scaler import Scaler as JScaler
    from d3il_tpu_torch import convert, registry
    from d3il_tpu_torch.agents import base
    from d3il_tpu_torch.data import dataset as ds
    spec = jregistry.TASKS["avoiding"]
    data = jds.load_task_dataset(os.path.join(DATA, "all_data"),
                                 train_files(), spec.assemble,
                                 spec.max_steps, 1)
    jagent, _ = jregistry.make_agent("gmm", jax.random.PRNGKey(0), 4, 2,
                                     JScaler.fit(*jds.all_valid(data)))
    agent, _ = registry.make_agent(
        "gmm", torch.Generator().manual_seed(0), 4, 2,
        convert.scaler_from_numpy(jagent.scaler, "cpu"))
    kw = dict(epochs=steps, batch_size=BATCH, window_size=1,
              steps_per_epoch=1, eval_every_n_epochs=steps + 1)
    # the minibatches of the JAX fit below, as it splits its key
    key, windows = jax.random.PRNGKey(1), []
    for _ in range(steps):
        key, k1, _ = jax.random.split(key, 3)
        k = jax.random.split(jax.random.split(k1, 1)[0])[0]
        windows.append([torch.from_numpy(np.asarray(x)) for x in
                        jds.sample_windows(data, k, BATCH, 1)])
    numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)

    def jax_run(p):
        _, final, hist = jbase.fit(jagent.loss_fn(), p, data, None,
                                   jbase.TrainConfig(**kw),
                                   jax.random.PRNGKey(1))
        return (convert.agent_params_from_numpy("gmm", numpy(final), "cpu"),
                [h["train_loss"] for h in hist])

    def port_run(p):
        queue = iter(windows)
        with mock.patch.object(ds, "sample_windows",
                               lambda *_: next(queue)):
            _, final, hist = base.fit(
                agent.loss_fn(),
                convert.agent_params_from_numpy("gmm", p, "cpu"), None,
                None, base.TrainConfig(**kw), torch.Generator())
        return final, [h["train_loss"] for h in hist]

    def ulp(tree, seed):
        rng = np.random.default_rng(seed)
        return jax.tree_util.tree_map(lambda x: (x * (
            1 + 6e-8 * rng.choice([-1.0, 1.0], np.shape(x)))).astype(
                np.float32), tree)

    p0 = numpy(jagent.params)
    runs = {"jax": jax_run(p0), "jax_ulp": jax_run(ulp(p0, 1)),
            "port": port_run(p0), "port_ulp": port_run(ulp(p0, 2))}
    for a, b in (("port", "jax"), ("jax_ulp", "jax"), ("port_ulp", "port")):
        (wa, la), (wb, lb) = runs[a], runs[b]
        rel = np.abs(np.subtract(la, lb)) / np.abs(lb)
        print(json.dumps({"pair": f"{a} vs {b}", "loss_rel_per_step":
                          [float(f"{r:.3g}") for r in rel],
                          "max_weight_diff": max(
                              (wa[k] - wb[k]).abs().max().item()
                              for k in wa)}))


def table(rows):
    from scipy.stats import fisher_exact
    by = {(r["side"], r["seed"]): r for r in rows}
    ss = sorted({r["seed"] for r in rows})
    lines = ["| seed | port success | port entropy | JAX success | "
             "JAX entropy |", "| --- | --- | --- | --- | --- |"]
    for s in ss:
        p, j = by.get(("port", s), {}), by.get(("jax", s), {})
        lines.append(f"| {s} | {p.get('success_rate', float('nan')):.4f} | "
                     f"{p.get('entropy', float('nan')):.4f} | "
                     f"{j.get('success_rate', float('nan')):.4f} | "
                     f"{j.get('entropy', float('nan')):.4f} |")
    tests = {"success": lambda r: r["success_rate"] >= BARS["success_rate"],
             "entropy": lambda r: r["entropy"] >= BARS["entropy"],
             "both": lambda r: (r["success_rate"] >= BARS["success_rate"]
                                and r["entropy"] >= BARS["entropy"])}
    lines.append("")
    for name, ok in tests.items():
        tally = {}
        for side in ("port", "jax"):
            rs = [by[(side, s)] for s in ss if (side, s) in by]
            tally[side] = (sum(ok(r) for r in rs), len(rs))
        (a, na), (b, nb) = tally["port"], tally["jax"]
        p = fisher_exact([[a, na - a], [b, nb - b]])[1]
        lines.append(f"{name}: port {a} of {na}, JAX {b} of {nb}, Fisher's "
                     f"exact p (two-sided) {p:.4f}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("train-jax", "train-port", "eval",
                                     "table", "chaos"))
    ap.add_argument("--seeds", default="0-19")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "avproto"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--episodes", type=int, default=EPISODES)
    ap.add_argument("--eval-max-steps", type=int, default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.what in ("train-jax", "train-port"):
        for s in seeds(args.seeds):
            t0 = time.perf_counter()
            loss = (train_jax(s, args.out) if args.what == "train-jax"
                    else train_port(s, args.out, args.device))
            print(json.dumps({"what": args.what, "seed": s,
                              "final_train_loss": float(loss),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    elif args.what == "eval":
        rows, seconds = evaluate(args.out, args.device, args.episodes,
                                 args.eval_max_steps)
        with open(os.path.join(args.out, "eval.json"), "w") as f:
            json.dump({"rows": rows, "rollout_seconds": seconds}, f, indent=1)
        for r in rows:
            print(json.dumps(r))
        print(f"rollout of {len(rows)} x {args.episodes} episodes: "
              f"{seconds:.1f} s")
    elif args.what == "chaos":
        chaos()
    else:
        with open(os.path.join(args.out, "eval.json")) as f:
            print(table(json.load(f)["rows"]))


if __name__ == "__main__":
    main()
