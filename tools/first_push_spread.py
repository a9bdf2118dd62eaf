"""Spread of inserting's joint velocities under float32 rounding at a push.

Runs the dynamic episode of tests/test_torch_inserting.py (InsertingParams
with 2 substeps, B = 2, the test's contexts: a reset, a hold at each tcp,
then a 1 cm move toward the red box) through

  * the JAX package in float32: the reference the test holds the port to;
  * the JAX package in float64 (x64; the reset's state cast);
  * the JAX package in float32 with the controller's posture (``q_virt``)
    moved by one float32 ulp per joint, seeded signs (4 draws);
  * the port's plain window in float32;

and prints each run's joint velocities ``qd`` and positions ``q`` against
the float32 and float64 references after each step, max-scaled as the
tests scale them. The push's joint-velocity tolerance of
tests/test_torch_inserting.py is read from this table.

    python tools/first_push_spread.py

Each precision runs in a process of its own (x64 is process-wide).
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PERTURB = 4


def run(precision):
    """One process: the episodes of one precision, as JSON."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax
    if precision == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from d3il_tpu.envs import inserting as jinserting
    from test_torch_inserting import B, inserting_contexts
    from test_torch_jaxref import actions, np_tree, port_params
    from d3il_tpu_torch.envs import inserting
    fdt = np.float64 if precision == "f64" else np.float32
    jparams = jinserting.InsertingParams(n_substeps=2, max_steps=50)
    params = port_params(jparams, inserting.InsertingParams)
    ctx = inserting_contexts(3, B)

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(fdt) if getattr(x, "dtype", None) in (
                jnp.float32, jnp.float64) else x, tree)

    jp = cast(jparams)
    # the reset in float32 on both (the JAX reset fixes its dtype), its
    # state cast for the steps
    js0 = cast(jax.jit(jax.vmap(lambda c: jinserting.reset(jp, c)))(
        tuple(jnp.asarray(c) for c in ctx)))
    jstep = jax.jit(jax.vmap(lambda s, a: jinserting.step(jp, s, a)))
    tcp = np.asarray(jax.vmap(lambda s: jp.tcp_pose(s)[0])(js0.scene))[:, :2]
    to_box = np.asarray(js0.scene.free_pos)[:, 0, :2] - tcp
    acts = [a.astype(fdt) for a in (actions(tcp), actions(
        tcp, 0.01 * to_box / np.linalg.norm(to_box, axis=1, keepdims=True)))]

    def record(sc):
        return {k: np.asarray(getattr(sc, k), np.float64).tolist()
                for k in ("qd", "q")}

    def jax_episode(js):
        out = []
        for a in acts:
            js, _ = jstep(js, jnp.asarray(a))
            out.append(record(np_tree(js).scene))
        return out

    runs = {"jax": jax_episode(js0)}
    if precision == "f64":
        return runs
    rng = np.random.default_rng(0)
    for k in range(N_PERTURB):
        qv = np.asarray(js0.ctrl.q_virt)
        qv = qv + rng.choice([-1, 1], qv.shape) * np.spacing(qv)
        runs[f"jax_q_virt_1ulp_{k}"] = jax_episode(js0._replace(
            ctrl=js0.ctrl._replace(q_virt=jnp.asarray(qv))))
    import torch
    state = inserting.reset(params, tuple(torch.from_numpy(c) for c in ctx))
    out = []
    for a in acts:
        state, _ = inserting.step(params, state, torch.from_numpy(a))
        out.append(record(state.scene))
    runs["port"] = out
    return runs


def scaled(a, ref):
    """max |a - ref| / max(|ref|max, 1): the tests' scaled error."""
    import numpy as np
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1.0)


def main():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {p: subprocess.Popen([sys.executable, __file__, "--run", p],
                                 stdout=subprocess.PIPE, env=env, text=True)
             for p in ("f32", "f64")}
    res = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key} run failed ({proc.returncode})")
        res[key] = json.loads(out.strip().splitlines()[-1])
    f32, f64 = res["f32"], res["f64"]
    print("step  run                 qd vs f32   qd vs f64   q vs f64")
    for i, step in enumerate(("hold", "push")):
        for name, ep in f32.items():
            r = ep[i]
            print(f"{step:<5} {name:<19} "
                  f"{scaled(r['qd'], f32['jax'][i]['qd']):.3e}   "
                  f"{scaled(r['qd'], f64['jax'][i]['qd']):.3e}   "
                  f"{scaled(r['q'], f64['jax'][i]['q']):.3e}")


if __name__ == "__main__":
    if "--run" in sys.argv:
        print(json.dumps(run(sys.argv[sys.argv.index("--run") + 1])))
    else:
        main()
