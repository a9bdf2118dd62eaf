"""Spread of avoiding's contact forces under float32 rounding.

Runs the episode of tests/test_torch_avoiding.py (AvoidingParams with 2
substeps, B = 3, env 0's rod ~5 mm inside the first obstacle, a hold at each
tcp and then a 1 cm move in +y) through

  * the JAX package in float32: the reference the test holds the port to;
  * the JAX package in float64 (x64; its params and state cast);
  * the JAX package in float32 with env 0's joints moved by seeded
    2e-7 rad steps, the size of float32 rounding at 1 rad (4 draws);
  * the port's plain window in float32;

in both modes, and prints each run's contact forces (``warm``) and joint
positions against the float32 and float64 references after each step,
max-scaled as the tests scale them. The contact-force tolerance of
tests/test_torch_avoiding.py is read from this table.

    python tools/avoiding_warm_spread.py

Each (precision, mode) runs in a process of its own (x64 is process-wide).
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3
N_PERTURB = 4


def run(precision, kinematic):
    """One process: the episodes of one precision and mode, as JSON."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax
    if precision == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from chip_smoke import avoiding_contact_posture
    from d3il_tpu.envs import avoiding as javoiding
    from test_torch_jaxref import HOLD_QUAT, np_tree, port_params
    from d3il_tpu_torch.envs import avoiding
    fdt = np.float64 if precision == "f64" else np.float32
    jparams = javoiding.AvoidingParams(n_substeps=2, max_steps=50,
                                       kinematic=kinematic)
    params = port_params(jparams, avoiding.AvoidingParams)
    qc = avoiding_contact_posture(params).astype(np.float32)

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda x: x.astype(fdt) if getattr(x, "dtype", None) in (
                jnp.float32, jnp.float64) else x, tree)

    jp = cast(jparams)
    jreset = jax.jit(jax.vmap(lambda _: javoiding.reset(jp)))
    jstep = jax.jit(jax.vmap(lambda s, a: javoiding.step(jp, s, a)))

    def actions(tcp):
        hold = np.concatenate([tcp, np.tile(HOLD_QUAT, (B, 1))], 1)
        return [a.astype(fdt) for a in
                (hold, hold + np.array([0.0, 0.01, 0, 0, 0, 0, 0]))]

    def jax_episode(delta):
        js = jreset(jnp.zeros(B))
        q = np.asarray(js.scene.q).copy()
        q[0, :7] = qc + delta
        qv = np.asarray(js.ctrl.q_virt).copy()
        qv[0] = qc
        js = cast(js._replace(scene=js.scene._replace(q=jnp.asarray(q)),
                              ctrl=js.ctrl._replace(q_virt=jnp.asarray(qv))))
        tcp = np.asarray(jax.vmap(lambda s: jp.tcp_pose(s)[0])(js.scene))
        out = []
        for a in actions(tcp):
            js, _ = jstep(js, jnp.asarray(a))
            sc = np_tree(js).scene
            out.append({k: np.asarray(getattr(sc, k), np.float64).tolist()
                        for k in ("warm", "q")})
        return out

    runs = {"jax": jax_episode(np.zeros(7, np.float32))}
    if precision == "f64":
        return runs
    rng = np.random.default_rng(0)
    for k in range(N_PERTURB):
        runs[f"jax_perturbed_{k}"] = jax_episode(
            (2e-7 * rng.standard_normal(7)).astype(np.float32))
    import torch
    from d3il_tpu_torch import convert
    state = avoiding.reset(params, avoiding.empty_context(B))
    q = state.scene.q.numpy().copy()
    q[0, :7] = qc
    qv = state.ctrl.q_virt.numpy().copy()
    qv[0] = qc
    state = state._replace(
        scene=state.scene._replace(q=torch.from_numpy(q)),
        ctrl=state.ctrl._replace(q_virt=torch.from_numpy(qv)))
    out = []
    for a in actions(params.tcp_pose(state.scene)[0].numpy()):
        state, _ = avoiding.step(params, state, torch.from_numpy(a))
        sc = convert.state_to_numpy(state)["scene"]
        out.append({k: np.asarray(sc[k], np.float64).tolist()
                    for k in ("warm", "q")})
    runs["port"] = out
    return runs


def scaled(a, ref):
    """max |a - ref| / max(|ref|max, 1): the tests' scaled error."""
    import numpy as np
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1.0)


def main():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {(p, kin): subprocess.Popen(
        [sys.executable, __file__, "--run", p] + (["--kinematic"] * kin),
        stdout=subprocess.PIPE, env=env, text=True)
        for p in ("f32", "f64") for kin in (False, True)}
    res = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key} run failed ({proc.returncode})")
        res[key] = json.loads(out.strip().splitlines()[-1])
    print("mode       step  run                 warm vs f32  warm vs f64"
          "  q vs f64")
    for kin in (False, True):
        f32, f64 = res[("f32", kin)], res[("f64", kin)]
        for i in range(2):
            for name, ep in f32.items():
                r = ep[i]
                print(f"{'kinematic' if kin else 'dynamic':<10} {i + 1:<5} "
                      f"{name:<19} {scaled(r['warm'], f32['jax'][i]['warm']):.3e}"
                      f"    {scaled(r['warm'], f64['jax'][i]['warm']):.3e}"
                      f"    {scaled(r['q'], f64['jax'][i]['q']):.3e}")


if __name__ == "__main__":
    if "--run" in sys.argv:
        print(json.dumps(run(sys.argv[sys.argv.index("--run") + 1],
                             "--kinematic" in sys.argv)))
    else:
        main()
