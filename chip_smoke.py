#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (d3il_tpu_torch).

Run from the repo root on a machine with one NVIDIA GPU and the CUDA
toolkit: ``python3 chip_smoke.py``. Imports nothing of JAX or d3il_tpu.

Phases (each fatal on failure):
  1. device check; build the kernels from csrc/ (one nvcc per source, in
     parallel) and print the build seconds and ptxas register/spill lines;
  2. hold each kernel (K1 ik_window, K2 arm_stage, K3 contact phase)
     against its plain PyTorch version on the card, at main-path shapes:
     B = 8192 envs, a 35-substep window, the pushing scene, inputs from a
     real reset + 2 steps; print the scaled errors against the tolerances
     and the median kernel / plain times (CUDA events, after warm-up);
  3. drive the main path: PushingParams() at full width, reset of 8192
     seeded contexts, 20 hold steps then 20 steps pushing toward the red
     box; check the state, the resting boxes, the tcp tracking and that
     each kernel's launch count matches the window structure; print
     env-steps/s with the card's name and power limit;
  4. print the ``kernels`` JSON line, the card line, and last
     {"ok": true, "device": {...}}.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 8192
HOLD_STEPS = PUSH_STEPS = 20
PEAK_FP32_FLOPS = 67e12     # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of fn() (after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def count_ops(fn, *args):
    """Floating-point operations the plain version performs on these
    inputs: numel of every arithmetic op's result (of its input for
    reductions), 2 m n k for matrix products; data movement counts 0."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    move = {"view", "_unsafe_view", "expand", "permute", "transpose", "t",
            "select", "slice", "unsqueeze", "squeeze", "as_strided",
            "reshape", "alias", "detach", "clone", "copy_", "_to_copy",
            "cat", "stack", "empty", "zeros", "ones", "full", "zeros_like",
            "ones_like", "full_like", "empty_like", "new_zeros", "new_ones",
            "new_empty", "new_full", "scalar_tensor", "lift_fresh", "index",
            "gather", "scatter", "unbind", "split", "repeat_interleave",
            "contiguous", "lift_fresh_copy", "_local_scalar_dense",
            "fill_", "zero_", "movedim", "split_with_sizes", "index_select",
            "repeat", "new_empty_strided", "empty_strided", "eye",
            "arange", "linspace", "_to_dim_order_copy", "slice_scatter",
            "select_scatter", "unfold", "diagonal", "flip", "roll"}
    reduce_ = {"sum", "amin", "amax", "mean", "linalg_vector_norm", "max",
               "min", "prod"}

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("mm", "bmm", "addmm", "baddbmm"):
                a, b2 = args[-2], args[-1]
                Counter.ops += 2 * a.numel() * b2.shape[-1]
            elif name in move:
                pass
            elif name in reduce_:
                Counter.ops += args[0].numel()
            else:
                outs = out if isinstance(out, (tuple, list)) else [out]
                Counter.ops += sum(o.numel() for o in outs
                                   if isinstance(o, torch.Tensor)
                                   and o.is_floating_point())
            return out

    with Counter():
        fn(*args)
    return Counter.ops


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def hold_action(tcp):
    """bench.py's hold action: the tcp's xy, z 0.12, the rod pointing down."""
    import torch
    down = torch.tensor([0.0, 1.0, 0.0, 0.0], device=tcp.device)
    return torch.cat([tcp[:, :2], torch.full_like(tcp[:, :1], 0.12),
                      down.expand(tcp.shape[0], 4)], dim=1)


def push_action(state, hold):
    """The hold action moved onto the red box's xy."""
    import torch
    return torch.cat([state.scene.free_pos[:, 0, :2], hold[:, 2:]], dim=1)


def profile_step(params, state, hold):
    """One push step under torch.profiler: device busy time against the
    step's wall time, launches by kind, and the kernels that take the most
    device time. Prints "not measured" when the trace has no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from d3il_tpu_torch.envs import pushing
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pushing.step(params, state, push_action(state, hold))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    if not dev or busy_us <= 0:
        log("profile: not measured (the trace holds no device time)")
        return
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    memcpy = sum(n for name, (n, _) in by_name.items()
                 if "memcpy" in name.lower())
    log(f"profile of one push step: wall {wall_us / 1e3:.1f} ms (profiler "
        f"on), device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.1%}), "
        f"{len(dev)} device activities of which {memcpy} memcpy")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, t) in top:
        log(f"  {t / 1e3:9.3f} ms {n:6d}x  {name[:90]}")


def scaled_err(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / max(b.abs().max().item(), 1.0)).item()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from d3il_tpu_torch.engine import (contact_kernel, dyn_kernel,
                                       substep_bm)
    from d3il_tpu_torch.envs import pushing
    from d3il_tpu_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    took = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + json.dumps({k: round(v, 1) for k, v in took.items()}))
    for name in build.SOURCES:
        logf = build.lib_path(name).with_suffix(".log")
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # ---- phase 2: kernels vs plain at main-path shapes ------------------
    t0 = time.perf_counter()
    params = pushing.PushingParams()            # 35 substeps, 25 iterations
    torch.cuda.synchronize()
    log(f"params: {time.perf_counter() - t0:.1f} s (offline IK + null-space "
        f"convergence), q_init {params.q_init.round(4).tolist()}")
    st = params.statics
    gen = torch.Generator(device=dev).manual_seed(0)
    state = pushing.reset(params, pushing.sample_context(gen, B))
    tcp, _ = params.tcp_pose(state.scene)
    hold = hold_action(tcp)
    for _ in range(2):
        state, _ = pushing.step(params, state, hold)
    torch.cuda.synchronize()

    # K1 gets the push setpoint (the red box), far from the converged hold
    # posture, so that every DLS iteration does work
    push = push_action(state, hold)
    sb = substep_bm.scene_to_bm(state.scene)
    bm = lambda x: torch.movedim(x, 0, -1).contiguous()
    k1_in = (bm(state.ctrl.q_virt), bm(state.ctrl.old_des_vel),
             bm(push[:, :3]), bm(push[:, 3:]))
    n_sub = params.n_substeps
    k1_out = dyn_kernel.ik_window_bm(st.ik, n_sub, *k1_in)
    sw = torch.full((B,), 0.04, device=dev)
    gf = torch.zeros(B, dtype=torch.bool, device=dev)
    k2_in = (sb.q, sb.qd, k1_out[2][0], k1_out[3][0], k1_out[4][0], sw, gf)
    k2_out = dyn_kernel.arm_stage_bm(st.arm, *k2_in)
    k3_in = substep_bm.contact_inputs(st, sb, k2_out)
    k3_out = contact_kernel.phase_batched_bm(st.contact, *k3_in)
    torch.cuda.synchronize()

    kernels = [
        dict(name="ik_window", key="K1", route="cuda",
             source="d3il_tpu_torch/csrc/dyn_kernel.cu",
             replaces="d3il_tpu/engine/dyn_kernel.py:230",
             run=lambda: dyn_kernel.ik_window_bm(st.ik, n_sub, *k1_in),
             plain=lambda: dyn_kernel.ik_window_plain(st.ik, n_sub, *k1_in),
             ins=k1_in, out=k1_out, reps=(5, 1),
             names=("q_virt", "old_vel", "q_des", "qd_des", "tau_model"),
             # test_dyn_kernel.py:148-156, but tau_model 2e-2 instead of
             # 2e-3: that test runs 2 substeps; over 35, float32 rounding
             # in q_des reaches qdd_des = ddg (dq/dt - old_vel)/dt times
             # 1/dt^2 = 1e6, and the plain version alone differs from its
             # own float64 run by ~7e-3 scaled (printed below as "floor")
             tols=(3e-5, 3e-2, 3e-5, 3e-2, 2e-2),
             f64=lambda: dyn_kernel.ik_window_plain(
                 st.ik, n_sub, *(x.double() for x in k1_in))),
        dict(name="arm_stage", key="K2", route="cuda",
             source="d3il_tpu_torch/csrc/dyn_kernel.cu",
             replaces="d3il_tpu/engine/dyn_kernel.py:165",
             run=lambda: dyn_kernel.arm_stage_bm(st.arm, *k2_in),
             plain=lambda: dyn_kernel.arm_stage_plain(
                 st.arm, *k2_in[:6], k2_in[6].to(torch.float32)),
             ins=k2_in, out=k2_out, reps=(20, 3),
             names=("xpos", "xquat", "axes", "anchors", "Minv", "qd_pre",
                    "a_arm"),
             # test_dyn_kernel.py:73-79
             tols=(1e-5, 1e-5, 1e-5, 1e-5, 3e-4, 1e-3, 1e-3)),
        dict(name="contact_phase", key="K3", route="cuda",
             source="d3il_tpu_torch/csrc/contact_kernel.cu",
             replaces="d3il_tpu/engine/contact_kernel.py:345",
             run=lambda: contact_kernel.phase_batched_bm(st.contact, *k3_in),
             plain=lambda: contact_kernel.phase_plain(st.meta, *k3_in),
             ins=k3_in, out=k3_out, reps=(20, 3), names=("f", "qfrc"),
             # test_contact_kernel.py:116-117
             tols=(2e-4, 2e-4)),
    ]
    failed = []
    for k in kernels:
        ref = k["plain"]()
        torch.cuda.synchronize()
        errs = [scaled_err(a, b) for a, b in zip(k["out"], ref)]
        k["max_abs_err"] = max((a.double() - b.double()).abs().max().item()
                               for a, b in zip(k["out"], ref))
        if "f64" in k:
            floor = [scaled_err(a, b) for a, b in zip(ref, k["f64"]())]
            log(f"{k['key']} {k['name']}: floor (plain float32 vs float64) "
                + ", ".join(f"{n} {e:.3e}" for n, e in zip(k["names"], floor)))
        for name, e, tol in zip(k["names"], errs, k["tols"]):
            ok = e <= tol
            log(f"{k['key']} {k['name']}.{name}: scaled err {e:.3e} "
                f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{k['key']}.{name}")
        k["ms"] = cuda_ms(k["run"], k["reps"][0])
        k["plain_ms"] = cuda_ms(k["plain"], k["reps"][1])
        ops = count_ops(k["plain"])
        byt = nbytes(k["ins"]) + nbytes(k["out"])
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, byt / PEAK_BYTES * 1e3
        k["bound_ms"] = max(t_ops, t_bytes)
        k["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log(f"{k['key']} {k['name']}: kernel {k['ms']:.3f} ms, plain "
            f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}: {ops:.3e} flop, {byt:.3e} B) [{card}]")
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")

    # ---- phase 3: the main path ----------------------------------------
    counters = {"K1": dyn_kernel.ik_window_bm, "K2": dyn_kernel.arm_stage_bm,
                "K3": contact_kernel.phase_batched_bm}
    for fn in counters.values():
        fn.launches = 0
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    state = pushing.reset(params, pushing.sample_context(gen, B))
    torch.cuda.synchronize()
    t_reset = time.perf_counter() - t0
    tcp0, _ = params.tcp_pose(state.scene)
    hold = hold_action(tcp0)
    t0 = time.perf_counter()
    for _ in range(HOLD_STEPS):
        state, res = pushing.step(params, state, hold)
    torch.cuda.synchronize()
    t_hold = time.perf_counter() - t0
    tcp, _ = params.tcp_pose(state.scene)
    box_z = state.scene.free_pos[..., 2]
    z_err = (box_z - 0.011).abs().max().item()
    track_err = (tcp[:, :2] - hold[:, :2]).norm(dim=1).max().item()
    red0 = state.scene.free_pos[:, 0, :2].clone()
    t0 = time.perf_counter()
    for _ in range(PUSH_STEPS):
        state, res = pushing.step(params, state, push_action(state, hold))
    torch.cuda.synchronize()
    t_push = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}

    finite = all(torch.isfinite(x).all().item() for x in
                 list(state.scene) + list(state.ctrl))
    moved = ((state.scene.free_pos[:, 0, :2] - red0).norm(dim=1)
             > 0.005).float().mean().item()
    rod_rows = state.scene.warm[:, 12:14].abs().amax(dim=(1, 2))
    rod_contact = (rod_rows > 0).float().mean().item()
    steps = HOLD_STEPS + PUSH_STEPS
    sps = B * steps / (t_hold + t_push)
    log(f"main path: reset {t_reset:.2f} s; hold {HOLD_STEPS} steps "
        f"{t_hold:.2f} s ({B * HOLD_STEPS / t_hold:.1f} env-steps/s); push "
        f"{PUSH_STEPS} steps {t_push:.2f} s "
        f"({B * PUSH_STEPS / t_push:.1f} env-steps/s)")
    log(f"main path: box z max |z - 0.011| after hold {z_err:.2e} m; tcp "
        f"xy tracking max error {track_err * 1e3:.3f} mm; red box moved "
        f">5 mm in {moved:.1%} of envs; rod-box contact force in "
        f"{rod_contact:.1%} of envs; all state finite: {finite}")
    expect = {"K1": steps, "K2": steps * params.n_substeps + 2,
              "K3": steps * params.n_substeps + 2}
    log(f"launches {launches} expected {expect}")
    log(json.dumps({"metric": "pushing_env_steps_per_s", "value": sps,
                    "unit": "env-steps/s", "batch": B, "steps": steps,
                    "card": card}))
    problems = []
    if not finite:
        problems.append("non-finite state")
    if z_err > 3e-3:
        problems.append(f"boxes not resting at z=0.011 (err {z_err:.2e})")
    if track_err > 5e-3:
        problems.append(f"tcp tracking error {track_err * 1e3:.2f} mm")
    if launches != expect:
        problems.append(f"launch counts {launches} != {expect}")
    if moved < 0.5:
        problems.append(f"the red box moved in only {moved:.1%} of envs")
    if problems:
        raise SystemExit("main path failed: " + "; ".join(problems))
    kernel_s = sum(k["ms"] * launches[k["key"]] for k in kernels) / 1e3
    log(f"main path: the three kernels' timed ms x launches = {kernel_s:.3f} "
        f"s of {t_hold + t_push:.3f} s wall "
        f"({kernel_s / (t_hold + t_push):.1%}) [{card}]")
    profile_step(params, state, hold)

    # ---- phase 4: report --------------------------------------------------
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by")
    print(json.dumps({"kernels": [
        dict({k: kk[k] for k in keys}, launches=launches[kk["key"]],
             library_ms=None) for kk in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
