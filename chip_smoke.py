#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (d3il_tpu_torch).

Run from the repo root on a machine with one NVIDIA GPU and the CUDA
toolkit: ``python3 chip_smoke.py``. Imports nothing of JAX or d3il_tpu.

Phases (each fatal on failure):
  1. device check; build the kernels from csrc/ (one nvcc per source, in
     parallel) and print the build seconds and ptxas register/spill lines;
  2. hold each kernel (K1 ik_window, K2 arm_stage, K3 contact phase, K4
     feedforward) against its plain PyTorch version on the card, at
     main-path shapes: B = 8192 envs, a 35-substep window, the pushing
     scene, inputs from a real reset + 2 steps; K4 runs on K1's own window,
     at [7, 8192] and folded to [7, 35 * 8192], and is also held against
     K1's tau_model; print the scaled errors against the tolerances and the
     median kernel / plain times (CUDA events, after warm-up); then hold
     K1-K3 again at the evaluation path's own shapes: B = 480 (not a
     multiple of the block size), the inputs of one real substep of the
     480-episode rollout under full dynamics and one in kinematic mode
     (zero arm inverse mass, plain-FK frames, finite-difference velocity);
  3. drive the env path: PushingParams() at full width, reset of 8192
     seeded contexts, 10 hold steps then 10 steps pushing toward the red
     box; check the state, the resting boxes, the tcp tracking and that
     each kernel's launch count, read right after the last step, matches
     the window structure; print env-steps/s with the card's name and power
     limit; then launch K4 on the window of the next push step and hold it
     to K1's tau_model (counted apart from the path's launches);
  4. drive the evaluation path: train a gmm agent at the registry's defaults
     on data/pushing (100 epochs), save it, reload it, and roll out the
     reference workload of 30 contexts x 16 trajectories (480 episodes in
     lockstep) under full arm dynamics and in kinematic mode, at a cut
     horizon; check finiteness, the frozen episodes, the +-0.01 m setpoint
     clip, the metrics' range, the launch counts and that a bc rollout
     repeats exactly; print success rate, entropy, score, seconds and
     episode-steps/s;
  5. print the ``kernels`` JSON line, the card line, and last
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
HOLD_STEPS = PUSH_STEPS = 10
EVAL_CONTEXTS, EVAL_TRAJS = 30, 16      # the reference workload: 480 episodes
EVAL_STEPS_DYNAMIC, EVAL_STEPS_KINEMATIC = 100, 20   # of the task's 400
REPEAT_STEPS = 10                       # bc determinism rollouts (kinematic)
ROLLOUT_CHECK_STEPS = 6     # push steps before the B = 480 substep checks
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


def leaves(tree):
    """Tensor leaves of nested (Named)tuples."""
    import torch
    if torch.is_tensor(tree):
        return [tree]
    return [leaf for x in tree for leaf in leaves(x)]


class Watch:
    """Per-step observer of a rollout, free of host syncs: the largest
    per-axis move of the xy setpoint between steps, and whether every state
    leaf stayed finite."""

    def __init__(self, device):
        import torch
        self.prev = None
        self.max_delta = torch.zeros((), device=device)
        self.finite = torch.ones((), dtype=torch.bool, device=device)

    def __call__(self, carry):
        import torch
        state, _, pos, obs, _, _ = carry
        if self.prev is not None:
            self.max_delta = torch.maximum(self.max_delta,
                                           (pos - self.prev).abs().max())
        for x in leaves(state) + [pos, obs]:
            if x.is_floating_point():
                self.finite = self.finite & torch.isfinite(x).all()
        self.prev = pos


def eval_rollout(spec, agent, q_init, kinematic, steps, counters, card,
                 seed=0, watch=True):
    """The reference workload (30 x 16 episodes in lockstep) for ``steps``
    env steps with the kernel counts zeroed just before and read just
    after. Returns (final state, dones, metrics, launches, seconds, Watch)."""
    import torch
    params = spec.make_params(kinematic=kinematic, max_steps=steps,
                              device="cuda", q_init=q_init)
    sim = spec.make_sim(seed=seed, n_contexts=EVAL_CONTEXTS,
                        n_trajectories_per_context=EVAL_TRAJS)
    w = Watch(params.device) if watch else None
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state, dones = sim.run_episodes(agent, params, on_step=w)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    return state, dones, sim.score(state), launches, seconds, w


def profile_eval_step(spec, agent, q_init, card):
    """Where one evaluation step at B = 480 goes: host-clock times (each
    ending in a synchronize) of the policy forward and the env step against
    the whole rollout body, then the body once under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from d3il_tpu_torch.envs import pushing
    from d3il_tpu_torch.eval import rollout, sims
    params = spec.make_params(kinematic=False, max_steps=400, device="cuda",
                              q_init=q_init)
    n = EVAL_CONTEXTS * EVAL_TRAJS
    ctxs = sims._fixed_or_sampled(sims.ref_contexts.pushing_contexts,
                                  pushing.sample_context, EVAL_CONTEXTS, True,
                                  params.device)
    cidx, gen = sims._grid(EVAL_CONTEXTS, EVAL_TRAJS, 0, params.device)
    apply = agent.policy_apply(gen)
    init, body = rollout.make_rod_stepper(params, pushing.reset, pushing.step,
                                          pushing.get_observation, apply)

    def timed(fn, reps=3):
        out = fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts), out

    with torch.no_grad():
        carry = init(agent.init_carry(10, n), tuple(x[cidx] for x in ctxs))
        for _ in range(2):
            carry = body(agent.params, carry)
        state, pc, pos, obs = carry[:4]
        obs_policy = torch.cat([pos, obs], dim=1)
        t_policy, (_, delta) = timed(
            lambda: apply(agent.params, pc, obs_policy))
        action = torch.cat([pos + delta.clamp(-0.01, 0.01), carry[5],
                            torch.tensor([0.0, 1.0, 0.0, 0.0],
                                         device=pos.device).expand(n, 4)], 1)
        t_step, _ = timed(lambda: pushing.step(params, state, action))
        t_body, _ = timed(lambda: body(agent.params, carry))
        log(f"eval step at B = {n} (host clock, median of 3): rollout body "
            f"{t_body:.1f} ms = policy forward {t_policy:.2f} ms + env step "
            f"{t_step:.1f} ms + rollout glue {t_body - t_policy - t_step:.2f} "
            f"ms [{card}]")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            body(agent.params, carry)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    if not dev or busy_us <= 0:
        log("eval step profile: not measured (the trace holds no device "
            "time)")
        return
    log(f"eval step profile at B = {n}: wall {wall_us / 1e3:.1f} ms "
        f"(profiler on), device busy {busy_us / 1e3:.1f} ms "
        f"({busy_us / wall_us:.1%}), {len(dev)} device activities [{card}]")


def scaled_err(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / max(b.abs().max().item(), 1.0)).item()


def hold_kernel(k, card, failed, timed=True):
    """Hold one kernel's outputs (``k["out"]``, from its wrapper) against its
    plain version on the same inputs at the stated tolerances; with
    ``timed``, also time both and compute the bound. Failures are appended
    to ``failed``."""
    import torch
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
            failed.append(f"{k['name']}.{name}")
    if not timed:
        return
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


def rollout_substep_kernels(spec, q_init, kinematic, tols):
    """K1-K3 on the inputs of one real substep of the evaluation rollout:
    the 30 x 16 reference episodes (B = 480) are reset, pushed toward the
    red box for ROLLOUT_CHECK_STEPS env steps, and the next step's window
    and first substep are formed as run_substeps_bm forms them, through the
    wrappers. Returns the kernel records for hold_kernel (no K2 in kinematic
    mode, which does not launch it)."""
    import torch
    from d3il_tpu_torch.engine import (contact_kernel, dyn_kernel,
                                       substep_bm)
    from d3il_tpu_torch.envs import pushing
    from d3il_tpu_torch.eval import sims
    params = spec.make_params(kinematic=kinematic, device="cuda",
                              q_init=q_init)
    st, n_sub = params.statics, params.n_substeps
    ctxs = sims._fixed_or_sampled(sims.ref_contexts.pushing_contexts,
                                  pushing.sample_context, EVAL_CONTEXTS, True,
                                  params.device)
    cidx, _ = sims._grid(EVAL_CONTEXTS, EVAL_TRAJS, 0, params.device)
    state = pushing.reset(params, tuple(x[cidx] for x in ctxs))
    tcp, _ = params.tcp_pose(state.scene)
    hold = hold_action(tcp)
    for _ in range(ROLLOUT_CHECK_STEPS):
        state, _ = pushing.step(params, state, push_action(state, hold))
    push = push_action(state, hold)
    n = push.shape[0]
    bm = lambda x: torch.movedim(x, 0, -1).contiguous()
    sb = substep_bm.scene_to_bm(state.scene)
    mode = "kinematic" if kinematic else "dynamic"
    k1_in = (bm(state.ctrl.q_virt), bm(state.ctrl.old_des_vel),
             bm(push[:, :3]), bm(push[:, 3:]))
    k1_out = dyn_kernel.ik_window_bm(st.ik, n_sub, *k1_in)
    recs = [dict(name=f"ik_window_b{n}_{mode}", key="K1", out=k1_out,
                 plain=lambda: dyn_kernel.ik_window_plain(st.ik, n_sub,
                                                          *k1_in),
                 f64=lambda: dyn_kernel.ik_window_plain(
                     st.ik, n_sub, *(x.double() for x in k1_in)),
                 names=("q_virt", "old_vel", "q_des", "qd_des", "tau_model"),
                 tols=tols["K1"])]
    sw = torch.full((n,), 0.04, device=params.device)
    if kinematic:
        q_new, qd_new = substep_bm.kinematic_target(st, sb, k1_out[2][0], sw)
        sb = sb._replace(q=q_new.contiguous(), qd=qd_new.contiguous())
        arm_out = substep_bm.beam_arm_out(st, sb.q)
        if arm_out[4].shape != (9, 9, n) or arm_out[4].any().item():
            raise SystemExit("kinematic mode: Minv is not a zero [9, 9, B]")
    else:
        gf = torch.zeros(n, dtype=torch.bool, device=params.device)
        k2_in = (sb.q, sb.qd, k1_out[2][0], k1_out[3][0], k1_out[4][0], sw, gf)
        arm_out = dyn_kernel.arm_stage_bm(st.arm, *k2_in)
        recs.append(dict(
            name=f"arm_stage_b{n}_{mode}", key="K2", out=arm_out,
            plain=lambda: dyn_kernel.arm_stage_plain(
                st.arm, *k2_in[:6], k2_in[6].to(torch.float32)),
            names=("xpos", "xquat", "axes", "anchors", "Minv", "qd_pre",
                   "a_arm"), tols=tols["K2"]))
    k3_in = substep_bm.contact_inputs(st, sb, arm_out)
    k3_out = contact_kernel.phase_batched_bm(st.contact, *k3_in)
    active = (k3_in[2] > 0).float().sum(0).mean().item()
    rod = (k3_out[0][12:14].abs().amax(dim=(0, 1)) > 0).float().mean().item()
    log(f"rollout substep ({mode}, B = {n}, after {ROLLOUT_CHECK_STEPS} push "
        f"steps): {active:.1f} contacts with depth > 0 per env, rod-box contact "
        f"force in {rod:.1%} of envs, max |v_all| {k3_in[6].abs().max():.3f}")
    recs.append(dict(name=f"contact_phase_b{n}_{mode}", key="K3", out=k3_out,
                     plain=lambda: contact_kernel.phase_plain(st.meta, *k3_in),
                     names=("f", "qfrc"), tols=tols["K3"]))
    return recs


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
    # K4 on K1's own window: q_des and qd_des as K1 stored them, qdd_des
    # rebuilt as the controller forms it (clip(ddgain (qd_i - qd_{i-1}) / dt,
    # +-25), qd_{-1} = the old_vel input), one substep and the whole window
    # folded into the batch
    ddg = torch.tensor([float(v) for v in params.cart_gains.ddgain],
                       device=dev)[None, :, None]
    qd_prev = torch.cat([k1_in[1][None], k1_out[3][:-1]])
    qdd_w = torch.clamp(ddg * (k1_out[3] - qd_prev) / float(params.dt),
                        -25.0, 25.0)
    fold = lambda x: torch.movedim(x, 0, 1).reshape(7, n_sub * B).contiguous()
    k4_in = (k1_out[2][0], k1_out[3][0], qdd_w[0].contiguous())
    k4w_in = (fold(k1_out[2]), fold(k1_out[3]), fold(qdd_w))
    k4_out = (dyn_kernel.feedforward_bm(st.ik, *k4_in),)
    k4w_out = (dyn_kernel.feedforward_bm(st.ik, *k4w_in),)
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
        dict(name="feedforward_b8192", key="K4", route="cuda", report=False,
             source="d3il_tpu_torch/csrc/dyn_kernel.cu",
             replaces="d3il_tpu/engine/dyn_kernel.py:276",
             run=lambda: (dyn_kernel.feedforward_bm(st.ik, *k4_in),),
             plain=lambda: (dyn_kernel.feedforward_plain(st.ik, *k4_in),),
             ins=k4_in, out=k4_out, reps=(20, 3), names=("tau",),
             # test_dyn_kernel.py:169-171
             tols=(3e-4,)),
        dict(name="feedforward", key="K4", route="cuda",
             source="d3il_tpu_torch/csrc/dyn_kernel.cu",
             replaces="d3il_tpu/engine/dyn_kernel.py:276",
             run=lambda: (dyn_kernel.feedforward_bm(st.ik, *k4w_in),),
             plain=lambda: (dyn_kernel.feedforward_plain(st.ik, *k4w_in),),
             ins=k4w_in, out=k4w_out, reps=(20, 3), names=("tau",),
             tols=(3e-4,)),
    ]
    failed = []
    for k in kernels:
        hold_kernel(k, card, failed)
    # K4 against K1: the same FK + RNEA pass on the same window
    K4_VS_K1_TOL = 1e-4
    e = scaled_err(k4w_out[0].reshape(7, n_sub, B).movedim(1, 0), k1_out[4])
    log(f"K4 feedforward.tau vs K1 ik_window.tau_model on the window: scaled "
        f"err {e:.3e} (tol {K4_VS_K1_TOL:g}) "
        f"{'ok' if e <= K4_VS_K1_TOL else 'FAIL'}")
    if e > K4_VS_K1_TOL:
        failed.append("K4.tau_vs_K1")
    # K1-K3 at the evaluation path's shapes and inputs, both modes, at the
    # tolerances above
    from d3il_tpu_torch import registry
    spec = registry.TASKS["pushing"]
    tols = {k["key"]: k["tols"] for k in kernels[:3]}
    for kin in (False, True):
        for k in rollout_substep_kernels(spec, params.q_init, kin, tols):
            hold_kernel(k, card, failed, timed=False)
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")

    # ---- phase 3: the main path ----------------------------------------
    counters = {"K1": dyn_kernel.ik_window_bm, "K2": dyn_kernel.arm_stage_bm,
                "K3": contact_kernel.phase_batched_bm,
                "K4": dyn_kernel.feedforward_bm}
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
    # K4 lies on no path of its own (K1 folds the same pass into its loop):
    # launch it here on the window of the next push step, as the controller
    # would feed it, and hold it to K1's tau_model. These launches (one of
    # K1, one of K4) are counted apart from the path's
    act = push_action(state, hold)
    qv, ov = bm(state.ctrl.q_virt), bm(state.ctrl.old_des_vel)
    _, _, qdes_w, qddes_w, tau_w = dyn_kernel.ik_window_bm(
        st.ik, n_sub, qv, ov, bm(act[:, :3]), bm(act[:, 3:]))
    qdd_w = torch.clamp(
        ddg * (qddes_w - torch.cat([ov[None], qddes_w[:-1]])) / float(params.dt),
        -25.0, 25.0)
    tau_ff = dyn_kernel.feedforward_bm(st.ik, fold(qdes_w), fold(qddes_w),
                                       fold(qdd_w))
    ff_err = scaled_err(tau_ff.reshape(7, n_sub, B).movedim(1, 0), tau_w)
    window_launches = {k: fn.launches - launches[k]
                       for k, fn in counters.items()}

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
              "K3": steps * params.n_substeps + 2, "K4": 0}
    expect_window = {"K1": 1, "K2": 0, "K3": 0, "K4": 1}
    log(f"main path launches {launches} expected {expect}; window check "
        f"after it {window_launches} expected {expect_window}: K4 tau vs K1 "
        f"tau_model scaled err {ff_err:.3e}, tol {K4_VS_K1_TOL:g}")
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
    if window_launches != expect_window:
        problems.append(f"window check launches {window_launches} != "
                        f"{expect_window}")
    if moved < 0.5:
        problems.append(f"the red box moved in only {moved:.1%} of envs")
    if not ff_err <= K4_VS_K1_TOL:
        problems.append(f"K4 disagrees with K1 on the path's window "
                        f"({ff_err:.3e})")
    if problems:
        raise SystemExit("main path failed: " + "; ".join(problems))
    kernel_s = sum(k["ms"] * launches[k["key"]] for k in kernels
                   if k.get("report", True)) / 1e3
    log(f"main path: the kernels' timed ms x launches = {kernel_s:.3f} "
        f"s of {t_hold + t_push:.3f} s wall "
        f"({kernel_s / (t_hold + t_push):.1%}) [{card}]")
    profile_step(params, state, hold)

    # ---- phase 4: the evaluation path -----------------------------------
    import run_eval_torch
    import run_train_torch
    ckpt = os.path.join(ROOT, "build", "chip_smoke", "pushing_gmm.pt")
    targs = run_train_torch.make_args(
        task="pushing", agent="gmm", device="cuda", skip_eval=True, ckpt=ckpt,
        data=os.path.join(ROOT, "data"))
    row = run_train_torch.run_one(targs)
    log(f"eval path: trained gmm (hidden {targs.hidden}, {targs.layers} "
        f"layers, window {targs.window}) for {targs.epochs} epochs in "
        f"{row['train_seconds']} s, final train loss "
        f"{row['final_train_loss']} [{card}]")
    spec, agent, meta = run_eval_torch.load_agent(ckpt, "cuda")
    n_eps = EVAL_CONTEXTS * EVAL_TRAJS
    eval_launches = {}
    for mode, kin, T in (("dynamic", False, EVAL_STEPS_DYNAMIC),
                         ("kinematic", True, EVAL_STEPS_KINEMATIC)):
        state, dones, out, ln, secs, w = eval_rollout(
            spec, agent, params.q_init, kin, T, counters, card)
        eval_launches[mode] = ln
        want = {"K1": T, "K2": 0 if kin else T * n_sub + 2,
                "K3": T * n_sub + 2, "K4": 0}
        finite = bool(w.finite.item()) and all(
            torch.isfinite(x).all().item() for x in leaves(state)
            if x.is_floating_point())
        max_delta = w.max_delta.item()
        frozen = bool((dones[1:] | ~dones[:-1]).all().item())
        log(f"eval path ({mode}): {n_eps} episodes x {T} steps (horizon cut "
            f"from {spec.max_steps}) in {secs:.2f} s = "
            f"{n_eps * T / secs:.1f} episode-steps/s; success_rate "
            f"{out['success_rate']:.4f}, entropy {out['entropy']:.4f}, score "
            f"{out['score']:.4f}; done at the end in "
            f"{dones[-1].float().mean().item():.1%} of episodes; max setpoint "
            f"move per step {max_delta:.5f} m; all finite: {finite}; "
            f"launches {ln} expected {want} [{card}]")
        problems = []
        if not finite:
            problems.append("non-finite state")
        if not frozen:
            problems.append("done went back to false")
        if max_delta > 0.01 + 1e-6:
            problems.append(f"setpoint moved {max_delta} m in one step")
        if not all(0.0 <= out[k] <= 1.0 for k in
                   ("success_rate", "entropy", "score")):
            problems.append(f"metrics out of [0, 1]: {out}")
        if ln != want:
            problems.append(f"launch counts {ln} != {want}")
        if problems:
            raise SystemExit(f"eval path ({mode}) failed: "
                             + "; ".join(problems))
    # a deterministic policy rolled out twice from one seed repeats exactly
    bc, _ = registry.make_agent(
        "bc", torch.Generator(device=dev).manual_seed(3), spec.obs_dim,
        spec.act_dim, agent.scaler)
    finals = [eval_rollout(spec, bc, params.q_init, True, REPEAT_STEPS,
                           counters, card, seed=5, watch=False)[0]
              for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(leaves(finals[0]),
                                                 leaves(finals[1])))
    log(f"eval path: bc rolled out twice ({n_eps} episodes x {REPEAT_STEPS} "
        f"kinematic steps, seed 5): final states identical: {same}")
    if not same:
        raise SystemExit("eval path failed: the bc rollout does not repeat")
    profile_eval_step(spec, agent, params.q_init, card)

    # ---- phase 5: report --------------------------------------------------
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by")
    # ``launches`` is the main path's count for K1-K3; K4, which no path
    # calls, reports its one launch on that path's window instead
    # (launches_path 0, launches_window_check 1)
    print(json.dumps({"kernels": [
        dict({k: kk[k] for k in keys},
             launches=launches[kk["key"]] or window_launches[kk["key"]],
             launches_path=launches[kk["key"]],
             launches_window_check=window_launches[kk["key"]],
             launches_eval_dynamic=eval_launches["dynamic"][kk["key"]],
             launches_eval_kinematic=eval_launches["kinematic"][kk["key"]],
             library_ms=None) for kk in kernels if kk.get("report", True)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
