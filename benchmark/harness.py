"""One run of a cell: set-up, the measured window, the traced steps and the
check, as ``run.py`` drives them.

  * Set-up (``setup_s``, from the first line of ``run.py``): the port's
    import, its kernels loaded (built by nvcc into the checkout's
    ``build/d3il_tpu_torch/`` on a checkout's first run), the Params() of
    the configuration, the contexts from the seed, the reset, the policy
    and the mix's warm-up steps, which touch every shape the window uses.
  * The window (``env_steps_per_s``): the closed loop of the mix, one env
    step issued when the last has returned to the host, until ``seconds``
    have passed, then one synchronize; the rate is the envs times the
    steps over the time from the window's start to that synchronize.
  * With ``trace``: the mix's ``trace_steps`` further steps under
    ``torch.profiler`` with the benchmark's spans and captures
    (``trace.py``), read by the per-layer metrics' readers.
  * The check (``check.py``): after the window (and the traced steps) and
    after the peak memory is read, the frozen reference recomputes the
    reset and two steps of the window, drawn from the seed among the
    episode steps of the mix's ``check_steps``, from the same inputs.

The window runs with the garbage collector off, so that no collection
stops the host's launch path, which paces the step.
"""
from __future__ import annotations

import gc
import importlib
import math
import random
import subprocess
import sys
import time

import torch

from benchmark import cell as cellmod
from benchmark import check, counts, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "d3il_tpu")
PORT = "d3il_tpu_torch"
REF = "benchmark.reference"
TRACE_RESERVE = 4 << 30   # bytes cached before the traced steps


class NoCard(RuntimeError):
    """The run found fewer CUDA devices than the cell asks for."""


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(chips: int) -> dict:
    """The card's name and power limit; raises NoCard without enough."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA device(s); "
                     f"torch.cuda.is_available() is "
                     f"{torch.cuda.is_available()}, "
                     f"{torch.cuda.device_count()} visible")
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"nvidia-smi: {e}"
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": limit}


def named_tuples(*modules) -> dict:
    return {k: v for m in modules for k, v in vars(m).items()
            if isinstance(v, type) and issubclass(v, tuple)
            and hasattr(v, "_fields")}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Session:
    """The program under test, set up for one cell and seed."""

    def __init__(self, cell: cellmod.Cell, seed: int, device="cuda",
                 overrides: dict | None = None, step_hook=None):
        ov = overrides or {}
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traffic = {**cell.traffic, **ov.get("traffic", {})}
        self.params_kw = {**cell.config["params"], **ov.get("params", {}),
                          "kinematic": self.traffic["mode"] == "kinematic"}
        self.batch = int(self.traffic["batch"])
        if torch.device(device).type == "cuda":
            from d3il_tpu_torch.kernels import build
            t = time.perf_counter()
            built = build.build_all()
            self.build_s = time.perf_counter() - t
            self.built = any(v > 0 for v in built.values())
        env_name = cell.config["env"]
        self.env = importlib.import_module(f"{PORT}.envs.{env_name}")
        self.ref_env = importlib.import_module(f"{REF}.envs.{env_name}")
        cls = cell.config["params_class"]
        self.params = getattr(self.env, cls)(**self.params_kw, device=device)
        self.ctx = traffic.contexts(self.ref_env, self.seed, self.batch,
                                    device)
        self.state = self.env.reset(self.params, self.ctx)
        self.start = self.state
        self.obs = self.env.get_observation(self.params, self.state)
        self.policy = traffic.policy(self.traffic, self.env, self.params,
                                     self.state, self.seed, cell.bench)
        self.step_fn = self.env.step if step_hook is None else step_hook(
            self.env.step)
        self.k = 0

    def step(self):
        """One env step of the closed loop; returns its record."""
        a = self.policy.action(self.state, self.obs, self.k)
        before = self.state
        self.state, res = self.step_fn(self.params, before, a)
        self.obs = res.obs
        rec = {"what": f"step {self.k}", "state": before, "action": a,
               "out": (self.state, res)}
        self.k += 1
        return rec

    def warm(self):
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()
        sync(self.device)

    def window(self, seconds: float):
        """The measured window; returns (steps, seconds, host seconds per
        step call, the records to check). The records are the reset and
        two steps drawn from the seed among the episode steps of the mix's
        ``check_steps`` [lo, hi), which every run reaches: the same steps
        whatever the window's length, so a faster program is checked where
        a slower one was. A drawn step the window does not reach is
        replaced by the window's last."""
        lo, hi = self.traffic["check_steps"]
        rng = random.Random(traffic.stream_seed(self.seed, "check"))
        want = set(rng.sample(range(lo, hi), 2))
        host, held, last = [], [], None
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            while True:
                h = time.perf_counter()
                rec = self.step()
                host.append(time.perf_counter() - h)
                last = rec
                if self.k - 1 in want:
                    rec["policy"] = self.policy.summary()
                    held.append(rec)
                if time.perf_counter() - t0 >= seconds:
                    break
            sync(self.device)
            dt = time.perf_counter() - t0
        finally:
            gc.enable()
        if len(held) < len(want) and last not in held:
            last["policy"] = self.policy.summary()
            held.append(last)
        recs = [{"what": "reset", "ctx": self.ctx, "out": self.start}]
        return len(host), dt, host, recs + held

    def free(self):
        """Drop the program's objects that the check does not need."""
        self.params = self.state = self.obs = self.policy = None
        self.start = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


class Reference:
    """The frozen plain reference of the cell's configuration, with its own
    Params() (start posture searched again) on ``device``."""

    def __init__(self, cell: cellmod.Cell, params_kw: dict, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name = cell.config["env"]
        self.env = importlib.import_module(f"{REF}.envs.{name}")
        self.params = getattr(self.env, cell.config["params_class"])(
            **params_kw, device=device)
        self.types = named_tuples(
            self.env, importlib.import_module(f"{REF}.engine.step"),
            importlib.import_module(f"{REF}.control.cartesian"),
            importlib.import_module(f"{REF}.envs.common"))

    def __call__(self, rec, lo, hi):
        if rec["what"] == "reset":
            return self.env.reset(self.params, check.rows(rec["ctx"], lo, hi))
        state = check.to_types(check.rows(rec["state"], lo, hi), self.types)
        return self.env.step(self.params, state,
                             check.rows(rec["action"], lo, hi))


def program_outputs(rec, lo, hi):
    return check.rows(rec["out"], lo, hi)


def bf16(t):
    """A float tensor rounded to bfloat16 and held in its own type again;
    any other tensor as it is."""
    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


class Bf16Control(Reference):
    """The control: the reference in the program's place with its state,
    its inputs and its outputs held in bfloat16 (the precision below the
    configuration's float32; see ``PERF.md`` for why not TF32)."""

    def __call__(self, rec, lo, hi):
        rec = dict(rec)
        for k in ("ctx", "state", "action"):
            if k in rec:
                rec[k] = check.tensor_map(bf16, rec[k])
        return check.tensor_map(bf16, super().__call__(rec, lo, hi))


class UlpWitness(Reference):
    """The witness of float32's own sensitivity: the reference stepped from
    the program's state with every float moved by one ulp (toward +inf),
    in the program's place. What it reads, any two float32 evaluations of
    the same step can read."""

    def __call__(self, rec, lo, hi):
        rec = dict(rec)
        for k in ("ctx", "state"):
            if k in rec:
                rec[k] = check.tensor_map(ulp_up, rec[k])
        return super().__call__(rec, lo, hi)


def ulp_up(t):
    """A float tensor moved by one ulp toward +inf; any other as it is."""
    if not t.is_floating_point():
        return t
    return torch.nextafter(t, torch.full_like(t, math.inf))


CONTROLS = {"bf16": Bf16Control, "ulp": UlpWitness}


def check_records(sess: Session, records, control: str | None = None):
    """The check's numbers and detail for the program's records; with
    ``control`` (a key of CONTROLS), for that control in the program's
    place instead."""
    ref = Reference(sess.cell, sess.params_kw, sess.device)
    cand = program_outputs
    if control is not None:
        cand = CONTROLS[control](sess.cell, sess.params_kw, sess.device)
    block = int(sess.traffic["ref_block"])
    return check.compare(records, cand, ref, sess.batch, block)


class Readings:
    """What the per-layer metrics' readers read (``metrics/*.py``)."""

    def __init__(self, batch, n_substeps):
        self.batch, self.n_substeps = batch, n_substeps
        self.host_step_s = []
        self.window_peak_bytes = None
        self.traced_steps, self.trace_window_s = 0, 0.0
        self.dev, self.busy_s = [], 0.0
        self.stage_s, self.stage_bound_s = {}, {}

    def roofline(self, stage):
        t = self.stage_s.get(stage, 0.0)
        if stage not in self.stage_bound_s or t <= 0:
            return None
        return 100.0 * self.stage_bound_s[stage] / t


class CountContext:
    """The reference's statics on the CPU for the stages' count functions,
    and a cache per stage."""

    def __init__(self, cell, params_kw):
        import numpy as np
        env = importlib.import_module(f"{REF}.envs.{cell.config['env']}")
        p = getattr(env, cell.config["params_class"])(
            **params_kw, device="cpu", q_init=np.zeros(7))
        self.ref_statics = p.statics
        self._caches = {}

    def cache(self, stage):
        return self._caches.setdefault(stage, {})


def traced(sess: Session, r: Readings, log):
    """The mix's traced steps; fills ``r`` and returns the breakdown."""
    from benchmark import trace
    stages = cellmod.kernel_stages()
    captures = {}
    n = int(sess.traffic["trace_steps"])
    if sess.device != "cpu":
        # the captures keep K3's depths until the count: a cached segment
        # reserved now serves them, so that no cudaMalloc (which waits for
        # the device) falls inside the traced steps
        torch.empty(TRACE_RESERVE, dtype=torch.uint8, device=sess.device)
    with trace.wrapped(stages, captures):
        wall, dev, host = trace.profile(sess.step, n,
                                         lambda: sync(sess.device))
    r.traced_steps, r.trace_window_s, r.dev = n, wall, dev
    r.busy_s = sum(b - a for a, b in trace.busy_intervals(dev)) / 1e9
    r.stage_s = trace.stage_device_s(dev, stages)
    ctx = CountContext(sess.cell, sess.params_kw)
    for st, recs in captures.items():
        total = 0.0
        for rec in recs:
            ops, byt = stages[st]["module"].work(rec, ctx)
            total += counts.bound_of(ops, byt)[0] / 1e3
        r.stage_bound_s[st] = total
        log(f"trace: {st} {len(recs)} calls, device "
            f"{r.stage_s.get(st, 0.0) * 1e3:.3f} ms, bound {total * 1e3:.4f} ms")
        if hasattr(stages[st]["module"], "active"):
            act = torch.stack([stages[st]["module"].active(c) for c in recs])
            log(f"trace: {st} active contacts per env min / mean / max "
                f"{int(act.min())} / {float(act.float().mean()):.3f} / "
                f"{int(act.max())} over {len(recs)} calls")
    captures.clear()
    log(f"trace: host waits and copies to the host in {n} steps: "
        f"{trace.host_syncs(dev, host)}")
    return {"device_ops": trace.top_ops(dev),
            "idle_gaps": trace.idle_by_host(dev, host)}


def run(workload: str, seed: int, seconds: float, trace_on: bool, t_start,
        log, device="cuda", overrides=None, step_hook=None, root=None):
    """One run; returns (result dict for the last line, [(number, value,
    limit)])."""
    cell = cellmod.load_cell(workload, **({"root": root} if root else {}))
    info = card(cell.chips) if device == "cuda" else {"kind": "cpu"}
    if device == "cuda":
        torch.set_num_threads(1)
    log(f"card: {info}")
    sess = Session(cell, seed, device, overrides, step_hook)
    sess.warm()
    setup_s = time.perf_counter() - t_start
    on_card = torch.device(device).type == "cuda"
    if on_card:
        log(f"set-up {setup_s:.3f} s (kernel build {sess.build_s:.3f} s, "
            f"built now: {sess.built})")
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    n, dt, host, records = sess.window(seconds)
    rate = sess.batch * n / dt
    log(f"window: {n} steps of {sess.batch} envs in {dt:.4f} s, "
        f"{rate:.2f} env-steps/s, host enqueue {1e3 * sum(host) / n:.2f} "
        f"ms a step")
    log(f"window: host ms per step {[round(1e3 * h, 1) for h in host]}")
    r = Readings(sess.batch, int(sess.params_kw["n_substeps"]))
    r.host_step_s = host
    peak = 0
    if on_card:
        r.window_peak_bytes = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, r.window_peak_bytes)
    breakdown = None
    if trace_on:
        breakdown = traced(sess, r, log)
        log(f"trace: {r.traced_steps} steps {r.trace_window_s:.3f} s "
            f"({1e3 * r.trace_window_s / r.traced_steps:.1f} ms a step "
            f"traced, {1e3 * dt / n:.1f} ms untraced), device busy "
            f"{r.busy_s:.4f} s, {len(r.dev)} device activities")
    sess.free()
    t = time.perf_counter()
    numbers, detail = check_records(sess, records)
    for d in detail:
        log(f"check {d}")
    log(f"check: {time.perf_counter() - t:.1f} s")
    limits = cell.limits["limits"]
    correct = check.verdict(numbers, limits)
    failed = sum(d["nonfinite_envs"] for d in detail)
    metrics = {}
    if trace_on:
        for m in cell.per_layer:
            v = cellmod.metric_reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = {"env_steps_per_s": rate, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": info["kind"], "count": cell.chips if on_card else 0,
                "memory_peak_bytes": int(peak)}
    if trace_on:
        dev_info.update(busy_s=r.busy_s, window_s=r.trace_window_s)
    result = {"correct": bool(correct), "attempted": n * sess.batch,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in check.NUMBERS}
    return result, [(k, numbers[k], limits[k]) for k in check.NUMBERS]


