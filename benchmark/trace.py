"""The traced steps: ``torch.profiler`` over a few env steps, spans from the
benchmark's own wrappers around the program's layers, and the captures
that the kernel stages count their work from.

The wrappers are installed on module attributes that the program looks up
at each call (as ``chip_smoke.py``'s ``kernel_counters`` reads the kernel
wrappers), only for the traced steps, and removed after them. Each adds a
``bench:<layer>`` span (``torch.profiler.record_function``); a kernel
stage's wrapper also hands its inputs and outputs to the stage's
``capture``, which keeps what its count needs.
"""
from __future__ import annotations

import importlib
import time
from contextlib import contextmanager

import torch

SPAN = "bench:"

# the program's layers that get a span, by module attribute
LAYERS = {
    "window": "d3il_tpu_torch.engine.substep_bm:run_substeps_bm",
    "joint_window": "d3il_tpu_torch.engine.substep_bm:joint_substeps_bm",
    "substep": "d3il_tpu_torch.engine.substep_bm:physics_substep_bm",
    "contact_inputs": "d3il_tpu_torch.engine.substep_bm:contact_inputs",
    "narrow_phase": "d3il_tpu_torch.engine.substep_bm:narrow_phase_bm",
}


def _resolve(target: str):
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


@contextmanager
def wrapped(stages: dict, captures: dict):
    """Spans around LAYERS and every stage's wrapper; each stage call's
    ``capture(args, out)`` appended to ``captures[stage]``."""
    saved = []

    def install(target, label, stage=None):
        mod, attr = _resolve(target)
        fn = getattr(mod, attr)

        def traced(*args, **kw):
            with torch.profiler.record_function(SPAN + label):
                out = fn(*args, **kw)
            if stage is not None:
                captures.setdefault(stage, []).append(
                    stages[stage]["module"].capture(args, out))
            return out

        traced.__wrapped__ = fn
        for k, v in vars(fn).items():     # e.g. the wrappers' launch counters
            setattr(traced, k, v)
        saved.append((mod, attr, fn))
        setattr(mod, attr, traced)

    try:
        for label, target in LAYERS.items():
            install(target, label)
        for name, st in stages.items():
            install(st["wrapper"], name, name)
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def profile(step, n: int, sync):
    """Run ``step()`` n times under the profiler, ending in ``sync()``;
    returns (host seconds of the n steps, device events [(name, start_ns,
    end_ns)], host events [(name, start_ns, end_ns)] of the thread that
    ran them). Without a card the device events are empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        wall = time.perf_counter() - t0
    dev, host, threads = [], [], {}
    for e in prof.profiler.kineto_results.events():
        ev = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            # the spans' ranges on the device's timeline are no activity
            if not (e.is_user_annotation() or ev[0].startswith(SPAN)):
                dev.append(ev)
        else:
            host.append((e.start_thread_id(), ev))
            if ev[0].startswith(SPAN):
                threads[e.start_thread_id()] = threads.get(
                    e.start_thread_id(), 0) + 1
    main = max(threads, key=threads.get) if threads else None
    host = [ev for tid, ev in host if tid == main]
    return wall, dev, host


def busy_intervals(dev):
    """The union of the device events' intervals, sorted."""
    out = []
    for _, a, b in sorted(dev, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_host(dev, host, k: int = 10):
    """Device idle time between the first and the last device event, by
    what the host was doing at the middle of each gap: the innermost
    ``bench:`` span and the innermost host event there. Returns the ``k``
    largest [[label, seconds]]."""
    busy = busy_intervals(dev)
    gaps = [((a[1] + b[0]) / 2, b[0] - a[1]) for a, b in zip(busy, busy[1:])
            if b[0] > a[1]]
    host = sorted(host, key=lambda e: (e[1], -e[2]))
    starts = [e[1] for e in host]
    totals = {}
    stack, i = [], 0
    for mid, length in sorted(gaps):
        while i < len(host) and starts[i] <= mid:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        live = [e for e in stack if e[1] <= mid < e[2]]
        span = next((e[0][len(SPAN):] for e in reversed(live)
                     if e[0].startswith(SPAN)), "-")
        op = live[-1][0] if live and not live[-1][0].startswith(SPAN) else "-"
        label = f"{span} > {op}"
        totals[label] = totals.get(label, 0.0) + length / 1e9
    return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])
            [:k]]


SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


def host_syncs(dev, host) -> dict:
    """Copies to the host on the device, and the host's synchronizing
    runtime calls, by name: each one a point where the host may wait for
    the device inside a step."""
    out = {}
    for name, _, _ in dev:
        if "DtoH" in name:
            out[short_name(name)] = out.get(short_name(name), 0) + 1
    for name, _, _ in host:
        if name in SYNCS:
            out[name] = out.get(name, 0) + 1
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list (cut at the first ``(``
    outside template brackets) and without a leading ``void``."""
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[5:] if name.startswith("void ") else name


def top_ops(dev, k: int = 10):
    """The ``k`` device operations that took most time, by name without
    arguments: [[name, seconds]]."""
    tot = {}
    for name, a, b in dev:
        n = short_name(name)
        tot[n] = tot.get(n, 0.0) + (b - a) / 1e9
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def stage_of(name: str, stages: dict):
    """The stage whose kernel names occur in device event ``name``."""
    for st, spec in stages.items():
        if any(k in name for k in spec["kernels"]):
            return st
    return None


def stage_device_s(dev, stages: dict) -> dict:
    """Device seconds by stage, under None the rest (the glue)."""
    out = {}
    for name, a, b in dev:
        st = stage_of(name, stages)
        out[st] = out.get(st, 0.0) + (b - a) / 1e9
    return out

