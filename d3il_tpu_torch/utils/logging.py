"""Run-metric logging: a JSONL stream per training or evaluation run.

Counterpart of ``d3il_tpu/utils/logging.py``. The reference logs every
batch loss and the evaluation metrics to wandb; here each run appends one
JSON object per epoch or event to a file, which survives crashes, diffs
cleanly and needs no network. ``profile_trace`` wraps a hot section in
``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time


class RunLogger:
    """Append-only JSONL metric stream. With no ``run_dir`` it is a no-op
    sink, so call sites never branch."""

    def __init__(self, run_dir: str | None, name: str):
        self.enabled = run_dir is not None
        self._f = None
        if self.enabled:
            os.makedirs(run_dir, exist_ok=True)
            path = os.path.join(run_dir, f"{name}.jsonl")
            self._f = open(path, "a", buffering=1)
            self.path = path
            self.log({"event": "start", "name": name,
                      "time": round(time.time(), 1)})

    def log(self, record: dict):
        if self._f is not None:
            self._f.write(json.dumps(record) + "\n")

    def epoch_callback(self, epoch: int, params, rec: dict):
        """The callback ``agents.base.fit`` calls after every epoch."""
        self.log({"event": "epoch", **rec})

    def close(self):
        if self._f is not None:
            self.log({"event": "end", "time": round(time.time(), 1)})
            self._f.close()
            self._f = None


def profile_trace(trace_dir: str | None):
    """A ``torch.profiler`` context over a hot section that writes a
    Chrome trace (``*.pt.trace.json``) under ``trace_dir`` when it exits,
    recording the CUDA activity too where there is a card; a null context
    when ``trace_dir`` is falsy. Usage:

        with profile_trace(args.profile_dir) as prof:
            ... hot section ...

    ``prof`` is the profiler (None for the null context), so the section's
    events can also be read in the process (``prof.events()``)."""
    if not trace_dir:
        return contextlib.nullcontext()
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(str(trace_dir)))
