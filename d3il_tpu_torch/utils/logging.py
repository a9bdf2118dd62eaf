"""Run-metric logging: a JSONL stream per training or evaluation run.

Counterpart of ``d3il_tpu/utils/logging.py``. The reference logs every
batch loss and the evaluation metrics to wandb; here each run appends one
JSON object per epoch or event to a file, which survives crashes, diffs
cleanly and needs no network.
"""
from __future__ import annotations

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
