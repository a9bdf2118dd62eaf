"""The port's RunLogger against the JAX package's: the same JSONL records,
apart from the timestamps, for the same calls."""
import json

from d3il_tpu.utils import logging as jlogging
from d3il_tpu_torch.utils import logging


def _records(mod, run_dir):
    log = mod.RunLogger(run_dir=str(run_dir), name="avoiding_gmm_s0")
    log.log({"event": "note", "n": 3, "x": [1.5, 2.0]})
    log.epoch_callback(0, None, {"epoch": 0, "train_loss": 0.25})
    log.epoch_callback(1, None, {"epoch": 1, "train_loss": 0.125,
                                 "val_loss": 0.5})
    log.close()
    log.close()     # a second close writes nothing
    with open(run_dir / "avoiding_gmm_s0.jsonl") as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        assert isinstance(r.pop("time", 0.0), float)
    return recs


def test_run_logger_writes_the_reference_records(tmp_path):
    got = _records(logging, tmp_path / "port")
    want = _records(jlogging, tmp_path / "jax")
    assert got == want
    assert [r["event"] for r in got] == ["start", "note", "epoch", "epoch",
                                         "end"]


def test_disabled_run_logger_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    log = logging.RunLogger(None, "x")
    log.log({"event": "note"})
    log.epoch_callback(0, None, {"epoch": 0})
    log.close()
    assert not log.enabled
    assert list(tmp_path.iterdir()) == []
