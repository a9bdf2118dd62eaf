"""The harness on the CPU: files found by name, the last line's keys, a run
without a card, a run with nothing but the benchmark's files, and the
faults of the timed path that the check has to catch. The control on the
card is marked ``cuda``."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import cell as cellmod
from benchmark import check, harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = "pushing.dyn.b65536"
TINY = {"traffic": {"batch": 4, "ref_block": 2, "warmup_steps": 1,
                    "trace_steps": 1, "check_steps": [1, 3]},
        "params": {"n_substeps": 2}}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def _run(step_hook=None, trace=False, seconds=0.05, **kw):
    return harness.run(CELL, 2 ** 33 + 5, seconds, trace, time.perf_counter(),
                       lambda m: None, device="cpu", overrides=TINY,
                       step_hook=step_hook, **kw)


def test_new_files_are_found(tmp_path):
    """A cell, a configuration, a traffic mix, a metric and a kernel stage
    added as new files and entries are found; no file there changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "pushing.json").read_text())
    cfg.update(name="pushing_short", params={**cfg["params"],
                                             "max_steps": 200})
    (b / "configs" / "pushing_short.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "push_expert.dyn.b65536.json")
                     .read_text())
    (b / "traffic" / "push_hold.kin.b8.json").write_text(json.dumps(
        {**mix, "batch": 8, "mode": "kinematic",
         "actions": {"kind": "hold", "z": 0.12}}))
    (b / "actions" / "hold.py").write_text(
        "import torch\n\n\n"
        "class Hold:\n"
        "    def __init__(self, p, obs):\n"
        "        B = obs.shape[0]\n"
        "        self.a = torch.cat([obs[:, :2], torch.tensor(\n"
        "            [p['z'], 0.0, 1.0, 0.0, 0.0]).expand(B, 5)], dim=1)\n\n"
        "    def action(self, state, obs, k):\n"
        "        return self.a\n\n"
        "    def summary(self):\n"
        "        return {}\n\n\n"
        "def make(p, env, params, state, seed):\n"
        "    return Hold(p, env.get_observation(params, state))\n")
    (b / "limits" / "pushing_short.kin.b8.json").write_text(
        (b / "limits" / f"{CELL}.json").read_text())
    (b / "metrics" / "steps_traced.py").write_text(
        "def read(r):\n    return r.traced_steps or None\n")
    (b / "kernels" / "k9.json").write_text(json.dumps(
        {"name": "k9", "what": "a new stage", "kernels": ["k9_kernel"],
         "wrapper": "d3il_tpu_torch.engine.dyn_kernel:feedforward_bm"}))
    (b / "kernels" / "k9.py").write_text(
        "def capture(args, out):\n    return {}\n\n\n"
        "def work(rec, ctx):\n    return 0, 0\n")
    spec["configs"].append({**spec["configs"][0], "name": "pushing_short",
                            "file": "benchmark/configs/pushing_short.json"})
    spec["workloads"].append({"name": "pushing_short.kin.b8",
                              "config": "pushing_short",
                              "traffic": "push_hold.kin.b8", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "env_steps_per_s",
                              "workloads": ["pushing_short.kin.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = cellmod.load_cell("pushing_short.kin.b8", root=tmp_path)
    assert c.traffic["mode"] == "kinematic" and c.traffic["batch"] == 8
    assert c.config["params"]["max_steps"] == 200
    assert [m["name"] for m in c.per_layer][-1] == "steps_traced"
    assert "k1_roofline" not in [m["name"] for m in c.per_layer]
    r = harness.Readings(8, 35)
    r.traced_steps = 3
    assert cellmod.metric_reader("steps_traced", b)(r) == 3
    assert set(cellmod.kernel_stages(b)) == {"k1", "k2", "k3", "k9"}
    # the new action kind drives a run of the new cell, by its name
    result, _ = harness.run(
        "pushing_short.kin.b8", 2 ** 33 + 7, 0.05, False, time.perf_counter(),
        lambda m: None, device="cpu", root=tmp_path,
        overrides={"traffic": {"ref_block": 4, "check_steps": [1, 3]},
                   "params": {"n_substeps": 2}})
    assert result["correct"] is True
    with pytest.raises(KeyError):
        cellmod.load_cell("no.such.cell", root=tmp_path)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    """The result holds the contract's keys, with the check's numbers and
    limits under a key of its own that comes last."""
    result, lines = _run(trace=trace)
    keys = list(result)
    assert keys[-1] == "check"
    assert keys[:5] == KEYS[:5]
    assert set(keys) <= set(KEYS) | {"breakdown"}
    assert ("breakdown" in keys) == trace
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert result["correct"] is True
    assert [k for k, _, _ in lines] == list(result["check"])
    names = set(result["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert names == {"host_ms_per_step"}   # no device events here
    else:
        assert names == {"env_steps_per_s", "setup_s"}
    json.dumps(result)


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2 ** 33), "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_without_card_fails():
    p = _run_py(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no card" in p.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _unchanged(step):
    def f(params, state, action):
        _, res = step(params, state, action)
        return state, res
    return f


def _half(step):
    """Half of the batch left out: those envs keep their state."""
    def f(params, state, action):
        new, res = step(params, state, action)
        h = action.shape[0] // 2

        def keep(n, o):
            if isinstance(n, torch.Tensor):
                return torch.cat([n[:h], o[h:]])
            return type(n)(*(keep(a, b) for a, b in zip(n, o)))
        return keep(new, state), res
    return f


def _answer_altered(step):
    """One env's answer altered where it is produced: its success flag."""
    def f(params, state, action):
        new, res = step(params, state, action)
        succ = new.success.clone()
        succ[1] = ~succ[1]
        return new._replace(success=succ), res
    return f


def _box_moved(step):
    """One env's new state altered where it is produced: its first box 1 cm
    off in x."""
    def f(params, state, action):
        new, res = step(params, state, action)
        pos = new.scene.free_pos.clone()
        pos[1, 0, 0] += 1e-2
        return new._replace(scene=new.scene._replace(free_pos=pos)), res
    return f


@pytest.mark.parametrize("fault", [_unchanged, _half, _answer_altered])
def test_fault_is_not_correct(fault):
    result, lines = _run(step_hook=fault, seconds=0.3)
    assert result["correct"] is False, lines


def test_witness_reads_within_the_limits():
    """The one-ulp witness (the reference from the program's state moved
    by one ulp) reads above nought and within every compared limit."""
    cell = cellmod.load_cell(CELL)
    sess = harness.Session(cell, 2 ** 33 + 9, "cpu", TINY)
    sess.warm()
    _, _, _, records = sess.window(0.3)
    sess.free()
    numbers, _ = harness.check_records(sess, records, control="ulp")
    assert numbers["err_med"] > 0
    assert check.verdict(numbers, cell.limits["limits"]), numbers


STACKING = "stacking.dyn.b32768"


def _with_stacking(tmp_path):
    """A checkout whose BENCHMARK.json adds the stacking cell, whose files
    (configuration, mix, action kind, limits) the benchmark holds: the
    cell comes back by entries alone."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "stacking", "source": "https://github.com/ALRhub/d3il",
        "file": "benchmark/configs/stacking.json", "reduced": [],
        "why": "the joint window and K3's compact variant"})
    spec["workloads"].append({
        "name": STACKING, "config": "stacking",
        "traffic": "stack_expert.dyn.b32768", "chips": 1,
        "why": "the scripted stacking expert"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def test_moved_box_is_not_correct(tmp_path):
    """Where the cell compares positions (stacking), one env's box 1 cm off
    fails ``pos_max``."""
    result, lines = harness.run(
        STACKING, 2 ** 33 + 5, 0.3, False, time.perf_counter(),
        lambda m: None, device="cpu", overrides=TINY, step_hook=_box_moved,
        root=_with_stacking(tmp_path))
    assert result["correct"] is False
    nums = {k: (v, lim) for k, v, lim in lines}
    assert nums["pos_max"][0] > nums["pos_max"][1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [CELL, STACKING])
def test_control_is_not_correct(cuda_device, workload, tmp_path):
    """The control (the reference in the program's place with its state,
    inputs and outputs in bfloat16) fails the cell's limits, at a batch a
    test run can hold."""
    cell = cellmod.load_cell(workload, root=_with_stacking(tmp_path))
    sess = harness.Session(cell, 2 ** 33 + 1, "cuda",
                           {"traffic": {"batch": 4096, "ref_block": 4096}})
    sess.warm()
    _, _, _, records = sess.window(1.0)
    sess.free()
    numbers, _ = harness.check_records(sess, records, control="bf16")
    assert not check.verdict(numbers, cell.limits["limits"]), numbers
