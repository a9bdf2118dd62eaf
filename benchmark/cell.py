"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own under ``benchmark/``:

  * ``configs/<config>.json``: the env and its Params() keywords;
  * ``traffic/<traffic>.json``: batch, mode, loop, actions, warm-up and
    traced steps, the reference's block size, read by ``traffic.py``;
  * ``actions/<kind>.py``: an action kind that mixes name;
  * ``limits/<workload>.json``: the limit of each number that decides
    ``correct``, with the readings it was set from;
  * ``metrics/<metric>.py``: one reader per per-layer metric;
  * ``kernels/<stage>.json`` (+ ``<stage>.py``): a kernel stage's wrapper,
    kernel names and count function.

A later cell, mix, action kind, metric or stage is a new file and a new entry; no file
here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench: Path


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json`` with its
    configuration, traffic, limits and the metrics it reports. Raises
    KeyError for a name the file does not hold."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "benchmark"
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((bench / "limits" / f"{workload}.json")
                          .read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
        bench=bench)


def load_module(path: Path):
    """A Python file of the benchmark loaded by its path, under a module
    name made from it."""
    name = f"benchmark_{path.parent.name}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH):
    """The ``read(readings)`` function of ``metrics/<name>.py``."""
    return load_module(bench / "metrics" / f"{name}.py").read


def kernel_stages(bench: Path = BENCH) -> dict:
    """{stage: its ``kernels/<stage>.json`` with ``module``, its count
    functions from ``kernels/<stage>.py``} for every stage file."""
    out = {}
    for path in sorted((bench / "kernels").glob("*.json")):
        st = json.loads(path.read_text())
        st["module"] = load_module(path.with_suffix(".py"))
        out[path.stem] = st
    return out
