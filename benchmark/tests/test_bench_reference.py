"""The frozen reference (``benchmark/reference``) against the port, and
the import names of the harness and the reference.

At B = 4 on the CPU, where the port runs the plain versions of its
kernels, one step of each configuration, at its published sizes, through
the port agrees with the frozen copy. No module of the harness or the
reference imports JAX or the JAX package; the reference imports nothing of
the port either. Names are compared by their part before the first dot,
whole (``d3il_tpu_torch`` begins with ``d3il_tpu``)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "d3il_tpu"}


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [l for k in sorted(x) for l in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [l for v in x for l in _leaves(v)]
    return []


def _action(name, env, params, state):
    if name == "pushing":
        tcp, _ = params.tcp_pose(state.scene)
        B = tcp.shape[0]
        return torch.cat([tcp[:, :2] + 0.01, torch.full((B, 1), 0.12),
                          torch.tensor([0.0, 1.0, 0.0, 0.0]).expand(B, 4)], 1)
    return torch.cat([state.ctrl_q + 0.02,
                      torch.full_like(state.ctrl_q[:, :1], 0.0)], 1)


@pytest.mark.parametrize("name", ["pushing", "stacking"])
def test_reference_step_matches_port(name):
    import importlib
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    port = importlib.import_module(f"d3il_tpu_torch.envs.{name}")
    ref = importlib.import_module(f"benchmark.reference.envs.{name}")
    cls = cfg["params_class"]
    p = getattr(port, cls)(**cfg["params"], device="cpu")
    r = getattr(ref, cls)(**cfg["params"], device="cpu")
    assert (p.q_init == r.q_init).all()
    ctx = ref.sample_context(torch.Generator().manual_seed(3), 4)
    sp, sr = port.reset(p, ctx), ref.reset(r, ctx)
    for a, b in zip(_leaves(sp), _leaves(sr)):
        assert torch.equal(a, b)
    act = _action(name, port, p, sp)
    op, orf = port.step(p, sp, act), ref.step(r, sr, act)
    lp, lr = _leaves(op), _leaves(orf)
    assert len(lp) == len(lr) > 10
    for a, b in zip(lp, lr):
        assert torch.equal(a, b)


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_import_names():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        names = _imports(p)
        assert not names & JAX_NAMES, (p, names & JAX_NAMES)
        if "reference" in p.relative_to(BENCH).parts:
            assert "d3il_tpu_torch" not in names, p
    # the reference loaded in a fresh process pulls in none of them either
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.reference.envs.pushing, "
            "benchmark.reference.envs.stacking; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = set(json.loads(subprocess.run(
        [sys.executable, "-c", code, str(ROOT)], capture_output=True,
        text=True, check=True).stdout.replace("'", '"')))
    assert not loaded & (JAX_NAMES | {"d3il_tpu_torch"}), loaded
