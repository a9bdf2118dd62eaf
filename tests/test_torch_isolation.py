"""The port imports neither JAX nor the JAX package.

In a fresh interpreter with ``sys.modules["jax"] = None`` (so any
``import jax`` raises; likewise jaxlib, flax, optax, orbax), every module of
d3il_tpu_torch and the four entry scripts must import, and no ``d3il_tpu``
module may have been loaded; likewise tools/gen_demos_torch.py and
tools/render_video_torch.py. The entry points' launcher
(``parallel/distributed.run_on_local_devices``) then starts two ranks,
fresh interpreters without that ban, and each imports the launcher and the
three entry scripts and reports every JAX or ``d3il_tpu`` module it has
loaded: none. chip_smoke.py, the entry scripts and the tools are also read
for such imports, since chip_smoke.py imports the port only once it has
found a card.
"""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r'''
import sys


def loaded():
    """(world size, the JAX and d3il_tpu modules this rank has loaded)."""
    import torch.distributed as dist
    import run_eval_torch, run_train_torch, run_vision_torch
    return dist.get_world_size(), sorted(
        m for m in sys.modules if m.split(".")[0] in
        ("jax", "jaxlib", "flax", "optax", "orbax", "d3il_tpu"))
'''

SCRIPT = r"""
import importlib, pkgutil, sys
for banned in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[banned] = None
import d3il_tpu_torch
names = [m.name for m in pkgutil.walk_packages(d3il_tpu_torch.__path__,
                                               "d3il_tpu_torch.")]
for name in names + ["run_train_torch", "run_eval_torch", "run_vision_torch",
                     "run_benchmark_torch"]:
    importlib.import_module(name)
import importlib.util
for tool in ("gen_demos_torch", "render_video_torch"):
    spec = importlib.util.spec_from_file_location(tool, f"tools/{tool}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for want in ("envs.aligning", "envs.sorting", "envs.avoiding",
             "envs.stacking", "control.joint_pd", "utils.logging",
             "data.scaler", "data.dataset",
             "agents.nets.mlp", "agents.bc",
             "agents.gmm", "agents.base", "envs.inserting",
             "agents.nets.transformer", "agents.gpt_bc", "agents.bet",
             "agents.act", "agents.cvae", "agents.lstm_gmm", "agents.ibc",
             "agents.ddpm", "agents.ddpm_encdec", "agents.beso",
             "data.experts", "data.gen_demos", "eval.metrics",
             "eval.contexts",
             "eval.rollout", "eval.sims", "registry", "convert",
             "vision.renderer", "vision.taskviews", "vision.encoder",
             "agents.vision", "control.cartesian", "engine.solver",
             "engine.collision", "engine.contact", "engine.step",
             "envs.common", "ops.spline", "utils.channel_logger",
             "parallel.mesh", "parallel.distributed"):
    assert "d3il_tpu_torch." + want in names, want
# the launcher of the entry points: two gloo ranks, each a fresh process
# (no ban there) that imports the entry scripts and lists what it loaded
import tempfile
from d3il_tpu_torch.parallel import distributed as pdist
assert pdist.local_world("cpu") == 1
with tempfile.TemporaryDirectory() as probe_dir:
    with open(f"{probe_dir}/jax_probe.py", "w") as f:
        f.write(sys.argv[1])        # PROBE
    sys.path.insert(0, probe_dir)
    import jax_probe
    assert pdist.run_on_local_devices(jax_probe.loaded, nprocs=2,
                                      device="cpu") == (2, [])
bad = sorted(m for m in sys.modules if m == "d3il_tpu" or m.startswith("d3il_tpu."))
assert not bad, bad
assert len(names) >= 50, names
print("ok", len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT, PROBE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_scripts_name_no_jax_module():
    """Every import statement of chip_smoke.py, the four entry scripts and
    the two tools, wherever it stands in the file."""
    import ast
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "d3il_tpu"}
    for script in ("chip_smoke.py", "run_train_torch.py",
                   "run_eval_torch.py", "run_vision_torch.py",
                   "run_benchmark_torch.py", "tools/gen_demos_torch.py",
                   "tools/render_video_torch.py"):
        with open(os.path.join(ROOT, script)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, (script, m)


def test_entry_points_need_cuda_by_default(monkeypatch):
    """Without a GPU, the entry points raise instead of falling back."""
    import pytest
    import torch
    from d3il_tpu_torch import convert
    from d3il_tpu_torch.envs import common, pushing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pushing.PushingParams()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(np.zeros(7))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.agent_params_from_numpy("bc", {})
    from d3il_tpu_torch.agents import base
    from d3il_tpu_torch.data import dataset, scaler
    xy = np.random.default_rng(0).normal(size=(4, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.scaler_from_numpy(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaler.Scaler.fit(xy, xy)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataset.build([(xy, xy)], 4, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataset.load_task_dataset("missing", [], None, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        base.load_checkpoint("missing.pt")
    from d3il_tpu_torch.parallel import mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.data_mesh()
    import run_eval_torch
    import run_train_torch
    assert run_train_torch.make_args().device == "cuda"
    # with no card, one rank, which raises
    from d3il_tpu_torch.parallel import distributed
    assert distributed.local_world() == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train_torch.main(["--task", "pushing"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_eval_torch.main(["--ckpt", "missing.pt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train_torch.run_one(run_train_torch.make_args(agent="gmm"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_eval_torch.load_agent("missing.pt")
    import run_vision_torch
    assert run_vision_torch.make_args().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_vision_torch.run(run_vision_torch.make_args())
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gen_demos_torch", os.path.join(ROOT, "tools", "gen_demos_torch.py"))
    gen_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen_cli)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen_cli.main(["--task", "pushing", "--out", "missing"])
    from d3il_tpu_torch.data import gen_demos
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen_demos.make_params("pushing")
