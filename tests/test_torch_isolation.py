"""The port imports neither JAX nor the JAX package.

In a fresh interpreter with ``sys.modules["jax"] = None`` (so any
``import jax`` raises), every module of d3il_tpu_torch must import, and no
``d3il_tpu`` module may have been loaded.
"""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import d3il_tpu_torch
names = [m.name for m in pkgutil.walk_packages(d3il_tpu_torch.__path__,
                                               "d3il_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "d3il_tpu" or m.startswith("d3il_tpu."))
assert not bad, bad
assert len(names) >= 20, names
print("ok", len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_entry_points_need_cuda_by_default(monkeypatch):
    """Without a GPU, the entry points raise instead of falling back."""
    import pytest
    import torch
    from d3il_tpu_torch import convert
    from d3il_tpu_torch.envs import common, pushing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pushing.PushingParams()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(np.zeros(7))
