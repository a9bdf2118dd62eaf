"""Carry parameters and state across from the JAX package as NumPy.

The JAX package's ``PushingState`` is a pytree of NamedTuples; passed
through ``numpy`` (e.g. ``jax.tree_util.tree_map(np.asarray, state)``) it
has the same fields as the port's ``PushingState``. These helpers take and
give nested mappings or NamedTuples of NumPy arrays, batch first, and never
touch JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from d3il_tpu_torch.control.cartesian import CartImpedanceState
from d3il_tpu_torch.engine.step import SceneState
from d3il_tpu_torch.envs import common, pushing


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(x, device):
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return torch.as_tensor(x, device=device)
    if np.issubdtype(x.dtype, np.integer):
        return torch.as_tensor(x.astype(np.int32), device=device)
    return torch.as_tensor(x.astype(np.float32), device=device)


def pushing_state_from_numpy(state, device=None) -> pushing.PushingState:
    """A batched pushing state (mapping or NamedTuple of NumPy arrays with
    ``scene`` and ``ctrl`` sub-structures) -> the port's PushingState."""
    dev = common.resolve_device(device)
    sc, cs = _get(state, "scene"), _get(state, "ctrl")
    return pushing.PushingState(
        scene=SceneState(*(_tensor(_get(sc, f), dev)
                           for f in SceneState._fields)),
        ctrl=CartImpedanceState(*(_tensor(_get(cs, f), dev)
                                  for f in CartImpedanceState._fields)),
        **{f: _tensor(_get(state, f), dev)
           for f in pushing.PushingState._fields if f not in ("scene", "ctrl")})


def pushing_state_to_numpy(state: pushing.PushingState) -> dict:
    """The port's PushingState -> nested dict of NumPy arrays."""
    np_ = lambda t: t.detach().cpu().numpy()
    out = {f: np_(getattr(state, f)) for f in pushing.PushingState._fields
           if f not in ("scene", "ctrl")}
    out["scene"] = {f: np_(x) for f, x in state.scene._asdict().items()}
    out["ctrl"] = {f: np_(x) for f, x in state.ctrl._asdict().items()}
    return out


def params_from_numpy(q_init, n_substeps: int = 35, max_steps: int = 400,
                      solver_iters: int = 25, device=None):
    """PushingParams whose episode start posture is ``q_init`` (e.g. the
    JAX package's ``PushingParams.q_init``), so both start alike."""
    return pushing.PushingParams(n_substeps=n_substeps, max_steps=max_steps,
                                 solver_iters=solver_iters, device=device,
                                 q_init=np.asarray(q_init, np.float64))
