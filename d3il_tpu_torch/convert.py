"""Carry parameters, weights and state across from the JAX package as NumPy.

The JAX package's ``PushingState`` is a pytree of NamedTuples; passed
through ``numpy`` (e.g. ``jax.tree_util.tree_map(np.asarray, state)``) it
has the same fields as the port's ``PushingState``. These helpers take and
give nested mappings or NamedTuples of NumPy arrays, batch first, and never
touch JAX. Agent weights cross the same way: a Flax parameter tree as nested
dicts of NumPy arrays becomes the port's ``{name: tensor}`` parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from d3il_tpu_torch.control.cartesian import CartImpedanceState
from d3il_tpu_torch.data.scaler import Scaler
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
                      solver_iters: int = 25, kinematic: bool = False,
                      device=None):
    """PushingParams whose episode start posture is ``q_init`` (e.g. the
    JAX package's ``PushingParams.q_init``), so both start alike."""
    return pushing.PushingParams(n_substeps=n_substeps, max_steps=max_steps,
                                 solver_iters=solver_iters,
                                 kinematic=kinematic, device=device,
                                 q_init=np.asarray(q_init, np.float64))


def _dense(tree, prefix: str, out: dict, device) -> None:
    """Flax Dense {kernel [in, out], bias} -> nn.Linear weight [out, in]."""
    out[prefix + ".weight"] = torch.as_tensor(
        np.array(np.asarray(tree["kernel"], np.float32).T, order="C"),
        device=device)
    out[prefix + ".bias"] = torch.as_tensor(
        np.array(tree["bias"], np.float32), device=device)


def _residual_mlp(tree, prefix: str, out: dict, device) -> None:
    """Flax ResidualMLP (Dense_0, ResidualBlock_j/{Dense_0, Dense_1},
    Dense_1) -> the port's ResidualMLP (inp, blocks.j.{fc1, fc2}, out)."""
    n_blocks = sum(k.startswith("ResidualBlock_") for k in tree)
    _dense(tree["Dense_0"], prefix + "inp", out, device)
    for j in range(n_blocks):
        block = tree[f"ResidualBlock_{j}"]
        _dense(block["Dense_0"], f"{prefix}blocks.{j}.fc1", out, device)
        _dense(block["Dense_1"], f"{prefix}blocks.{j}.fc2", out, device)
    _dense(tree["Dense_1"], prefix + "out", out, device)


def agent_params_from_numpy(name: str, flax_params, device=None) -> dict:
    """The JAX package's parameter tree of agent ``name`` ('bc' or 'gmm'),
    as nested dicts of NumPy arrays, -> the port's ``agent.params``."""
    device = common.resolve_device(device)
    tree = flax_params.get("params", flax_params)
    out: dict = {}
    if name == "bc":
        _residual_mlp(tree, "", out, device)
    elif name == "gmm":
        _residual_mlp(tree["ResidualMLP_0"], "trunk.", out, device)
        for i, head in enumerate(("means", "stds", "logits")):
            _dense(tree[f"Dense_{i}"], head, out, device)
    else:
        raise KeyError(f"agent {name!r} is not ported; ported: ['bc', 'gmm']")
    return out


def scaler_from_numpy(scaler, device=None) -> Scaler:
    """The JAX package's Scaler (NamedTuple or mapping of arrays) -> the
    port's."""
    device = common.resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    fields = ("x_mean", "x_std", "y_mean", "y_std", "y_bounds", "x_bounds")
    return Scaler(*(f32(_get(scaler, f)) for f in fields),
                  bool(_get(scaler, "scale_data")))
