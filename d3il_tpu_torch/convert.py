"""Carry parameters, weights and state across from the JAX package as NumPy.

A task's state in the JAX package (``AvoidingState``, ``PushingState``,
``AligningState``, ``SortingState``, ``StackingState``) is a pytree of
NamedTuples; passed through ``numpy``
(e.g. ``jax.tree_util.tree_map(np.asarray, state)``) it has the same fields
as the port's state of that name. These helpers take and
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


# a task state's sub-structures: field name -> NamedTuple
_SUBSTATES = {"scene": SceneState, "ctrl": CartImpedanceState}


def state_from_numpy(state, state_cls=pushing.PushingState, device=None):
    """A batched task state (mapping or NamedTuple of NumPy arrays with a
    ``scene`` and, but for stacking, a ``ctrl`` sub-structure, e.g. the JAX
    package's ``AligningState`` passed through ``numpy``) -> the port's
    ``state_cls`` (``AvoidingState``, ``PushingState``, ``AligningState``,
    ``SortingState``, ``StackingState``). A scene without free bodies
    (avoiding) has free-body arrays of length 0."""
    dev = common.resolve_device(device)

    def field(f):
        x = _get(state, f)
        sub = _SUBSTATES.get(f)
        if sub is None:
            return _tensor(x, dev)
        return sub(*(_tensor(_get(x, g), dev) for g in sub._fields))

    return state_cls(**{f: field(f) for f in state_cls._fields})


def state_to_numpy(state) -> dict:
    """A task state of the port -> nested dict of NumPy arrays."""
    np_ = lambda t: t.detach().cpu().numpy()
    return {f: ({g: np_(y) for g, y in x._asdict().items()}
                if f in _SUBSTATES else np_(x))
            for f, x in state._asdict().items()}


def params_from_numpy(q_init, params_cls=pushing.PushingParams, device=None,
                      **kw):
    """A task's Params (``params_cls``: ``AvoidingParams``,
    ``PushingParams``, ``AligningParams``, ``SortingParams``,
    ``StackingParams``) whose episode start posture is
    ``q_init`` (e.g. the JAX package's ``Params.q_init``), so both start
    alike; ``kw`` are the class's own arguments (n_substeps, max_steps,
    kinematic, num_boxes, ...)."""
    return params_cls(device=device, q_init=np.asarray(q_init, np.float64),
                      **kw)


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
