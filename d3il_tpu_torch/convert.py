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


def _layer_norm(tree, prefix: str, out: dict, device) -> None:
    """Flax LayerNorm {scale, bias} -> nn.LayerNorm {weight, bias}."""
    out[prefix + ".weight"] = torch.as_tensor(
        np.array(tree["scale"], np.float32), device=device)
    out[prefix + ".bias"] = torch.as_tensor(
        np.array(tree["bias"], np.float32), device=device)


def _param(x, name: str, out: dict, device) -> None:
    out[name] = torch.as_tensor(np.array(x, np.float32), device=device)


def _block(tree, prefix: str, out: dict, device) -> None:
    """Flax transformer Block (LayerNorm_0, CausalSelfAttention_0/{Dense_0,
    Dense_1}, LayerNorm_1, Dense_0, Dense_1) -> the port's Block (ln1,
    attn.{qkv, proj}, ln2, fc, proj)."""
    _layer_norm(tree["LayerNorm_0"], prefix + "ln1", out, device)
    attn = tree["CausalSelfAttention_0"]
    _dense(attn["Dense_0"], prefix + "attn.qkv", out, device)
    _dense(attn["Dense_1"], prefix + "attn.proj", out, device)
    _layer_norm(tree["LayerNorm_1"], prefix + "ln2", out, device)
    _dense(tree["Dense_0"], prefix + "fc", out, device)
    _dense(tree["Dense_1"], prefix + "proj", out, device)


def _gpt(tree, prefix: str, out: dict, device) -> None:
    """Flax GPT (Dense_0, pos_emb, Block_i, LayerNorm_0, Dense_1) -> the
    port's GPT (inp, pos_emb, blocks.i, ln_f, head)."""
    _dense(tree["Dense_0"], prefix + "inp", out, device)
    _param(tree["pos_emb"], prefix + "pos_emb", out, device)
    n = sum(k.startswith("Block_") for k in tree)
    for i in range(n):
        _block(tree[f"Block_{i}"], f"{prefix}blocks.{i}.", out, device)
    _layer_norm(tree["LayerNorm_0"], prefix + "ln_f", out, device)
    _dense(tree["Dense_1"], prefix + "head", out, device)


def _time_embed(tree, prefix: str, out: dict, device) -> None:
    _dense(tree["Dense_0"], prefix + "fc1", out, device)
    _dense(tree["Dense_1"], prefix + "fc2", out, device)


def _lstm_cell(tree, prefix: str, out: dict, device) -> None:
    """Flax OptimizedLSTMCell (input kernels ii/if/ig/io, no bias; hidden
    kernels and biases hi/hf/hg/ho) -> nn.LSTMCell's stacked [i, f, g, o]
    weight_ih, weight_hh and bias_hh."""
    cat = lambda names, key: np.concatenate(
        [np.asarray(tree[n][key], np.float32).T for n in names], axis=0)
    _param(cat(("ii", "if", "ig", "io"), "kernel"), prefix + "weight_ih",
           out, device)
    _param(cat(("hi", "hf", "hg", "ho"), "kernel"), prefix + "weight_hh",
           out, device)
    _param(np.concatenate([np.asarray(tree[n]["bias"], np.float32)
                           for n in ("hi", "hf", "hg", "ho")]),
           prefix + "bias_hh", out, device)


def _indexed(tree, name: str):
    """The Flax subtrees ``name_0``, ``name_1``, ... of a setup list."""
    n = sum(k.startswith(name + "_") for k in tree)
    return [tree[f"{name}_{i}"] for i in range(n)]


def _gmm(tree, out, device):
    _residual_mlp(tree["ResidualMLP_0"], "trunk.", out, device)
    for i, head in enumerate(("means", "stds", "logits")):
        _dense(tree[f"Dense_{i}"], head, out, device)


def _bet_mlp(tree, out, device):
    _residual_mlp(tree["ResidualMLP_0"], "trunk.", out, device)
    _dense(tree["Dense_0"], "logits", out, device)
    _dense(tree["Dense_1"], "offsets", out, device)


def _act(tree, out, device):
    for layer in ("state_in", "act_in", "z_head", "z_in", "out"):
        _dense(tree[layer], layer, out, device)
    for part in ("enc_blocks", "dec_blocks"):
        for i, blk in enumerate(_indexed(tree, part)):
            _block(blk, f"{part}.{i}.", out, device)
    _param(tree["query"], "query", out, device)


def _cvae(tree, out, device):
    _residual_mlp(tree["enc"], "enc.", out, device)
    _residual_mlp(tree["dec"], "dec.", out, device)
    _dense(tree["mean_head"], "mean_head", out, device)
    _dense(tree["logstd_head"], "logstd_head", out, device)


def _lstm_gmm(tree, out, device):
    for i, cell in enumerate(_indexed(tree, "cells")):
        _lstm_cell(cell, f"cells.{i}.", out, device)
    for layer in ("mid", "mean_head", "std_head", "logit_head"):
        _dense(tree[layer], layer, out, device)


def _ddpm(tree, out, device):
    _time_embed(tree["TimeEmbed_0"], "temb.", out, device)
    _residual_mlp(tree["ResidualMLP_0"], "mlp.", out, device)


def _ddpm_encdec(tree, out, device):
    for i, layer in enumerate(("s_in", "t_in", "a_in", "out")):
        _dense(tree[f"Dense_{i}"], layer, out, device)
    _time_embed(tree["TimeEmbed_0"], "temb.", out, device)
    _param(tree["pos"], "pos", out, device)
    for i, blk in enumerate(_indexed(tree, "Block")):
        _block(blk, f"blocks.{i}.", out, device)


def _beso(tree, out, device):
    """ScoreMLP (TimeEmbed_0, ResidualMLP_0) or ScoreGPT (Dense_0 the
    sigma embedding, pos_emb, Dense_1 / Dense_2 the state and action
    embeddings, Block_i, LayerNorm_0, Dense_3 / Dense_4 the head)."""
    if "pos_emb" not in tree:
        _ddpm(tree, out, device)
        return
    for i, layer in enumerate(("t_in", "s_in", "a_in", "hid", "out")):
        _dense(tree[f"Dense_{i}"], layer, out, device)
    _param(tree["pos_emb"], "pos_emb", out, device)
    for i, blk in enumerate(_indexed(tree, "Block")):
        _block(blk, f"blocks.{i}.", out, device)
    _layer_norm(tree["LayerNorm_0"], "ln_f", out, device)


def _conv(tree, prefix: str, out: dict, device) -> None:
    """Flax Conv {kernel [kh, kw, in, out], bias} -> the port's SameConv
    weight [out, in, kh, kw] (and bias where the layer has one)."""
    _param(np.asarray(tree["kernel"], np.float32).transpose(3, 2, 0, 1),
           prefix + ".weight", out, device)
    if "bias" in tree:
        _param(tree["bias"], prefix + ".bias", out, device)


def _camera_encoder(tree, prefix: str, out: dict, device) -> None:
    """Flax CameraEncoder (ResNet18_0/{Conv_0, GroupNorm_0, ResNetBlock_i/
    {Conv_0, GroupNorm_0, Conv_1, GroupNorm_1, shortcut Conv_2,
    GroupNorm_2}}, SpatialSoftmax_0/Conv_0, Dense_0) -> the port's
    (trunk.{stem, stem_gn, blocks.i.{conv1, gn1, conv2, gn2, short,
    short_gn}}, kp.conv, out)."""
    rn = tree["ResNet18_0"]
    _conv(rn["Conv_0"], prefix + "trunk.stem", out, device)
    _layer_norm(rn["GroupNorm_0"], prefix + "trunk.stem_gn", out, device)
    for i, blk in enumerate(_indexed(rn, "ResNetBlock")):
        p = f"{prefix}trunk.blocks.{i}."
        names = (("conv1", "gn1"), ("conv2", "gn2"), ("short", "short_gn"))
        for j, (conv, gn) in enumerate(names):
            if f"Conv_{j}" in blk:
                _conv(blk[f"Conv_{j}"], p + conv, out, device)
                _layer_norm(blk[f"GroupNorm_{j}"], p + gn, out, device)
    _conv(tree["SpatialSoftmax_0"]["Conv_0"], prefix + "kp.conv", out, device)
    _dense(tree["Dense_0"], prefix + "out", out, device)


def _prefixed(fn, prefix: str):
    """A tree converter writing its names under ``prefix``."""
    def convert(tree, out, device):
        part: dict = {}
        fn(tree, part, device)
        out.update({prefix + k: v for k, v in part.items()})
    return convert


def _vision(head: dict):
    """A vision agent's tree: the shared encoder (``_VisionCore_0`` of the
    compact modules, ``core`` of the setup ones) -> ``core.bp.`` /
    ``core.ih.``, and ``head``: Flax subtree name ("": the whole tree, for
    the compact modules' heads at its top) -> its converter."""
    def convert(tree, out, device):
        enc = tree.get("_VisionCore_0", tree.get("core"))
        enc = enc["MultiImageObsEncoder_0"]
        _camera_encoder(enc["CameraEncoder_0"], "core.bp.", out, device)
        _camera_encoder(enc["CameraEncoder_1"], "core.ih.", out, device)
        for name, fn in head.items():
            fn(tree[name] if name else tree, out, device)
    return convert


def _rmlp(prefix: str):
    return lambda t, o, d: _residual_mlp(t, prefix, o, d)


# agent name -> (Flax parameter tree, out, device) writing the port's names
_AGENT_TREES = {
    "bc": lambda t, o, d: _residual_mlp(t, "", o, d),
    "gmm": _gmm,
    "gpt_bc": lambda t, o, d: _gpt(t, "", o, d),
    "bet": lambda t, o, d: _gpt(t["GPT_0"], "gpt.", o, d),
    "bet_mlp": _bet_mlp,
    "act": _act,
    "cvae": _cvae,
    "lstm_gmm": _lstm_gmm,
    "ibc": lambda t, o, d: _residual_mlp(t["ResidualMLP_0"], "mlp.", o, d),
    "ddpm": _ddpm,
    "ddpm_encdec": _ddpm_encdec,
    "beso": _beso,
    "bc_vision": _vision({"ResidualMLP_0": _rmlp("head.")}),
    "bet_mlp_vision": _vision({"": _prefixed(_bet_mlp, "head.")}),
    "gmm_vision": _vision({"": _prefixed(_gmm, "head.")}),
    "ddpm_vision": _vision({
        "temb": lambda t, o, d: _time_embed(t, "den.temb.", o, d),
        "head": _rmlp("den.mlp.")}),
    "cvae_vision": _vision({"enc": _rmlp("enc."), "dec": _rmlp("dec.")}),
    "beso_vision": _vision({
        "temb": lambda t, o, d: _time_embed(t, "score.temb.", o, d),
        "head": _rmlp("score.mlp.")}),
    "act_vision": _vision({"act": _prefixed(_act, "act.")}),
    "ddpm_encdec_vision": _vision({"den": _prefixed(_ddpm_encdec, "den.")}),
    "ibc_vision": _vision({"ebm": lambda t, o, d: _residual_mlp(
        t["ResidualMLP_0"], "ebm.mlp.", o, d)}),
    "gpt_bc_vision": _vision({"gpt": lambda t, o, d: _gpt(t, "gpt.", o, d)}),
}
PORTED_AGENTS = tuple(sorted(_AGENT_TREES))


def agent_params_from_numpy(name: str, flax_params, device=None) -> dict:
    """The JAX package's parameter tree of agent ``name`` (one of
    ``PORTED_AGENTS``), as nested dicts of NumPy arrays, -> the port's
    ``agent.params``."""
    if name not in _AGENT_TREES:
        raise KeyError(f"agent {name!r} is not ported; ported: "
                       f"{list(PORTED_AGENTS)}")
    device = common.resolve_device(device)
    out: dict = {}
    _AGENT_TREES[name](flax_params.get("params", flax_params), out, device)
    return out


def scaler_from_numpy(scaler, device=None) -> Scaler:
    """The JAX package's Scaler (NamedTuple or mapping of arrays) -> the
    port's."""
    device = common.resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    fields = ("x_mean", "x_std", "y_mean", "y_std", "y_bounds", "x_bounds")
    return Scaler(*(f32(_get(scaler, f)) for f in fields),
                  bool(_get(scaler, "scale_data")))
