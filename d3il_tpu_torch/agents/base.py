"""Agent base: training loop, optimizer, checkpoint utilities.

Counterpart of ``d3il_tpu/agents/base.py``. An agent's parameters are a
plain ``{name: tensor}`` dict (``params_of(model)``) applied with
``torch.func.functional_call``, so the loop tracks live, EMA and best
parameters as values, as the JAX loop does. Training is epochs of minibatch
steps over device-resident window tensors, periodic validation, best-params
tracking, and a ``torch.save`` checkpoint of the full train state that a
later ``fit`` with the same directory resumes from. Data parallel over a
process group (``parallel/mesh.py``) when given a mesh or run under a group
of more than one process.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from d3il_tpu_torch.data import dataset as ds
from d3il_tpu_torch.envs.common import resolve_device
from d3il_tpu_torch.parallel import mesh as pmesh


@dataclass
class TrainConfig:
    epochs: int = 100
    batch_size: int = 1024
    lr: float = 1e-3
    weight_decay: float = 0.0
    eval_every_n_epochs: int = 10
    window_size: int = 1
    steps_per_epoch: int | None = None  # default: n_windows // batch_size
    ema_decay: float | None = None      # e.g. 0.995 for diffusion agents


GRAD_CLIP_NORM = 10.0


def params_of(model: torch.nn.Module) -> dict:
    """The model's parameters as a {name: tensor} dict of detached copies."""
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def make_optimizer(cfg: TrainConfig, params: dict):
    """Adam (AdamW with decoupled decay when weight_decay > 0) over the
    tensors of ``params``. ``train_step`` clips the gradient to a global
    norm of 10 first (``clip_by_global_norm``): sharp-mixture NLLs (GMM
    with the 1e-4 std floor) spike to 1e7-scale on off-component residuals
    and the raw Adam step then destabilizes the whole run."""
    tensors = list(params.values())
    if cfg.weight_decay > 0:
        return torch.optim.AdamW(tensors, lr=cfg.lr,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.Adam(tensors, lr=cfg.lr)


def train_step(loss_fn: Callable, params: dict, opt, obs, act, generator,
               mesh: pmesh.DataMesh | None = None):
    """One clipped optimizer step on a minibatch, in place on ``params``
    (whose tensors require grad). With a ``mesh``, ``obs`` and ``act`` are
    this rank's rows and the gradient is all-reduced as a mean over the
    ranks before the clip, so that the clip and the step see the gradient
    of the whole minibatch. Returns the detached loss (of this rank's
    rows)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, obs, act, generator)
    loss.backward()
    grads = [p.grad for p in params.values() if p.grad is not None]
    if mesh is not None:
        pmesh.all_reduce_mean(mesh, grads)
    clip_by_global_norm(grads, GRAD_CLIP_NORM)
    opt.step()
    return loss.detach()


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float):
    """``optax.clip_by_global_norm``, in place: below ``max_norm`` the
    gradients stay as they are, else each becomes g / norm * max_norm.
    (``torch.nn.utils.clip_grad_norm_`` scales by max_norm / (norm + 1e-6),
    which moves a clipped step by 1e-7 relative.) Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


def _copy(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


def _resume_state(path: str, mesh: pmesh.DataMesh | None, device):
    """The checkpoint at ``path`` to resume from, or None. Under a mesh,
    rank 0 alone reads it and broadcasts it, so every rank resumes from
    rank 0's state, or none, whether or not it sees rank 0's files."""
    if mesh is None:
        return load_checkpoint(path, device) if os.path.exists(path) \
            else None
    st = load_checkpoint(path, "cpu") \
        if mesh.rank == 0 and os.path.exists(path) else None
    st = pmesh.broadcast_object(mesh, st)
    return None if st is None else pmesh.tree_map(lambda x: x.to(device), st)


def fit(loss_fn: Callable, params: dict, train_data: ds.TrajectoryData,
        val_data: ds.TrajectoryData | None, cfg: TrainConfig,
        generator: torch.Generator, val_metric_fn: Callable | None = None,
        log_every: int = 0, callback=None, checkpoint_dir: str | None = None,
        checkpoint_every: int = 0, mesh: pmesh.DataMesh | None = None):
    """Generic training loop.

    loss_fn(params, obs_window [B,W,Do], act_window [B,W,Da], generator)
    -> scalar. val_metric_fn(params, obs, act) -> scalar (defaults to the
    loss). ``generator`` lives on the data's device and drives the minibatch
    sampling. Returns (best_params, final_params, history).

    Validation draws its windows from a generator of its own, seeded from
    ``generator``'s seed and the epoch, and calls the loss with a generator
    seeded 0, as the JAX loop takes a key of its own and PRNGKey(0): the
    training stream is the same with or without validation.

    Data parallel, with a ``mesh`` (``parallel/mesh.py``) or, given none,
    under an initialized process group of more than one process: the
    minibatch indices of the global batch come from ``generator``, whose
    state is the same on every rank, and each rank takes its
    ``batch_size / world`` rows (the world size must divide the batch);
    the gradient is all-reduced as a mean before the clip and the epoch
    loss after each epoch, so ``history`` is the same on every rank; params
    are broadcast from rank 0 at the start; only rank 0 reads the
    checkpoint to resume from, and broadcasts it, and only rank 0 writes
    one. Over more than one rank the loss's own draws come from a
    generator of each rank's own, seeded from ``generator``'s seed, the
    epoch and the rank (``pmesh.rank_generator``), so a stochastic loss
    trains on other draws than in one process; over one rank they come
    from ``generator``, as with no mesh.

    With ``checkpoint_dir`` and ``checkpoint_every > 0`` the full train
    state (params, EMA params, optimizer state, best params, epoch,
    generator state) is saved every N epochs, and a later fit() with the
    same directory resumes from the last one.
    """
    if mesh is None:
        mesh = pmesh.default_mesh()
    if mesh is not None and cfg.batch_size % mesh.world:
        raise ValueError(f"batch_size {cfg.batch_size} does not divide over "
                         f"{mesh.world} ranks")
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    if mesh is not None:
        pmesh.replicate(mesh, params)
    opt = make_optimizer(cfg, params)
    spe = cfg.steps_per_epoch or max(1, train_data.n_windows // cfg.batch_size)
    ema = cfg.ema_decay
    seed = generator.initial_seed()
    seeded = lambda s: torch.Generator(device=generator.device).manual_seed(s)

    def train_epoch(ema_params, epoch):
        loss_gen = generator if mesh is None or mesh.world == 1 else \
            pmesh.rank_generator(mesh, pmesh.rank_seed(seed, epoch),
                                 generator.device)
        losses = []
        for _ in range(spe):
            obs, act = ds.sample_windows(train_data, generator,
                                         cfg.batch_size, cfg.window_size)
            if mesh is not None:
                obs, act = pmesh.shard_batch(mesh, (obs, act))
            losses.append(train_step(loss_fn, params, opt, obs, act,
                                     loss_gen, mesh))
            if ema is not None:
                with torch.no_grad():
                    for k, e in ema_params.items():
                        e.mul_(ema).add_(params[k], alpha=1 - ema)
        loss = torch.stack(losses).mean()
        if mesh is not None:
            pmesh.all_reduce_mean(mesh, [loss])
        return loss.item()

    @torch.no_grad()
    def evaluate(p, epoch):
        obs, act = ds.sample_windows(val_data,
                                     seeded(pmesh.rank_seed(seed, epoch,
                                                            "val")),
                                     min(4096, val_data.n_windows),
                                     cfg.window_size)
        if val_metric_fn is not None:
            return float(val_metric_fn(p, obs, act))
        return float(loss_fn(p, obs, act, seeded(0)))

    best_params, best_val = _copy(params), np.inf
    ema_params = _copy(params)
    history = []
    start_epoch = 0
    state_path = os.path.join(checkpoint_dir, "state.pt") \
        if checkpoint_dir else None
    st = _resume_state(state_path, mesh, generator.device) \
        if state_path else None
    if st is not None:
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(st["params"][k])
        ema_params = _copy(st["ema_params"])
        opt.load_state_dict(st["opt_state"])
        best_params = _copy(st["best_params"])
        best_val = float(st["best_val"])
        generator.set_state(st["generator_state"].cpu())
        seed = generator.initial_seed()
        start_epoch = int(st["epoch"]) + 1
        print(f"resumed from {checkpoint_dir} at epoch {start_epoch}")
        if start_epoch >= cfg.epochs:
            # fully-trained checkpoint: the loop below runs zero epochs;
            # replay the last real epoch loss so callers reading
            # history[-1] work
            history.append({"epoch": start_epoch - 1,
                            "train_loss": float(st["last_train_loss"]),
                            "resumed_complete": True})
    for epoch in range(start_epoch, cfg.epochs):
        train_loss = train_epoch(ema_params, epoch)
        eval_candidate = ema_params if ema is not None else params
        rec = {"epoch": epoch, "train_loss": train_loss}
        if val_data is not None and (epoch + 1) % cfg.eval_every_n_epochs == 0:
            val = evaluate(eval_candidate, epoch)
            rec["val_loss"] = val
            if val < best_val:
                best_val, best_params = val, _copy(eval_candidate)
        history.append(rec)
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch+1}/{cfg.epochs} loss {rec['train_loss']:.5f}"
                  + (f" val {rec.get('val_loss'):.5f}" if "val_loss" in rec else ""))
        if callback is not None:
            # the deployable weights for this epoch (EMA when ema_decay is
            # set), the track fit() itself returns as final_params
            callback(epoch, eval_candidate, rec)
        if state_path and checkpoint_every and \
                (epoch + 1) % checkpoint_every == 0 and \
                (mesh is None or mesh.rank == 0):
            save_checkpoint(state_path, params,
                            extra={"ema_params": ema_params,
                                   "opt_state": opt.state_dict(),
                                   "best_params": best_params,
                                   "best_val": float(best_val),
                                   "last_train_loss": rec["train_loss"],
                                   "epoch": epoch,
                                   "generator_state": generator.get_state()})
    final_params = _copy(ema_params if ema is not None else params)
    if val_data is None:
        best_params = final_params
    return best_params, final_params, history


def save_checkpoint(path: str, params: dict, extra: dict | None = None):
    """Full-state checkpoint: one ``torch.save`` of nested dicts of tensors
    and plain Python values."""
    payload = {"params": _copy(params)}
    if extra:
        payload.update(extra)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=None):
    return torch.load(path, map_location=resolve_device(device),
                      weights_only=True)


def gumbel(shape, generator: torch.Generator):
    """Standard Gumbel draws -log(-log(u)), u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def draw_categorical(logits, generator: torch.Generator, g=None):
    """One categorical draw per row of ``logits`` [..., K] -> [...] int64:
    the argmax of logits plus standard Gumbel draws ``g`` (drawn from
    ``generator`` unless given), the form of ``jax.random.categorical``."""
    if g is None:
        g = gumbel(logits.shape, generator)
    return torch.argmax(logits + g, dim=-1)


class _Bound(torch.nn.Module):
    """``model.<method>`` as a module's forward, for functional_call."""

    def __init__(self, model: torch.nn.Module, method: str):
        super().__init__()
        self.m, self.method = model, method

    def forward(self, *args):
        return getattr(self.m, self.method)(*args)


def call_method(model: torch.nn.Module, params: dict, method: str, *args):
    """``model.<method>(*args)`` with ``params`` in place of the model's
    own parameters (Flax's ``apply(params, ..., method=)``)."""
    return torch.func.functional_call(
        _Bound(model, method), {"m." + k: v for k, v in params.items()},
        args)
