"""Agent base: training loop, optimizer, checkpoint utilities.

Counterpart of ``d3il_tpu/agents/base.py``. An agent's parameters are a
plain ``{name: tensor}`` dict (``params_of(model)``) applied with
``torch.func.functional_call``, so the loop tracks live, EMA and best
parameters as values, as the JAX loop does. Training is epochs of minibatch
steps over device-resident window tensors, periodic validation, best-params
tracking, and a ``torch.save`` checkpoint of the full train state that a
later ``fit`` with the same directory resumes from. One device: no mesh.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from d3il_tpu_torch.data import dataset as ds
from d3il_tpu_torch.envs.common import resolve_device


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
    norm of 10 first: sharp-mixture NLLs (GMM with the 1e-4 std floor) spike
    to 1e7-scale on off-component residuals and the raw Adam step then
    destabilizes the whole run."""
    tensors = list(params.values())
    if cfg.weight_decay > 0:
        return torch.optim.AdamW(tensors, lr=cfg.lr,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.Adam(tensors, lr=cfg.lr)


def train_step(loss_fn: Callable, params: dict, opt, obs, act, generator):
    """One clipped optimizer step on a minibatch, in place on ``params``
    (whose tensors require grad). Returns the detached loss."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, obs, act, generator)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(list(params.values()), GRAD_CLIP_NORM)
    opt.step()
    return loss.detach()


def _copy(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


def fit(loss_fn: Callable, params: dict, train_data: ds.TrajectoryData,
        val_data: ds.TrajectoryData | None, cfg: TrainConfig,
        generator: torch.Generator, val_metric_fn: Callable | None = None,
        log_every: int = 0, callback=None, checkpoint_dir: str | None = None,
        checkpoint_every: int = 0):
    """Generic training loop.

    loss_fn(params, obs_window [B,W,Do], act_window [B,W,Da], generator)
    -> scalar. val_metric_fn(params, obs, act) -> scalar (defaults to the
    loss). ``generator`` lives on the data's device and drives the minibatch
    sampling. Returns (best_params, final_params, history).

    With ``checkpoint_dir`` and ``checkpoint_every > 0`` the full train
    state (params, EMA params, optimizer state, best params, epoch,
    generator state) is saved every N epochs, and a later fit() with the
    same directory resumes from the last one.
    """
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    opt = make_optimizer(cfg, params)
    spe = cfg.steps_per_epoch or max(1, train_data.n_windows // cfg.batch_size)
    ema = cfg.ema_decay

    def train_epoch(ema_params):
        losses = []
        for _ in range(spe):
            obs, act = ds.sample_windows(train_data, generator,
                                         cfg.batch_size, cfg.window_size)
            losses.append(train_step(loss_fn, params, opt, obs, act,
                                     generator))
            if ema is not None:
                with torch.no_grad():
                    for k, e in ema_params.items():
                        e.mul_(ema).add_(params[k], alpha=1 - ema)
        return torch.stack(losses).mean().item()

    @torch.no_grad()
    def evaluate(p):
        obs, act = ds.sample_windows(val_data, generator,
                                     min(4096, val_data.n_windows),
                                     cfg.window_size)
        if val_metric_fn is not None:
            return float(val_metric_fn(p, obs, act))
        return float(loss_fn(p, obs, act, generator))

    best_params, best_val = _copy(params), np.inf
    ema_params = _copy(params)
    history = []
    start_epoch = 0
    state_path = os.path.join(checkpoint_dir, "state.pt") \
        if checkpoint_dir else None
    if state_path and os.path.exists(state_path):
        st = load_checkpoint(state_path, device=generator.device)
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(st["params"][k])
        ema_params = _copy(st["ema_params"])
        opt.load_state_dict(st["opt_state"])
        best_params = _copy(st["best_params"])
        best_val = float(st["best_val"])
        generator.set_state(st["generator_state"].cpu())
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
        train_loss = train_epoch(ema_params)
        eval_candidate = ema_params if ema is not None else params
        rec = {"epoch": epoch, "train_loss": train_loss}
        if val_data is not None and (epoch + 1) % cfg.eval_every_n_epochs == 0:
            val = evaluate(eval_candidate)
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
                (epoch + 1) % checkpoint_every == 0:
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
