"""Data scaler: per-dim z-score + bounds.

Counterpart of ``d3il_tpu/data/scaler.py``: the statistics are fitted in
float64 NumPy and held as float32 tensors on the device the agent runs on.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from d3il_tpu_torch.envs.common import resolve_device

_EPS = 1e-12


class Scaler(NamedTuple):
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor
    y_bounds: torch.Tensor   # [2, Da] scaled bounds
    x_bounds: torch.Tensor
    scale_data: bool = True

    @staticmethod
    def fit(x: np.ndarray, y: np.ndarray, scale_data: bool = True,
            device=None) -> "Scaler":
        device = resolve_device(device)
        x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
        y = np.asarray(y, np.float64).reshape(-1, y.shape[-1])
        xm, xs = x.mean(0), x.std(0)
        ym, ys = y.mean(0), y.std(0)
        if scale_data:
            yb = np.stack([(y.min(0) - ym) / (ys + _EPS),
                           (y.max(0) - ym) / (ys + _EPS)])
            xb = np.stack([(x.min(0) - xm) / (xs + _EPS),
                           (x.max(0) - xm) / (xs + _EPS)])
        else:
            yb = np.stack([y.min(0), y.max(0)])
            xb = np.stack([x.min(0), x.max(0)])
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        return Scaler(f32(xm), f32(xs), f32(ym), f32(ys), f32(yb), f32(xb),
                      scale_data)

    def scale_input(self, x):
        if not self.scale_data:
            return x
        return (x - self.x_mean) / (self.x_std + _EPS)

    def scale_output(self, y):
        if not self.scale_data:
            return y
        return (y - self.y_mean) / (self.y_std + _EPS)

    def inverse_scale_output(self, y):
        if not self.scale_data:
            return y
        return y * (self.y_std + _EPS) + self.y_mean

    def clip_action(self, y):
        """Clamp to 1.1x the scaled data bounds. NaN-safe: a diverged
        policy's NaN or infinite action becomes 0 before the clamp, so it
        never reaches the env state and the contact solve."""
        y = torch.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)
        return torch.minimum(torch.maximum(y, self.y_bounds[0] * 1.1),
                             self.y_bounds[1] * 1.1)
