"""MLP backbones.

Counterpart of ``d3il_tpu/agents/nets/mlp.py``. ResidualMLP is the
reference's IBC-style pre-activation residual network (default activation
Mish, dropout 0, no norm in the benchmark configs). The layer products stay
``nn.Linear``; every layer starts from Flax ``Dense``'s initialiser (LeCun
normal weights, zero bias) so a model trained here starts from the
distribution the JAX one does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def mish(x):
    return x * torch.tanh(F.softplus(x))


_ACTS = {"Mish": mish, "ReLU": F.relu, "relu": F.relu, "tanh": torch.tanh,
         "gelu": F.gelu}


def dense(in_dim: int, out_dim: int,
          generator: torch.Generator) -> nn.Linear:
    """nn.Linear with Flax Dense's default initialiser: weights from a
    normal of std sqrt(1 / fan_in) truncated at 2 std (0.8796 restores the
    variance the truncation removes), zero bias. The weights are drawn from
    ``generator`` (inverse-CDF sampling of the truncated normal) and the
    layer lives on its device."""
    dev = generator.device
    layer = nn.Linear(in_dim, out_dim, device=dev)
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    u = torch.rand((out_dim, in_dim), generator=generator, device=dev)
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))      # Phi(-2)
    w = torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1) * (math.sqrt(2) * std)
    with torch.no_grad():
        layer.weight.copy_(w.clamp(-2 * std, 2 * std))
        layer.bias.zero_()
    return layer


class ResidualBlock(nn.Module):
    def __init__(self, hidden_dim: int, generator: torch.Generator, act=mish,
                 dropout_rate: float = 0.0, use_norm: bool = False):
        super().__init__()
        self.act = act
        self.fc1 = dense(hidden_dim, hidden_dim, generator)
        self.fc2 = dense(hidden_dim, hidden_dim, generator)
        self.drop = nn.Dropout(dropout_rate) if dropout_rate > 0 else None
        self.norm1 = nn.LayerNorm(hidden_dim, eps=1e-6) if use_norm else None
        self.norm2 = nn.LayerNorm(hidden_dim, eps=1e-6) if use_norm else None

    def _pre(self, h, norm):
        if norm is not None:
            h = norm(h)
        h = self.act(h)
        return h if self.drop is None else self.drop(h)

    def forward(self, x):
        h = self.fc1(self._pre(x, self.norm1))
        h = self.fc2(self._pre(h, self.norm2))
        return x + h


class ResidualMLP(nn.Module):
    """input layer -> num_hidden_layers // 2 residual blocks -> output layer
    (num_hidden_layers must be even: pairs form residual blocks)."""

    def __init__(self, input_dim: int, hidden_dim: int = 100,
                 num_hidden_layers: int = 4, output_dim: int = 2,
                 activation: str = "Mish", dropout_rate: float = 0.0,
                 use_norm: bool = False, *, generator: torch.Generator):
        super().__init__()
        act = _ACTS[activation]
        self.inp = dense(input_dim, hidden_dim, generator)
        self.blocks = nn.ModuleList(
            ResidualBlock(hidden_dim, generator, act, dropout_rate, use_norm)
            for _ in range(num_hidden_layers // 2))
        self.out = dense(hidden_dim, output_dim, generator)

    def forward(self, x):
        x = self.inp(x)
        for block in self.blocks:
            x = block(x)
        return self.out(x)


class MLP(nn.Module):
    """Plain MLP (reference MLPNetwork)."""

    def __init__(self, input_dim: int, hidden_dim: int = 100,
                 num_hidden_layers: int = 1, output_dim: int = 1,
                 activation: str = "ReLU", *,
                 generator: torch.Generator):
        super().__init__()
        self.act = _ACTS[activation]
        dims = [input_dim] + [hidden_dim] * num_hidden_layers
        self.hidden = nn.ModuleList(dense(a, b, generator)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.out = dense(dims[-1], output_dim, generator)

    def forward(self, x):
        for layer in self.hidden:
            x = self.act(layer(x))
        return self.out(x)
