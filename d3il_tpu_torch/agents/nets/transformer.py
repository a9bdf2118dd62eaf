"""Minimal causal GPT backbone.

Counterpart of ``d3il_tpu/agents/nets/transformer.py``: learned positional
embeddings, pre-LN blocks, causal self-attention, written out as plain
products so that it computes what the Flax module does: the tanh GELU,
LayerNorm with epsilon 1e-6, masked scores set to -1e9 (not -inf) before
the softmax, a zero-initialised ``pos_emb``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from d3il_tpu_torch.agents.nets.mlp import dense

LN_EPS = 1e-6


def layer_norm(dim: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS, device=device)


class CausalSelfAttention(nn.Module):
    def __init__(self, n_embd: int, n_head: int, generator: torch.Generator):
        super().__init__()
        self.n_head = n_head
        self.qkv = dense(n_embd, 3 * n_embd, generator)
        self.proj = dense(n_embd, n_embd, generator)

    def forward(self, x):
        B, T, C = x.shape
        H = self.n_head
        q, k, v = self.qkv(x).reshape(B, T, 3, H, C // H).unbind(dim=2)
        att = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(C // H)
        mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        att = torch.softmax(att.masked_fill(~mask, -1e9), dim=-1)
        y = torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, C)
        return self.proj(y)


class Block(nn.Module):
    def __init__(self, n_embd: int, n_head: int, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.ln1 = layer_norm(n_embd, dev)
        self.attn = CausalSelfAttention(n_embd, n_head, generator)
        self.ln2 = layer_norm(n_embd, dev)
        self.fc = dense(n_embd, 4 * n_embd, generator)
        self.proj = dense(4 * n_embd, n_embd, generator)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc(self.ln2(x)), approximate="tanh")
        return x + self.proj(h)


class GPT(nn.Module):
    """Token-level causal transformer over embedded inputs:
    x [B, T, input_dim] -> [B, T, output_dim]."""

    def __init__(self, input_dim: int, n_embd: int = 120, n_head: int = 4,
                 n_layer: int = 4, block_size: int = 16, output_dim: int = 2,
                 *, generator: torch.Generator):
        super().__init__()
        self.inp = dense(input_dim, n_embd, generator)
        self.pos_emb = nn.Parameter(torch.zeros((1, block_size, n_embd),
                                                device=generator.device))
        self.blocks = nn.ModuleList(Block(n_embd, n_head, generator)
                                    for _ in range(n_layer))
        self.ln_f = layer_norm(n_embd, generator.device)
        self.head = dense(n_embd, output_dim, generator)

    def forward(self, x):
        h = self.inp(x) + self.pos_emb[:, :x.shape[1]]
        for block in self.blocks:
            h = block(h)
        return self.head(self.ln_f(h))


def normal_param(shape, std: float, generator: torch.Generator):
    """A parameter drawn from N(0, std^2) (Flax's ``normal(std)``)."""
    return nn.Parameter(std * torch.randn(shape, generator=generator,
                                          device=generator.device))
