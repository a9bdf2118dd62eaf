"""Success / behavioral-entropy / KL metrics, on device.

Counterpart of ``d3il_tpu/eval/metrics.py``; the formulas match the
reference harness per task:
  * pushing: per-context mode distribution over successful rollouts,
    entropy normalized by log(4); score 0.5*(SR + H)
  * avoiding: 9-bit mode decoding, entropy base 24; score 0.8*SR + 0.2*H
  * aligning: 2 modes, entropy over all contexts; score 0.5*(SR + H)
  * sorting: entropy + KL(p(m|c) || demo prior) over nonzero contexts,
    both log-normalized by log(n_modes); score SR - KL
  * stacking: per-prefix (1/2/3-box) entropy + KL vs demo priors;
    score SR1 + SR2 + SR3
Inputs are tensors (successes float, modes integer); priors and mode keys
may be NumPy arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _like(x, ref, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=dtype, device=ref.device)


def mode_probs_per_context(modes, successes, n_modes: int):
    """modes [C, T] int, successes [C, T] {0,1} -> normalized p(m|c) [C, M].

    Only successful rollouts count. A mode outside [0, M) (-1: none yet)
    counts toward no bin."""
    valid = (modes >= 0) & (modes < n_modes)
    onehot = F.one_hot(torch.where(valid, modes, 0).long(), n_modes) \
        * (valid * successes)[..., None]
    counts = onehot.sum(dim=1)  # [C, M]
    return counts / (counts.sum(dim=1, keepdim=True) + 1e-12)


def entropy(mode_probs, n_modes: int):
    """Mean normalized entropy over contexts."""
    h = -(mode_probs * torch.log(mode_probs + 1e-12)
          / math.log(float(n_modes))).sum(-1)
    return h.mean()


def entropy_kl_nonzero(mode_probs, prior, n_modes: int):
    """Entropy and KL over contexts with at least one successful rollout:
    all-zero rows are dropped before averaging; both entropy and cross term
    are normalized by log(n_modes); KL = -H - mean_c sum_m p(m|c) log
    prior(m) / log M."""
    row_ok = mode_probs.sum(-1) > 1e-6
    denom = torch.clamp(row_ok.sum(), min=1)
    logM = math.log(float(n_modes))
    prior = _like(prior, mode_probs)
    h_rows = -(mode_probs * torch.log(mode_probs + 1e-12) / logM).sum(-1)
    x_rows = (mode_probs * torch.log(prior + 1e-12) / logM).sum(-1)
    zero = torch.zeros_like(h_rows)
    h = torch.where(row_ok, h_rows, zero).sum() / denom
    log_ = torch.where(row_ok, x_rows, zero).sum() / denom
    return h, -h - log_


def pushing_score(successes, modes):
    sr = successes.mean()
    probs = mode_probs_per_context(modes, successes, 4)
    h = entropy(probs, 4)
    return {"success_rate": sr, "entropy": h, "score": 0.5 * (sr + h)}


def avoiding_score(successes, mode_encodings):
    """successes [N], mode_encodings [N, 9] -> SR + pooled entropy base 24
    over the bit-packed encodings of the successful rollouts."""
    sr = successes.mean()
    weights = _like((1 << np.arange(9)).astype(np.float32), successes)
    dec = (mode_encodings * weights[None, :]).sum(-1)
    ok = (successes > 0.5).to(torch.float32)
    # histogram over the 512 possible encodings, successful rollouts only
    counts = torch.zeros(512, device=successes.device).scatter_add_(
        0, dec.long(), ok)
    p = counts / (counts.sum() + 1e-12)
    h = -torch.sum(torch.where(p > 0, p * torch.log(p + 1e-12),
                               torch.zeros_like(p))) / math.log(24.0)
    return {"success_rate": sr, "entropy": h, "score": 0.8 * sr + 0.2 * h}


def aligning_score(successes, modes, mean_distance=None):
    """successes/modes [C, T]; 2 modes (inside/outside push),
    score 0.5*(SR + H)."""
    sr = successes.mean()
    probs = mode_probs_per_context(modes, successes, 2)
    h = entropy(probs, 2)
    out = {"success_rate": sr, "entropy": h, "score": 0.5 * (sr + h)}
    if mean_distance is not None:
        # rollouts whose physics diverged would poison a plain mean:
        # average the finite entries and report the diverged fraction
        ok = torch.isfinite(mean_distance)
        n_ok = torch.clamp(ok.sum(), min=1)
        out["mean_distance"] = torch.where(
            ok, mean_distance, torch.zeros_like(mean_distance)).sum() / n_ok
        out["nonfinite_frac"] = 1.0 - ok.to(torch.float32).mean()
    return out


def sorting_score(successes, modes, mode_keys, prior):
    """successes [C,T]; modes [C,T] = bit-packed color orders. mode_keys:
    the distinct encodings seen in the demo data; prior: their demo
    probabilities. Rollout modes outside mode_keys count toward no bin.
    Score SR - KL."""
    mode_keys = _like(mode_keys, successes, modes.dtype)
    n_modes = mode_keys.shape[0]
    eq = modes[..., None] == mode_keys[None, None, :]  # [C,T,M]
    counts = (eq * successes[..., None]).sum(dim=1)
    probs = counts / (counts.sum(-1, keepdim=True) + 1e-12)
    h, kl = entropy_kl_nonzero(probs, prior, n_modes)
    sr = successes.mean()
    return {"success_rate": sr, "entropy": h, "kl": kl, "score": sr - kl}


# stacking prefix encodings:
#   1-box: r=0 g=1 b=2;  2-box & 3-box share the table
#   rg=0 rb=1 gr=2 gb=3 br=4 bg=5 (the third box is determined by the first two)
def stacking_prefix_codes(order):
    """order [..., 3] box-index arrival order (0=r,1=g,2=b; -1 unfilled) ->
    (code1 [..],  code2 [..]) with -1 where the prefix is unfilled."""
    first, second = order[..., 0], order[..., 1]
    code1 = first
    shifted = second - (second > first).to(second.dtype)
    code2 = torch.where((first >= 0) & (second >= 0), first * 2 + shifted,
                        torch.full_like(first, -1))
    return code1, code2


def stacking_score(order, mode_len, successes, successes_1, successes_2,
                   prior_1, prior_2, prior_3):
    """order [C,T,3], mode_len [C,T]; successes* [C,T]. Per-prefix
    entropy/KL vs the demo priors; score = SR1 + SR2 + SR3."""
    code1, code2 = stacking_prefix_codes(order)
    code3 = code2  # the 3-box encoding equals the 2-box code

    def cal(codes, succ, prior, n):
        probs = mode_probs_per_context(torch.clamp(codes, min=0),
                                       succ * (codes >= 0), n)
        return entropy_kl_nonzero(probs, prior, n)

    h1, kl1 = cal(code1, successes_1, prior_1, 3)
    h2, kl2 = cal(code2, successes_2, prior_2, 6)
    h3, kl3 = cal(code3, successes, prior_3, 6)
    sr1 = successes_1.mean()
    sr2 = successes_2.mean()
    sr = successes.mean()
    return {"success_rate": sr, "success_rate_1": sr1, "success_rate_2": sr2,
            "entropy_1": h1, "kl_1": kl1, "entropy_2": h2, "kl_2": kl2,
            "entropy_3": h3, "kl_3": kl3, "score": sr1 + sr2 + sr}


def inserting_score(successes, modes):
    """successes/modes [C, T]; modes are the reference ids 1..6 (0 while
    incomplete). The composite follows the pushing convention: per-context
    entropy over the 6 orders, score 0.5*(SR + H)."""
    sr = successes.mean()
    probs = mode_probs_per_context(torch.clamp(modes - 1, min=0),
                                   successes * (modes > 0), 6)
    h = entropy(probs, 6)
    return {"success_rate": sr, "entropy": h, "score": 0.5 * (sr + h)}


def kl_to_prior(mode_probs, prior):
    """KL(p || prior) averaged over contexts."""
    p = mode_probs
    prior = _like(prior, p)
    return (p * (torch.log(p + 1e-12) - torch.log(prior + 1e-12))).sum(-1).mean()
