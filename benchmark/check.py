"""The comparison that decides ``correct``: what the timed path produced,
against the frozen plain reference (``benchmark/reference``) run on the
same inputs, env by env.

The records compared are the reset (the reference resets the same
contexts with its own Params(), so the start is checked by itself) and
two steps of the window drawn from the seed (the reference steps from the
program's state before each: a contact simulation in float32 drifts apart
over many steps, so the reference follows the program step by step).
Every output is compared: the new state, the observation, the reward,
done and the info.

Per env, a float leaf's error is its largest absolute difference over the
env's elements, over a scale: the root mean square of the reference's
leaf over the whole batch, or the median leaf's, whichever is larger. The
numbers compared, each the worst over the records:

  * ``err_med``: the median over the envs of an env's worst leaf. Contact
    onsets make a few envs' velocities and forces differ widely between
    any two float32 evaluations (the reference against itself from a
    state one ulp away reads the same: ``harness.UlpWitness``), so the
    bulk is compared here;
  * ``err_p90``, ``err_p99``: the 90th and 99th percentiles over the envs
    of the same, the tail: a fault in fewer than half of the envs (one
    kind of contact, one phase of the expert) moves them where it leaves
    the median. A cell's limits file compares the percentile that its
    witness keeps clear of the contact onsets' share of envs;
  * ``pos_max``: the largest error of any env in a position of the new
    state: joint and box positions and orientations, the controller's
    virtual posture and setpoint. Where contact onsets move positions as
    far as a lower precision does (pushing's rod striking a box), a
    cell's limits file holds no limit for it, and it is printed only;
  * ``flips``: the envs whose discrete outputs (step counters, done,
    success, modes) differ anywhere: an exact comparison, limit 0.

A number whose limit is null is printed beside "not compared".

The reference runs in blocks of envs (the mix's ``ref_block``) so that it
fits beside what the program left, after the window has closed.
"""
from __future__ import annotations

import math

import torch

NUMBERS = ("err_med", "err_p90", "err_p99", "pos_max", "flips")
# quantiles over the envs of an env's worst leaf, by number
QUANTILES = {"err_med": 0.5, "err_p90": 0.9, "err_p99": 0.99}
# leaves that hold a position (by their last name), for pos_max
POSITIONS = {"q", "free_pos", "free_quat", "q_virt", "ctrl_q", "target_xy"}


def leaves(x, path=""):
    """[(path, tensor)] of nested NamedTuples, tuples and dicts."""
    if isinstance(x, torch.Tensor):
        return [(path, x)]
    if isinstance(x, dict):
        return [l for k in sorted(x) for l in leaves(x[k], f"{path}.{k}")]
    if hasattr(x, "_fields"):
        return [l for k, v in zip(x._fields, x)
                for l in leaves(v, f"{path}.{k}")]
    if isinstance(x, (tuple, list)):
        return [l for i, v in enumerate(x) for l in leaves(v, f"{path}.{i}")]
    return []


def to_types(x, types: dict):
    """``x`` with every NamedTuple rebuilt as the class of the same name in
    ``types`` (the reference's), tensors kept."""
    if hasattr(x, "_fields"):
        cls = types.get(type(x).__name__, type(x))
        return cls(*(to_types(v, types) for v in x))
    if isinstance(x, dict):
        return {k: to_types(v, types) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_types(v, types) for v in x)
    return x


def tensor_map(f, x):
    """``x`` with ``f`` applied to every tensor in it."""
    if isinstance(x, torch.Tensor):
        return f(x)
    if hasattr(x, "_fields"):
        return type(x)(*(tensor_map(f, v) for v in x))
    if isinstance(x, dict):
        return {k: tensor_map(f, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(tensor_map(f, v) for v in x)
    return x


def rows(x, lo: int, hi: int):
    """Envs lo:hi of every tensor in ``x`` (batch first)."""
    return tensor_map(lambda t: t[lo:hi], x)


class Tally:
    """Per-env differences of one record, gathered block by block."""

    def __init__(self):
        self.diff = {}      # float leaf -> [B] largest |cand - ref| per env
        self.sq = {}        # float leaf -> (sum of ref^2, count)
        self.flip = []      # [block] bool: a discrete output differs
        self.nonfinite = 0  # envs whose candidate output is not finite

    def add(self, cand, ref):
        cl, rl = leaves(cand), leaves(ref)
        if [p for p, _ in cl] != [p for p, _ in rl]:
            raise ValueError("candidate and reference outputs differ in "
                             "structure")
        B = rl[0][1].shape[0]
        flip = torch.zeros(B, dtype=torch.bool, device=rl[0][1].device)
        bad = torch.zeros_like(flip)
        for (path, c), (_, r) in zip(cl, rl):
            c = c.to(r.device).reshape(B, -1)
            r = r.reshape(B, -1)
            if r.is_floating_point():
                c64, r64 = c.double(), r.double()
                d = (c64 - r64).abs().amax(dim=1)
                d = torch.where(torch.isfinite(c64).all(dim=1), d,
                                torch.full_like(d, math.inf))
                bad |= ~torch.isfinite(c64).all(dim=1)
                self.diff.setdefault(path, []).append(d)
                s, n = self.sq.get(path, (0.0, 0))
                self.sq[path] = (s + float((r64 ** 2).sum()), n + r.numel())
            else:
                flip |= (c != r).any(dim=1)
        self.flip.append(flip)
        self.nonfinite += int(bad.sum())

    def numbers(self):
        """(numbers, per-leaf largest scaled error)."""
        rms = {p: math.sqrt(s / max(n, 1)) for p, (s, n) in self.sq.items()}
        floor = sorted(rms.values())[len(rms) // 2] if rms else 0.0
        per_env, per_leaf, pos = None, {}, 0.0
        for path, parts in self.diff.items():
            e = torch.cat(parts) / max(rms[path], floor, 1e-30)
            per_leaf[path] = float(e.max())
            if path.rsplit(".", 1)[-1] in POSITIONS:
                pos = max(pos, per_leaf[path])
            per_env = e if per_env is None else torch.maximum(per_env, e)
        flips = int(torch.cat(self.flip).sum()) if self.flip else 0
        nums = {k: 0.0 for k in QUANTILES}
        if per_env is not None:
            e = per_env.float().cpu()
            nums = {k: float(torch.quantile(e, q))
                    for k, q in QUANTILES.items()}
            # printed in the detail only
            nums["err_p999"] = float(torch.quantile(e, 0.999))
        return {**nums, "pos_max": pos, "flips": flips}, per_leaf


def compare(records, cand_fn, ref_fn, batch: int, block: int):
    """Run ``cand_fn(record, lo, hi)`` and ``ref_fn(record, lo, hi)`` over
    blocks of envs for each record; returns (numbers, per-record detail):
    each number the worst over the records, NaN where a candidate output
    was not finite."""
    worst = {k: 0 for k in NUMBERS}
    detail = []
    for rec in records:
        t = Tally()
        for lo in range(0, batch, block):
            hi = min(lo + block, batch)
            ref = ref_fn(rec, lo, hi)
            t.add(cand_fn(rec, lo, hi), ref)
            del ref
        nums, per_leaf = t.numbers()
        if t.nonfinite:
            nums = {k: math.nan for k in nums}
        summary = {k: round(float(v), 4)
                   for k, v in rec.get("policy", {}).items()}
        detail.append({"record": rec["what"], **nums, "policy": summary,
                       "nonfinite_envs": t.nonfinite,
                       "worst_leaves": sorted(per_leaf.items(),
                                              key=lambda kv: -kv[1])[:4]})
        for k in NUMBERS:
            if math.isnan(nums[k]) or math.isnan(worst[k]):
                worst[k] = math.nan
            else:
                worst[k] = max(worst[k], nums[k])
    return worst, detail


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number finite, and within its limit where it has one."""
    return all(math.isfinite(numbers[k])
               and (limits[k] is None or numbers[k] <= limits[k])
               for k in NUMBERS)
