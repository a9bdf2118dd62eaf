"""Fixed evaluation contexts and demonstration mode priors.

Counterpart of ``d3il_tpu/eval/contexts.py`` (pure NumPy; its own copy).

The reference benchmark evaluates on *fixed* context sets shipped as pickles
(environments/dataset/data/{pushing,aligning,stacking}/test_contexts.pkl,
generated by the data/*/get_contexts.py scripts with a pinned seed) and, for
stacking, scores KL against a demo-derived mode prior
(data/stacking/mode_prob.pkl, consumed at simulation/stacking_sim.py:39-63).

Those artifacts are copied verbatim (they are data, not code) into
data/ref_contexts/ so agent-parity claims are checkable against the exact
contexts the reference uses, and are read from there directly. Tasks without
a shipped context file (avoiding, sorting, inserting) keep the seed-2
sampling fallback in eval/sims.py.

Demo-derived sorting/stacking priors for OUR generated datasets come from
`mode_prior_from_demos`, mirroring how the reference derives mode_prob.pkl
from its recorded human demos (data/sorting/check_mode.py semantics).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REF_DIR = os.environ.get("D3IL_TPU_REF_CONTEXTS",
                         os.path.join(_HERE, "data", "ref_contexts"))


def _load(name):
    path = os.path.join(REF_DIR, name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def pushing_contexts():
    """Reference pushing test contexts (60) -> repo context pytree
    (red_xy [N,2], red_quat [N,4], green_xy [N,2], green_quat [N,4]).

    Each raw entry is [red_pos3(x, y, deg), red_quat, green_pos3, green_quat]
    (pushing.py BlockContextManager.sample); only xy + quat are consumed by
    set_context (pushing.py:120-140)."""
    raw = _load("pushing_test_contexts.pkl")
    if raw is None:
        return None
    red = np.stack([np.asarray(c[0][:2], np.float32) for c in raw])
    red_q = np.stack([np.asarray(c[1], np.float32) for c in raw])
    green = np.stack([np.asarray(c[2][:2], np.float32) for c in raw])
    green_q = np.stack([np.asarray(c[3], np.float32) for c in raw])
    return red, red_q, green, green_q


def aligning_contexts():
    """Reference aligning test contexts (60) -> (box_xy, box_quat, tgt_xy,
    tgt_quat) stacked arrays (aligning.py set_context consumes pos[:2]+quat)."""
    raw = _load("aligning_test_contexts.pkl")
    if raw is None:
        return None
    box = np.stack([np.asarray(c[0][:2], np.float32) for c in raw])
    box_q = np.stack([np.asarray(c[1], np.float32) for c in raw])
    tgt = np.stack([np.asarray(c[2][:2], np.float32) for c in raw])
    tgt_q = np.stack([np.asarray(c[3], np.float32) for c in raw])
    return box, box_q, tgt, tgt_q


def stacking_contexts():
    """Reference stacking test contexts (100) -> (xy [N,4,2], quat [N,4,4]):
    rows = red, green, blue boxes + target (stacking.py ContextManager.sample
    returns 4 [pos3, quat] pairs)."""
    raw = _load("stacking_test_contexts.pkl")
    if raw is None:
        return None
    xy = np.stack([np.stack([np.asarray(e[0][:2], np.float32) for e in c])
                   for c in raw])
    quat = np.stack([np.stack([np.asarray(e[1], np.float32) for e in c])
                     for c in raw])
    return xy, quat


# stacking_sim.py:43-45 mode tables: index order of the shipped prior dict
_MODE3_KEYS = ("rgb", "rbg", "grb", "gbr", "brg", "bgr")


def stacking_mode_priors():
    """(p1 [3], p2 [6], p3 [6]) from the shipped mode_prob.pkl, reproducing
    stacking_sim.py:47-63: p3[i] = prob of the i-th mode_3 key; the 2-box
    prior reuses the same vector (each mode_2 key is the unique 2-prefix of
    one mode_3 key); p1 sums adjacent pairs (r, g, b first-box marginals)."""
    d = _load("stacking_mode_prob.pkl")
    if d is None:
        return None
    p3 = np.array([d[k] for k in _MODE3_KEYS], np.float32)
    p2 = p3.copy()
    p1 = np.array([p3[0] + p3[1], p3[2] + p3[3], p3[4] + p3[5]], np.float32)
    return p1, p2, p3


def mode_prior_from_demos(task_dir: str):
    """Empirical mode distribution of a generated demo set.

    Reads every episode pickle listed in train_files.pkl + eval_files.pkl and
    histograms the stored `mode` field. Returns (keys [M], probs [M]) for
    scalar modes (sorting/pushing) or (p1, p2, p3) for stacking's per-prefix
    arrival orders (mode stored as a length<=3 list of box indices)."""
    files = []
    for split in ("train_files.pkl", "eval_files.pkl"):
        p = os.path.join(task_dir, split)
        if os.path.exists(p):
            with open(p, "rb") as f:
                files.extend(pickle.load(f))
    modes = []
    for fn in files:
        with open(os.path.join(task_dir, "all_data", fn), "rb") as f:
            modes.append(pickle.load(f)["mode"])
    if not modes:
        return None
    first = np.asarray(modes[0])
    if first.ndim == 0:  # scalar mode codes
        arr = np.asarray(modes, np.int64)
        keys, counts = np.unique(arr, return_counts=True)
        return keys.astype(np.int32), (counts / counts.sum()).astype(np.float32)
    # stacking: arrival-order lists -> per-prefix priors. Index orders match
    # the reference's mode tables (stacking_sim.py:42-46): p1 over first box
    # r/g/b; p2 over the 6 ordered pairs rg,rb,gr,gb,br,bg (code2 below);
    # p3 over the 6 full permutations rgb,rbg,grb,gbr,brg,bgr — each 2-prefix
    # determines its permutation, so the full-order histogram uses the same
    # code2 index but counts only complete (length-3) stacks.
    c1 = np.zeros(3)
    c2 = np.zeros(6)
    c3 = np.zeros(6)
    for m in modes:
        m = [int(x) for x in np.asarray(m).ravel() if int(x) >= 0]
        if len(m) >= 1:
            c1[m[0]] += 1
        if len(m) >= 2:
            code2 = m[0] * 2 + (m[1] - (1 if m[1] > m[0] else 0))
            c2[code2] += 1
        if len(m) >= 3:
            c3[code2] += 1
    p1 = (c1 / max(c1.sum(), 1)).astype(np.float32)
    p2 = (c2 / max(c2.sum(), 1)).astype(np.float32)
    p3 = (c3 / max(c3.sum(), 1)).astype(np.float32)
    return p1, p2, p3
