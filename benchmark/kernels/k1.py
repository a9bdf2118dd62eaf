"""K1's work per call: the operations of the reference's plain IK window,
less what it forms twice (``counts.ik_window_ops``), and the bytes of its
inputs and outputs, read once and written once."""
from __future__ import annotations

import torch

from benchmark import counts


def capture(args, out):
    """What the count needs of one call: its batch, window and bytes."""
    _, n_sub, *ins = args
    return {"B": int(ins[0].shape[-1]), "n_sub": int(n_sub),
            "bytes": counts.nbytes(ins) + counts.nbytes(out)}


def work(rec, ctx):
    """(operations, bytes) of the call ``rec`` (from ``capture``)."""
    from benchmark.reference.engine import dyn_kernel
    spec, n_sub = ctx.ref_statics.ik, rec["n_sub"]

    def ops(b):
        ins = (torch.full((7, b), 0.1), torch.zeros(7, b),
               torch.tensor([0.5, 0.0, 0.3])[:, None].repeat(1, b),
               torch.tensor([0.0, 1.0, 0.0, 0.0])[:, None].repeat(1, b))
        plain = counts.count_ops(dyn_kernel.ik_window_plain, spec, n_sub,
                                 *ins)
        return counts.ik_window_ops(spec, n_sub, ins, plain)

    return (counts.per_shape(ops, ctx.cache("k1"), (rec["B"], n_sub)),
            rec["bytes"])
