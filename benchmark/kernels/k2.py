"""K2's work per call: the operations of the reference's plain arm stage
and the bytes of its inputs and outputs, read once and written once."""
from __future__ import annotations

import torch

from benchmark import counts


def capture(args, out):
    """What the count needs of one call: its batch and bytes."""
    ins = args[1:]
    return {"B": int(ins[0].shape[-1]),
            "bytes": counts.nbytes(ins) + counts.nbytes(out)}


def work(rec, ctx):
    """(operations, bytes) of the call ``rec`` (from ``capture``)."""
    from benchmark.reference.engine import dyn_kernel
    spec = ctx.ref_statics.arm

    def ops(b):
        z = lambda *s: torch.zeros(s + (b,))
        return counts.count_ops(dyn_kernel.arm_stage_plain, spec,
                                torch.full((9, b), 0.1), z(9), z(7), z(7),
                                z(7), torch.full((b,), 0.04), z())

    return counts.per_shape(ops, ctx.cache("k2"), (rec["B"],)), rec["bytes"]
