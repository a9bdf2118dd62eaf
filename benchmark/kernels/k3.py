"""K3's work per call, over each env's active contacts (depth > 0), as
``counts.active_work`` counts it: the operations of the reference's plain
contact phase on each env's scene cut to them (counted once per number of
active contacts: the count depends on the shapes alone), and the bytes of
depth, f and qfrc of every env, the per-env inputs of the envs with an
active contact and pts, normal and warm of the active contacts."""
from __future__ import annotations

import torch

from benchmark import counts


def capture(args, out):
    """What the count needs of one call: its depths (kept until the count)
    and the bytes of its parts."""
    ins = args[1:]
    depth = ins[2]
    B = int(depth.shape[-1])
    return {"depth": depth, "B": B,
            "fixed_bytes": counts.nbytes((depth,) + tuple(out)),
            "env_bytes": counts.nbytes(ins[3:10]),
            "contact_bytes": sum(ins[i][0, :, 0].numel()
                                 * ins[i].element_size() for i in (0, 1, 10))}


def active(rec):
    """Active contacts per env of the call ``rec`` [B] (on the CPU)."""
    return (rec["depth"] > 0).sum(0).cpu()


def work(rec, ctx):
    """(operations, bytes) of the call ``rec`` (from ``capture``)."""
    from benchmark.reference.engine import contact, contact_kernel
    meta = ctx.ref_statics.meta
    n_act = active(rec)
    cache = ctx.cache("k3")

    def ops(n):
        if n not in cache:
            m = contact.select_contacts(meta, list(range(n)))
            z = lambda *s: torch.zeros(s + (1,))
            cache[n] = counts.count_ops(
                contact_kernel.phase_plain, m, z(n, 3), z(n, 3), z(n),
                z(meta.nv_r, 3), z(meta.nv_r, 3), z(meta.nv_r, meta.nv_r),
                z(meta.nv), z(meta.nv), z(meta.nf, 3), z(meta.nf, 4),
                z(n, 3))
        return cache[n]

    total = sum(envs * ops(n) for n, envs in
                enumerate(torch.bincount(n_act).tolist()) if n and envs)
    byt = (rec["fixed_bytes"]
           + rec["env_bytes"] * int((n_act > 0).sum()) // rec["B"]
           + int(n_act.sum()) * rec["contact_bytes"])
    return total, byt
