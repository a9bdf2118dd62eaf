"""The yardstick's work counts and the card's peaks: what a kernel call
needs, in float32 operations and bytes, worked out from its shapes and
inputs (never from a time), and the least time the card could take for it.

``count_ops``, ``ik_window_ops``, ``nbytes``, ``bound_of`` and
``active_work`` are frozen copies of the port's ``chip_smoke.py`` helpers of
the same names, applied to the frozen reference's plain versions
(``benchmark/reference``) instead of the program's. ``per_shape`` takes a
count that grows linearly with the batch at two small batches on the CPU
and extends it to the batch of a call, once per shape.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def count_ops(fn, *args):
    """Floating-point operations the plain version performs on these
    inputs: numel of every arithmetic op's result (of its input for
    reductions), 2 m n k for matrix products; data movement counts 0."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    move = {"view", "_unsafe_view", "expand", "permute", "transpose", "t",
            "select", "slice", "unsqueeze", "squeeze", "as_strided",
            "reshape", "alias", "detach", "clone", "copy_", "_to_copy",
            "cat", "stack", "empty", "zeros", "ones", "full", "zeros_like",
            "ones_like", "full_like", "empty_like", "new_zeros", "new_ones",
            "new_empty", "new_full", "scalar_tensor", "lift_fresh", "index",
            "gather", "scatter", "unbind", "split", "repeat_interleave",
            "contiguous", "lift_fresh_copy", "_local_scalar_dense",
            "fill_", "zero_", "movedim", "split_with_sizes", "index_select",
            "repeat", "new_empty_strided", "empty_strided", "eye",
            "arange", "linspace", "_to_dim_order_copy", "slice_scatter",
            "select_scatter", "unfold", "diagonal", "flip", "roll"}
    reduce_ = {"sum", "amin", "amax", "mean", "linalg_vector_norm", "max",
               "min", "prod"}

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("mm", "bmm", "addmm", "baddbmm"):
                a, b2 = args[-2], args[-1]
                Counter.ops += 2 * a.numel() * b2.shape[-1]
            elif name in move:
                pass
            elif name in reduce_:
                Counter.ops += args[0].numel()
            else:
                outs = out if isinstance(out, (tuple, list)) else [out]
                Counter.ops += sum(o.numel() for o in outs
                                   if isinstance(o, torch.Tensor)
                                   and o.is_floating_point())
            return out

    with Counter():
        fn(*args)
    return Counter.ops


def ik_window_ops(spec, n_sub, ins, plain):
    """Operations K1's function needs on these inputs (q_virt, old_vel,
    des_pos, des_quat): ``plain``, the plain version's count on them
    (count_ops), less what it forms twice
    or never reads. Each substep after the first composes fk(q_virt) and
    its dof frames again, which its predecessor's RNEA formed at the same
    q; each convergence gate repeats the first IK iteration's pose error;
    each later IK iteration's FK composes the bodies off the path to the
    grasp target (the fingers), which nothing reads before the next FK."""
    from benchmark.reference.engine import dyn_scalar as dsc
    chain = spec.ctrl_chain
    ee = chain.body_index("panda_grasptarget")
    q = [ins[0][i] for i in range(chain.nv)]
    dp = tuple(ins[2][k] for k in range(3))
    dq = dsc.qnormalize(tuple(ins[3][k] for k in range(4)))
    xpos, xquat = dsc.fk_s(chain, q)
    path, b = set(), ee
    while b >= 0:
        path.add(b)
        b = int(chain.parent[b])
    off_path = [b for b in range(chain.nb) if b not in path]
    if any(int(chain.joint_type[b]) in (dsc.HINGE, dsc.SLIDE)
           for b in off_path):
        raise ValueError("a body off the grasp target's path has a joint")

    def gate():         # cart_step_s's gate, as far as iteration 0 forms it
        cq = xquat[ee]
        d_minus = sum((cq[k] - dq[k]) ** 2 for k in range(4))
        d_plus = sum((cq[k] + dq[k]) ** 2 for k in range(4))
        flip = dsc._where(d_minus > d_plus, -1.0, 1.0)
        dsc.vsub(dp, xpos[ee])
        dsc.quat_error_s(cq, tuple(dq[k] * flip for k in range(4)))

    def off_path_composes():        # fk_s on a welded body
        for b in off_path:
            p = int(chain.parent[b])
            dsc.qmul(xquat[p], tuple(float(v) for v in chain.body_quat[b]))
            dsc.vadd(xpos[p], dsc.qrot(
                xquat[p], tuple(float(v) for v in chain.body_pos[b])))

    twice = (count_ops(lambda: dsc.fk_s(chain, q))
             + count_ops(lambda: dsc.dof_frames_s(chain, xpos, xquat)))
    later_iters = int(spec.gains.num_iter) - 1
    return (plain - (n_sub - 1) * twice - n_sub * count_ops(gate)
            - n_sub * later_iters * count_ops(off_path_composes))


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_of(n_ops, n_bytes):
    """(ms, "operations" or "bytes"): the least time for n_ops float32
    operations and n_bytes moved, the larger of the two."""
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def active_work(meta, ins, out):
    """(operations, bytes) of K3 on each env's active contacts (depth >
    0) alone, summed over the batch. Operations: the plain version's on
    each env's scene cut to them; the count depends on the shapes alone,
    so it is taken once per distinct active count, on the first env with
    that count; an env with none needs none. Bytes: depth, f and qfrc of
    every env, the per-env inputs of the envs with an active contact, and
    pts, normal and warm of the active contacts only."""
    import torch
    from benchmark.reference.engine import contact, contact_kernel
    n_act = (ins[2] > 0).sum(0)
    B = n_act.shape[0]
    per_contact = (0, 1, 10)    # pts, normal, warm: [ncon, 3, B]
    byt = (nbytes((ins[2],) + tuple(out))
           + nbytes(ins[3:10]) * int((n_act > 0).sum()) // B
           + int(n_act.sum()) * sum(ins[i][0, :, 0].numel()
                                    * ins[i].element_size()
                                    for i in per_contact))
    total = 0
    counts = torch.bincount(n_act).tolist()
    for n, envs in enumerate(counts):
        if n == 0 or envs == 0:
            continue
        e = int(torch.nonzero(n_act == n)[0, 0])
        idx = torch.nonzero(ins[2][:, e] > 0)[:, 0]
        cut = [x[..., e:e + 1].contiguous() for x in ins]
        for i in (0, 1, 2, 10):     # pts, normal, depth, warm
            cut[i] = cut[i][idx].contiguous()
        meta_e = contact.select_contacts(meta, idx.cpu().numpy())
        total += envs * count_ops(
            lambda: contact_kernel.phase_plain(meta_e, *cut))
    return total, byt


def per_shape(count, cache, key):
    """A count that grows linearly with the batch, for a call of ``key[0]``
    envs: ``count(b)`` taken at b = 1 and 2 (on the CPU, through the
    reference's plain version), extended to the call's batch. Cached under
    the rest of ``key``, so each shape is counted once."""
    B, rest = key[0], key[1:]
    if rest not in cache:
        cache[rest] = (count(1), count(2))
    c1, c2 = cache[rest]
    return c1 + (B - 1) * (c2 - c1)
