"""The benchmark's frozen count functions (``benchmark/counts.py``) give
the operations and bytes of ``chip_smoke.py``'s originals on the same
inputs, at small batches on the CPU; the kernel stages' per-call counts
(``benchmark/kernels/k*.py``), taken once per shape at two small batches
and extended to the call's, equal a direct count at the call's batch."""
import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import counts
from benchmark.harness import CountContext
from benchmark import cell as cellmod

N_SUB = 3


@pytest.fixture(scope="module")
def sides():
    """(port params, reference statics) of pushing at a known posture."""
    from d3il_tpu_torch.envs import pushing
    from benchmark.reference.envs import pushing as rpushing
    q0 = np.array([0.0, 0.3, 0.0, -2.0, 0.0, 2.3, 0.8])
    return (pushing.PushingParams(device="cpu", q_init=q0),
            rpushing.PushingParams(device="cpu", q_init=q0).statics)


def _k1_ins(B):
    g = torch.Generator().manual_seed(B)
    return (0.3 * torch.rand((7, B), generator=g), torch.zeros(7, B),
            torch.tensor([0.5, -0.1, 0.2])[:, None].repeat(1, B),
            torch.tensor([0.0, 1.0, 0.0, 0.0])[:, None].repeat(1, B))


def test_count_ops_and_bound_of_match():
    f = lambda a, b: (a @ b).sum() + torch.sin(a).amax()
    a, b = torch.rand(3, 5), torch.rand(5, 4)
    assert counts.count_ops(f, a, b) == chip_smoke.count_ops(f, a, b)
    for ops, byt in ((1e9, 1e6), (1e6, 1e10), (0, 0)):
        assert counts.bound_of(ops, byt) == chip_smoke.bound_of(ops, byt)
    assert counts.nbytes([a, b]) == chip_smoke.nbytes([a, b])


@pytest.mark.parametrize("B", [2, 5])
def test_ik_window_ops_match(sides, B):
    from d3il_tpu_torch.engine import dyn_kernel
    from benchmark.reference.engine import dyn_kernel as rdyn
    port, ref = sides
    ins = _k1_ins(B)
    mine = counts.ik_window_ops(ref.ik, N_SUB, ins, counts.count_ops(
        rdyn.ik_window_plain, ref.ik, N_SUB, *ins))
    theirs = chip_smoke.ik_window_ops(
        port.statics.ik, N_SUB, ins, chip_smoke.count_ops(
            dyn_kernel.ik_window_plain, port.statics.ik, N_SUB, *ins))
    assert mine == theirs > 0


def _k3_ins(port, B):
    """K3's inputs of one real substep of B pushing envs, some contacts
    active (the boxes rest on the table) and some not."""
    from d3il_tpu_torch.engine import dyn_kernel, substep_bm
    from d3il_tpu_torch.envs import pushing
    ctx = pushing.sample_context(torch.Generator().manual_seed(B), B)
    st = pushing.reset(port, ctx)
    sb = substep_bm.scene_to_bm(st.scene)
    z = torch.zeros(7, B)
    arm = dyn_kernel.arm_stage_bm(port.statics.arm, sb.q, sb.qd,
                                  sb.q[:7], z, z, torch.full((B,), 0.04),
                                  torch.zeros(B, dtype=torch.bool))
    ins = substep_bm.contact_inputs(port.statics, sb, arm)
    return ins, (arm, sb)


@pytest.mark.parametrize("B", [3])
def test_active_work_and_stage_counts_match(sides, B):
    from d3il_tpu_torch.engine import contact_kernel
    port, ref = sides
    ins, (arm, sb) = _k3_ins(port, B)
    out = contact_kernel.phase_plain(port.statics.meta, *ins)
    n_act = (ins[2] > 0).sum(0)
    assert int(n_act.min()) > 0 and int(n_act.max()) < ins[2].shape[0]
    mine = counts.active_work(ref.meta, ins, out)
    assert mine == chip_smoke.active_work(port.statics.meta, ins, out)
    # the stage's count: once per number of active contacts, from shapes
    cell = cellmod.load_cell("pushing.dyn.b65536")
    ctx = CountContext(cell, cell.config["params"])
    stages = cellmod.kernel_stages()
    k3 = stages["k3"]["module"]
    assert k3.work(k3.capture((None,) + tuple(ins), out), ctx) == mine
    # K1 and K2: the count at two small batches, extended, equals the
    # direct count at this one
    from benchmark.reference.engine import dyn_kernel as rdyn
    n_sub = cell.config["params"]["n_substeps"]
    k1_in = _k1_ins(B)
    k1_out = rdyn.ik_window_plain(ctx.ref_statics.ik, n_sub, *k1_in)
    k1 = stages["k1"]["module"]
    direct = counts.ik_window_ops(ctx.ref_statics.ik, n_sub, k1_in,
                                  counts.count_ops(rdyn.ik_window_plain,
                                                   ctx.ref_statics.ik, n_sub,
                                                   *k1_in))
    assert k1.work(k1.capture((None, n_sub) + k1_in, k1_out), ctx) == (
        direct, counts.nbytes(k1_in) + counts.nbytes(k1_out))
    k2 = stages["k2"]["module"]
    z = torch.zeros(7, B)
    k2_in = (sb.q, sb.qd, sb.q[:7], z, z, torch.full((B,), 0.04),
             torch.zeros(B))
    direct = counts.count_ops(rdyn.arm_stage_plain, ctx.ref_statics.arm,
                              *k2_in)
    assert k2.work(k2.capture((None,) + k2_in, arm), ctx) == (
        direct, counts.nbytes(k2_in) + counts.nbytes(arm))
