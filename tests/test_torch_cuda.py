"""The port's CUDA kernels == their plain PyTorch versions (needs a card).

Marked ``cuda``: each test skips without a CUDA device. On a machine with
an H100 and nvcc, run ``python -m pytest -m cuda tests/test_torch_cuda.py``;
the first test builds the kernels. Imports no JAX (the GPU machine has
none). Inputs are NumPy draws from a seed, or a port reset computed on the
CPU; tolerances are those the JAX tests hold the TPU kernels to.
"""
import numpy as np
import pytest
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from chip_smoke import (avoiding_contact_posture,  # noqa: E402
                        box_between_fingers, is_box_wall, pair_rows,
                        rod_pressing_box)
from d3il_tpu_torch.control import gains  # noqa: E402
from d3il_tpu_torch.engine import (contact, contact_kernel, dyn_kernel,  # noqa: E402
                                   substep_bm)
from d3il_tpu_torch.envs import pushing, scenes  # noqa: E402
from d3il_tpu_torch.robot import panda  # noqa: E402

# the pushing task's start posture (the JAX package's PushingParams.q_init)
Q_INIT = np.array([-0.36010373, 0.43400675, -0.13117754, -2.05403185,
                   0.09223454, 2.48476696, 0.23339309])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _scaled_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / max(b.abs().max().item(), 1.0)).item()


# the original batch of each test, then the ragged edges of the kernels'
# groupings: one env, a batch that fills no whole block (K1: 32 or 4 envs
# per block, K2: 16, K3: 4, K4: 128 columns), and the evaluation path's 480
# envs
BATCHES = (1, 33, 480)


@pytest.mark.cuda
@pytest.mark.parametrize("B", (256,) + BATCHES)
def test_arm_stage_kernel_matches_plain(cuda_device, B):
    rng = np.random.default_rng(2)
    q = np.concatenate([Q_INIT[:, None] + 0.1 * rng.standard_normal((7, B)),
                        0.02 + 0.01 * rng.random((2, B))])
    ins = [q, 0.3 * rng.standard_normal((9, B)),
           q[:7] + 0.01 * rng.standard_normal((7, B)),
           0.1 * rng.standard_normal((7, B)), rng.standard_normal((7, B)),
           np.where(np.arange(B) % 2 == 0, 0.04, 0.0)]
    ins = [torch.from_numpy(x.astype(np.float32)) for x in ins]
    gf = torch.from_numpy(np.arange(B) % 4 == 1)
    spec = dyn_kernel.ArmSpec(scenes.build_pushing_scene(),
                              gains.JointPDGains())
    ref = dyn_kernel.arm_stage_bm(spec, *ins, gf)
    n0 = dyn_kernel.arm_stage_bm.launches
    out = dyn_kernel.arm_stage_bm(spec, *(x.to(cuda_device) for x in ins),
                                  gf.to(cuda_device))
    torch.cuda.synchronize()
    assert dyn_kernel.arm_stage_bm.launches == n0 + 1
    # test_dyn_kernel.py:73-79
    tols = (1e-5, 1e-5, 1e-5, 1e-5, 3e-4, 1e-3, 1e-3)
    for a, b, tol in zip(out, ref, tols):
        assert _scaled_err(a, b) <= tol


def _ik_inputs(B, seed=3):
    rng = np.random.default_rng(seed)
    ins = [panda.INIT_QPOS[:, None] + 0.2 * rng.standard_normal((7, B)),
           0.05 * rng.standard_normal((7, B)),
           np.array([0.5, 0.0, 0.2])[:, None]
           + 0.05 * rng.standard_normal((3, B)),
           np.tile(np.array([0.0, 1.0, 0.0, 0.0])[:, None], (1, B))]
    return [torch.from_numpy(x.astype(np.float32)) for x in ins]


def _ik_spec():
    return dyn_kernel.IkSpec(panda.build_control_chain(),
                             gains.CartPosQuatGains(), 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B", (256,) + BATCHES)
def test_ik_window_kernel_matches_plain(cuda_device, B):
    n_sub = 4
    ins = _ik_inputs(B)
    spec = _ik_spec()
    ref = dyn_kernel.ik_window_bm(spec, n_sub, *ins)
    n0 = dyn_kernel.ik_window_bm.launches
    out = dyn_kernel.ik_window_bm(spec, n_sub,
                                  *(x.to(cuda_device) for x in ins))
    torch.cuda.synchronize()
    assert dyn_kernel.ik_window_bm.launches == n0 + 1
    # test_dyn_kernel.py:148-156: q_virt/q_des 3e-5, velocities 3e-2,
    # feedforward 2e-3 scaled
    for a, b, tol in zip(out, ref, (3e-5, 3e-2, 3e-5, 3e-2, 2e-3)):
        assert _scaled_err(a, b) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", dyn_kernel.IK_LANES)
def test_ik_window_kernel_path_window(cuda_device, lanes):
    """K1 over the path's 35-substep window at every lane count it is built
    for, B = 33 (no whole block at any of them)."""
    B, n_sub = 33, 35
    ins = _ik_inputs(B, seed=4)
    spec = _ik_spec()
    ref = dyn_kernel.ik_window_bm(spec, n_sub, *ins)
    out = dyn_kernel.launch_ik_window(
        spec, n_sub, [x.to(cuda_device) for x in ins], lanes)
    torch.cuda.synchronize()
    # chip_smoke.py's K1 tolerances: test_dyn_kernel.py:148-156, but
    # tau_model 2e-2 instead of 2e-3: that test runs 2 substeps; over 35,
    # float32 rounding in q_des reaches qdd_des = ddg (dq/dt - old_vel)/dt
    # times 1/dt^2 = 1e6, and the plain version alone differs from its own
    # float64 run by ~7e-3 scaled
    for a, b, tol in zip(out, ref, (3e-5, 3e-2, 3e-5, 3e-2, 2e-2)):
        assert _scaled_err(a, b) <= tol


def _dynamic_contact_inputs(B, seed=4):
    """K3's inputs on one dynamic substep of a pushing reset on the CPU,
    boxes spread around the rod."""
    params = pushing.PushingParams(n_substeps=2, device="cpu", q_init=Q_INIT)
    rng = np.random.default_rng(seed)
    red = np.stack([0.525 + 0.04 * rng.uniform(-1, 1, B),
                    -0.28 + 0.04 * rng.uniform(-1, 1, B)], 1)
    yaw = rng.uniform(-np.pi / 2, np.pi / 2, (B, 2))
    quat = lambda y: np.stack([np.cos(y / 2), 0 * y, 0 * y, np.sin(y / 2)], 1)
    green = np.stack([0.6 + 0.05 * rng.uniform(-1, 1, B),
                      -0.1 + 0.05 * rng.uniform(-1, 1, B)], 1)
    ctx = tuple(torch.from_numpy(x.astype(np.float32)) for x in
                (red, quat(yaw[:, 0]), green, quat(yaw[:, 1])))
    state = pushing.reset(params, ctx)
    sb = substep_bm.scene_to_bm(state.scene)
    st = params.statics
    arm = dyn_kernel.arm_stage_bm(st.arm, sb.q, sb.qd, sb.q[:7].contiguous(),
                                  torch.zeros(7, B), torch.zeros(7, B),
                                  torch.full((B,), 0.04),
                                  torch.zeros(B, dtype=torch.bool))
    return st.meta, substep_bm.contact_inputs(st, sb, arm)


def _hold_contact(meta, args, device):
    """Launch K3 on ``args`` moved to ``device`` through the wrapper and
    hold it to the plain version (test_contact_kernel.py:116-117: 2e-4
    scaled); launch it again into outputs filled with NaN first, where
    every element must come from the kernel: the same outputs, and f
    exactly 0 on every contact with depth <= 0."""
    f_ref, q_ref = contact_kernel.phase_plain(meta, *args)
    tables = contact_kernel.ContactTables(meta, device)
    B = args[0].shape[-1]
    ins = tuple(a.to(device) for a in args)
    n0 = contact_kernel.phase_batched_bm.launches
    f, qfrc = contact_kernel.phase_batched_bm(tables, *ins)
    torch.cuda.synchronize()
    assert contact_kernel.phase_batched_bm.launches == n0 + 1
    assert f_ref.abs().max() > 1e-3
    assert _scaled_err(f, f_ref) <= 2e-4
    assert _scaled_err(qfrc, q_ref) <= 2e-4
    f_nan = torch.full((meta.ncon, 3, B), float("nan"), device=device)
    q_nan = torch.full((meta.nv, B), float("nan"), device=device)
    contact_kernel._launch(tables, ins, f_nan, q_nan)
    torch.cuda.synchronize()
    assert torch.equal(f_nan, f) and torch.equal(q_nan, qfrc)
    inactive = (args[2] <= 0).to(device)
    assert (f.movedim(1, -1)[inactive] == 0.0).all()
    return tables


@pytest.mark.cuda
@pytest.mark.parametrize("B", (64,) + BATCHES)
def test_contact_kernel_matches_plain(cuda_device, B):
    meta, args = _dynamic_contact_inputs(B)
    tables = _hold_contact(meta, args, cuda_device)
    assert (tables.geometry(B).variant, tables.geometry(B).cols) == (1, 56)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, variant, cols", (
    ((4, 14), 1, 56), ((0, 18, 12), 2, 0), ((0, 18, 12, 13, 5, 6), 2, 0)))
def test_contact_kernel_scene_sizes(cuda_device, rows, variant, cols):
    """K3 on scenes made of a range of pushing's contacts (and some
    repeated): the register variant with 26 padding rows (30 rows), and the
    general variant just past the register variant (57 rows) and at 66."""
    B = 33
    meta, args = _dynamic_contact_inputs(B)
    idx = np.r_[np.arange(rows[0], rows[1]), np.array(rows[2:], int)]
    meta = contact.select_contacts(meta, idx)
    t = torch.as_tensor(idx)
    args = tuple(a[t].contiguous() if i in (0, 1, 2, 10) else a
                 for i, a in enumerate(args))  # pts, normal, depth, warm
    tables = _hold_contact(meta, args, cuda_device)
    assert (tables.geometry(B).variant, tables.geometry(B).cols) == (variant,
                                                                     cols)


@pytest.mark.cuda
@pytest.mark.parametrize("B", (77,) + BATCHES)
def test_contact_kernel_matches_plain_kinematic(cuda_device, B):
    """K3 on the kinematic mode's inputs (zero arm inverse mass and smooth
    acceleration, plain-FK frames, finite-difference arm velocity), the rod
    beamed into the red box."""
    params = pushing.PushingParams(n_substeps=2, device="cpu", q_init=Q_INIT,
                                   kinematic=True)
    gen = torch.Generator().manual_seed(6)
    state = pushing.reset(params, pushing.sample_context(gen, B))
    st = params.statics
    sb = substep_bm.scene_to_bm(state.scene)
    tcp, _ = params.tcp_pose(state.scene)
    # put the red box under the rod tip so the rod rows carry force
    free_pos = sb.free_pos.clone()
    free_pos[0, :2] = tcp[:, :2].T + 0.02
    sb = sb._replace(free_pos=free_pos)
    q_des = sb.q[:7] + 0.002 * torch.randn(7, B, generator=gen)
    q_new, qd_new = substep_bm.kinematic_target(st, sb, q_des,
                                                torch.full((B,), 0.04))
    sb = sb._replace(q=q_new.contiguous(), qd=qd_new.contiguous())
    arm = substep_bm.beam_arm_out(st, sb.q)
    assert arm[4].shape == (9, 9, B) and not arm[4].any()
    args = substep_bm.contact_inputs(st, sb, arm)
    _hold_contact(st.meta, args, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("B", (256,) + BATCHES)
def test_feedforward_kernel_matches_plain(cuda_device, B):
    rng = np.random.default_rng(5)
    # test_dyn_kernel.py:164-166
    ins = [rng.uniform(-1.5, 1.5, (7, B)), rng.standard_normal((7, B)),
           3.0 * rng.standard_normal((7, B))]
    ins = [torch.from_numpy(x.astype(np.float32)) for x in ins]
    spec = _ik_spec()
    ref = dyn_kernel.feedforward_bm(spec, *ins)
    n0 = dyn_kernel.feedforward_bm.launches
    out = dyn_kernel.feedforward_bm(spec, *(x.to(cuda_device) for x in ins))
    torch.cuda.synchronize()
    assert dyn_kernel.feedforward_bm.launches == n0 + 1
    assert ref.abs().max() > 1.0
    # test_dyn_kernel.py:169-171
    assert _scaled_err(out, ref) <= 3e-4
    with pytest.raises(ValueError, match="shape"):
        dyn_kernel.feedforward_bm(spec, ins[0].to(cuda_device),
                                  ins[1][:6].to(cuda_device),
                                  ins[2].to(cuda_device))


# the start postures of the aligning and sorting tasks (the JAX package's
# AligningParams.q_init and SortingParams.q_init)
Q_INIT_ALIGNING = np.array([-0.40412223, 0.32504207, -0.20123088,
                            -1.84203374, 0.07952347, 2.16244817, 0.14624882])
Q_INIT_SORTING = np.array([-0.33100116, 0.24833255, -0.19925672,
                           -1.95236027, 0.06261307, 2.19832397, 0.22458877])
ROD_SCENES = ("aligning", "sorting_2", "sorting_4", "sorting_6")


def _rod_scene_state(task, B, device, settle):
    """A rod task's params on ``device`` and its reset's initial scene from
    seeded contexts after ``settle`` hold substeps, while the contacts carry
    force: sorting's boxes start inside the platform (z = 0.05) and are
    pushed out of it; aligning's tray is lowered to 0.5 mm into the table."""
    from d3il_tpu_torch.envs import aligning, common, sorting
    gen = torch.Generator().manual_seed(11)
    if task == "aligning":
        env = aligning
        params = aligning.AligningParams(n_substeps=4, device=device,
                                         q_init=Q_INIT_ALIGNING)
        ctx = aligning.sample_context(gen, B)
    else:
        env, n = sorting, int(task.split("_")[1])
        params = sorting.SortingParams(n, n_substeps=4, device=device,
                                       q_init=Q_INIT_SORTING)
        ctx = sorting.sample_context(gen, B, n)
    sc = env.initial_scene(params, ctx)
    if task == "aligning":
        fp = sc.free_pos.clone()
        fp[:, 0, 2] = scenes.TABLE_Z + 0.01 - 5e-4
        sc = sc._replace(free_pos=fp)
    return params, common.settle(params, sc, n=settle)


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("task", ROD_SCENES)
def test_contact_kernel_rod_scenes(cuda_device, task, B):
    """K3's general variant on the aligning and sorting scenes (96 to 372
    rows; the compact kernel at 15 to 58 KB of shared memory per env, its
    active contacts within the cap), inputs from one substep of a reset on
    the card, held to the plain version at the tolerance above."""
    params, sc = _rod_scene_state(task, B, cuda_device, settle=3)
    st = params.statics
    sb = substep_bm.scene_to_bm(sc)
    arm = dyn_kernel.arm_stage_bm(st.arm, sb.q, sb.qd, sb.q[:7].contiguous(),
                                  torch.zeros_like(sb.q[:7]),
                                  torch.zeros_like(sb.q[:7]),
                                  torch.full((B,), 0.04, device=cuda_device),
                                  torch.zeros(B, dtype=torch.bool,
                                              device=cuda_device))
    args = substep_bm.contact_inputs(st, sb, arm)
    tables = _hold_contact(st.meta, args, cuda_device)
    geo = tables.geometry(B)
    assert geo.variant == 2 and geo.envs_per_block == 4
    assert geo.smem_per_env == contact_kernel.smem_bytes(st.meta, B,
                                                         tables.n_sm)
    assert geo.cap == contact_kernel.compact_cap(
        st.meta, contact_kernel.env_budget(B, tables.n_sm))
    # every env's active contacts within the cap: no env on the workspace
    assert (args[2] > 0).sum(0).max().item() <= geo.cap


@pytest.mark.cuda
@pytest.mark.parametrize("task", ("aligning", "sorting_2"))
def test_arm_kernels_rod_scenes(cuda_device, task):
    """K1 over a 4-substep window toward a setpoint 1 cm from the tcp, and
    K2 on its first substep, from an aligning and a sorting state on the
    card, B = 33, held to the plain versions at the tolerances above."""
    B = 33
    params, sc = _rod_scene_state(task, B, cuda_device, settle=2)
    st = params.statics
    tcp, _ = params.tcp_pose(sc)
    bm = lambda x: torch.movedim(x, 0, -1).contiguous()
    des = tcp + 0.01 * torch.tensor([1.0, -1.0, -1.0], device=cuda_device)
    quat = torch.tensor([0.0, 1.0, 0.0, 0.0], device=cuda_device)
    ins = (bm(sc.q[:, :7]), torch.zeros(7, B, device=cuda_device), bm(des),
           bm(quat.expand(B, 4)))
    n0 = dyn_kernel.ik_window_bm.launches
    out = dyn_kernel.ik_window_bm(st.ik, 4, *ins)
    ref = dyn_kernel.ik_window_plain(st.ik, 4, *ins)
    torch.cuda.synchronize()
    assert dyn_kernel.ik_window_bm.launches == n0 + 1
    for a, b, tol in zip(out, ref, (3e-5, 3e-2, 3e-5, 3e-2, 2e-3)):
        assert _scaled_err(a, b) <= tol
    sb = substep_bm.scene_to_bm(sc)
    k2_in = (sb.q, sb.qd, out[2][0], out[3][0], out[4][0],
             torch.full((B,), 0.04, device=cuda_device))
    gf = torch.zeros(B, dtype=torch.bool, device=cuda_device)
    n0 = dyn_kernel.arm_stage_bm.launches
    out2 = dyn_kernel.arm_stage_bm(st.arm, *k2_in, gf)
    ref2 = dyn_kernel.arm_stage_plain(st.arm, *k2_in, gf.to(torch.float32))
    torch.cuda.synchronize()
    assert dyn_kernel.arm_stage_bm.launches == n0 + 1
    for a, b, tol in zip(out2, ref2, (1e-5, 1e-5, 1e-5, 1e-5, 3e-4, 1e-3,
                                      1e-3)):
        assert _scaled_err(a, b) <= tol


def _avoiding_contact_inputs(B):
    """K3's inputs on one dynamic substep of avoiding (no free body, nf =
    0) on the CPU: each env's arm at a seeded perturbation of a posture
    whose rod sits ~5 mm inside the first obstacle, so the rod-obstacle row
    carries force."""
    from d3il_tpu_torch.envs import avoiding
    params = avoiding.AvoidingParams(n_substeps=2, device="cpu",
                                     q_init=Q_INIT)
    qc = avoiding_contact_posture(params)
    state = avoiding.reset(params, avoiding.empty_context(B))
    rng = np.random.default_rng(12)
    q = state.scene.q.clone()
    q[:, :7] = torch.from_numpy(
        (qc + 1e-3 * rng.standard_normal((B, 7))).astype(np.float32))
    sb = substep_bm.scene_to_bm(state.scene._replace(q=q))
    st = params.statics
    arm = dyn_kernel.arm_stage_bm(st.arm, sb.q, sb.qd, sb.q[:7].contiguous(),
                                  torch.zeros(7, B), torch.zeros(7, B),
                                  torch.full((B,), 0.04),
                                  torch.zeros(B, dtype=torch.bool))
    return st.meta, substep_bm.contact_inputs(st, sb, arm)


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
def test_contact_kernel_avoiding_no_free_body(cuda_device, B):
    """K3's register variant on a scene with no free body (avoiding: 8
    contacts, 24 rows, nv 9): empty free-body inputs, whose pointers the
    kernel must not read, held to the plain version at the tolerance
    above."""
    meta, args = _avoiding_contact_inputs(B)
    assert meta.nf == 0 and args[8].shape == (0, 3, B)
    # contact 2 (pair 1): the rod against the first obstacle, in every env
    f_ref, _ = contact_kernel.phase_plain(meta, *args)
    assert (f_ref[2].abs().amax(dim=0) > 1e-3).all()
    tables = _hold_contact(meta, args, cuda_device)
    assert (tables.geometry(B).variant, tables.geometry(B).smem_per_env) == \
        (1, 3632)


# the stacking task's start posture (the JAX package's
# StackingParams.q_init)
Q_INIT_STACKING = np.array([-8.73528734e-07, -4.12198342e-02,
                            7.97928294e-07, -2.18946218e+00, 3.53404417e-08,
                            2.15303779e+00, 7.85398126e-01])


def _stacking_state(B):
    """Stacking's params and a reset of B seeded contexts on the CPU, each
    env's red box moved between the open fingers, 1 mm into the first tip
    pad, so the finger rows carry force."""
    from d3il_tpu_torch.envs import stacking
    params = stacking.StackingParams(n_substeps=2, device="cpu",
                                     q_init=Q_INIT_STACKING)
    state = stacking.reset(params, stacking.sample_context(
        torch.Generator().manual_seed(13), B))
    sc = state.scene
    fp, fq = sc.free_pos.clone(), sc.free_quat.clone()
    fp[:, 0] = box_between_fingers(params, sc)
    fq[:, 0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    return params, sc._replace(free_pos=fp, free_quat=fq)


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
def test_contact_kernel_stacking_fingers(cuda_device, B):
    """K3's general variant on stacking (88 contacts, 264 rows, nv 27) with
    the boxes on the table and a finger's tip pad pressing the red box:
    rows on the finger slide joints (columns 7, 8 of J) that carry force,
    held to the plain version at the tolerance above."""
    params, sc = _stacking_state(B)
    st = params.statics
    sb = substep_bm.scene_to_bm(sc)
    arm = dyn_kernel.arm_stage_bm(st.arm, sb.q, sb.qd, sb.q[:7].contiguous(),
                                  torch.zeros(7, B), torch.zeros(7, B),
                                  torch.zeros(B),
                                  torch.ones(B, dtype=torch.bool))
    args = substep_bm.contact_inputs(st, sb, arm)
    f_ref, q_ref = contact_kernel.phase_plain(st.meta, *args)
    # pair 6 (contacts 24-27): the first tip pad against the red box
    assert (f_ref[24:28].abs().amax(dim=(0, 1)) > 1e-3).all()
    assert (q_ref[7:9].abs() > 0).any(dim=0).all()
    tables = _hold_contact(st.meta, args, cuda_device)
    geo = tables.geometry(B)    # one block per SM at B <= 528: every contact
    assert geo.variant == 2
    assert geo.smem_per_env == 52768
    assert (geo.envs_per_block, geo.cap, geo.ws_per_env) == (4, 88, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
def test_arm_stage_gripper_chain_grasp(cuda_device, B):
    """K2 on the gripper chain (15 bodies) with the grasp law on: the
    fingers open at 0.04, the command width 0 and the grasp flag set (the
    -20 N grasp force), the joint setpoint 0.01 rad off, from a stacking
    reset; held to the plain version at the tolerances above."""
    params, sc = _stacking_state(B)
    st = params.statics
    assert st.scene.robot.nb == 15
    sb = substep_bm.scene_to_bm(sc)
    rng = np.random.default_rng(14)
    q_des = sb.q[:7] + torch.from_numpy(
        (0.01 * rng.standard_normal((7, B))).astype(np.float32))
    ins = (sb.q, sb.qd, q_des.contiguous(), torch.zeros(7, B),
           torch.zeros(7, B), torch.zeros(B))
    gf = torch.ones(B, dtype=torch.bool)
    ref = dyn_kernel.arm_stage_bm(st.arm, *ins, gf)
    n0 = dyn_kernel.arm_stage_bm.launches
    out = dyn_kernel.arm_stage_bm(st.arm, *(x.to(cuda_device) for x in ins),
                                  gf.to(cuda_device))
    torch.cuda.synchronize()
    assert dyn_kernel.arm_stage_bm.launches == n0 + 1
    for a, b, tol in zip(out, ref, (1e-5, 1e-5, 1e-5, 1e-5, 3e-4, 1e-3,
                                    1e-3)):
        assert _scaled_err(a, b) <= tol


def _inserting_press_state(B):
    """Inserting's params and a reset of B seeded contexts on the CPU, each
    env's rod pressing its red box 1 mm into maze_9
    (chip_smoke.rod_pressing_box), so the box-wall rows carry force."""
    from d3il_tpu_torch.envs import inserting
    params = inserting.InsertingParams(n_substeps=2, device="cpu",
                                       q_init=Q_INIT)
    state = inserting.reset(params, inserting.sample_context(
        torch.Generator().manual_seed(15), B))
    return params, rod_pressing_box(params, state.scene)


@pytest.mark.cuda
@pytest.mark.parametrize("B", BATCHES)
def test_contact_kernel_inserting_box_wall(cuda_device, B):
    """K3's general variant on inserting, the largest scene (78 pairs, 270
    contacts, 810 rows, nv 27, nf 3; the compact kernel at 57,584 B of
    shared memory per env, four envs per block, a cap of 95 active
    contacts), with the rod pressing the red box into a maze wall:
    the box-wall rows carry force in every env; held to the plain version
    at the tolerance above."""
    params, sc = _inserting_press_state(B)
    st = params.statics
    assert (st.meta.ncon, st.meta.nv, st.meta.nf) == (270, 27, 3)
    sb = substep_bm.scene_to_bm(sc)
    arm = dyn_kernel.arm_stage_bm(st.arm, sb.q, sb.qd, sb.q[:7].contiguous(),
                                  torch.zeros(7, B), torch.zeros(7, B),
                                  torch.full((B,), 0.04),
                                  torch.zeros(B, dtype=torch.bool))
    args = substep_bm.contact_inputs(st, sb, arm)
    f_ref, _ = contact_kernel.phase_plain(st.meta, *args)
    rows = pair_rows(params.scene, is_box_wall)
    assert (f_ref[rows].abs().amax(dim=(0, 1)) > 1e-3).all()
    tables = _hold_contact(st.meta, args, cuda_device)
    geo = tables.geometry(B)    # one block per SM at B <= 528
    assert (geo.variant, geo.envs_per_block, geo.smem_per_env) == (2, 4,
                                                                   57584)
    assert geo.cap == 95
    assert geo.ws_per_env == contact_kernel.ws_bytes(st.meta)


@pytest.mark.cuda
def test_contact_kernel_compact_paths(cuda_device):
    """K3's compact variant on one sorting_6 batch whose envs take every
    path: no active contact, one, five (the register form), the scene's
    own 24-28 (the factored form in shared memory), exactly the cap (70 at
    this batch), and every contact at 1 mm depth (124, above the cap: the
    global workspace); held to the plain version at the tolerance above, f
    exactly 0 on the inactive contacts, the outputs filled with NaN
    first."""
    B = 36
    params, sc = _rod_scene_state("sorting_6", B, cuda_device, settle=3)
    st = params.statics
    sb = substep_bm.scene_to_bm(sc)
    arm = dyn_kernel.arm_stage_bm(st.arm, sb.q, sb.qd, sb.q[:7].contiguous(),
                                  torch.zeros_like(sb.q[:7]),
                                  torch.zeros_like(sb.q[:7]),
                                  torch.full((B,), 0.04, device=cuda_device),
                                  torch.zeros(B, dtype=torch.bool,
                                              device=cuda_device))
    args = list(substep_bm.contact_inputs(st, sb, arm))
    cap = st.contact.geometry(B).cap
    depth = args[2].clone()
    for e in range(B):
        act = torch.nonzero(depth[:, e] > 0)[:, 0]
        kind = e % 6
        if kind < 3:        # none, one, five of its own active contacts
            depth[act[(0, 1, 5)[kind]:], e] = -1e-3
        elif kind == 4:     # exactly the cap: inactive ones added
            extra = torch.nonzero(depth[:, e] <= 0)[:, 0][:cap - len(act)]
            depth[extra, e] = 1e-3
        elif kind == 5:     # every contact: above the cap
            depth[:, e] = 1e-3
    args[2] = depth
    n_act = (depth > 0).sum(0).cpu()
    assert set(n_act[0::6].tolist()) == {0} and set(n_act[1::6].tolist()) == {1}
    assert set(n_act[2::6].tolist()) == {5}
    assert 3 * n_act[3::6].min() > contact_kernel.REG_COLS
    assert n_act[3::6].max() <= cap
    assert (n_act[4::6] == cap).all() and (n_act[5::6] == st.meta.ncon).all()
    tables = _hold_contact(st.meta, tuple(args), cuda_device)
    assert tables.geometry(B).cap == cap < st.meta.ncon


AGENT_NAMES = ("gpt_bc", "bet", "bet_mlp", "act", "cvae", "lstm_gmm", "ibc",
               "ddpm", "ddpm_encdec")


@pytest.mark.cuda
@pytest.mark.parametrize("name", AGENT_NAMES)
def test_agent_forward_on_the_card(cuda_device, name):
    """Each agent of the slice at its registry defaults (full width) on the
    card against the same weights on the CPU: the loss on a minibatch of 64
    windows (1e-4 relative) and two policy steps of 33 episodes (1e-5
    absolute on actions of ~5e-3), every draw made on the CPU and passed in
    where the function takes draws. IBC's sampler picks by argmax among 64
    samples, where float32 differences between the devices may pick
    another: its energies are held instead (1e-4 relative), and its
    actions to the sampler's bounds."""
    from d3il_tpu_torch import registry
    from d3il_tpu_torch.agents import base
    from d3il_tpu_torch.data.scaler import Scaler
    rng = np.random.default_rng(16)
    OBS, ACT, n, B = 10, 2, 64, 33
    x = rng.normal(size=(256, OBS)).astype(np.float32)
    y = (0.005 * rng.normal(size=(256, ACT))).astype(np.float32)
    scaler = Scaler.fit(x, y, device="cpu")
    acts = scaler.scale_output(torch.from_numpy(y))
    agent, _ = registry.make_agent(name, torch.Generator().manual_seed(0),
                                   OBS, ACT, scaler, acts)
    dev_agent, _ = registry.make_agent(
        name, torch.Generator().manual_seed(0), OBS, ACT,
        Scaler(*(t.to(cuda_device) if torch.is_tensor(t) else t
                 for t in scaler)), acts)
    dev_agent.params = {k: v.to(cuda_device) for k, v in agent.params.items()}
    if hasattr(agent, "centers"):
        dev_agent.centers = agent.centers.to(cuda_device)
    W = getattr(agent, "train_window", None) or agent.window_size
    obs = torch.from_numpy(rng.normal(size=(n, W, OBS)).astype(np.float32))
    act = torch.from_numpy((0.005 * rng.normal(size=(n, W, ACT))).astype(
        np.float32))
    g = torch.Generator().manual_seed(1)
    draws = {"act": {"eps": torch.randn(n, 32, generator=g)},
             "cvae": {"eps": torch.randn(n, 32, generator=g)},
             "ibc": {"neg": torch.rand(n, 8, ACT, generator=g)},
             "ddpm": {"t": torch.randint(0, 16, (n,), generator=g),
                      "eps": torch.randn(n, ACT, generator=g)},
             "ddpm_encdec": {"t": torch.randint(0, 16, (n,), generator=g),
                             "eps": torch.randn(n, 8, ACT, generator=g)},
             }.get(name, {})
    want = agent.loss_fn()(agent.params, obs, act, None, **draws)
    got = dev_agent.loss_fn()(dev_agent.params, obs.to(cuda_device),
                              act.to(cuda_device), None,
                              **{k: v.to(cuda_device)
                                 for k, v in draws.items()})
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-4)
    if name == "ibc":
        from d3il_tpu_torch.agents import ibc
        s = torch.from_numpy(rng.normal(size=(B, OBS)).astype(np.float32))
        a = torch.from_numpy(rng.normal(size=(B, 64, ACT)).astype(np.float32))
        e = ibc._energy(agent.model, agent.params, s, a)
        de = ibc._energy(dev_agent.model, dev_agent.params,
                         s.to(cuda_device), a.to(cuda_device))
        np.testing.assert_allclose(de.cpu().numpy(), e.numpy(), rtol=1e-4,
                                   atol=1e-5)
        apply = dev_agent.policy_apply(
            torch.Generator(device=cuda_device).manual_seed(2))
        _, da = apply(dev_agent.params, dev_agent.init_carry(OBS, B),
                      s.to(cuda_device))
        lo, hi = (scaler.inverse_scale_output(b * 1.1)
                  for b in scaler.y_bounds)
        assert ((da.cpu() >= lo - 1e-6) & (da.cpu() <= hi + 1e-6)).all()
        return

    def policy_draws():
        gum = lambda *shape: base.gumbel(shape, g)
        return {"bet": lambda: gum(B, 64), "bet_mlp": lambda: gum(B, 64),
                "cvae": lambda: torch.randn(B, 32, generator=g),
                "lstm_gmm": lambda: (gum(B, 8),
                                     torch.randn(B, ACT, generator=g)),
                "ddpm": lambda: torch.randn(17, B, ACT, generator=g),
                "ddpm_encdec": lambda: torch.randn(17, B, 8, ACT,
                                                   generator=g),
                }.get(name, lambda: None)()

    to_dev = lambda d: tuple(to_dev(x) for x in d) if isinstance(d, tuple) \
        else d.to(cuda_device)
    apply, dev_apply = agent.policy_apply(None), dev_agent.policy_apply(None)
    carry, dev_carry = agent.init_carry(OBS, B), dev_agent.init_carry(OBS, B)
    for t in range(2):
        o = torch.from_numpy(rng.normal(size=(B, OBS)).astype(np.float32))
        d = policy_draws()
        kw, dev_kw = ({}, {}) if d is None else ({"draws": d},
                                                 {"draws": to_dev(d)})
        carry, a = apply(agent.params, carry, o, **kw)
        dev_carry, da = dev_apply(dev_agent.params, dev_carry,
                                  o.to(cuda_device), **dev_kw)
        np.testing.assert_allclose(da.cpu().numpy(), a.numpy(), atol=1e-5,
                                   err_msg=f"step {t}")


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ("mlp", "gpt"))
def test_beso_on_the_card(cuda_device, backbone):
    """beso at its registry defaults (the GPT at pushing's window 5) on the
    card against the same weights on the CPU: the loss on 64 windows with
    the CPU's draws (1e-4 relative) and two policy steps of 33 episodes of
    the default euler_ancestral sampler (8 steps) with the starting actions
    and the sampler's normals drawn on the CPU (1e-5 absolute on actions of
    ~5e-3)."""
    from d3il_tpu_torch import registry
    from d3il_tpu_torch.data.scaler import Scaler
    rng = np.random.default_rng(17)
    OBS, ACT, n, B = 10, 2, 64, 33
    kw = {"backbone": "gpt", "window_size": 5} if backbone == "gpt" else {}
    x = rng.normal(size=(256, OBS)).astype(np.float32)
    y = (0.005 * rng.normal(size=(256, ACT))).astype(np.float32)
    scaler = Scaler.fit(x, y, device="cpu")
    agent, _ = registry.make_agent("beso", torch.Generator().manual_seed(0),
                                   OBS, ACT, scaler, **kw)
    dev_agent, _ = registry.make_agent(
        "beso", torch.Generator().manual_seed(0), OBS, ACT,
        Scaler(*(t.to(cuda_device) if torch.is_tensor(t) else t
                 for t in scaler)), **kw)
    dev_agent.params = {k: v.to(cuda_device) for k, v in agent.params.items()}
    W = agent.window_size
    obs = torch.from_numpy(rng.normal(size=(n, W, OBS)).astype(np.float32))
    act = torch.from_numpy((0.005 * rng.normal(size=(n, W, ACT))).astype(
        np.float32))
    g = torch.Generator().manual_seed(1)
    tgt = (n, W, ACT) if backbone == "gpt" else (n, ACT)
    draws = {"u": 0.05 + 0.6 * torch.rand(n, generator=g),
             "noise": torch.randn(tgt, generator=g)}
    want = agent.loss_fn()(agent.params, obs, act, None, **draws)
    got = dev_agent.loss_fn()(dev_agent.params, obs.to(cuda_device),
                              act.to(cuda_device), None,
                              **{k: v.to(cuda_device)
                                 for k, v in draws.items()})
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-4)
    apply, dev_apply = agent.policy_apply(None), dev_agent.policy_apply(None)
    carry, dev_carry = agent.init_carry(OBS, B), dev_agent.init_carry(OBS, B)
    shape = agent.action_shape(B)
    for t in range(2):
        o = torch.from_numpy(rng.normal(size=(B, OBS)).astype(np.float32))
        d = (torch.randn(shape, generator=g),
             torch.randn((agent.n_steps,) + shape, generator=g))
        with torch.no_grad():
            carry, a = apply(agent.params, carry, o, d)
            dev_carry, da = dev_apply(dev_agent.params, dev_carry,
                                      o.to(cuda_device),
                                      tuple(x.to(cuda_device) for x in d))
        np.testing.assert_allclose(da.cpu().numpy(), a.numpy(), atol=1e-5,
                                   err_msg=f"step {t}")


@pytest.mark.cuda
def test_pushing_expert_runner_on_the_card(cuda_device):
    """One chunk (2 steps) of the kinematic pushing expert runner for 33
    episodes on the card (K1 and K3 launched) against the same chunk on the
    CPU (their plain versions), the same contexts, modes and exploration
    normals: the expert's discrete state and the dones exactly, the scene
    and the logs 1e-3 max-scaled."""
    from d3il_tpu_torch.data import experts, gen_demos
    B, L = 33, 2
    gen = torch.Generator().manual_seed(3)
    ctx = pushing.sample_context(gen, B)
    modes = np.arange(B) % 4
    seq_box, seq_tgt = gen_demos.pushing_sequences(modes)
    noise = torch.randn((L, B, 2), generator=gen)
    out = []
    for dev in ("cpu", cuda_device):
        params = pushing.PushingParams(n_substeps=2, device=dev,
                                       q_init=Q_INIT, kinematic=True)
        init, chunk = experts.make_pushing_runner(params, chunk_len=L)
        carry = init(tuple(c.to(dev) for c in ctx), seq_box, seq_tgt)
        out.append(chunk(carry, noise.to(dev)))
    (c0, logs0, d0), (c1, logs1, d1) = out
    for name in ("stage", "phase", "stall"):
        assert torch.equal(getattr(c1.es, name).cpu(), getattr(c0.es, name))
    assert torch.equal(d1.cpu(), d0)
    for name in ("q", "qd", "free_pos", "free_quat"):
        assert _scaled_err(getattr(c1.env.scene, name),
                           getattr(c0.env.scene, name)) <= 1e-3, name
    for a, b in zip(logs1, logs0):
        assert _scaled_err(a, b) <= 1e-3


@pytest.mark.cuda
def test_vision_renderer_and_encoder_on_the_card(cuda_device):
    """sorting_2's views (both cameras at res 96) of B = 4 observations
    from a seed rendered on the card against the CPU: at least 99.8 % of
    the pixels within 1e-5; then the MultiImageObsEncoder at its full width
    on those images with the same weights on both (cuDNN convolutions, TF32
    off): 1e-4 max-scaled."""
    from d3il_tpu_torch.vision import encoder, taskviews
    rng = np.random.default_rng(21)
    B = 4
    xy = rng.uniform([0.35, -0.25], [0.65, 0.25], (B, 4, 2))
    tan = rng.uniform(-1.0, 1.0, (B, 2, 1))
    obs = torch.from_numpy(np.concatenate(
        [xy[:, :2].reshape(B, 4), np.concatenate([xy[:, 2:], tan], 2)
         .reshape(B, 6)], 1).astype(np.float32))
    render = taskviews.make_render_obs("sorting_2", 96)
    want = render(obs)
    got = render(obs.to(cuda_device))
    for g, w in zip(got[:2], want[:2]):
        agree = ((g.cpu() - w).abs() <= 1e-5).all(-1).float().mean()
        assert agree >= 0.998, agree
    assert torch.equal(got[2].cpu(), want[2])
    enc = encoder.MultiImageObsEncoder(
        generator=torch.Generator().manual_seed(0))
    dev_enc = encoder.MultiImageObsEncoder(
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    dev_enc.load_state_dict(enc.state_dict())
    with torch.no_grad():
        f = enc(*want)
        df = dev_enc(*(x.to(cuda_device) for x in want))
    assert f.shape == (B, 2 * 64 + 4)
    assert _scaled_err(df, f) <= 1e-4


@pytest.mark.cuda
def test_per_env_window_matches_batched_window(cuda_device):
    """``envs/common._run_substeps_single`` for each of 4 pushing envs on
    the card (K1 and K3 at a batch of one, the arm's dynamics in plain
    PyTorch) against the batched window of the same 4 envs (K1, K2 and K3
    at B = 4), 10 substeps toward the red box from a state two steps into
    a push: every scene field within 1e-3 max-scaled (K2's qd_pre hold),
    the controller state within 3e-5; launches per env-window K1 1, K2 0,
    K3 one per substep."""
    from d3il_tpu_torch.envs import common
    B, n_sub = 4, 10
    params = pushing.PushingParams(n_substeps=n_sub, device=cuda_device,
                                   q_init=Q_INIT)
    gen = torch.Generator().manual_seed(5)
    state = pushing.reset(params, pushing.sample_context(gen, B))
    tcp, _ = params.tcp_pose(state.scene)
    quat = torch.tensor([0.0, 1.0, 0.0, 0.0], device=cuda_device)
    for _ in range(2):
        act = torch.cat([state.scene.free_pos[:, 0, :2],
                         torch.full((B, 1), 0.12, device=cuda_device),
                         quat.expand(B, 4)], dim=1)
        state, _ = pushing.step(params, state, act)
    sc, cs = state.scene, state.ctrl
    des_pos, des_quat = act[:, :3].contiguous(), act[:, 3:].contiguous()
    sc_b, cs_b = common.run_substeps(params, sc, cs, des_pos, des_quat)
    counters = (dyn_kernel.ik_window_bm, dyn_kernel.arm_stage_bm,
                contact_kernel.phase_batched_bm)
    for e in range(B):
        n0 = [fn.launches for fn in counters]
        sc_e, cs_e = common._run_substeps_single(
            params, type(sc)(*(x[e] for x in sc)),
            type(cs)(*(x[e] for x in cs)), des_pos[e], des_quat[e], 0.04,
            False)
        torch.cuda.synchronize()
        assert [fn.launches - n for fn, n in zip(counters, n0)] == \
            [1, 0, n_sub]
        for name, a, b in zip(sc._fields, sc_e, sc_b):
            assert _scaled_err(a, b[e]) <= 1e-3, (e, name)
        for a, b in zip(cs_e, cs_b):
            assert _scaled_err(a, b[e]) <= 3e-5, e
