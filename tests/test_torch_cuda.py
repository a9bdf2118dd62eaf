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

from d3il_tpu_torch.control import gains  # noqa: E402
from d3il_tpu_torch.engine import contact_kernel, dyn_kernel, substep_bm  # noqa: E402
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


@pytest.mark.cuda
def test_arm_stage_kernel_matches_plain(cuda_device):
    B = 256
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


@pytest.mark.cuda
def test_ik_window_kernel_matches_plain(cuda_device):
    B, n_sub = 256, 4
    rng = np.random.default_rng(3)
    ins = [panda.INIT_QPOS[:, None] + 0.2 * rng.standard_normal((7, B)),
           0.05 * rng.standard_normal((7, B)),
           np.array([0.5, 0.0, 0.2])[:, None]
           + 0.05 * rng.standard_normal((3, B)),
           np.tile(np.array([0.0, 1.0, 0.0, 0.0])[:, None], (1, B))]
    ins = [torch.from_numpy(x.astype(np.float32)) for x in ins]
    spec = dyn_kernel.IkSpec(panda.build_control_chain(),
                             gains.CartPosQuatGains(), 1e-3)
    ref = dyn_kernel.ik_window_bm(spec, n_sub, *ins)
    out = dyn_kernel.ik_window_bm(spec, n_sub,
                                  *(x.to(cuda_device) for x in ins))
    torch.cuda.synchronize()
    # test_dyn_kernel.py:148-156: q_virt/q_des 3e-5, velocities 3e-2,
    # feedforward 2e-3 scaled
    for a, b, tol in zip(out, ref, (3e-5, 3e-2, 3e-5, 3e-2, 2e-3)):
        assert _scaled_err(a, b) <= tol


@pytest.mark.cuda
def test_contact_kernel_matches_plain(cuda_device):
    B = 64
    params = pushing.PushingParams(n_substeps=2, device="cpu", q_init=Q_INIT)
    rng = np.random.default_rng(4)
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
    args = substep_bm.contact_inputs(st, sb, arm)
    f_ref, q_ref = contact_kernel.phase_batched_bm(st.contact, *args)
    tables = contact_kernel.ContactTables(st.meta, cuda_device)
    f, qfrc = contact_kernel.phase_batched_bm(
        tables, *(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert f_ref.abs().max() > 1e-3
    # test_contact_kernel.py:116-117
    assert _scaled_err(f, f_ref) <= 2e-4
    assert _scaled_err(qfrc, q_ref) <= 2e-4
