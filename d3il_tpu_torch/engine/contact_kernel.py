"""Contact phase kernel (K3): wrapper, static tables and plain version.

Counterpart of ``d3il_tpu/engine/contact_kernel.py``. On CUDA tensors
``phase_batched_bm`` launches the hand-written kernel in
``csrc/contact_kernel.cu`` or raises; on CPU tensors it runs the plain
version, the batched ``contact.build_rows`` + ``contact.phase_core``.
``phase_batched_bm.launches`` counts kernel launches.

The kernel has two variants, both one warp per env, picked by the scene's
size (``geometry`` mirrors how the .cu picks and sizes them): the register
variant (scenes with at most 56 constraint rows, pushing's 54 among them)
forms the scaled Delassus matrix once and keeps each lane's rows of it in
registers; the general variant keeps J and M^-1 J' in shared memory and
takes any larger scene whose per-env working set fits one block's shared
memory. A larger scene raises. Unlike the TPU kernel there is no 128-lane
tile gate. A scene with no free body (nf = 0, avoiding) passes empty
``free_pos`` / ``free_quat`` tensors, whose pointers the kernel never reads
(every loop over free bodies and free columns is empty; ``side_a`` /
``side_b`` are all -1).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from d3il_tpu_torch.engine import contact
from d3il_tpu_torch.kernels import build

_MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90


class ContactDims(ctypes.Structure):
    _fields_ = [("ncon", ctypes.c_int), ("nv_r", ctypes.c_int),
                ("nf", ctypes.c_int), ("nv", ctypes.c_int),
                ("n_iters", ctypes.c_int), ("impratio", ctypes.c_float)]


def smem_bytes(meta) -> int:
    """Per-env shared memory of the general variant (mirrors smem_floats in
    the .cu)."""
    n = 3 * meta.ncon
    return 4 * (2 * n * meta.nv + meta.nv_r ** 2 + 6 * meta.nv_r
                + 12 * meta.nf + 3 * meta.nv + 9 * n + 2 * meta.ncon)


REG_COLS = 56      # rows the register variant takes, padded (K3_REG_NC)
REG_WARPS = 4      # envs per block of the register variant (K3_REG_WARPS)
REG_MAX_VR = 9     # robot dofs the register variant takes (K3_MAXVR)


def reg_smem_bytes(meta) -> int:
    """Per-env shared memory of the register variant (mirrors
    reg_smem_floats in the .cu)."""
    nc = REG_COLS
    f = (meta.nv * nc + 3 * nc + meta.nv_r ** 2 + 6 * meta.nv_r
         + 12 * meta.nf + 2 * meta.nv + 10 * meta.ncon)
    return 4 * ((f + 3) // 4 * 4)


def reg_table_bytes(meta) -> int:
    """The register variant's per-block copy of the scene tables (mirrors
    reg_table_floats in the .cu)."""
    f = (9 * meta.ncon + meta.ncon * meta.nv_r + meta.nv_r + 2 * meta.ncon
         + 6 * meta.nf)
    return 4 * ((f + 3) // 4 * 4)


class Geometry(NamedTuple):
    """How the kernel runs a scene: ``variant`` 1 (register) or 2
    (general), envs (warps) per block, shared-memory bytes per env and per
    block (the register variant adds one copy of the scene tables per
    block), and the register variant's padded width (0 for the general)."""

    variant: int
    envs_per_block: int
    smem_per_env: int
    smem_per_block: int
    cols: int


def geometry(meta) -> Geometry:
    """The launch geometry of ``d3il_contact_phase`` for this scene: the
    register variant where it applies, else the general one. Raises for a
    scene neither takes."""
    if 3 * meta.ncon <= REG_COLS and meta.nv_r <= REG_MAX_VR:
        per_env = reg_smem_bytes(meta)
        per_block = reg_table_bytes(meta) + per_env * REG_WARPS
        if per_block <= _MAX_SMEM:
            return Geometry(1, REG_WARPS, per_env, per_block, REG_COLS)
    per_env = smem_bytes(meta)
    if per_env > _MAX_SMEM:
        raise ValueError(
            f"contact scene with ncon={meta.ncon}, nv={meta.nv} needs "
            f"{per_env} B of shared memory per env; the kernel takes at most "
            f"{_MAX_SMEM}")
    w = min(max((48 * 1024) // per_env, 1), 4)
    return Geometry(2, w, per_env, per_env * w, 0)


def _row_const(meta) -> np.ndarray:
    """[ncon, 9] static row constants: k, b, mu, d0, dw, width, mid, 1/mid,
    1/(1-mid) (kbi + impedance sigmoid with solimp power 2)."""
    si = meta.solimp
    if not np.all(si[:, 4] == 2.0):
        raise NotImplementedError("contact kernel needs solimp power == 2")
    mid = si[:, 3]
    return np.stack([meta.k_row, meta.b_row, meta.mu, si[:, 0], si[:, 1],
                     np.maximum(si[:, 2], 1e-12), mid, 1.0 / mid,
                     1.0 / (1.0 - mid)], axis=1).astype(np.float32)


class ContactTables:
    """Device copies of a scene's static row tables, built once, and the
    kernel variant that runs the scene."""

    def __init__(self, meta: contact.ContactMeta, device):
        self.geometry = geometry(meta)
        _row_const(meta)  # power check
        self.meta = meta
        dev = torch.device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32).reshape(-1),
                                        device=dev).contiguous()

        def side(onehot):
            idx = np.full(meta.ncon, -1, np.int32)
            for r in range(meta.ncon):
                hit = np.flatnonzero(onehot[r]) if meta.nf else []
                if len(hit):
                    idx[r] = int(hit[0])
            return torch.as_tensor(idx, device=dev)

        self.rowc = f32(_row_const(meta))
        self.mask_rob = f32(meta.mask_rob)
        self.is_hinge = f32(meta.is_hinge)
        self.side_a = side(meta.onehot_a)
        self.side_b = side(meta.onehot_b)
        self.inv_free = f32(meta.inv_free if meta.nf else np.zeros(1))
        self.dims = ContactDims(meta.ncon, meta.nv_r, meta.nf, meta.nv,
                                meta.n_iters, float(meta.impratio))


def phase_plain(meta, pts, normal, depth, axes, anchors, Minv_arm, v_all,
                a_smooth, free_pos, free_quat, warm):
    """Plain version on batch-minor inputs: batched build_rows + phase_core."""
    bf = lambda x: torch.movedim(x, -1, 0)
    Jf = contact.build_rows(meta, bf(pts), bf(normal), bf(axes), bf(anchors),
                            bf(free_pos), bf(free_quat))
    f, qfrc = contact.phase_core(meta, Jf, bf(depth), bf(Minv_arm), bf(v_all),
                                 bf(a_smooth), bf(warm))
    return (torch.movedim(f, 0, -1).contiguous(),
            torch.movedim(qfrc, 0, -1).contiguous())


_P = ctypes.c_void_p


def _lib():
    lib = build.load("contact_kernel")
    if not getattr(lib, "_d3il_ready", False):
        lib.d3il_contact_phase.argtypes = [ContactDims, ctypes.c_int,
                                           ctypes.c_int, *([_P] * 19), _P]
        lib.d3il_contact_phase.restype = ctypes.c_int
        lib._d3il_ready = True
    return lib


def phase_batched_bm(tables: ContactTables, pts, normal, depth, axes, anchors,
                     Minv_arm, v_all, a_smooth, free_pos, free_quat, warm):
    """Batch-minor contact phase: every input [..., B]. Returns
    (f [ncon, 3, B], qfrc [nv, B])."""
    meta = tables.meta
    if pts.device.type == "cpu":
        return phase_plain(meta, pts, normal, depth, axes, anchors, Minv_arm,
                           v_all, a_smooth, free_pos, free_quat, warm)
    B = pts.shape[-1]
    ncon, nv_r, nf, nv = meta.ncon, meta.nv_r, meta.nf, meta.nv
    build.check_inputs({
        "pts": (pts, (ncon, 3)), "normal": (normal, (ncon, 3)),
        "depth": (depth, (ncon,)), "axes": (axes, (nv_r, 3)),
        "anchors": (anchors, (nv_r, 3)), "Minv_arm": (Minv_arm, (nv_r, nv_r)),
        "v_all": (v_all, (nv,)), "a_smooth": (a_smooth, (nv,)),
        "free_pos": (free_pos, (nf, 3)), "free_quat": (free_quat, (nf, 4)),
        "warm": (warm, (ncon, 3))}, B, pts.device)
    if tables.rowc.device != pts.device:
        raise ValueError(f"contact tables are on {tables.rowc.device}, "
                         f"inputs on {pts.device}")
    f = torch.empty((ncon, 3, B), dtype=torch.float32, device=pts.device)
    qfrc = torch.empty((nv, B), dtype=torch.float32, device=pts.device)
    ptrs = [t.data_ptr() for t in (
        pts, normal, depth, axes, anchors, Minv_arm, v_all, a_smooth,
        free_pos, free_quat, warm, tables.rowc, tables.mask_rob,
        tables.is_hinge, tables.side_a, tables.side_b, tables.inv_free, f,
        qfrc)]
    status = _lib().d3il_contact_phase(tables.dims, tables.geometry.variant,
                                       B, *ptrs,
                                       build.stream_of(pts.device))
    build.check(status, "contact_phase launch")
    phase_batched_bm.launches += 1
    return f, qfrc


phase_batched_bm.launches = 0
