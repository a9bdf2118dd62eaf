"""Contact phase kernel (K3): wrapper, static tables and plain version.

Counterpart of ``d3il_tpu/engine/contact_kernel.py``. On CUDA tensors
``phase_batched_bm`` launches the hand-written kernel in
``csrc/contact_kernel.cu`` (one warp per env, J and M^-1 J' in shared
memory) or raises; on CPU tensors it runs the plain version, the batched
``contact.build_rows`` + ``contact.phase_core``. ``phase_batched_bm.launches``
counts kernel launches. Unlike the TPU kernel there is no 128-lane tile
gate: any scene whose per-env working set fits one block's shared memory
runs; a larger one raises.
"""
from __future__ import annotations

import ctypes

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
    """Per-env shared memory of the kernel (mirrors smem_floats in the .cu)."""
    n = 3 * meta.ncon
    return 4 * (2 * n * meta.nv + meta.nv_r ** 2 + 6 * meta.nv_r
                + 12 * meta.nf + 3 * meta.nv + 9 * n + 2 * meta.ncon)


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
    """Device copies of a scene's static row tables, built once."""

    def __init__(self, meta: contact.ContactMeta, device):
        if smem_bytes(meta) > _MAX_SMEM:
            raise ValueError(
                f"contact scene with ncon={meta.ncon}, nv={meta.nv} needs "
                f"{smem_bytes(meta)} B of shared memory per env; the kernel "
                f"takes at most {_MAX_SMEM}")
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
                                           *([_P] * 19), _P]
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
    if meta.nf == 0:
        raise NotImplementedError("contact kernel path needs free bodies")
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
    status = _lib().d3il_contact_phase(tables.dims, B, *ptrs,
                                       build.stream_of(pts.device))
    build.check(status, "contact_phase launch")
    phase_batched_bm.launches += 1
    return f, qfrc


phase_batched_bm.launches = 0
