"""Contact phase kernel (K3): wrapper, static tables and plain version.

Counterpart of ``d3il_tpu/engine/contact_kernel.py``. On CUDA tensors
``phase_batched_bm`` launches the hand-written kernel in
``csrc/contact_kernel.cu`` or raises; on CPU tensors it runs the plain
version, the batched ``contact.build_rows`` + ``contact.phase_core``.
``phase_batched_bm.launches`` counts kernel launches (one per call).

The kernel has two variants, both one warp per env and four envs per
block, picked by the scene's size (``geometry`` picks them and the compact
variant's cap, and mirrors how the .cu sizes them): the register variant (scenes with at most 56 constraint
rows: pushing's 54, avoiding's 24) forms the scaled Delassus matrix once
and keeps each lane's rows of it in registers; the compact variant (every
larger scene) first compacts each env's active contacts (depth > 0), whose
rows alone carry the solve, writes f = 0 on the others, and solves the
active ones in the register form where they fit 56 rows, else in a
factored form in shared memory sized at launch for ``cap`` active contacts
per env (the most that fit an env's share of an SM when the batch runs in
one wave); an env above the cap runs on its slot of a global workspace
that ``ContactTables`` allocates at the first launch that needs it (again
only for a larger batch). Unlike the TPU kernel there is no 128-lane tile
gate. A scene with no free body (nf = 0, avoiding) passes empty
``free_pos`` / ``free_quat`` tensors, whose pointers the kernel never
reads (every loop over free bodies and free columns is empty; ``side_a`` /
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


REG_COLS = 56      # rows the register form takes, padded (K3_REG_NC)
REG_WARPS = 4      # envs (warps) per block, both variants (K3_REG_WARPS)
REG_MAX_VR = 9     # robot dofs the register form takes (K3_MAXVR)
REG_MIN_BLOCKS = 3  # blocks per SM the registers allow (K3_REG_MINB)
SM_SMEM = 233472   # shared memory per SM on sm_90
BLOCK_RESERVED = 1024  # of it, what CUDA reserves per block
SM_COUNT = 132     # H100 SXM's SMs: a geometry asked without a card


def _round4(f: int) -> int:
    return (f + 3) // 4 * 4


def reg_smem_bytes(meta) -> int:
    """Per-env shared memory of the register variant (mirrors
    reg_smem_floats in the .cu)."""
    nc = REG_COLS
    f = (meta.nv * nc + 3 * nc + meta.nv_r ** 2 + 6 * meta.nv_r
         + 12 * meta.nf + 2 * meta.nv + 10 * meta.ncon)
    return 4 * _round4(f)


def reg_table_bytes(meta) -> int:
    """The register variant's per-block copy of the scene tables (mirrors
    reg_table_floats in the .cu)."""
    f = (9 * meta.ncon + meta.ncon * meta.nv_r + meta.nv_r + 2 * meta.ncon
         + 6 * meta.nf)
    return 4 * _round4(f)


def staged_floats(meta, nc: int) -> int:
    """One env's staged inputs for ``nc`` contacts (staged_floats)."""
    return _round4(meta.nv_r ** 2 + 6 * meta.nv_r + 12 * meta.nf
                   + 2 * meta.nv + 10 * nc)


def fact_floats(meta, nc: int) -> int:
    """The factored solve's working set for ``nc`` active contacts
    (fact_floats)."""
    return (staged_floats(meta, nc) + 3 * nc * (meta.nv + meta.nv_r)
            + 27 * nc + meta.nv + nc)


def compact_smem_floats(meta, cap: int) -> int:
    """Per-env shared memory of the compact variant at a cap of ``cap``
    active contacts: the compact index, then the larger of the register
    form's and the factored form's working sets (compact_smem_floats)."""
    reg = staged_floats(meta, REG_COLS // 3) + (meta.nv + 3) * REG_COLS
    return _round4(meta.ncon) + _round4(max(reg, fact_floats(meta, cap)))


def env_budget(B: int, n_sm: int) -> int:
    """The compact variant's shared memory per env, in bytes, for a launch
    of B envs on n_sm SMs: the share of an SM's shared memory left to each
    env at the fewest blocks per SM that run the batch in one wave, at most
    REG_MIN_BLOCKS (as many as the registers allow)."""
    blocks = -(-B // REG_WARPS)
    per_sm = min(max(-(-blocks // n_sm), 1), REG_MIN_BLOCKS)
    return (SM_SMEM // per_sm - BLOCK_RESERVED) // REG_WARPS


def compact_cap(meta, budget: int) -> int:
    """The most active contacts an env of the compact variant solves in
    shared memory: the largest cap whose per-env shared memory fits
    ``budget`` bytes, 0 where none does."""
    cap = meta.ncon
    while cap > 0 and 4 * compact_smem_floats(meta, cap) > budget:
        cap -= 1
    return cap


def smem_bytes(meta, B: int = 1, n_sm: int = SM_COUNT) -> int:
    """Per-env shared memory of the compact variant at its cap, for a
    batch of B envs on n_sm SMs."""
    return 4 * compact_smem_floats(meta,
                                   compact_cap(meta, env_budget(B, n_sm)))


def ws_bytes(meta) -> int:
    """Per-env slot of the compact variant's global workspace: the factored
    working set with every contact active (compact_ws_floats)."""
    return 4 * _round4(fact_floats(meta, meta.ncon))


class Geometry(NamedTuple):
    """How the kernel runs a launch: ``variant`` 1 (register) or 2
    (compact), envs (warps) per block, shared-memory bytes per env and per
    block (the register variant adds one copy of the scene tables per
    block), the register variant's padded width (0 for the compact), and
    the compact variant's cap of active contacts an env solves in shared
    memory and its workspace bytes per env (0 where the cap takes every
    contact; both 0 for the register variant)."""

    variant: int
    envs_per_block: int
    smem_per_env: int
    smem_per_block: int
    cols: int
    cap: int
    ws_per_env: int


def geometry(meta, B: int, n_sm: int = SM_COUNT) -> Geometry:
    """The launch geometry of ``d3il_contact_phase`` for this scene and a
    batch of B envs on n_sm SMs: the register variant where it applies,
    else the compact one, whose cap the launch passes to the kernel.
    Raises for a scene neither takes."""
    if meta.nv_r > REG_MAX_VR:
        raise ValueError(f"contact scene with nv_r={meta.nv_r}: the kernel "
                         f"takes at most {REG_MAX_VR} robot dofs")
    if 3 * meta.ncon <= REG_COLS:
        per_env = reg_smem_bytes(meta)
        per_block = reg_table_bytes(meta) + per_env * REG_WARPS
        if per_block <= _MAX_SMEM:
            return Geometry(1, REG_WARPS, per_env, per_block, REG_COLS, 0, 0)
    cap = compact_cap(meta, env_budget(B, n_sm))
    per_env = 4 * compact_smem_floats(meta, cap)
    if per_env * REG_WARPS > _MAX_SMEM:
        raise ValueError(
            f"contact scene with ncon={meta.ncon}, nv={meta.nv} needs "
            f"{per_env * REG_WARPS} B of shared memory per block; the kernel "
            f"takes at most {_MAX_SMEM}")
    return Geometry(2, REG_WARPS, per_env, per_env * REG_WARPS, 0, cap,
                    0 if cap == meta.ncon else ws_bytes(meta))


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
    """Device copies of a scene's static row tables, built once, the kernel
    variant that runs the scene and the compact variant's workspace."""

    def __init__(self, meta: contact.ContactMeta, device):
        self.variant = geometry(meta, 1).variant   # raises for no variant
        _row_const(meta)  # power check
        self.meta = meta
        dev = torch.device(device)
        self.n_sm = (torch.cuda.get_device_properties(dev).multi_processor_count
                     if dev.type == "cuda" else SM_COUNT)
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
        self._ws = None
        self._geometry = {}

    def geometry(self, B: int) -> Geometry:
        """The launch geometry for a batch of B envs on this device (kept
        per batch size: the cap's search is host time on every launch)."""
        geo = self._geometry.get(B)
        if geo is None:
            geo = self._geometry[B] = geometry(self.meta, B, self.n_sm)
        return geo

    def workspace(self, B: int):
        """The compact variant's global workspace for ``B`` envs (one slot
        per env, used only by an env above the cap), allocated at the first
        launch that needs one and again only for a larger batch; None where
        the cap takes every contact and for the register variant."""
        need = B * self.geometry(B).ws_per_env // 4
        if not need:
            return None
        if self._ws is None or self._ws.numel() < need:
            self._ws = torch.empty(need, dtype=torch.float32,
                                   device=self.rowc.device)
        return self._ws


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
                                           ctypes.c_int, ctypes.c_int,
                                           *([_P] * 20), _P]
        lib.d3il_contact_phase.restype = ctypes.c_int
        lib._d3il_ready = True
    return lib


def _launch(tables: ContactTables, ins, f, qfrc):
    """Launch the kernel on the checked CUDA inputs ``ins`` (the eleven of
    ``phase_batched_bm``, in its order) into ``f`` and ``qfrc``, every
    element of which it writes. Counts nothing: ``phase_batched_bm``
    counts its own launches."""
    B = ins[0].shape[-1]
    ws = tables.workspace(B)
    ptrs = [t.data_ptr() for t in (
        *ins, tables.rowc, tables.mask_rob, tables.is_hinge, tables.side_a,
        tables.side_b, tables.inv_free, f, qfrc)]
    status = _lib().d3il_contact_phase(
        tables.dims, tables.variant, B, tables.geometry(B).cap, *ptrs,
        None if ws is None else ws.data_ptr(), build.stream_of(f.device))
    build.check(status, "contact_phase launch")


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
    _launch(tables, (pts, normal, depth, axes, anchors, Minv_arm, v_all,
                     a_smooth, free_pos, free_quat, warm), f, qfrc)
    phase_batched_bm.launches += 1
    return f, qfrc


phase_batched_bm.launches = 0
