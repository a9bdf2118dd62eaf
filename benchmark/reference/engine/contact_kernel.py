"""Plain version of the contact phase kernel K3: a frozen copy of the
port's ``engine/contact_kernel.py`` without the CUDA launch path, the
batched ``contact.build_rows`` + ``contact.phase_core``.
"""
from __future__ import annotations

import torch

from benchmark.reference.engine import contact


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


def phase_batched_bm(meta, pts, normal, depth, axes, anchors, Minv_arm, v_all,
                     a_smooth, free_pos, free_quat, warm):
    """Batch-minor contact phase (the plain version) on the scene's
    ``contact.ContactMeta``: every input [..., B]. Returns (f [ncon, 3, B],
    qfrc [nv, B])."""
    return phase_plain(meta, pts, normal, depth, axes, anchors, Minv_arm,
                       v_all, a_smooth, free_pos, free_quat, warm)
