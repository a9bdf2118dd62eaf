"""Cartesian pos+quat impedance controller state.

Counterpart of the state part of ``d3il_tpu/control/cartesian.py``. The
controller update itself (the damped-least-squares IK loop with its
convergence gate and finite-difference feedforward) runs for a whole
substep window in the IK-window kernel, ``engine/dyn_kernel.ik_window_bm``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CartImpedanceState(NamedTuple):
    q_virt: torch.Tensor       # [B, 7] virtual IK joint positions
    old_des_vel: torch.Tensor  # [B, 7] previous commanded joint velocity


def init_state(current_j_pos: torch.Tensor) -> CartImpedanceState:
    """Seed the virtual trajectory from the measured joints."""
    return CartImpedanceState(q_virt=current_j_pos,
                              old_des_vel=torch.zeros_like(current_j_pos))
