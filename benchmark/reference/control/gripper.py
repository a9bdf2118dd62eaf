"""Gripper finger force law (``d3il_tpu/control/gripper.py``).

A symmetric centering force plus either a grasp force / closing-velocity
servo when the fingers are wide of the commanded width, or a clipped PD
toward it. The arm-stage kernel (``csrc/dyn_kernel.cu``) carries the same
law inline.
"""
from __future__ import annotations

import torch

PGAIN = 500.0
DGAIN = 10.0


def finger_forces(fing_pos, fing_vel, set_width, grasp_flag):
    """Per-finger forces [..., 2] from positions/velocities [..., 2], the
    commanded width per finger [...] and the grasp flag [...] (bool)."""
    mean_pos = fing_pos.mean(dim=-1, keepdim=True)
    force = PGAIN * (mean_pos - fing_pos)
    set_width = set_width[..., None]
    wide = (mean_pos - set_width) > 0.005
    # -20 N grasp force with a closing-speed brake (see the JAX counterpart)
    brake = 200.0 * torch.clamp_min(-(fing_vel + 0.2), 0.0)
    grasp = torch.clamp_max(-20.0 + brake, 0.0)
    close_servo = DGAIN * (-0.2 - fing_vel)
    pd = torch.clamp(PGAIN * (set_width - fing_pos) - DGAIN * fing_vel,
                     -5.0, 5.0)
    branch_wide = torch.where(grasp_flag[..., None], grasp, close_servo)
    return force + torch.where(wide, branch_wide, pd)
