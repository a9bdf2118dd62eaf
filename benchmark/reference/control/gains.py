"""Typed controller gain sets.

Values mirror the reference's gin config
(d3il_sim/controllers/Config/mujoco_controller_config.gin:6-37;
identical to d3il_tpu/control/gains.py) folded into
plain dataclasses — the rebuild uses one typed config system instead of
gin+hydra split across files.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

REST_POSTURE = np.array([0.0, 0.174, 0.0, -0.872, 0.0, 1.222, 0.785])


@dataclass(frozen=True)
class JointPDGains:
    pgain: np.ndarray = field(default_factory=lambda: np.array(
        [120.0, 120.0, 120.0, 120.0, 50.0, 30.0, 10.0]))
    dgain: np.ndarray = field(default_factory=lambda: np.array(
        [10.0, 10.0, 10.0, 10.0, 6.0, 5.0, 3.0]))


@dataclass(frozen=True)
class CartPosQuatGains:
    """CartPosQuatImpedenceController config (gin lines 26-37)."""
    pgain_pos: np.ndarray = field(default_factory=lambda: np.array([200.0, 200.0, 800.0]))
    pgain_quat: np.ndarray = field(default_factory=lambda: np.array([30.0, 30.0, 30.0]))
    pgain_null: np.ndarray = field(default_factory=lambda: np.full(7, 40.0))
    J_reg: float = 1e-12
    W: np.ndarray = field(default_factory=lambda: np.ones(7))
    rest_posture: np.ndarray = field(default_factory=lambda: REST_POSTURE.copy())
    ddgain: np.ndarray = field(default_factory=lambda: np.full(7, 0.4))
    joint_filter_coefficient: float = 1.0
    min_svd_values: float = 1e-2
    max_svd_values: float = 1e2
    num_iter: int = 3
    learning_rate: float = 0.001
    # qdd_des finite-difference clamp (rad/s^2). The reference only guards
    # against NaN (norm <= 10000, IKControllers.py:300); our float32 solve
    # needs a physical-band clamp to bound limit-cycle jitter torque
    # (control/cartesian.py notes). Configurable for experiments.
    qdd_clip: float = 25.0


@dataclass(frozen=True)
class DampingGains:
    dgain: np.ndarray = field(default_factory=lambda: np.array(
        [5.0, 5.0, 5.0, 5.0, 3.0, 2.5, 1.5]))
