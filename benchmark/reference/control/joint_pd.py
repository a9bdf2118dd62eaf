"""Joint-space tracking controllers: PD + model-based feedforward.

Counterpart of ``d3il_tpu/control/joint_pd.py``, on tensors with the joints
last (``[..., 7]``):

  * ``pd_accel``           — the reference's JointPDController.getControl;
  * ``model_feedforward``  — M(q_des) qdd_des + C(q_des, qd_des) on the URDF
                             control chain (one zero-gravity RNEA pass);
  * ``feedforward_torque`` — the two summed
                             (ModelBasedFeedforwardController.getControl).

The batched windows fold these into the kernels: K2 takes the PD law and
K1 / K4 the feedforward (``engine/dyn_kernel.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.control.gains import JointPDGains
from benchmark.reference.engine import dyn_scalar as dsc

# the reference JointPDController's default setpoint
DEFAULT_SETPOINT = np.array([0.0, 0.0, 0.0, -1.562, 0.0, 1.914, 0.0])


def pd_accel(gains: JointPDGains, q_des, qd_des, q, qd):
    p = q.new_tensor(np.asarray(gains.pgain, np.float64))
    d = q.new_tensor(np.asarray(gains.dgain, np.float64))
    return p * (q_des - q) + d * (qd_des - qd)


def model_feedforward(ctrl_chain, q_des, qd_des, qdd_des):
    """M(q_des) qdd_des + C(q_des, qd_des): the inverse dynamics of the
    desired trajectory with gravity off. Depends only on the desired
    trajectory, so callers batch it over whole windows."""
    q, qd, qdd = ([x[..., i] for i in range(ctrl_chain.nv)]
                  for x in (q_des, qd_des, qdd_des))
    xpos, xquat = dsc.fk_s(ctrl_chain, q)
    return torch.stack(dsc.rnea_s(ctrl_chain, xpos, xquat, q, qd, qdd,
                                  gravity=(0.0, 0.0, 0.0)), dim=-1)


def feedforward_torque(ctrl_chain, gains: JointPDGains, q_des, qd_des,
                       qdd_des, q, qd):
    """PD + model feedforward on the desired trajectory."""
    return (pd_accel(gains, q_des, qd_des, q, qd)
            + model_feedforward(ctrl_chain, q_des, qd_des, qdd_des))
