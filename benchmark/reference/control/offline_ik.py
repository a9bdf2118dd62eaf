"""Host-side offline IK for episode start poses (``d3il_tpu/control/offline_ik.py``).

Adaptive-step damped-least-squares IK (the reference's
OfflineIKTrajectoryGenerator). Runs once per task at build time: NumPy
float64 bookkeeping around a float32 FK/Jacobian on the CPU, as the JAX
package evaluates its FK in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ops import quat as quat_ops
from benchmark.reference.robot import chain as chain_mod
from benchmark.reference.robot.panda import JOINT_POS_MAX, JOINT_POS_MIN

# reference gains (TrajectoryTracking.py:344-366)
_PGAIN = np.array([33.9403713446798, 30.9403713446798, 33.9403713446798,
                   27.69370238555632, 33.98706171459314, 30.9185531893281])
_PGAIN_NULL = 5 * np.array([7.675519770796831, 2.676935478437176,
                            8.539040163444975, 1.270446361314313,
                            8.87752182480855, 2.186782233762969,
                            4.414432577659688])
_TARGET_NULL = np.array([3.57795216e-09, 1.74532920e-01, 3.30500960e-08,
                         -8.72664630e-01, -1.14096181e-07, 1.22173047e00,
                         7.85398126e-01])


def solve(ctrl_chain, des_pos, des_quat, q0=None, eps=1e-5, it_max=4000):
    """Find q such that FK(q) = (des_pos, des_quat) at panda_grasptarget."""
    ee = ctrl_chain.body_index("panda_grasptarget")

    def fk_jac(q):
        qt = torch.as_tensor(q, dtype=torch.float32)
        cache = chain_mod.fk(ctrl_chain, qt)
        J = chain_mod.point_jacobian(ctrl_chain, qt, ee, fk_cache=cache)
        return (cache[0][ee].double().numpy(), cache[1][ee].double().numpy(),
                J.double().numpy())

    des_pos = np.asarray(des_pos, np.float64)
    des_quat = np.asarray(des_quat, np.float64)
    des_quat_t = torch.as_tensor(des_quat, dtype=torch.float32)
    q = np.array(_TARGET_NULL if q0 is None else q0, np.float64)
    qd_d = np.zeros(7)
    dt = 1e-3
    old_err = np.inf
    W = np.eye(7)
    for _ in range(it_max):
        old_q = q.copy()
        q = np.clip(q + dt * qd_d, JOINT_POS_MIN, JOINT_POS_MAX)
        pos, quat, J = fk_jac(q)
        if np.linalg.norm(quat - des_quat) > np.linalg.norm(quat + des_quat):
            quat = -quat
        cpos_err = np.clip(des_pos - pos, -0.1, 0.1)
        cquat_err = np.clip(quat_ops.quat_error(
            torch.as_tensor(quat, dtype=torch.float32),
            des_quat_t).double().numpy(), -0.5, 0.5)
        err = np.sum(cpos_err ** 2) + np.sum((quat - des_quat) ** 2)
        if err > old_err:
            q = old_q
            dt *= 0.7
            if dt < 1e-5:
                # restart kick: float32 FK noise can wedge the adaptive step
                dt = 1e-3
                old_err = np.inf
            continue
        dt *= 1.025
        if err < eps:
            break
        old_err = err
        e6 = np.concatenate([cpos_err, cquat_err])
        JwJ = J @ W @ J.T + 1e-6 * np.eye(6)
        qd_null = _PGAIN_NULL * (_TARGET_NULL - q)
        # joint-limit avoidance (TrajectoryTracking.py:421-436)
        margin, pl = 0.1, 20.0
        hi = q > JOINT_POS_MAX - margin
        lo = q < JOINT_POS_MIN + margin
        qd_null = qd_null + hi * pl * (JOINT_POS_MAX - margin - q) \
            + lo * pl * (JOINT_POS_MIN + margin - q)
        y = np.linalg.solve(JwJ, _PGAIN * e6 - J @ qd_null)
        qd_d = W @ J.T @ y + qd_null
    return q
