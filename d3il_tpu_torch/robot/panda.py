"""Franka-Panda chain models built from the extracted reference constants.

Counterpart of ``d3il_tpu/robot/panda.py``: the URDF *control* chain the
IK/impedance controllers use (7 revolute dofs, fingers welded at 0) and the
MJCF *sim* chain the physics steps (7 hinge + 2 slide finger dofs).
"""
from __future__ import annotations

import numpy as np

from d3il_tpu_torch.robot import _panda_constants as C
from d3il_tpu_torch.robot.chain import (Chain, ChainBuilder, HINGE, SLIDE,
                                        _quat_to_mat_np, _rpy_to_quat)

# Franka limits used by RobotBase (reference core/Robots.py:54-65)
TORQUE_LIMIT = np.array([80.0, 80.0, 80.0, 80.0, 10.0, 10.0, 10.0])
JOINT_VEL_LIMIT = np.array([2.0, 2.0, 2.0, 2.0, 2.5, 2.5, 2.5])
JOINT_POS_MIN = np.array([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973])
JOINT_POS_MAX = np.array([2.8973, 1.7628, 2.0, -0.0698, 2.8973, 3.7525, 2.8973])

# Default initial arm configuration (reference MjRobot.get_init_qpos)
INIT_QPOS = np.array([
    3.57795216e-09, 1.74532920e-01, 3.30500960e-08, -8.72664630e-01,
    -1.14096181e-07, 1.22173047e00, 7.85398126e-01,
])


def _urdf_inertia_mat(link):
    ixx, iyy, izz, ixy, ixz, iyz = link["inertia"]
    I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    R = _quat_to_mat_np(_rpy_to_quat(link["i_rpy"]))
    return R @ I @ R.T


def build_control_chain() -> Chain:
    """URDF-parameter chain: 7 revolute dofs, hand+fingers welded rigid.
    FK target frame: body ``panda_grasptarget``."""
    links = C.URDF_LINKS
    joints = {j["name"]: j for j in C.URDF_JOINTS}
    b = ChainBuilder()
    b.add_body("panda_link0", None, mass=links["panda_link0"]["mass"],
               com=links["panda_link0"]["com"],
               inertia=_urdf_inertia_mat(links["panda_link0"]))
    for i in range(1, 8):
        j = joints[f"panda_joint{i}"]
        lk = links[f"panda_link{i}"]
        b.add_body(
            f"panda_link{i}", j["parent"], pos=j["xyz"],
            quat=_rpy_to_quat(j["rpy"]), joint_type=HINGE, joint_axis=j["axis"],
            mass=lk["mass"], com=lk["com"], inertia=_urdf_inertia_mat(lk),
            joint_range=(j["lower"], j["upper"]))
    for name in ("panda_joint8", "panda_hand_joint",
                 "panda_finger_joint1", "panda_finger_joint2"):
        j = joints[name]
        lk = links[j["child"]]
        b.add_body(j["child"], j["parent"], pos=j["xyz"],
                   quat=_rpy_to_quat(j["rpy"]), mass=lk["mass"],
                   com=lk["com"], inertia=_urdf_inertia_mat(lk))
    j = joints["panda_grasptarget_hand"]
    b.add_body("panda_grasptarget", j["parent"], pos=j["xyz"],
               quat=_rpy_to_quat(j["rpy"]))
    return b.build()


def _mjcf_inertia_mat(inertial):
    R = _quat_to_mat_np(np.asarray(inertial["quat"], np.float64)
                        / np.linalg.norm(inertial["quat"]))
    return R @ np.diag(inertial["diaginertia"]) @ R.T


_JT = {"hinge": HINGE, "slide": SLIDE}


def build_sim_chain(variant: str = "rod") -> Chain:
    """MJCF-parameter chain for simulation (7 arm + 2 finger dofs).

    variant: "rod" -> panda_rod_invisible.xml, "gripper" -> panda.xml."""
    spec = C.MJCF_PANDA_ROD if variant == "rod" else C.MJCF_PANDA_GRIPPER
    b = ChainBuilder()
    for body in spec["bodies"]:
        inert = body["inertial"]
        kw = dict(
            pos=body["pos"], quat=body["quat"],
            mass=inert["mass"] if inert else 0.0,
            com=inert["pos"] if inert else (0, 0, 0),
            inertia=_mjcf_inertia_mat(inert) if inert else None,
        )
        jnt = body["joint"]
        if jnt is not None:
            rng = jnt["range"] if jnt["range"] else (-1e9, 1e9)
            kw.update(joint_type=_JT[jnt["type"]], joint_axis=jnt["axis"],
                      joint_pos=jnt["pos"], damping=jnt["damping"],
                      joint_range=tuple(rng))
        parent = body["parent"] if body["parent"] != "world" else None
        b.add_body(body["name"], parent, **kw)
    return b.build()


def sim_geoms(variant: str = "rod"):
    """Collision-relevant primitive geoms of the sim robot (those with a
    contype or conaffinity), each a dict with its body's name."""
    spec = C.MJCF_PANDA_ROD if variant == "rod" else C.MJCF_PANDA_GRIPPER
    return [{"body": body["name"], **g} for body in spec["bodies"]
            for g in body["geoms"]
            if g["contype"] != 0 or g["conaffinity"] != 0]
