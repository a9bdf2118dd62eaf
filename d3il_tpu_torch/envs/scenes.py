"""Scene construction for the pushing task (``d3il_tpu/envs/scenes.py``).

The lab table's top surface sits at z = -0.019 with the reference's contact
parameters, modelled as an infinite plane.
"""
from __future__ import annotations

import numpy as np

from d3il_tpu_torch.engine import model as emodel
from d3il_tpu_torch.robot import panda

TABLE_Z = -0.019
TABLE_SOLIMP = (0.999, 0.999, 0.001, 0.5, 2.0)
TABLE_SOLREF = (0.002, 1.0)

# reference init end-effector pose shared by the rod tasks
INIT_EE_POS = np.array([0.525, -0.28, 0.12])
INIT_EE_QUAT = np.array([0.0, 1.0, 0.0, 0.0])


def table_geom() -> emodel.Geom:
    return emodel.Geom(gtype=emodel.PLANE, size=(0.0, 0.0, 1.0),
                       pos=(0.4, 0.0, TABLE_Z), solimp=TABLE_SOLIMP,
                       solref=TABLE_SOLREF, name="table")


def rod_robot_geoms(chain):
    """Rod collision capsule (panda_rod_invisible.xml body 'rod'): radius
    0.01, core half-length 0.14 so the caps end at the cylinder's faces."""
    hand = chain.body_index("panda_hand")
    return [emodel.Geom(gtype=emodel.CAPSULE, size=(0.01, 0.14),
                        body=hand, pos=(0.0, 0.0, 0.075), name="rod")]


def build_pushing_scene(solver_iters: int = 25) -> emodel.SceneModel:
    """Pushing task scene: two 0.05 kg boxes with 3 cm half-extents."""
    robot = panda.build_sim_chain("rod")
    boxes = [
        dict(name="push_box", mass=0.05, size=(0.03, 0.03, 0.03)),
        dict(name="push_box2", mass=0.05, size=(0.03, 0.03, 0.03)),
    ]
    return emodel.build_scene(
        robot, rod_robot_geoms(robot), boxes, [table_geom()],
        collide_robot_static=True, solver_iters=solver_iters)


# Pushing target poses (pushing_objects.py:11-15)
PUSHING_TARGET_1 = np.array([0.42, 0.3, 0.0])
PUSHING_TARGET_2 = np.array([0.63, 0.3, 0.0])
