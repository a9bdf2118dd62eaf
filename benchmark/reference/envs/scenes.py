"""Scene construction for the pushing and avoiding tasks
(``d3il_tpu/envs/scenes.py``).

The lab table's top surface sits at z = -0.019 with the reference's contact
parameters, modelled as an infinite plane.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference.engine import model as emodel
from benchmark.reference.robot import panda

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


def build_avoiding_scene(solver_iters: int = 15) -> emodel.SceneModel:
    """Obstacle-avoidance scene: six static cylinders (capsule-approximated)
    on the table; no free bodies."""
    robot = panda.build_sim_chain("rod")
    mid, off, y1, dy = 0.5, 0.075, -0.1, 0.18
    obstacles = [
        ("l1_obs", (mid, y1), 0.03, 0.07),
        ("l2_top_obs", (mid - off, y1 + dy), 0.025, 0.1),
        ("l2_bottom_obs", (mid + off, y1 + dy), 0.025, 0.1),
        ("l3_top_obs", (mid - 2 * off, y1 + 2 * dy), 0.025, 0.1),
        ("l3_mid_obs", (mid, y1 + 2 * dy), 0.025, 0.1),
        ("l3_bottom_obs", (mid + 2 * off, y1 + 2 * dy), 0.025, 0.1),
    ]
    static = [table_geom()] + [
        emodel.Geom(gtype=emodel.CAPSULE, size=(r, hl), pos=(x, y, 0.0),
                    name=name)
        for name, (x, y), r, hl in obstacles
    ]
    return emodel.build_scene(robot, rod_robot_geoms(robot), [], static,
                              collide_robot_static=True,
                              solver_iters=solver_iters)


# Avoiding task layout (the reference's avoiding.py:96-110)
AVOIDING_L1_Y = -0.1
AVOIDING_L2_Y = -0.1 + 0.18
AVOIDING_L3_Y = -0.1 + 2 * 0.18
AVOIDING_GOAL_Y = -0.1 + 2.5 * 0.18
AVOIDING_L1_X = 0.5
AVOIDING_L2_TOP_X = 0.5 - 0.075
AVOIDING_L2_BOT_X = 0.5 + 0.075
AVOIDING_L3_TOP_X = 0.5 - 0.15
AVOIDING_L3_MID_X = 0.5
AVOIDING_L3_BOT_X = 0.5 + 0.15
