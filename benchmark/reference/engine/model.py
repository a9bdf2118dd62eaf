"""Scene model for the batched physics engine (host NumPy).

Counterpart of ``d3il_tpu/engine/model.py``, kept identical so both
packages build the same scenes. A scene = one Panda sim chain (9 dofs) + N
free box bodies + static geoms; shapes are fixed and the contact-pair list
is enumerated at build time, so the batched window runs every env in
lockstep.

Exploited structure: the generalized-coordinate mass matrix of
[arm | free bodies] is block-diagonal (free bodies couple to the arm only
through contact Jacobians), so smooth dynamics solve per block instead of one
big dense factorization.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from benchmark.reference.robot.chain import Chain

# geom types
PLANE, SPHERE, CAPSULE, CYLINDER, BOX = 0, 1, 2, 3, 4

_GEOM_TYPES = {"plane": PLANE, "sphere": SPHERE, "capsule": CAPSULE,
               "cylinder": CYLINDER, "box": BOX}

# MuJoCo defaults (mjModel option/geom defaults used by the reference scenes)
DEFAULT_SOLREF = (0.02, 1.0)
DEFAULT_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)
DEFAULT_FRICTION = (1.0, 0.005, 0.0001)


@dataclass(frozen=True)
class Geom:
    """One collision geom. body < 0: static world geom; body >= 0 and
    free_idx < 0: attached to robot body `body`; free_idx >= 0: the geom of
    free body `free_idx` (body is ignored)."""
    gtype: int
    size: tuple
    body: int = -1
    free_idx: int = -1
    pos: tuple = (0.0, 0.0, 0.0)
    quat: tuple = (1.0, 0.0, 0.0, 0.0)
    friction: tuple = DEFAULT_FRICTION
    solref: tuple = DEFAULT_SOLREF
    solimp: tuple = DEFAULT_SOLIMP
    margin: float = 0.0
    priority: int = 0
    name: str = ""


@dataclass(frozen=True)
class ContactPair:
    """Static candidate contact pair with pre-mixed solver parameters.

    Mixing follows MuJoCo: solref/solimp averaged (equal solmix), friction is
    the element-wise max, margin the max.
    """
    geom_a: Geom
    geom_b: Geom
    max_points: int
    friction: float
    solref: tuple
    solimp: tuple
    margin: float


def _mix(pa: Geom, pb: Geom) -> dict:
    """MuJoCo contact-parameter combination: with equal geom priority,
    solref/solimp average and friction takes the element-wise max; a
    higher-priority geom's parameters win outright (used by the sorting
    platform: friction=0.3 priority=1, sorting/platform.xml)."""
    if pa.priority != pb.priority:
        w = pa if pa.priority > pb.priority else pb
        solimp = tuple(w.solimp) + DEFAULT_SOLIMP[len(w.solimp):]
        return dict(friction=w.friction[0], solref=tuple(w.solref),
                    solimp=solimp, margin=max(pa.margin, pb.margin))
    solimp_a = tuple(pa.solimp) + DEFAULT_SOLIMP[len(pa.solimp):]
    solimp_b = tuple(pb.solimp) + DEFAULT_SOLIMP[len(pb.solimp):]
    return dict(
        friction=max(pa.friction[0], pb.friction[0]),
        solref=tuple((np.asarray(pa.solref) + np.asarray(pb.solref)) / 2.0),
        solimp=tuple((np.asarray(solimp_a) + np.asarray(solimp_b)) / 2.0),
        margin=max(pa.margin, pb.margin),
    )


_PAIR_POINTS = {
    (BOX, PLANE): 4, (PLANE, BOX): 4,
    (BOX, BOX): 4,
    (CAPSULE, BOX): 2, (BOX, CAPSULE): 2,
    (CAPSULE, PLANE): 2, (PLANE, CAPSULE): 2,
    (CAPSULE, CAPSULE): 1,
    (SPHERE, PLANE): 1, (PLANE, SPHERE): 1,
    (SPHERE, BOX): 1, (BOX, SPHERE): 1,
    (SPHERE, SPHERE): 1,
}


@dataclass(frozen=True)
class SceneModel:
    robot: Chain
    free_names: tuple = ()
    free_mass: np.ndarray = field(default_factory=lambda: np.zeros(0))
    free_inertia: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    geoms: tuple = ()
    pairs: tuple = ()
    gravity: tuple = (0.0, 0.0, -9.81)
    dt: float = 1e-3
    impratio: float = 3.0
    # actuator force ranges per robot dof (gear = 1 torque motors)
    forcerange: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    solver_iters: int = 30

    @property
    def n_free(self) -> int:
        return len(self.free_names)

    @property
    def nv(self) -> int:
        return self.robot.nv + 6 * self.n_free

    @property
    def ncon_max(self) -> int:
        return sum(p.max_points for p in self.pairs)


def box_inertia(mass: float, half_size) -> np.ndarray:
    """Diagonal body-frame inertia of a solid box with given half-extents."""
    a, b, c = half_size
    return mass / 3.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b])


def build_scene(robot: Chain, robot_geoms: list, free_bodies: list,
                static_geoms: list, collide_robot_static: bool = True,
                dt: float = 1e-3, solver_iters: int = 30,
                forcerange=None) -> SceneModel:
    """Assemble a SceneModel.

    free_bodies: list of dicts {name, mass, size (box half extents), friction,
    solref, solimp} — matching the reference's primitive Box objects
    (PrimitiveObjects.py:47-78 + MjPrimLoader.py MJCF emission). A body may
    instead carry "geoms": a list of Geom-kwarg dicts (compound bodies such as
    the aligning tray, robot_push_box.xml), with explicit "inertia" [3].
    """
    free_names, free_mass, free_inertia = [], [], []
    free_geoms = []
    for i, fb in enumerate(free_bodies):
        free_names.append(fb["name"])
        free_mass.append(fb["mass"])
        if "geoms" in fb:
            free_inertia.append(np.asarray(fb["inertia"], np.float64))
            for j, g in enumerate(fb["geoms"]):
                free_geoms.append(Geom(
                    free_idx=i, name=f"{fb['name']}:{j}", **g))
        else:
            free_inertia.append(box_inertia(fb["mass"], fb["size"]))
            free_geoms.append(Geom(
                gtype=BOX, size=tuple(fb["size"]), free_idx=i,
                friction=tuple(fb.get("friction", DEFAULT_FRICTION)),
                solref=tuple(fb.get("solref", DEFAULT_SOLREF)),
                solimp=tuple(fb.get("solimp", DEFAULT_SOLIMP)),
                priority=int(fb.get("priority", 0)),
                name=fb["name"]))

    geoms = tuple(robot_geoms) + tuple(free_geoms) + tuple(static_geoms)

    pairs = []

    def add_pair(ga: Geom, gb: Geom):
        key = (ga.gtype, gb.gtype)
        if key not in _PAIR_POINTS:
            if (gb.gtype, ga.gtype) in _PAIR_POINTS:
                ga, gb = gb, ga
                key = (ga.gtype, gb.gtype)
            else:
                raise ValueError(f"no collider for pair {key}")
        pairs.append(ContactPair(ga, gb, _PAIR_POINTS[key], **_mix(ga, gb)))

    # free x static, free x free, robot x free, robot x static
    for fg in free_geoms:
        for sg in static_geoms:
            add_pair(fg, sg)
    for i in range(len(free_geoms)):
        for j in range(i + 1, len(free_geoms)):
            if free_geoms[i].free_idx == free_geoms[j].free_idx:
                continue  # same compound body never self-collides
            add_pair(free_geoms[i], free_geoms[j])
    for rg in robot_geoms:
        for fg in free_geoms:
            add_pair(rg, fg)
    if collide_robot_static:
        for rg in robot_geoms:
            for sg in static_geoms:
                add_pair(rg, sg)

    if forcerange is None:
        # reference actuator clamp (panda_rod_invisible.xml:120-133)
        forcerange = np.array([[-87, 87]] * 4 + [[-12, 12]] * 3 + [[-70, 70]] * 2,
                              np.float64)
    return SceneModel(
        robot=robot, free_names=tuple(free_names),
        free_mass=np.asarray(free_mass, np.float64),
        free_inertia=np.asarray(free_inertia, np.float64).reshape(-1, 3),
        geoms=geoms, pairs=tuple(pairs), dt=dt, solver_iters=solver_iters,
        forcerange=np.asarray(forcerange, np.float64),
    )
