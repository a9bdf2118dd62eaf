"""The per-env physics step (``engine/step.make_step_fn``) and the dense
contact solver (``engine/solver.py``) against the JAX package's.

The box scenes are ``tests/test_engine.py``'s (a far-away 1-dof robot, 3 cm
boxes on the table plane): a box dropped from 0.5 mm above its rest
height, a box shoved sideways at 0.5 m/s and two boxes stacked 0.2 mm
apart, a few substeps each. The sphere scene puts every sphere pair of the narrow phase
in contact: a free sphere on the table (sphere-plane) against a free box
(sphere-box) under a sphere on a 1-dof arm (sphere-sphere, and
sphere-plane / sphere-box against the arm's sphere), stepped under
dynamics and with the arm kinematic. Each scene's JAX step is jitted once
for one env. The solver's pieces run on random cone problems.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from test_torch_jaxref import assert_scaled

from d3il_tpu.engine import model as jmodel
from d3il_tpu.engine import solver as jsolver
from d3il_tpu.engine import step as jstep
from d3il_tpu.robot.chain import ChainBuilder as JChainBuilder
from d3il_tpu_torch.engine import model, solver
from d3il_tpu_torch.engine import step as estep
from d3il_tpu_torch.robot.chain import HINGE, ChainBuilder

TABLE_SOLIMP = (0.999, 0.999, 0.001, 0.5, 2.0)
TABLE_SOLREF = (0.002, 1.0)
# scaled tolerances per state field over a few substeps: the two packages
# differ in float32 rounding of the dynamics (JAX: jvp of the body
# Jacobians; the port: RNEA / CRBA) and of the contact solve
TOLS = {"q": 1e-5, "qd": 3e-4, "free_pos": 1e-5, "free_quat": 1e-5,
        "free_linvel": 3e-4, "free_angvel": 3e-4, "warm": 3e-4}


def _robot(builder_cls, pos):
    b = builder_cls()
    b.add_body("base", None, pos=pos, joint_type=HINGE, joint_axis=(0, 1, 0),
               mass=1.0, inertia=np.eye(3) * 0.1, damping=0.5,
               joint_range=(-1, 1))
    return b.build()


def _scenes(m, builder_cls, which):
    """The scene ``which`` built by one package's model module ``m``."""
    table = m.Geom(gtype=m.PLANE, size=(0, 0, 1), solimp=TABLE_SOLIMP,
                   solref=TABLE_SOLREF, name="table")
    fr = np.array([[-100.0, 100.0]])
    if which in ("box", "stack"):
        n = 1 if which == "box" else 2
        free = [dict(name=f"box{i}", mass=0.05, size=(0.03, 0.03, 0.03))
                for i in range(n)]
        return m.build_scene(_robot(builder_cls, (100.0, 100.0, 0.0)), [],
                             free, [table], collide_robot_static=False,
                             solver_iters=40, forcerange=fr)
    sphere = dict(name="ball", mass=0.03, inertia=[4.8e-6] * 3,
                  geoms=[dict(gtype=m.SPHERE, size=(0.02, 0.0, 0.0))])
    box = dict(name="box", mass=0.05, size=(0.03, 0.03, 0.03))
    arm_ball = m.Geom(gtype=m.SPHERE, size=(0.02, 0.0, 0.0), body=0,
                      pos=(0.0, 0.0, -0.01), name="arm_ball")
    return m.build_scene(_robot(builder_cls, (0.05, 0.0, 0.068)), [arm_ball],
                         [sphere, box], [table], solver_iters=30,
                         forcerange=fr)


def _port_state(js):
    return estep.SceneState(*(torch.tensor(np.asarray(x)) for x in js))


def _run(which, states, ctrls, kinematic=False):
    """Step one env of scene ``which`` from ``states`` (a JAX SceneState)
    under ``ctrls`` (a list of [nu] arrays) on both sides and compare
    after every substep."""
    jscene = _scenes(jmodel, JChainBuilder, which)
    scene = _scenes(model, ChainBuilder, which)
    assert [(p.geom_a.gtype, p.geom_b.gtype) for p in scene.pairs] == \
        [(p.geom_a.gtype, p.geom_b.gtype) for p in jscene.pairs]
    jfn = jax.jit(jstep.make_step_fn(jscene, kinematic_robot=kinematic))
    fn = estep.make_step_fn(scene, kinematic_robot=kinematic)
    loaded = np.zeros(scene.ncon_max, bool)
    for js0 in states:
        js, ps = js0, _port_state(js0)
        for i, u in enumerate(ctrls):
            js = jfn(js, jnp.asarray(u, jnp.float32))
            ps = fn(ps, torch.as_tensor(np.asarray(u, np.float32)))
            for name, a, b in zip(estep.SceneState._fields, ps, js):
                assert_scaled(a.numpy(), np.asarray(b), TOLS[name],
                              f"{which} {name} substep {i}")
            loaded |= np.abs(np.asarray(js.warm)).max(-1) > 0
    kinds = [(p.geom_a.gtype, p.geom_b.gtype) for p in scene.pairs
             for _ in range(p.max_points)]
    return {k for k, hit in zip(kinds, loaded) if hit}, int(loaded.sum())


def test_box_scenes_match_jax():
    """Drop, slide and stack: 10 substeps each; the rows that carry force
    at some substep: the box's 4 on the table, the stack's on the table
    and between the boxes."""
    init = lambda scene, pos, **kw: jstep.init_state(
        scene, q=jnp.zeros(1), free_pos=jnp.asarray(pos, jnp.float32))._replace(
            **{k: jnp.asarray(v, jnp.float32) for k, v in kw.items()})
    js = _scenes(jmodel, JChainBuilder, "box")
    ctrls = [np.zeros(1)] * 10
    drop = init(js, [[0.0, 0.0, 0.0305]])
    slide = init(js, [[0.0, 0.0, 0.0301]], free_linvel=[[0.5, 0.0, 0.0]])
    _, loaded = _run("box", [drop, slide], ctrls)
    assert loaded == 4
    js2 = _scenes(jmodel, JChainBuilder, "stack")
    stack = init(js2, [[0.0, 0.0, 0.0299], [0.005, 0.0, 0.0901]])
    kinds, loaded = _run("stack", [stack], ctrls)
    assert kinds == {(model.BOX, model.PLANE), (model.BOX, model.BOX)}
    assert loaded >= 8


def test_sphere_scene_matches_jax_in_both_robot_modes():
    """Every sphere pair carries force at some substep; under dynamics a torque drives the
    arm's sphere down into the free one, kinematic the arm follows a set
    trajectory ([q, qd] controls)."""
    st = jstep.init_state(
        _scenes(jmodel, JChainBuilder, "sphere"), q=jnp.zeros(1),
        free_pos=jnp.asarray([[0.0495, 0.0, 0.0195], [0.0, 0.0, 0.0295]],
                             jnp.float32))
    spheres = {(model.SPHERE, model.PLANE), (model.SPHERE, model.BOX),
               (model.SPHERE, model.SPHERE)}
    kinds, _ = _run("sphere", [st], [np.array([-2.0])] * 8)
    assert spheres <= kinds
    qs = np.linspace(0.0, 0.05, 9)
    ctrls = [np.array([q, 5.0]) for q in qs[1:]]
    kinds, _ = _run("sphere", [st], ctrls, kinematic=True)
    assert spheres <= kinds


def test_solver_pieces_match_jax():
    """kbi and _project_cone on random constraints, and solve_contacts
    (dense APGD, warm and cold) on random cone problems with inactive
    contacts, against the JAX functions, 1e-5 scaled."""
    rng = np.random.default_rng(0)
    solref = (0.02, 1.0)
    solimp = (0.9, 0.95, 0.001, 0.5, 2.0)
    r = rng.uniform(-0.002, 0.001, 16).astype(np.float32)
    for a, b in zip(solver.kbi(solref, solimp, torch.as_tensor(r)),
                    jsolver.kbi(solref, solimp, jnp.asarray(r))):
        assert_scaled(a.numpy(), np.asarray(b), 1e-6, "kbi")
    for _ in range(32):
        f = rng.normal(size=3).astype(np.float32)
        mu = np.float32(rng.uniform(0.1, 1.5))
        assert_scaled(solver._project_cone(torch.as_tensor(f),
                                           torch.as_tensor(mu)).numpy(),
                      np.asarray(jsolver._project_cone(jnp.asarray(f), mu)),
                      1e-6, "_project_cone")
    nc = 6
    jsolve = jax.jit(jsolver.solve_contacts, static_argnums=4)
    for trial in range(4):
        J = rng.normal(size=(3 * nc, 9)).astype(np.float32)
        A = (J @ J.T + np.diag(rng.uniform(0.01, 0.1, 3 * nc))).astype(
            np.float32).reshape(nc, 3, nc, 3)
        b0 = rng.normal(size=(nc, 3)).astype(np.float32)
        mu = rng.uniform(0.3, 1.0, nc).astype(np.float32)
        active = rng.uniform(size=nc) > 0.3
        f0 = (None if trial % 2 else
              np.abs(rng.normal(size=(nc, 3))).astype(np.float32))
        want = np.asarray(jsolve(
            jnp.asarray(A), jnp.asarray(b0), jnp.asarray(mu),
            jnp.asarray(active), 30, None if f0 is None else jnp.asarray(f0)))
        got = solver.solve_contacts(
            torch.as_tensor(A), torch.as_tensor(b0), torch.as_tensor(mu),
            torch.as_tensor(active), 30,
            None if f0 is None else torch.as_tensor(f0)).numpy()
        assert np.abs(want).max() > 0.1 and not want[~active].any()
        assert_scaled(got, want, 1e-5, f"solve_contacts trial {trial}")
