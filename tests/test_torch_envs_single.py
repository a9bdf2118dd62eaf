"""The per-env API of ``envs/common.py`` against the JAX package's, on one
pushing env over a 2-substep window, under full arm dynamics and in
kinematic mode.

Both sides build PushingParams(n_substeps=2) at the JAX package's start
posture (the JAX Params once per module; its kinematic twin shares it with
the kinematic engine step swapped in, ``kinematic`` being a Python
attribute that selects the traced program). The env: the arm at q_init,
the red box 0.1 mm into the table with the rod pressed 1.3 mm into its
side, the green box away. From there each side runs ``physics_substep``
(a setpoint 1 mm off the posture, a feedforward torque), ``hold_substep``,
``control_substep``, ``ik_trajectory`` and ``_run_substeps_single`` toward
the red box; each mode's JAX functions are jitted together for one env,
one compile. The port's window takes q_des / tau_model from K1's plain
version at a batch of one where the JAX window runs its controller scan
and vmapped feedforward. The scene is held to the rod tasks' tolerance
(``test_torch_jaxref.check_rod_state``'s), the controller to
``tests/test_torch_cartesian.py``'s.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import (HOLD_QUAT, assert_scaled, jax_pushing_params,
                               port_pushing_params)

from d3il_tpu.control import cartesian as jcartesian
from d3il_tpu.engine import step as jstep
from d3il_tpu.envs import common as jcommon
from d3il_tpu_torch.control import cartesian
from d3il_tpu_torch.engine import step as estep
from d3il_tpu_torch.envs import common

FIELDS = estep.SceneState._fields
# every scene field max-scaled (tests/test_substep_bm.py:60-63, the rod
# tasks' tolerance in tests/test_torch_jaxref.py:check_rod_state)
SCENE_TOL = 3e-4
# the controller trajectory: float32 rounding of the IK iterates, its
# finite differences amplified by 1 / dt (qd) and 0.4 / dt^2 (qdd, clipped
# to +-25); see tests/test_torch_cartesian.py
TRAJ_TOLS = (1e-6, 1e-4, 5e-2)


@pytest.fixture(scope="module")
def pairs():
    jparams = jax_pushing_params(n_substeps=2)
    jkin = copy.copy(jparams)
    jkin.kinematic = True
    jkin._engine_step = jstep.make_step_fn(jparams.scene,
                                           kinematic_robot=True)
    params = port_pushing_params(jparams)
    kin = port_pushing_params(jparams)
    kin.kinematic = True
    return {False: (jparams, params), True: (jkin, kin)}


def _inputs(params):
    """One env's scene state, controller state and window setpoint as
    NumPy (float32)."""
    q = np.concatenate([params.q_init, [0.0, 0.0]]).astype(np.float32)
    sc = estep.init_state(params.scene, torch.as_tensor(q)[None],
                          torch.zeros(1, 2, 3), torch.zeros(1, 2, 4))
    tcp, _ = params.tcp_pose(sc)
    tcp = tcp[0].numpy()
    free_pos = np.array([[tcp[0] + 0.039, tcp[1], 0.0109],
                         [0.65, 0.2, 0.0109]], np.float32)
    free_quat = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (2, 1))
    scene = dict(q=q, qd=np.zeros(9, np.float32), free_pos=free_pos,
                 free_quat=free_quat,
                 free_linvel=np.zeros((2, 3), np.float32),
                 free_angvel=np.zeros((2, 3), np.float32),
                 warm=np.zeros((params.scene.ncon_max, 3), np.float32))
    des_pos = np.array([tcp[0] + 0.01, tcp[1], 0.12], np.float32)
    return scene, q[:7].copy(), des_pos, HOLD_QUAT.astype(np.float32)


def _jax_all(jparams):
    """Every per-env function of the JAX package's common.py, in one jit."""
    def run(sc, cs, des_pos, des_quat, q_des, qd_des, tau):
        phys = jcommon.physics_substep(jparams, sc, q_des, qd_des, tau)
        (hold, _), _ = jcommon.hold_substep(jparams, (sc, sc.q[:7]), None)
        (ctl, ctl_cs, _, _), _ = jcommon.control_substep(
            jparams, (sc, cs, des_pos, des_quat), None)
        win = jcommon._run_substeps_single(jparams, sc, cs, des_pos,
                                           des_quat, jnp.float32(0.04),
                                           jnp.asarray(False))
        traj = jcommon.ik_trajectory(jparams, cs, des_pos, des_quat)
        return phys, hold, (ctl, ctl_cs), win, traj
    return jax.jit(run)


def _check_scene(ours, theirs, when):
    for name, a, b in zip(FIELDS, ours, theirs):
        assert_scaled(a.numpy(), np.asarray(b), SCENE_TOL, f"{when} {name}")


def _check_cs(ours, theirs, when):
    for a, b, tol in zip(ours, theirs, TRAJ_TOLS[:2]):
        assert_scaled(a.numpy(), np.asarray(b), tol, when)


def _compare(pair):
    jparams, params = pair
    scene, q_virt, des_pos, des_quat = _inputs(params)
    q_des = q_virt + np.float32(1e-3)
    qd_des = np.full(7, 0.1, np.float32)
    tau = np.linspace(-0.5, 0.5, 7).astype(np.float32)
    jsc = jstep.SceneState(**{k: jnp.asarray(v) for k, v in scene.items()})
    jcs = jcartesian.init_state(jnp.asarray(q_virt))
    phys, hold, (ctl, ctl_cs), (win, win_cs), (traj_cs, traj) = _jax_all(
        jparams)(jsc, jcs, jnp.asarray(des_pos), jnp.asarray(des_quat),
                 jnp.asarray(q_des), jnp.asarray(qd_des), jnp.asarray(tau))

    t = lambda a: torch.tensor(np.asarray(a))
    sc = estep.SceneState(**{k: t(v) for k, v in scene.items()})
    cs = cartesian.init_state(t(q_virt))
    dp, dq = t(des_pos), t(des_quat)
    mode = "kinematic" if params.kinematic else "dynamic"
    _check_scene(common.physics_substep(params, sc, t(q_des), t(qd_des),
                                        t(tau)), phys,
                 f"physics_substep ({mode})")
    (ours, _), _ = common.hold_substep(params, (sc, sc.q[:7]), None)
    _check_scene(ours, hold, f"hold_substep ({mode})")
    (ours, ours_cs, _, _), _ = common.control_substep(params,
                                                      (sc, cs, dp, dq), None)
    _check_scene(ours, ctl, f"control_substep ({mode})")
    _check_cs(ours_cs, ctl_cs, f"control_substep cs ({mode})")
    ours, ours_cs = common._run_substeps_single(params, sc, cs, dp, dq, 0.04,
                                                False)
    _check_scene(ours, win, f"_run_substeps_single ({mode})")
    _check_cs(ours_cs, win_cs, f"_run_substeps_single cs ({mode})")
    ours_cs, ours_traj = common.ik_trajectory(params, cs, dp, dq)
    _check_cs(ours_cs, traj_cs, f"ik_trajectory cs ({mode})")
    for a, b, tol in zip(ours_traj, traj, TRAJ_TOLS):
        assert_scaled(a.numpy(), np.asarray(b), tol, f"ik_trajectory {mode}")
    # the rod pushes the red box and the table carries both boxes
    warm = np.abs(np.asarray(win.warm)).max(-1)
    assert warm[12:14].max() > 0 and (warm[:8] > 0).sum() >= 4


def test_per_env_substeps_match_jax_dynamic(pairs):
    _compare(pairs[False])


def test_per_env_substeps_match_jax_kinematic(pairs):
    _compare(pairs[True])
