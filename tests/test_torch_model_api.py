"""The last public functions of the robot model, ops and control modules
against the JAX package, on seeded NumPy inputs (JAX run eagerly).

* ``robot/chain.py``: ``mass_matrix`` (atol 5e-5, rtol 1e-4),
  ``bias_forces``, ``gravity_forces`` and ``coriolis_forces`` (atol 1e-4,
  rtol 1e-4; the JAX tests hold the JAX functions to MuJoCo at 1e-3) and
  ``point_jacobian_batch`` (2e-5), on the control chain and both sim
  chains, batched over the samples (JAX: one ``jit`` of their ``vmap``
  a chain);
* ``ops/quat.from_mat`` (equal up to sign within 1e-5) and
  ``ops/linalg.inv3`` / ``inv6`` / ``inv9`` on well-conditioned SPD
  matrices (within 1e-5 of the largest entry);
* ``control/gains.DampingGains`` and ``robot/panda.sim_geoms`` (equal);
  and the public names of every module pair: what the port lacks is the
  list of deliberate exclusions below, which ``ROADMAP.md`` section 1
  gives with its reasons.
"""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from d3il_tpu.control import gains as jgains
from d3il_tpu.ops import linalg as jlinalg
from d3il_tpu.ops import quat as jquat
from d3il_tpu.robot import chain as jchain
from d3il_tpu.robot import panda as jpanda

from d3il_tpu_torch.control import gains
from d3il_tpu_torch.ops import linalg, quat
from d3il_tpu_torch.robot import chain, panda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHAINS = {"control": lambda m: m.build_control_chain(),
          "sim_rod": lambda m: m.build_sim_chain("rod"),
          "sim_gripper": lambda m: m.build_sim_chain("gripper")}


def test_chain_dynamics_and_batch_jacobian_match_jax():
    for which in sorted(CHAINS):
        _hold_chain(which)


def _hold_chain(which):
    jch, ch = CHAINS[which](jpanda), CHAINS[which](panda)
    rng = np.random.default_rng(len(which))
    n, nv = 3, ch.nv
    lo = np.maximum(ch.joint_range[:, 0], -2.5)
    hi = np.minimum(ch.joint_range[:, 1], 2.5)
    q = rng.uniform(lo, hi, size=(n, nv)).astype(np.float32)
    qd = rng.normal(size=(n, nv)).astype(np.float32)
    tq, tqd = torch.from_numpy(q), torch.from_numpy(qd)
    port = {"mass_matrix": chain.mass_matrix(ch, tq),
            "bias_forces": chain.bias_forces(ch, tq, tqd),
            "gravity_forces": chain.gravity_forces(ch, tq),
            "coriolis_forces": chain.coriolis_forces(ch, tq, tqd)}
    # 4 points a sample, each on a body of its own, 5 cm off its origin
    bodies = rng.integers(1, ch.nb, size=(n, 4))
    fk = chain.fk(ch, tq)
    off = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.05
    points = fk[0].gather(1, torch.from_numpy(bodies)[..., None].expand(
        -1, -1, 3)) + torch.from_numpy(off)
    jp, jr = chain.point_jacobian_batch(ch, tq, torch.from_numpy(bodies),
                                        points, fk)
    assert jp.shape == jr.shape == (n, 4, 3, nv)
    jq, jqd = jnp.asarray(q), jnp.asarray(qd)

    @jax.jit
    def reference(q, qd, body, point):
        one = lambda q, qd, b, p: (
            {"mass_matrix": jchain.mass_matrix(jch, q),
             "bias_forces": jchain.bias_forces(jch, q, qd),
             "gravity_forces": jchain.gravity_forces(jch, q),
             "coriolis_forces": jchain.coriolis_forces(jch, q, qd)},
            jchain.point_jacobian_batch(jch, q, b, p, jchain.fk(jch, q)))
        return jax.vmap(one)(q, qd, body, point)

    want, (wjp, wjr) = reference(jq, jqd, jnp.asarray(bodies, jnp.int32),
                                 jnp.asarray(points.numpy()))
    for name, w in want.items():
        atol = 5e-5 if name == "mass_matrix" else 1e-4
        np.testing.assert_allclose(port[name].numpy(), np.asarray(w),
                                   atol=atol, rtol=1e-4,
                                   err_msg=f"{which} {name}")
    np.testing.assert_allclose(jp.numpy(), np.asarray(wjp), atol=2e-5,
                               err_msg=f"{which} Jp")
    np.testing.assert_allclose(jr.numpy(), np.asarray(wjr), atol=2e-5,
                               err_msg=f"{which} Jr")
    # gravity is the bias at rest, Coriolis the bias without gravity
    torch.testing.assert_close(
        port["gravity_forces"] + port["coriolis_forces"],
        port["bias_forces"], atol=1e-4, rtol=1e-4)


def _spd(rng, n, k):
    A = rng.normal(size=(n, k, k))
    return (A @ A.transpose(0, 2, 1) / k + np.eye(k)).astype(np.float32)


def test_from_mat_and_closed_form_inverses_match_jax():
    rng = np.random.default_rng(7)
    # rotations of random quaternions, and ones near each of Shepperd's
    # four branches (w, x, y, z dominant), so that every candidate is taken
    qs = rng.normal(size=(64, 4))
    qs[:4] = np.eye(4) + 0.05 * rng.normal(size=(4, 4))
    m = jquat.to_mat(jnp.asarray(qs, jnp.float32))
    got = quat.from_mat(torch.tensor(np.asarray(m))).numpy()
    want = np.asarray(jquat.from_mat(m))
    sign = np.where(np.sum(got * want, -1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got * sign, want, atol=1e-5)
    assert (got[:, 0] >= 0).all()
    for k, jf, f in ((3, jlinalg.inv3, linalg.inv3),
                     (6, jlinalg.inv6, linalg.inv6),
                     (9, jlinalg.inv9, linalg.inv9)):
        M = _spd(rng, 16, k)
        got = f(torch.from_numpy(M)).numpy()
        want = np.asarray(jf(jnp.asarray(M)))
        scale = np.abs(want).max(axis=(-1, -2), keepdims=True)
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-5,
                                   rtol=0, err_msg=f"inv{k}")
        np.testing.assert_allclose(got @ M, np.broadcast_to(np.eye(k),
                                                             M.shape),
                                   atol=1e-4, err_msg=f"inv{k} @ M")


# what the port leaves out of each module pair (JAX module -> names), as
# ROADMAP.md section 1 lists it: switches between implementations, XLA
# placements, the TPU's tile gate, the JAX batch-minor window's jnp pieces
# and the kernel bodies' scalar helpers (in the port: the CUDA kernels and
# their plain versions), the orbax train state, the Flax vision nets (one
# VisionNet in the port)
EXCLUDED = {
    "agents/base.py": {"TrainState"},
    "agents/vision.py": {
        "VisionACTNet", "VisionBCNet", "VisionBeTNet", "VisionBesoNet",
        "VisionCVAENet", "VisionDDPMNet", "VisionEncDecNet", "VisionGMMNet",
        "VisionGPTBCNet", "VisionIBCNet"},
    "engine/contact.py": {"set_impl"},
    "engine/contact_kernel.py": {"phase_batched", "pick_tile"},
    "engine/dyn_scalar.py": {"chol_solve_s", "mat_tvec"},
    "engine/substep_bm.py": {
        "cartesian_step_bm", "chol_bm", "chol_solve_vec_bm",
        "clamped_spd_solve_bm", "dynamics_bm", "finger_forces_bm", "fk_bm",
        "inv_spd_bm", "model_feedforward_bm", "point_jacobian_bm", "qerror",
        "qfrom_axis_angle", "qintegrate", "qmul", "qnormalize", "qparts",
        "qrot", "qtomat", "set_dyn_kernel", "supported", "vcross"},
    "envs/common.py": {"set_substep_impl"},
    "parallel/mesh.py": {"batch_sharding", "constrain_batch",
                         "replicated_sharding"},
}
# JAX modules whose port has another file name, and the test-time oracle
RENAMED = {"data/experts_jax.py": "data/experts.py"}
NOT_PORTED = {"testing/__init__.py", "testing/mjcf_ref.py"}


def _public(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_gains_geoms_and_public_names_match_jax():
    assert gains.DampingGains().dgain.tolist() == \
        jgains.DampingGains().dgain.tolist()
    for variant in ("rod", "gripper"):
        got, want = panda.sim_geoms(variant), jpanda.sim_geoms(variant)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)
    missing = {}
    jroot = os.path.join(ROOT, "d3il_tpu")
    for dirpath, _, files in os.walk(jroot):
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), jroot)
            if rel in NOT_PORTED:
                continue
            port = os.path.join(ROOT, "d3il_tpu_torch", RENAMED.get(rel, rel))
            assert os.path.exists(port), f"no port of d3il_tpu/{rel}"
            lacks = _public(os.path.join(jroot, rel)) - _public(port)
            if lacks:
                missing[rel] = lacks
    assert missing == EXCLUDED
