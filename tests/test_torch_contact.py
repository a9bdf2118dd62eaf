"""Port contact phase (K3's plain version) == the JAX package.

Inputs are port rollout states on the CPU with the red box placed against
the rod, so box-table and rod-box contacts are active; they go as NumPy to
``jax.vmap(contact.phase_single)``, to the Pallas kernel in interpret mode
and to the port's batched ``build_rows`` + ``phase_core``.
"""
import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_jaxref import (assert_scaled, contexts, jax_pushing_params,
                               port_pushing_params)

from d3il_tpu.engine import contact as jcontact
from d3il_tpu.engine import contact_kernel as jcontact_kernel
from d3il_tpu.engine import step as jstep
from d3il_tpu.robot import chain as jchain
from d3il_tpu_torch.engine import contact, contact_kernel, dyn_kernel
from d3il_tpu_torch.engine import step as estep
from d3il_tpu_torch.engine import substep_bm
from d3il_tpu_torch.envs import pushing, scenes
from d3il_tpu_torch.robot import chain

B = 4
# test_contact_kernel.py:116-117: max-scaled absolute error of f and qfrc
TOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    jparams = jax_pushing_params(n_substeps=2)
    params = port_pushing_params(jparams)
    # red boxes at and around the rod's start xy (0.525, -0.28)
    red_xy = np.array([[0.525, -0.245], [0.555, -0.28], [0.525, -0.28],
                       [0.50, -0.27]])
    ctx = contexts(0, B, red_xy=red_xy)
    state = pushing.reset(params, tuple(torch.from_numpy(c) for c in ctx))
    sb = substep_bm.scene_to_bm(state.scene)
    st = params.statics
    rng = np.random.default_rng(1)
    q_des = sb.q[:7] + torch.from_numpy(
        0.01 * rng.standard_normal((7, B)).astype(np.float32))
    arm = dyn_kernel.arm_stage_bm(st.arm, sb.q, sb.qd, q_des.contiguous(),
                                  torch.zeros(7, B), torch.zeros(7, B),
                                  torch.full((B,), 0.04),
                                  torch.zeros(B, dtype=torch.bool))
    args = substep_bm.contact_inputs(st, sb, arm)
    # a non-trivial warm start: the solution of one phase
    f, _ = contact_kernel.phase_batched_bm(st.contact, *args)
    args = args[:-1] + (f,)
    bf = [np.ascontiguousarray(np.moveaxis(a.numpy(), -1, 0)) for a in args]
    return jparams, params, args, bf, state


def test_build_meta_matches(setup):
    jparams, params, _, _, _ = setup
    a = jcontact.build_meta(jparams.scene)
    b = contact.build_meta(params.scene)
    assert a._fields == b._fields
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


def test_narrow_phase_matches(setup):
    """The batched colliders == the JAX per-env narrow phase (vmapped)."""
    jparams, params, _, _, state = setup
    scene = jparams.scene

    def one(q, fp, fq):
        sc = jstep.SceneState(q=q, qd=None, free_pos=fp, free_quat=fq,
                              free_linvel=None, free_angvel=None, warm=None)
        c, _ = jstep._contact_rows(scene, sc, jchain.fk(scene.robot, q))
        return c.pos, c.normal, c.depth

    sc = state.scene
    ref = jax.jit(jax.vmap(one))(*(jnp.asarray(x.numpy()) for x in
                                   (sc.q, sc.free_pos, sc.free_quat)))
    xpos, xquat = chain.fk(params.scene.robot, sc.q)
    out = estep.narrow_phase(params.scene, xpos, xquat, sc.free_pos,
                             sc.free_quat)
    depth_ref = np.asarray(ref[2])
    assert (depth_ref[:, 12:14] > 0).any(), "no rod-box contact in the setup"
    # colliders differ only in float32 rounding order: 1e-5 absolute
    for name, a, b in zip(("pos", "normal", "depth"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=name)


def test_phase_matches_phase_single(setup):
    jparams, params, args, bf, _ = setup
    meta = jcontact.build_meta(jparams.scene)
    f_ref, q_ref = jax.jit(jax.vmap(
        lambda *a: jcontact.phase_single(meta, *a)))(*bf)
    f, qfrc = contact_kernel.phase_batched_bm(params.statics.contact, *args)
    f_ref, q_ref = np.asarray(f_ref), np.asarray(q_ref)
    assert np.abs(f_ref).max() > 1e-3
    assert_scaled(np.moveaxis(f.numpy(), -1, 0), f_ref, TOL, "f")
    assert_scaled(np.moveaxis(qfrc.numpy(), -1, 0), q_ref, TOL, "qfrc")


def test_phase_matches_pallas_interpret(setup):
    jparams, params, args, bf, _ = setup
    meta = jcontact.build_meta(jparams.scene)
    f_ref, q_ref = jcontact_kernel.phase_batched(meta, *bf, interpret=True)
    f, qfrc = contact_kernel.phase_batched_bm(params.statics.contact, *args)
    assert_scaled(np.moveaxis(f.numpy(), -1, 0), np.asarray(f_ref), TOL, "f")
    assert_scaled(np.moveaxis(qfrc.numpy(), -1, 0), np.asarray(q_ref), TOL,
                  "qfrc")


def test_contact_tables_match_meta(setup):
    """The kernel's static tables encode build_meta's arrays."""
    _, params, _, _, _ = setup
    tab = params.statics.contact
    meta = tab.meta
    side_a = tab.side_a.numpy()
    for r in range(meta.ncon):
        hit = np.flatnonzero(meta.onehot_a[r])
        assert side_a[r] == (hit[0] if len(hit) else -1)
    np.testing.assert_allclose(tab.rowc.numpy().reshape(meta.ncon, 9)[:, 2],
                               meta.mu, rtol=1e-6)
    assert contact_kernel.smem_bytes(meta) * 4 <= 48 * 1024


def _cu_source(name):
    return (pathlib.Path(contact_kernel.__file__).parents[1] / "csrc"
            / f"{name}.cu").read_text()


def _rows(meta, ncon):
    """A scene of ``ncon`` contacts: pushing's rows repeated."""
    return contact.select_contacts(meta, np.arange(ncon) % meta.ncon)


def test_contact_kernel_geometry_mirrors_the_cu():
    """The Python mirror of K3's launch geometry against the formulas in
    csrc/contact_kernel.cu: the register variant's padded width, its
    shared memory per env and per block, the general variant's shared
    memory, and which scenes each takes; a scene too large for both
    raises."""
    src = _cu_source("contact_kernel")
    macro = {k: int(v) for k, v in
             re.findall(r"#define (K3_\w+) (\d+)\b", src)}
    per_env = re.search(r"inline int reg_smem_floats\(const ContactDims& D\) "
                        r"\{\s*const int nc = K3_REG_NC;\s*int f = (.*?);",
                        src, re.S).group(1)
    table = re.search(r"inline int reg_table_floats\(const ContactDims& D\) "
                      r"\{\s*int f = (.*?);", src, re.S).group(1)
    general = re.search(r"inline int smem_floats\(const ContactDims& D\) \{"
                        r"\s*int n = 3 \* D.ncon;\s*return (.*?);",
                        src, re.S).group(1)
    c_eval = lambda expr, **v: eval(" ".join(expr.replace("D.", "").replace(
        "K3_ROWC", "9").split()), {}, v)
    assert (macro["K3_REG_NC"], macro["K3_REG_WARPS"], macro["K3_MAXVR"]) == (
        contact_kernel.REG_COLS, contact_kernel.REG_WARPS,
        contact_kernel.REG_MAX_VR)
    nc, warps = macro["K3_REG_NC"], macro["K3_REG_WARPS"]

    meta = contact.build_meta(scenes.build_pushing_scene())
    for ncon, variant in ((18, 1), (4, 1), (19, 2), (21, 2), (30, 2),
                          (60, 2)):
        m = _rows(meta, ncon)
        v = dict(ncon=m.ncon, nv_r=m.nv_r, nf=m.nf, nv=m.nv, n=3 * m.ncon)
        g = contact_kernel.geometry(m)
        assert g.variant == variant, ncon
        if variant == 1:
            f_env = (c_eval(per_env, nc=nc, **v) + 3) // 4 * 4
            f_tab = (c_eval(table, **v) + 3) // 4 * 4
            assert g.cols == nc and g.envs_per_block == warps
            assert g.smem_per_env == 4 * f_env
            assert g.smem_per_block == 4 * (f_tab + warps * f_env)
        else:
            assert g.cols == 0
            assert g.smem_per_env == 4 * c_eval(general, **v)
    pushing_geo = contact_kernel.ContactTables(meta, "cpu").geometry
    assert (pushing_geo.variant, pushing_geo.cols) == (1, 56)
    with pytest.raises(ValueError, match="shared memory"):
        contact_kernel.ContactTables(_rows(meta, 600), "cpu")
