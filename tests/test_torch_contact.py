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


def _c_functions(src, macros):
    """The .cu's integer size functions (``__host__ __device__ inline
    int``) as Python callables of the same arguments, C integer division
    kept; ContactDims arguments are read by attribute (a ContactMeta).
    imin and imax are Python's min and max."""
    scope = dict(macros, K3_ROWC=9, imin=min, imax=max)
    funcs = {"imin": min, "imax": max}
    for name, args, body in re.findall(
            r"__host__ __device__ inline int (\w+)\(([^)]*)\) \{([^{}]*)\}",
            src):
        if name in funcs:
            continue
        names = [a.split()[-1].lstrip("&") for a in args.split(",")]
        lines = []
        for stmt in " ".join(body.split()).split(";")[:-1]:
            stmt = re.sub(r"^\s*(const )?int ", "", stmt).strip()
            lines.append("    " + stmt.replace("/", "//"))
        exec(f"def {name}({', '.join(names)}):\n" + "\n".join(lines), scope)
        funcs[name] = scope[name]
    return funcs


def test_contact_kernel_geometry_mirrors_the_cu():
    """K3's launch geometry: the Python mirror of the sizes in
    csrc/contact_kernel.cu (the register variant's padded width, its
    shared memory per env and per block, the compact variant's shared
    memory per env at a cap and its workspace slot) against the .cu's own
    formulas; the compact variant's budget per env for a batch (one wave
    at the fewest blocks per SM) and its cap (the largest that fits the
    budget), which the wrapper alone picks and passes to the kernel; and
    which scenes each variant takes; a scene too large for both raises."""
    src = _cu_source("contact_kernel")
    macro = {k: int(v) for k, v in
             re.findall(r"#define (K3_\w+) (\d+)\b", src)}
    f = _c_functions(src, macro)
    assert {"reg_smem_floats", "reg_table_floats", "staged_floats",
            "fact_floats", "compact_reg_floats", "compact_smem_floats",
            "compact_ws_floats", "imax"} <= set(f)
    # the launch takes the cap and sizes shared memory from it
    assert re.search(r"d3il_contact_phase\(ContactDims D, int variant, "
                     r"int B, int cap,", src)
    assert re.search(r"compact_smem_floats\(D, cap\) \* K3_REG_WARPS", src)
    assert (macro["K3_REG_NC"], macro["K3_REG_WARPS"], macro["K3_MAXVR"],
            macro["K3_REG_MINB"]) == (
        contact_kernel.REG_COLS, contact_kernel.REG_WARPS,
        contact_kernel.REG_MAX_VR, contact_kernel.REG_MIN_BLOCKS)
    nc, warps = macro["K3_REG_NC"], macro["K3_REG_WARPS"]
    for B in (1, 33, 480, 1080, 8192):
        for n_sm in (132, 114):
            # the fewest blocks per SM (at most REG_MIN_BLOCKS) that run
            # the batch's blocks of `warps` envs in one wave
            per_sm = next((k for k in range(1, contact_kernel.REG_MIN_BLOCKS)
                           if k * n_sm * warps >= B),
                          contact_kernel.REG_MIN_BLOCKS)
            assert contact_kernel.env_budget(B, n_sm) == (
                (contact_kernel.SM_SMEM // per_sm
                 - contact_kernel.BLOCK_RESERVED) // warps), (B, n_sm)

    meta = contact.build_meta(scenes.build_pushing_scene())
    for ncon, variant in ((18, 1), (4, 1), (19, 2), (21, 2), (30, 2),
                          (60, 2)):
        m = _rows(meta, ncon)
        for B in (1, 480, 1080, 8192):
            g = contact_kernel.geometry(m, B)
            assert g.variant == variant, ncon
            assert g.envs_per_block == warps
            if variant == 1:
                assert g.cols == nc
                assert g.smem_per_env == 4 * f["reg_smem_floats"](m)
                assert g.smem_per_block == 4 * (
                    f["reg_table_floats"](m) + warps * f["reg_smem_floats"](m))
                continue
            budget = contact_kernel.env_budget(B, contact_kernel.SM_COUNT)
            cap = g.cap
            assert cap == 0 or 4 * f["compact_smem_floats"](m, cap) <= budget
            assert (cap == m.ncon
                    or 4 * f["compact_smem_floats"](m, cap + 1) > budget)
            for c in (1, cap, m.ncon):
                assert (contact_kernel.compact_smem_floats(m, c)
                        == f["compact_smem_floats"](m, c))
                assert (contact_kernel.staged_floats(m, c)
                        == f["staged_floats"](m, c))
                assert (contact_kernel.fact_floats(m, c)
                        == f["fact_floats"](m, c))
            assert g.cols == 0
            assert g.smem_per_env == 4 * f["compact_smem_floats"](m, cap)
            assert g.smem_per_block == warps * g.smem_per_env
            assert g.ws_per_env == (0 if cap == m.ncon else
                                    4 * f["compact_ws_floats"](m))
    # 60 contacts of nv 21 in a batch of 8192 (three blocks per SM) pass
    # the cap: its envs with more active run on the workspace
    assert 0 < contact_kernel.geometry(_rows(meta, 60), 8192).cap < 60
    pushing_geo = contact_kernel.ContactTables(meta, "cpu").geometry(8192)
    assert (pushing_geo.variant, pushing_geo.cols) == (1, 56)
    with pytest.raises(ValueError, match="shared memory"):
        contact_kernel.ContactTables(_rows(meta, 14000), "cpu")
