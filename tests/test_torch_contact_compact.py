"""K3's compaction is exact: the plain solve of a scene equals, per env, the
plain solve of the scene cut to that env's active contacts (depth > 0),
with f = 0 on every inactive contact.

A contact with depth <= 0 has act = 0, so its rows are scaled by zero from
the first matvec on: every product of the solve adds exact zeros for it,
and its force is zero. The compact variant of the CUDA kernel
(``csrc/contact_kernel.cu``) rests on this identity. Pure PyTorch on the
CPU, no JAX: the scenes' metas from ``contact.build_meta`` and seeded NumPy
inputs, B = 4 envs with none, one, about half and all contacts active.
"""
import numpy as np
import pytest
import torch

from d3il_tpu_torch.engine import contact, contact_kernel
from d3il_tpu_torch.envs import inserting, sorting, stacking

SCENES = {"sorting_6": lambda: sorting.build_sorting_scene(6),
          "stacking": stacking.build_stacking_scene,
          "inserting": inserting.build_inserting_scene}
# max-scaled absolute error of the compacted solve against the full one:
# the same float32 arithmetic summed over fewer (zero) terms
TOL = 1e-5


def _inputs(meta, seed):
    """Batch-minor K3 inputs for B = 4 envs: contact points near the
    origin with unit normals, random arm axes and anchors, a symmetric
    positive definite arm inverse mass, unit free-body quaternions, and
    depths active on none (env 0), one (env 1), about half (env 2) and all
    (env 3) of the contacts."""
    rng = np.random.default_rng(seed)
    B, ncon, nv_r, nf, nv = 4, meta.ncon, meta.nv_r, meta.nf, meta.nv
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)
    active = np.zeros((ncon, B), bool)
    active[rng.integers(ncon), 1] = True
    active[:, 2] = rng.random(ncon) < 0.5
    active[:, 3] = True
    depth = np.where(active, rng.uniform(1e-4, 5e-3, (ncon, B)),
                     rng.uniform(-0.02, 0.0, (ncon, B)))
    L = 0.3 * rng.standard_normal((B, nv_r, nv_r))
    minv = L @ L.transpose(0, 2, 1) + 0.5 * np.eye(nv_r)
    ins = (0.3 * rng.standard_normal((ncon, 3, B)),
           unit(rng.standard_normal((ncon, 3, B))), depth,
           unit(rng.standard_normal((nv_r, 3, B))),
           0.3 * rng.standard_normal((nv_r, 3, B)),
           np.moveaxis(minv, 0, -1), rng.standard_normal((nv, B)),
           rng.standard_normal((nv, B)),
           0.3 * rng.standard_normal((nf, 3, B)),
           unit(rng.standard_normal((nf, 4, B))),
           0.1 * rng.standard_normal((ncon, 3, B)))
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32))
            for x in ins], active


def _scaled_err(a, b):
    return ((a - b).abs().max() / max(b.abs().max().item(), 1.0)).item()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_compacted_solve_equals_the_full_solve(scene):
    meta = contact.build_meta(SCENES[scene]())
    ins, active = _inputs(meta, seed=len(scene))
    f, qfrc = contact_kernel.phase_plain(meta, *ins)
    assert (f.movedim(1, -1)[~torch.from_numpy(active)] == 0.0).all()
    assert (f[:, :, 0] == 0.0).all() and (qfrc[:, 0] == 0.0).all()
    assert f[:, :, 3].abs().max() > 1e-3
    for e in range(1, 4):
        idx = np.flatnonzero(active[:, e])
        t = torch.as_tensor(idx)
        cut = [x[..., e:e + 1].contiguous() for x in ins]
        for i in (0, 1, 2, 10):     # pts, normal, depth, warm
            cut[i] = cut[i][t].contiguous()
        f_c, q_c = contact_kernel.phase_plain(
            contact.select_contacts(meta, idx), *cut)
        assert _scaled_err(f_c[..., 0], f[idx, :, e]) <= TOL, e
        assert _scaled_err(q_c[:, 0], qfrc[:, e]) <= TOL, e
