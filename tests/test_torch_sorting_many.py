"""Sorting with 4 and 6 boxes in the port against ``jax.vmap(sorting.step)``,
under full arm dynamics.

The scenes whose K3 launches take more than 48 KB of shared memory per
block on the card (sorting_4: 68 contacts, 204 rows, nv 33; sorting_6:
124 contacts, 372 rows, nv 45). The JAX package runs them per
env under ``vmap`` on every backend (they fail its kernel's tile test); the
port runs them on its batched window, here through the kernels' plain
versions. Both sides build SortingParams(n, n_substeps=2) with the JAX
package's start posture, reset B = 2 envs from the same NumPy contexts and
take one hold step; tolerances are tests/test_torch_pushing.py's.
"""
import jax
import pytest

from test_torch_jaxref import check_rod_state, port_params, sorting_contexts
from test_torch_sorting import FIELDS, check_result, run_episode

from d3il_tpu.envs import sorting as jsorting
from d3il_tpu_torch.engine import contact_kernel
from d3il_tpu_torch.envs import sorting

B = 2


@pytest.fixture(scope="module", params=[4, 6], ids=["sorting_4", "sorting_6"])
def episode(request):
    n = request.param
    jparams = jsorting.SortingParams(n, n_substeps=2, max_steps=50)
    params = port_params(jparams, sorting.SortingParams, num_boxes=n)
    return n, params, run_episode(jparams, params,
                                  sorting_contexts(20 + n, B, n), 1)


@pytest.mark.parametrize("i", [0, 1], ids=["reset", "step1"])
def test_state_matches(episode, i):
    n, _, ep = episode
    js, ps, _, _ = ep[i]
    check_rod_state(js, ps, FIELDS, f"sorting_{n} {['reset', 'step1'][i]}")


def test_step_result_matches(episode):
    _, _, ep = episode
    _, _, jres, res = ep[1]
    check_result(jres, res)
    assert jax.tree_util.tree_leaves(jres.obs)[0].shape == tuple(res.obs.shape)


def test_scene_takes_the_general_variant(episode):
    """The scene's size, the K3 variant and launch geometry the card runs
    its evaluation batch of 480 envs with; the reset's contacts lifted
    every box out of the platform."""
    n, params, ep = episode
    meta = params.statics.meta
    want = {4: (68, 33, 46032), 6: (124, 45, 57888)}[n]
    assert (meta.ncon, meta.nv, contact_kernel.smem_bytes(meta, 480)) == want
    geo = params.statics.contact.geometry(480)
    assert (geo.variant, geo.envs_per_block) == (2, 4)
    assert geo.smem_per_block > 48 * 1024
    _, ps, _, _ = ep[0]
    z = ps["scene"]["free_pos"][..., 2]
    assert z.shape == (B, n) and ((z > 0.115) & (z < 0.135)).all()
