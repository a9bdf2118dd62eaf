"""The data-parallel path (``d3il_tpu_torch/parallel``) on real OS
processes joined by gloo on the CPU, and its row arithmetic against the
JAX package's ``d3il_tpu.parallel``.

The workers import only ``d3il_tpu_torch``. One spawn of three ranks holds
``run_sharded`` at B = 11 over three ranks (also with an output leaf of
no columns, as avoiding's free bodies) and, on a group of ranks 0 and
1, over two; on that pair, the pushing step sharded against the
one-process step (the JAX test's 1e-5, ``tests/test_parallel.py:54-57``)
and the bc ``fit`` of ``tests/test_parallel.py:73-109`` against one
process here (losses rtol 2e-4, weights atol 2e-4, the JAX test's), and
resumed from rank 0's checkpoint against the unbroken run (exact), rank 1
from a directory of its own that holds none, as on a host that does not
see rank 0's files. A
second spawn starts two processes from the D3IL_* variables, as
``tests/test_distributed.py`` does, and holds the all-reduced loss to its
NumPy value (rel 1e-5) and the ranks' own draws apart.
"""
import os

import numpy as np
import pytest
import torch

from test_torch_cuda import Q_INIT
from test_torch_jaxref import spawn_ranks

from d3il_tpu_torch.agents import base
from d3il_tpu_torch.data import dataset as ds
from d3il_tpu_torch.parallel import distributed as pdist
from d3il_tpu_torch.parallel import mesh as pmesh

# the bc run of tests/test_parallel.py:73-109; the workers run the same
# source
BC_SETUP = r"""
import numpy as np, torch
from d3il_tpu_torch.agents import base
from d3il_tpu_torch.agents.bc import BCAgent
from d3il_tpu_torch.data import dataset as ds
from d3il_tpu_torch.data.scaler import Scaler

OBS, ACT, N, T = 6, 2, 8, 10
rng = np.random.default_rng(0)
obs = rng.normal(size=(N, T, OBS)).astype(np.float32)
act = rng.normal(size=(N, T, ACT)).astype(np.float32)
slices = np.stack(np.meshgrid(np.arange(N), np.arange(T - 1),
                              indexing="ij"), -1).reshape(-1, 2)
data = ds.TrajectoryData(torch.from_numpy(obs), torch.from_numpy(act),
                         torch.ones(N, T), torch.from_numpy(slices))
scaler = Scaler.fit(obs.reshape(-1, OBS), act.reshape(-1, ACT), device="cpu")
cfg = base.TrainConfig(epochs=3, batch_size=16, steps_per_epoch=2,
                       eval_every_n_epochs=10)
agent = BCAgent.create(torch.Generator().manual_seed(0), OBS, ACT, scaler)


def train(mesh, epochs=cfg.epochs, ckpt_dir=None):
    _, final, hist = base.fit(
        agent.loss_fn(), agent.params, data, None,
        base.TrainConfig(**dict(vars(cfg), epochs=epochs)),
        torch.Generator().manual_seed(1), mesh=mesh,
        checkpoint_dir=ckpt_dir, checkpoint_every=1)
    return final, [h["train_loss"] for h in hist]
"""

RANKS = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from d3il_tpu_torch import convert
from d3il_tpu_torch.envs import pushing
from d3il_tpu_torch.parallel import distributed as pdist
from d3il_tpu_torch.parallel import mesh as pmesh

assert pdist.initialize_from_env(device="cpu")
assert dist.get_backend() == "gloo"
world = pmesh.data_mesh()
group = dist.new_group([0, 1])          # every rank takes part
pair = pmesh.data_mesh(group) if world.rank < 2 else None
params = convert.params_from_numpy(np.array(json.loads(sys.argv[1])),
                                   n_substeps=2, solver_iters=5, device="cpu")


def err(a, b):
    la, lb = pmesh.tree_leaves(a), pmesh.tree_leaves(b)
    assert [x.shape for x in la] == [y.shape for y in lb]
    return max((x.double() - y.double()).abs().max().item()
               for x, y in zip(la, lb) if x.numel())


reset = lambda c: pushing.reset(params, c)
ctx = pushing.sample_context(torch.Generator().manual_seed(1), 11)
one = reset(ctx)
out = {"rank": world.rank, "world": world.world,
       "rows_over_3": err(pmesh.run_sharded(reset, ctx, mesh=world), one)}
# a leaf without columns, as avoiding's free bodies ([B, 0, 3])
empty = lambda r: (r, r.new_zeros(r.shape[0], 0, 3))
rows = torch.arange(33.0).reshape(11, 3)
out["empty_leaf"] = err(pmesh.run_sharded(empty, rows, mesh=world),
                        empty(rows))
if pair is not None:
    out["rows_over_2"] = err(pmesh.run_sharded(reset, ctx, mesh=pair), one)
    ctx4 = pushing.sample_context(torch.Generator().manual_seed(0), 4)
    action = torch.tensor([0.45, -0.1, 0.12, 0.0, 1.0, 0.0, 0.0]).repeat(4, 1)
    step = lambda s, a: pushing.step(params, s, a)
    want, _ = step(reset(ctx4), action)
    got, _ = pmesh.run_sharded(step, pmesh.run_sharded(reset, ctx4, mesh=pair),
                               action, mesh=pair)
    out["step_q"] = err(got.scene.q, want.scene.q)
    out["step_free_pos"] = err(got.scene.free_pos, want.scene.free_pos)
    exec(sys.argv[2])
    final, losses = train(pair)
    torch.save(final, sys.argv[3] + f".{pair.rank}")
    out["losses"] = losses
    # 2 epochs with a checkpoint (rank 0 writes it), then a resumed 3rd;
    # rank 1's directory stays empty: it resumes from rank 0's broadcast
    ckpt = sys.argv[3] + ("_ckpt" if pair.rank == 0 else "_ckpt_rank1")
    train(pair, 2, ckpt)
    resumed, tail = train(pair, 3, ckpt)
    out["own_checkpoint"] = os.path.exists(os.path.join(ckpt, "state.pt"))
    out["resumed_losses"] = tail
    out["resumed_equal"] = all(torch.equal(resumed[k], final[k])
                               for k in final)
# a process group still referenced when the interpreter exits can abort it
# there: drop every mesh and group first
del world, pair, group
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_sharded_step_rows_and_fit_over_gloo_ranks(tmp_path):
    outs = spawn_ranks(RANKS, 3, repr(Q_INIT.tolist()), BC_SETUP,
                       str(tmp_path / "final"))
    assert [o["rank"] for o in outs] == [0, 1, 2]
    for o in outs:
        # B = 11 over 3 ranks (one padded row) and over 2 (one padded row):
        # the one-process rows, shapes included
        assert o["rows_over_3"] == 0.0
        assert o["empty_leaf"] == 0.0
    for o in outs[:2]:
        assert o["rows_over_2"] == 0.0
        assert o["step_q"] <= 1e-5 and o["step_free_pos"] <= 1e-5, o
    ns = {}
    exec(BC_SETUP, ns)
    final_1, losses_1 = ns["train"](None)     # one process, no group
    for o in outs[:2]:
        np.testing.assert_allclose(o["losses"], losses_1, rtol=2e-4)
        final_2 = torch.load(tmp_path / f"final.{o['rank']}")
        assert set(final_2) == set(final_1)
        for k in final_1:
            np.testing.assert_allclose(final_2[k].numpy(),
                                       final_1[k].numpy(), atol=2e-4,
                                       err_msg=k)
    assert outs[0]["losses"] == outs[1]["losses"]
    # a resumed run continues the unbroken one on both ranks
    assert [o["own_checkpoint"] for o in outs[:2]] == [True, False]
    for o in outs[:2]:
        assert o["resumed_losses"] == o["losses"][2:]
        assert o["resumed_equal"]


ENV_INIT = r"""
import json
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from d3il_tpu_torch.parallel import distributed as pdist
from d3il_tpu_torch.parallel import mesh as pmesh

assert pdist.initialize_from_env(device="cpu"), "no process group"
mesh = pdist.global_mesh()
assert (mesh.world, dist.get_backend()) == (2, "gloo")

# a deterministic global batch; each process loads only its own half
B, D = 8, 5
full_x = np.arange(B * D, dtype=np.float32).reshape(B, D) / 10.0
full_y = np.ones((B, 1), np.float32)
sl = pdist.process_shard(B)
x, y = pdist.host_local_batch(mesh, (torch.from_numpy(full_x[sl]),
                                     torch.from_numpy(full_y[sl])))
assert x.shape == (B // 2, D)
# rank 1 starts from other weights: replicate hands it rank 0's
w = torch.full((D, 1), 0.1 if mesh.rank == 0 else 7.0)
pmesh.replicate(mesh, [w])
w.requires_grad_(True)
loss = torch.mean((x @ w - y) ** 2)
loss.backward()
loss = loss.detach()
pmesh.all_reduce_mean(mesh, [loss, w.grad])
# the ranks' own draws, as fit's loss and a Sim's policy take them
draws = torch.stack([
    torch.rand(6, generator=pmesh.rank_generator(
        mesh, pmesh.rank_seed(1, 0), "cpu")),
    torch.rand(6, generator=pmesh.rank_generator(mesh, 1, "cpu"))])
every = pmesh.gather_rows(mesh, draws[None])
rank = mesh.rank
del mesh                # no process group outlives destroy_process_group
dist.destroy_process_group()
print(json.dumps({"process": rank, "shard": [sl.start, sl.stop],
                  "loss": loss.item(), "grad": w.grad[:, 0].tolist(),
                  "own_draws_differ": bool((every[0] != every[1]).all())}))
"""


def test_env_initialized_two_process_loss_and_draws():
    outs = spawn_ranks(ENV_INIT, 2)
    assert [o["shard"] for o in outs] == [[0, 4], [4, 8]]
    assert outs[0]["loss"] == pytest.approx(outs[1]["loss"], rel=1e-6)
    B, D = 8, 5
    x = np.arange(B * D, dtype=np.float32).reshape(B, D) / 10.0
    y = np.ones((B, 1), np.float32)
    w = np.ones((D, 1), np.float32) * 0.1
    assert outs[0]["loss"] == pytest.approx(float(np.mean((x @ w - y) ** 2)),
                                            rel=1e-5)
    grad = (2.0 / B) * x.T @ (x @ w - y)
    for o in outs:
        np.testing.assert_allclose(o["grad"], grad[:, 0], rtol=1e-5)
        assert o["own_draws_differ"]


def test_shard_and_padding_rows_match_jax(monkeypatch):
    """process_shard against the JAX one under every process count of 1-4
    (jax.process_count / process_index patched), and run_sharded's padded
    rows and each rank's block against the JAX run_sharded's padded input
    and each device's shard of it, B = 11 over 2 and 3 devices."""
    import jax
    import jax.numpy as jnp
    import torch.distributed as dist
    from d3il_tpu.parallel import distributed as jdist
    from d3il_tpu.parallel import mesh as jmesh

    for pc in range(1, 5):
        for pi in range(pc):
            monkeypatch.setattr(jax, "process_count", lambda: pc)
            monkeypatch.setattr(jax, "process_index", lambda: pi)
            monkeypatch.setattr(dist, "is_initialized", lambda: True)
            monkeypatch.setattr(dist, "get_world_size", lambda: pc)
            monkeypatch.setattr(dist, "get_rank", lambda: pi)
            for n in range(13):
                assert pdist.process_shard(n) == jdist.process_shard(n), \
                    (pc, pi, n)
    monkeypatch.undo()

    placed = []
    shard = jmesh.shard_batch
    monkeypatch.setattr(jmesh, "shard_batch",
                        lambda m, t: placed.append(shard(m, t)) or placed[-1])
    rows = np.arange(11 * 3, dtype=np.int32).reshape(11, 3)
    for n in (2, 3):
        out = jmesh.run_sharded(lambda r: r, jnp.asarray(rows),
                                mesh=jmesh.data_mesh(jax.devices()[:n]))
        np.testing.assert_array_equal(np.asarray(out), rows)
        (jpadded,) = placed.pop()
        padded = pmesh.pad_rows(torch.from_numpy(rows), n)
        np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
        for r, dev in enumerate(jax.devices()[:n]):
            (block,) = [s.data for s in jpadded.addressable_shards
                        if s.device == dev]
            mine = pmesh.shard_batch(pmesh.DataMesh(world=n, rank=r), padded)
            np.testing.assert_array_equal(mine.numpy(), np.asarray(block))
    # one process: run_sharded is fn itself, and fit keeps its own path
    assert pmesh.default_mesh() is None
    assert pmesh.data_mesh(device="cpu") == pmesh.DataMesh()
    assert pmesh.run_sharded(lambda r: r + 1, torch.zeros(3)).tolist() == \
        [1.0, 1.0, 1.0]
    # a mesh of one rank: a stochastic loss draws what it draws with none
    rng = np.random.default_rng(0)
    data = ds.build([(rng.normal(size=(20, 2)).astype(np.float32),
                      rng.normal(size=(20, 1)).astype(np.float32))], 20, 1,
                    device="cpu")

    def noisy(p, obs, act, g):
        noise = torch.randn(act.shape, generator=g)
        return ((obs[..., :1] * p["w"] - act + noise) ** 2).mean()

    cfg = base.TrainConfig(epochs=3, batch_size=4, steps_per_epoch=2)
    (_, f0, h0), (_, f1, h1) = [
        base.fit(noisy, {"w": torch.ones(1)}, data, None, cfg,
                 torch.Generator().manual_seed(5), mesh=m)
        for m in (None, pmesh.DataMesh())]
    assert h0 == h1 and torch.equal(f0["w"], f1["w"])
    with pytest.raises(ValueError, match="does not divide"):
        base.fit(None, {}, None, None, base.TrainConfig(batch_size=5),
                 torch.Generator(), mesh=pmesh.DataMesh(world=2))
    assert os.environ.get("D3IL_COORD_ADDR") is None
    assert not pdist.initialize_from_env(device="cpu")
