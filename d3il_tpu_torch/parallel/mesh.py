"""Data mesh: the process group a batch is sharded over, and the row
helpers of the data-parallel paths.

Counterpart of ``d3il_tpu/parallel/mesh.py``. The JAX package shards the
leading (env or minibatch) axis of every array over a device mesh and XLA
inserts the collectives. Here each process of a ``torch.distributed``
group owns one device and a contiguous block of the batch's rows, and the
collectives are explicit:

* ``run_sharded`` pads the batch to a multiple of the world size, runs
  ``fn`` on this rank's rows and all-gathers the outputs (every eval Sim);
* ``agents/base.fit`` all-reduces the gradient as a mean before the
  global-norm clip, and the epoch loss;
* ``replicate`` broadcasts rank 0's tensors, so that every rank starts
  from the same weights.

The JAX module's ``batch_sharding``, ``replicated_sharding`` and
``constrain_batch`` name XLA placements and have no PyTorch meaning of
their own: the gradient all-reduce in ``fit`` and the gather in
``run_sharded`` do their work.

NCCL refuses two ranks on one GPU, so one card runs a group of one rank;
several ranks on one host run gloo on the CPU.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from d3il_tpu_torch.envs.common import resolve_device


@dataclass(frozen=True)
class DataMesh:
    """A process group, this process's rank in it, its size and the device
    its rows live on. ``group=None`` is a mesh of one process with no
    collectives (``DataMesh(device=d)``). A mesh keeps its process group
    alive: drop it before ``destroy_process_group()``, since a group still
    referenced when the interpreter exits can abort it there (seen with
    gloo under load)."""
    group: Any = None
    world: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")


def data_mesh(group=None, device=None) -> DataMesh:
    """The mesh over ``group`` (the default group when None). Its device is
    ``device``, else the current CUDA device under NCCL and the CPU under
    gloo. With no process group initialized: world size 1, no group, on
    ``resolve_device(device)``."""
    if not (dist.is_available() and dist.is_initialized()):
        return DataMesh(device=resolve_device(device))
    group = dist.group.WORLD if group is None else group
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
    return DataMesh(group, dist.get_world_size(group),
                    dist.get_rank(group), torch.device(device))


def default_mesh() -> DataMesh | None:
    """The default group's mesh when it spans more than one process, else
    None: what ``fit`` and the Sims shard over when given no mesh."""
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return data_mesh()
    return None


def tree_map(fn, tree):
    """fn over every tensor leaf of nested tuples (NamedTuples keep their
    type), lists and dicts; other leaves pass through."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple):
        parts = [tree_map(fn, x) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    if isinstance(tree, list):
        return [tree_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def leading_size(tree) -> int:
    """The leading axis every tensor leaf of ``tree`` shares."""
    sizes = {x.shape[0] for x in tree_leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"mismatched leading axes {sorted(sizes)}")
    return sizes.pop()


def pad_rows(tree, world: int):
    """Every leaf's leading axis padded from B up to a multiple of
    ``world`` by repeating row 0, as the JAX ``run_sharded`` pads."""
    B = leading_size(tree)
    extra = -(-B // world) * world - B
    if extra == 0:
        return tree
    return tree_map(
        lambda x: torch.cat([x, x[:1].expand((extra,) + x.shape[1:])]), tree)


def shard_batch(mesh: DataMesh, tree):
    """This rank's contiguous block of every leaf's leading axis: B / world
    rows, rank r's after rank r - 1's. B must be a multiple of the world
    size (``pad_rows``)."""
    B = leading_size(tree)
    if B % mesh.world:
        raise ValueError(f"a batch of {B} rows does not divide over "
                         f"{mesh.world} ranks")
    per = B // mesh.world
    return tree_map(lambda x: x[mesh.rank * per:(mesh.rank + 1) * per],
                    tree)


def _by_dtype(leaves):
    groups = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    return groups.items()


def _wire(dtype):
    # gloo carries no bool
    return torch.uint8 if dtype == torch.bool else dtype


def gather_rows(mesh: DataMesh, tree):
    """Every tensor leaf all-gathered along its leading axis over the mesh,
    rank r's rows after rank r - 1's. All leaves of one dtype travel in one
    collective; gloo and NCCL need a contiguous buffer of one shape on
    every rank, so every rank holds as many rows (``pad_rows``)."""
    if mesh.group is None:
        return tree
    leaves = tree_leaves(tree)
    n = leading_size(tree)
    out = [None] * len(leaves)
    for dtype, idx in _by_dtype(leaves):
        flat = torch.cat([leaves[i].reshape(n, -1).to(mesh.device,
                                                      _wire(dtype))
                          for i in idx], 1).contiguous()
        parts = [torch.empty_like(flat) for _ in range(mesh.world)]
        dist.all_gather(parts, flat, group=mesh.group)
        full = torch.cat(parts)
        off = 0
        for i in idx:
            x = leaves[i]
            w = math.prod(x.shape[1:])
            out[i] = full[:, off:off + w].reshape((-1,) + x.shape[1:]).to(
                x.device, dtype)
            off += w
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def _flat_collective(mesh: DataMesh, tensors, op):
    """``op(flat)`` on one buffer per dtype of ``tensors`` (flattened, on
    the mesh's device), then copied back into them in place."""
    with torch.no_grad():
        for dtype, idx in _by_dtype(tensors):
            flat = torch.cat([tensors[i].detach().reshape(-1).to(
                mesh.device, _wire(dtype)) for i in idx])
            op(flat)
            off = 0
            for i in idx:
                x = tensors[i]
                x.copy_(flat[off:off + x.numel()].view(x.shape).to(
                    x.device, dtype))
                off += x.numel()


def replicate(mesh: DataMesh, tree):
    """Every tensor leaf broadcast from the mesh's rank 0, in place (every
    rank then holds rank 0's values); returns the tree."""
    if mesh.group is not None:
        src = dist.get_global_rank(mesh.group, 0)
        _flat_collective(mesh, tree_leaves(tree), lambda flat: dist.broadcast(
            flat, src, group=mesh.group))
    return tree


def all_reduce_mean(mesh: DataMesh, tensors):
    """Each floating tensor of the list replaced, in place, by its mean
    over the mesh's ranks."""
    if mesh.group is not None:
        def mean(flat):
            dist.all_reduce(flat, group=mesh.group)
            flat.div_(mesh.world)
        _flat_collective(mesh, list(tensors), mean)


def broadcast_object(mesh: DataMesh, obj):
    """A picklable object (tensors on the CPU) from the mesh's rank 0:
    every rank returns rank 0's."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.group, 0),
                               group=mesh.group, device=mesh.device)
    return box[0]


def run_sharded(fn, *batched_inputs, mesh: DataMesh | None = None):
    """fn over the leading axis of ``batched_inputs``, sharded across the
    mesh's ranks.

    The analogue of the JAX ``run_sharded``: the inputs are padded up to a
    multiple of the world size (by repeating row 0), each rank runs ``fn``
    on its own block of rows, and the outputs (every tensor leaf with that
    block's rows first) are all-gathered over the group and sliced back to
    B rows. ``fn`` is batched: it maps inputs of b rows to outputs of b
    rows, as the port's window and rollouts do, where the JAX package maps
    a per-env function under ``vmap``. With no mesh and no process group of
    more than one process, this is ``fn(*batched_inputs)``.
    """
    mesh = mesh if mesh is not None else default_mesh()
    if mesh is None:
        return fn(*batched_inputs)
    B = leading_size(batched_inputs)
    local = shard_batch(mesh, pad_rows(batched_inputs, mesh.world))
    out = gather_rows(mesh, fn(*local))
    return tree_map(lambda x: x[:B], out)


def rank_seed(*parts) -> int:
    """A 63-bit seed hashed from ``parts``: different parts give
    independent streams."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def rank_generator(mesh: DataMesh | None, seed: int, device):
    """The generator of this rank's own draws (a policy's, a loss's):
    seeded ``seed`` itself on rank 0 and ``rank_seed(seed, rank)`` on
    every other rank, so that no two ranks draw the same noise for
    different rows. Rank 0's stream is a one-process run's only where the
    caller passes the one-process seed: the Sims do (seed + 1), ``fit``
    does not (it hashes the epoch into the loss's seed)."""
    rank = 0 if mesh is None else mesh.rank
    return torch.Generator(device=device).manual_seed(
        seed if rank == 0 else rank_seed(seed, rank))
