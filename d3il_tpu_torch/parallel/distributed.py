"""Multi-process start-up and per-process data sharding.

Counterpart of ``d3il_tpu/parallel/distributed.py``. The JAX package joins
every host's chips into one global device set with
``jax.distributed.initialize``; here every process joins one
``torch.distributed`` group (NCCL when its device is a GPU, gloo on the
CPU) and owns one device. Data loading stays per process: each loads only
its own shard of a global work list (``process_shard``) and keeps it on
its device (``host_local_batch``); no process holds the global batch.

``initialize_from_env`` reads the coordinator variables, so one entry
point runs as one process (the variables unset: nothing happens) or under
a launcher that injects them. No entry script calls it: the caller does,
and ``fit`` and the Sims then shard over the default group.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from d3il_tpu_torch.envs.common import resolve_device
from d3il_tpu_torch.parallel import mesh as pmesh

# how long a collective (the start-up rendezvous included) waits for a
# missing peer before it fails
TIMEOUT_S = 300


def initialize_from_env(device=None) -> bool:
    """``torch.distributed.init_process_group`` from D3IL_COORD_ADDR
    (host:port of rank 0), D3IL_NUM_PROCS and D3IL_PROC_ID; nothing when
    D3IL_COORD_ADDR is unset. NCCL when this process's device
    (``resolve_device(device)``: CUDA unless the caller names another) is
    a GPU, which becomes the current device when ``device`` names its
    index (``cuda:<local rank>``, one GPU a process); gloo on the CPU.
    Returns True if a process group was initialized."""
    addr = os.environ.get("D3IL_COORD_ADDR")
    if not addr:
        return False
    num = int(os.environ["D3IL_NUM_PROCS"])
    pid = int(os.environ["D3IL_PROC_ID"])
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}", world_size=num,
                            rank=pid, timeout=timedelta(seconds=TIMEOUT_S))
    return True


def global_mesh() -> pmesh.DataMesh:
    """The mesh over every process of the default group."""
    return pmesh.data_mesh()


def host_local_batch(mesh: pmesh.DataMesh, tree):
    """This process's shard of a global batch, on the mesh's device.

    Every leaf's leading axis is this process's block of the global batch,
    whose size is the local size times the world size: one all-gather of
    the local sizes checks that every rank holds as many rows."""
    tree = pmesh.tree_map(lambda x: x.to(mesh.device), tree)
    n = pmesh.leading_size(tree)
    if mesh.group is not None:
        sizes = [torch.zeros(1, dtype=torch.int64, device=mesh.device)
                 for _ in range(mesh.world)]
        dist.all_gather(sizes, torch.tensor([n], device=mesh.device),
                        group=mesh.group)
        sizes = [int(s) for s in sizes]
        if len(set(sizes)) != 1:
            raise ValueError(f"ranks hold different local batch sizes "
                             f"{sizes}")
    return tree


def process_shard(n_items: int) -> slice:
    """The contiguous slice of a global work list owned by this process."""
    if dist.is_available() and dist.is_initialized():
        pc, pi = dist.get_world_size(), dist.get_rank()
    else:
        pc, pi = 1, 0
    per = -(-n_items // pc)
    return slice(pi * per, min((pi + 1) * per, n_items))
