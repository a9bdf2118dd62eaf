"""Multi-process start-up and per-process data sharding.

Counterpart of ``d3il_tpu/parallel/distributed.py``. The JAX package joins
every host's chips into one global device set with
``jax.distributed.initialize``; here every process joins one
``torch.distributed`` group (NCCL when its device is a GPU, gloo on the
CPU) and owns one device. Data loading stays per process: each loads only
its own shard of a global work list (``process_shard``) and keeps it on
its device (``host_local_batch``); no process holds the global batch.

As the JAX package's single process sees every local chip, one entry
point uses every local GPU: ``local_world`` counts the ranks it starts on
this host (``torch.cuda.device_count()``, which ``CUDA_VISIBLE_DEVICES``
chooses, for ``device`` "cuda"; 1 for ``cuda:<k>`` and the CPU) and
``run_on_local_devices`` runs one rank per GPU, each a process of its own
on its own card, joined by NCCL; ``fit`` and the Sims then shard over the
default group, and the caller gets rank 0's result. A stochastic
agent's draws come from a generator of each rank's own
(``pmesh.rank_generator``), so one seed gives another model and other
metrics on another number of ranks, where the JAX package draws one
stream whatever its chip count.

Across hosts the caller's launcher starts every process with the
coordinator variables and calls ``initialize_from_env`` itself, as it
calls ``jax.distributed.initialize`` for the JAX package; ``local_world``
is then 1, so an entry point starts no ranks of its own.
"""
from __future__ import annotations

import gc
import os
import socket
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

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


def local_world(device=None) -> int:
    """The number of ranks an entry point starts on this host for
    ``device``: every visible GPU (``torch.cuda.device_count()``) for
    ``"cuda"`` or None, provided no process group is initialized and
    D3IL_COORD_ADDR is unset (a launcher that owns the processes); 1 for
    ``cuda:<k>``, the CPU, or a host without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return 1
    if os.environ.get("D3IL_COORD_ADDR") or (
            dist.is_available() and dist.is_initialized()):
        return 1
    return max(1, torch.cuda.device_count())


def process_index() -> int:
    """This process's rank in the default group (0 with none): rank 0
    alone writes a run's checkpoint, log and result line."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    """The number of processes in the default group (1 with none): the
    ``ranks`` of an entry point's row."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, args, nprocs, device, port, out):
    """One rank of ``run_on_local_devices``: join the group, run ``fn``,
    write rank 0's result, leave the group."""
    os.environ.update(D3IL_COORD_ADDR=f"127.0.0.1:{port}",
                      D3IL_NUM_PROCS=str(nprocs), D3IL_PROC_ID=str(rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    else:
        # the host's cores shared out among the ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // nprocs))
    initialize_from_env(dev)
    result = fn(*args)
    if rank == 0:
        with open(out, "wb") as f:
            torch.save(result, f)
    # a process group still held by a mesh when the interpreter exits can
    # abort it there: drop every mesh before the group (a rank that failed
    # leaves it to the interpreter; the call fails either way)
    del result
    gc.collect()
    dist.destroy_process_group()


def run_on_local_devices(fn, *args, nprocs: int, device=None):
    """``fn(*args)`` on ``nprocs`` ranks of this host; returns rank 0's
    result.

    With ``nprocs == 1``, ``fn`` runs in this process, with no process
    group. Otherwise each rank is a process of its own (``spawn``) that
    joins a group through the D3IL_* variables (rank 0 at a free port of
    127.0.0.1): on ``cuda:<rank>`` over NCCL when ``device`` is a GPU,
    on the CPU over gloo otherwise; ``fn`` and ``args`` are pickled to it
    (``fn`` a module-level function), and rank 0's result comes back with
    its tensors on the CPU. If any rank fails, the others are stopped and
    this raises; no rank outlives the call."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be at least 1, got {nprocs}")
    if nprocs == 1:
        return fn(*args)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and nprocs > torch.cuda.device_count():
        raise ValueError(f"{nprocs} ranks need as many GPUs, "
                         f"{torch.cuda.device_count()} are visible")
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("a process group is already initialized: its "
                           "launcher owns the ranks")
    with tempfile.TemporaryDirectory(prefix="d3il_ranks_") as tmpdir:
        out = os.path.join(tmpdir, "rank0.pt")
        ctx = torch_mp.start_processes(
            _rank_main, args=(fn, args, nprocs, dev.type, _free_port(), out),
            nprocs=nprocs, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        with open(out, "rb") as f:
            return torch.load(f, map_location="cpu", weights_only=False)


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
    pc, pi = process_count(), process_index()
    per = -(-n_items // pc)
    return slice(pi * per, min((pi + 1) * per, n_items))
