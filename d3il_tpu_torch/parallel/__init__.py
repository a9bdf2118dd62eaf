"""Data parallelism over a ``torch.distributed`` process group: the mesh
and its row helpers (``mesh``), multi-process start-up and per-process
data sharding (``distributed``)."""
