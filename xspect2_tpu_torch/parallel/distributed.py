"""Multi-process distributed runtime.

Multi-device runs use ``torch.distributed``, one process per device:
every process calls :func:`initialize`, builds the same global mesh
over all ranks, and feeds the same global inputs (or, for host-sharded
input, its own shard of the read stream).  CUDA tensors travel through
NCCL, CPU tensors (``device="cpu"``) through gloo.

Typical launch (the same command in every process, with the
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` that
``torchrun`` sets)::

    from xspect2_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()                  # env-driven coordinator
    mesh = make_mesh(n_cls=2)                 # all ranks of the world
    clf = ShardedClassifier(index, mesh, ...) # identical in every process
"""

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from xspect2_tpu_torch import resolve_device

logger = logging.getLogger("xspect2_tpu_torch.distributed")

DEFAULT_TIMEOUT_S = 600.0
_timeout = timedelta(seconds=DEFAULT_TIMEOUT_S)


def group_timeout() -> timedelta:
    """The timeout :func:`initialize` gave the world; every process group
    of a mesh gets the same."""
    return _timeout


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> dict:
    """Initialize ``torch.distributed`` (no-op for a single process).

    Arguments default to the standard environment variables
    (``MASTER_ADDR`` with ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``coordinator_address`` is ``host:port`` or a full init method such
    as ``file:///path``.
    With neither an address nor a process count nothing is initialized
    and the process is a world of one.  ``device`` picks the backend:
    None means CUDA (``nccl``; raises without a card), ``"cpu"`` means
    ``gloo``.  A collective that waits longer than ``timeout_s`` fails.
    Returns a summary dict of the resulting topology.
    """
    global _timeout
    device = resolve_device(device)
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])

    if coordinator_address or num_processes:
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError(
                "a distributed run needs the coordinator address, the number of "
                "processes and this process's id"
            )
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        _timeout = timedelta(seconds=timeout_s)
        if device.type == "cuda":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo",
            init_method=coordinator_address,
            world_size=num_processes,
            rank=process_id,
            timeout=_timeout,
        )
    initialized = dist.is_available() and dist.is_initialized()
    topology = {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": dist.get_world_size() if initialized else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if initialized else 1,
    }
    logger.info("distributed topology: %s", topology)
    return topology


def local_data_shard(items: list, axis_size: int | None = None) -> list:
    """The slice of a global work list owned by this process.

    Round-robin assignment by rank: the host-side input pipeline for
    data-parallel read streaming (each process parses and packs only its
    own shard of the input files).
    """
    initialized = dist.is_available() and dist.is_initialized()
    count = (dist.get_world_size() if initialized else 1) if axis_size is None else axis_size
    idx = dist.get_rank() if initialized else 0
    return [item for i, item in enumerate(items) if i % count == idx]
