"""Joining the ranks of a run — the port of
``transmogrifai_tpu/parallel/multihost.py``.

Each rank is one process running the identical program (``torchrun``
starts them and sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, the counterparts
of the JAX package's ``JAX_*`` variables). :func:`initialize` joins them
into one process group; ``mesh.make_mesh`` then sees the whole world.

Recipe (every rank runs it):

    from transmogrifai_tpu_torch.parallel import multihost, mesh
    multihost.initialize()              # env-driven; no-op in one process
    m = mesh.make_mesh()                # over every rank
    ... Workflow(...).set_mesh(m).train() ...

or ``torchrun --nproc-per-node N app.py --run-type Train ...
--mesh-devices N`` (an ``OpApp``), where the runner does both.

Backend: ``nccl`` when every local rank has a card of its own, ``gloo``
otherwise (the CPU, or several ranks sharing a card: NCCL refuses two
ranks on one device). gloo sums CUDA tensors through the host. Every
group gets a stated timeout (:data:`COLLECTIVE_TIMEOUT_S`, 300 s), so
one dead rank fails the run instead of hanging it.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

__all__ = ["initialize", "is_distributed", "is_coordinator",
           "process_summary", "backend", "barrier", "collective_timeout"]

#: seconds a collective may wait for a rank before the run fails
COLLECTIVE_TIMEOUT_S = 300.0


def _dist():
    import torch.distributed as dist
    return dist


def collective_timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[list] = None) -> bool:
    """Join this process to the world's process group.

    ``coordinator_address`` is rank 0's ``host:port`` (default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size
    (``WORLD_SIZE``), ``process_id`` this rank (``RANK``),
    ``local_device_ids`` the cards this host's ranks share (default all
    visible); the rank's card is ``cuda:(LOCAL_RANK % len(ids))``.
    Returns True once a world of several ranks is joined, False in one
    process (nothing is initialized). Idempotent."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None or not num_processes \
            or int(num_processes) <= 1:
        return False                      # one process: nothing to join
    local_rank = _env_int("LOCAL_RANK") or 0
    local_world = _env_int("LOCAL_WORLD_SIZE") or int(num_processes)
    be = "gloo"
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        ids = (list(local_device_ids) if local_device_ids is not None
               else list(range(torch.cuda.device_count())))
        torch.cuda.set_device(ids[local_rank % len(ids)])
        be = "nccl" if local_world <= len(ids) else "gloo"
    dist.init_process_group(
        be, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=collective_timeout())
    return True


def backend() -> Optional[str]:
    """The world group's backend, or None in one process."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return None


def is_distributed() -> bool:
    dist = _dist()
    return bool(dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


def is_coordinator() -> bool:
    """True on the one process that performs shared-filesystem writes
    (the model save, the metrics and trace sinks, checkpoints, the cost
    database): rank 0. Every rank computes identical results, so one
    writer suffices, and the crash-consistent swaps do not support
    concurrent writers. Always True in one process."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def barrier() -> None:
    """Wait for every rank of the world (nothing in one process)."""
    if is_distributed():
        _dist().barrier()


def process_summary() -> dict:
    """This process's view for the metrics documents."""
    dist = _dist()
    on = dist.is_available() and dist.is_initialized()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_id": dist.get_rank() if on else 0,
            "process_count": dist.get_world_size() if on else 1,
            "local_devices": local,
            "global_devices": dist.get_world_size() if on else 1,
            "backend": backend()}
