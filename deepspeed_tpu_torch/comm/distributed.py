"""Process-group bootstrap (counterpart of
``deepspeed_tpu/comm/distributed.py``, itself the reference's
``deepspeed/utils/distributed.py``: ``init_distributed`` :12,
``mpi_discovery`` :54).

:func:`init_distributed` starts ``torch.distributed`` from the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, as torchrun sets them; OpenMPI / MVAPICH variables as a
fallback): NCCL when the ranks train on CUDA devices, gloo on the CPU.
It is idempotent, and with no launcher environment it does nothing, as
in the JAX package.  Unlike the JAX package, a launcher environment of
``WORLD_SIZE=1`` still starts a process group (torchrun does the same):
the JAX runtime needs none for one process, while here the engine reads
its mesh from the started group (ROADMAP C4).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import logger


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def init_distributed(
    dist_backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    auto_mpi_discovery: bool = True,
    timeout_seconds: Optional[float] = None,
    verbose: bool = True,
) -> bool:
    """Start the default process group from the launcher environment;
    returns whether a group is running.

    ``device``: where the ranks train (``"cuda"`` picks NCCL and binds the
    process to ``LOCAL_RANK``'s card; ``"cpu"`` picks gloo); default: the
    card when there is one.  ``init_method``: a store URL
    (``file://...`` for tests on one host); default
    ``tcp://MASTER_ADDR:MASTER_PORT``.  ``timeout_seconds``: the group's
    collective timeout (``DS_DIST_TIMEOUT``, default 600)."""
    if is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", 0))
    master_addr = env.get("MASTER_ADDR")
    if (world_size is None or rank is None) and auto_mpi_discovery:
        mpi = mpi_discovery()
        if mpi is not None:
            world_size = world_size or mpi["world_size"]
            rank = rank if rank is not None else mpi["rank"]
            local_rank = mpi["local_rank"]
            master_addr = master_addr or mpi["master_addr"]
    if world_size is None or rank is None:
        return False  # no launcher environment: one process, no group
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    backend = dist_backend or ("nccl" if cuda else "gloo")
    if cuda:
        # ranks over gloo may share one card: LOCAL_RANK wraps around the
        # cards there are
        local_rank %= max(1, torch.cuda.device_count())
        torch.cuda.set_device(local_rank)
    if init_method is None:
        init_method = f"tcp://{master_addr or '127.0.0.1'}:{env.get('MASTER_PORT', '29500')}"
    timeout = float(timeout_seconds if timeout_seconds is not None
                    else env.get("DS_DIST_TIMEOUT", "600"))
    kw = {}
    if cuda and backend == "nccl":
        kw["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank), timeout=datetime.timedelta(seconds=timeout), **kw)
    if verbose:
        logger.info(f"init_distributed: rank {rank}/{world_size} ({backend}) via {init_method}")
    return True


def destroy() -> None:
    """Stop the default process group, if one is running."""
    if is_initialized():
        dist.destroy_process_group()


def mpi_discovery() -> Optional[dict]:
    """Map OpenMPI/MVAPICH env vars to rank info (reference
    ``utils/distributed.py:54-96``), without importing mpi4py."""
    env = os.environ
    if "OMPI_COMM_WORLD_RANK" in env:
        return {
            "rank": int(env["OMPI_COMM_WORLD_RANK"]),
            "world_size": int(env["OMPI_COMM_WORLD_SIZE"]),
            "local_rank": int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", 0)),
            "master_addr": env.get("MASTER_ADDR", "127.0.0.1"),
        }
    if "MV2_COMM_WORLD_RANK" in env:
        return {
            "rank": int(env["MV2_COMM_WORLD_RANK"]),
            "world_size": int(env["MV2_COMM_WORLD_SIZE"]),
            "local_rank": int(env.get("MV2_COMM_WORLD_LOCAL_RANK", 0)),
            "master_addr": env.get("MASTER_ADDR", "127.0.0.1"),
        }
    return None
