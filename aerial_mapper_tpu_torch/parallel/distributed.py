"""Multi-process initialization and rank-0 artifact merging.

Twin of ``aerial_mapper_tpu/parallel/distributed.py``, on
``torch.distributed``. JAX scales out with one process per host,
``jax.distributed.initialize`` and a global mesh; here it is one process per
card (``torchrun`` or :func:`initialize_distributed`), a process group, and
a mesh over every rank's devices (``parallel/mesh.py::mesh_devices``) whose
collectives exchange through the group (``parallel/collectives.py``). Host
I/O stays per process, with a rank-0 merge (this module).

Backends: NCCL for one rank per card; Gloo moves the blocks through host
memory and runs where NCCL cannot, on the CPU or with several ranks on one
card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.parallel import collectives as cl

logger = logging.getLogger("aerial_mapper_tpu_torch")

# how long a rank waits for the others, at the rendezvous and in every
# collective, before the run fails
DEFAULT_TIMEOUT_S = 600.0


def _init_method(address: str) -> str:
    """A JAX-style ``host:port`` as ``tcp://host:port``; a ``file://`` or
    ``tcp://`` init method as given."""
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the process group; returns whether more than one process is
    up afterwards.

    With ``coordinator_address`` (``host:port`` as in JAX, or a ``file://``
    / ``tcp://`` init method) it calls ``init_process_group`` with
    ``num_processes`` and ``process_id``. With no address it reads the
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, as
    ``torchrun`` sets them) and does nothing when that names one process,
    as JAX's auto-detection does. A group already up is kept.

    ``backend=None`` means NCCL, and raises without CUDA
    (``device.py::resolve_device``); CPU callers, and ranks that share a
    card, pass ``"gloo"``. With NCCL each rank makes its local card current
    (``LOCAL_RANK``, else the rank modulo the visible cards): that card is
    the rank's device in a mesh. Every wait, the rendezvous and each
    collective, ends after ``timeout_s`` with an error. A failed join
    raises: the run never goes on as one process.
    """
    if dist.is_initialized():
        logger.debug("torch.distributed: already initialized")
    else:
        if coordinator_address is None and \
                int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return False
        if backend is None:
            resolve_device(None)
            backend = "nccl"
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError(
                    "initialize_distributed: a coordinator address needs "
                    "num_processes and process_id")
            kw = dict(init_method=_init_method(coordinator_address),
                      world_size=int(num_processes), rank=int(process_id))
            rank = int(process_id)
        else:
            kw = dict(init_method="env://")
            rank = int(os.environ["RANK"])
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    multi = process_count() > 1
    logger.info("distributed: process %d/%d (%s)", process_index(),
                process_count(), dist.get_backend())
    return multi


def process_count() -> int:
    """The ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank0() -> bool:
    return process_index() == 0


def gather_row_bands_to_host(bands: list, mesh, axis_name: str = "tiles"
                             ) -> Optional[np.ndarray]:
    """Assemble a row-band-sharded raster (one band per shard,
    ``parallel/sharded.py::shard_layers``) as numpy on rank 0; None on
    every other rank. Every rank must call: the bands are gathered through
    the group (JAX's ``process_allgather``) and only rank 0 keeps them."""
    full = cl.concat(mesh, bands, axis_name, device="cpu")
    return full.numpy() if is_rank0() else None


def pad_to_multiple(n: int, k: int) -> int:
    """Observations/pairs padding helper for even sharding."""
    return (-n) % k


def shard_sequence_indices(num_items: int, num_shards: int,
                           shard: int) -> Sequence[int]:
    """Contiguous block partition of item indices (the parFor partition,
    utils-common.h:40-58, applied across hosts for host-side I/O)."""
    block = -(-num_items // num_shards)
    return range(shard * block, min(num_items, (shard + 1) * block))
