"""Device mesh for tile- and pair-sharded mapping, in one process or
across the processes of a ``torch.distributed`` group.

Twin of ``aerial_mapper_tpu/parallel/mesh.py``. JAX's ``shard_map`` is a
single-controller program over a ``jax.sharding.Mesh``; its twin here is a
mesh over a list of ``torch.device``s, in which a device may repeat. The
shards of a repeated device are logical shards: they run one after another
on that device, and every exchange between shards is a tensor copy
(``parallel/collectives.py``). With one device per card the same code runs
one shard per card.

Across processes (JAX's multi-controller mesh) the mesh records the process
of each shard: the global device list is every rank's
:func:`default_devices` in rank order (:func:`mesh_devices`), JAX's
process-major ``jax.devices()`` order, so a flat shard id means the same
shard in both packages. Each rank runs its own shards
(:meth:`Mesh.local_shards`); a device entry of another rank is only a
label, and the collectives exchange blocks through the process group.

Axes, as in JAX:

- ``tiles``: map row bands (DSM / ortho rasters);
- ``pairs``: stereo pair batches;
- ``obs``: bundle-adjustment observations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def default_devices(device_type: str = "cuda") -> list:
    """This process's devices: every visible CUDA device
    (``torch.device("cuda", i)``), or the one CPU device. Under an
    initialized ``torch.distributed`` group a process drives one card, its
    current CUDA device (``parallel/distributed.py::initialize_distributed``
    sets it from the local rank), as JAX gives each GPU process its own.

    There is no CPU fallback: asking for CUDA on a machine without it
    raises. This function is the one seam for logical shards: tests and
    ``chip_smoke.py`` patch it to a repeated list (``["cpu"] * 8``,
    ``[cuda:0] * 8``), the twin of XLA's
    ``--xla_force_host_platform_device_count``.
    """
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "default_devices: CUDA was requested but "
                "torch.cuda.is_available() is False"
            )
        if _group_size() is not None:
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def _group_size():
    """The world size of the initialized ``torch.distributed`` group, or
    None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def mesh_devices(device_type: str = "cuda"):
    """(devices, processes) that the drivers build their meshes over.

    Without a process group: this process's :func:`default_devices` and
    ``processes=None`` (a one-process mesh). Under an initialized group
    (also of one rank): every rank's :func:`default_devices` in rank order
    and the rank of each, gathered through the group (every rank must
    call). Ranks that report different device counts raise
    ``RuntimeError``: every rank must hold the same number of shards."""
    local = default_devices(device_type)
    world = _group_size()
    if world is None:
        return local, None
    per_rank = [None] * world
    dist.all_gather_object(per_rank, [str(d) for d in local])
    counts = [len(d) for d in per_rank]
    if len(set(counts)) != 1:
        raise RuntimeError(
            f"mesh_devices: the ranks hold different device counts "
            f"{counts}; every rank must hold the same number of shards")
    devices = [torch.device(d) for ds in per_rank for d in ds]
    processes = [r for r, ds in enumerate(per_rank) for _d in ds]
    return devices, processes


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an object array of ``torch.device`` (row-major: the
    flat shard index is the row-major index over the axes, as JAX's
    device order)."""

    axis_names: Tuple[str, ...]
    devices: np.ndarray  # object array, one axis per name
    # the rank of each shard (the devices' shape), None in one process
    processes: Optional[np.ndarray] = None

    @property
    def shape(self) -> dict:
        """Axis name -> size (read as ``mesh.shape[name]``, as in JAX)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> list:
        """The shards' devices in flat (row-major) order (another rank's
        entries are labels only)."""
        return list(self.devices.reshape(-1))

    @property
    def spans_processes(self) -> bool:
        """Whether the shards live in the ranks of a process group (the
        collectives then exchange through it, also with one rank)."""
        return self.processes is not None

    def local_shards(self) -> list:
        """The flat ids of the shards this process runs (all of them in
        one process)."""
        if self.processes is None:
            return list(range(self.size))
        me = dist.get_rank()
        return [f for f, p in enumerate(self.processes.reshape(-1))
                if p == me]

    def home_device(self) -> torch.device:
        """The device of this process's first shard (where a caller keeps
        what it reads from a replicated result)."""
        return self.flat_devices()[self.local_shards()[0]]


def make_mesh(
    axis_names: Sequence[str] = ("tiles",),
    shape: Optional[Tuple[int, ...]] = None,
    devices=None,
    processes=None,
) -> Mesh:
    """Build a mesh over all (or the given) devices; a device may repeat.

    With ``shape=None`` the first axis absorbs all devices. For 2-D meshes
    (e.g. ("pairs", "tiles")) pass an explicit shape whose product equals
    the device count; a mismatch raises ``ValueError``, as in JAX.
    ``devices=None`` means :func:`mesh_devices` (CUDA; every rank's under a
    process group). ``processes`` gives the rank of each device (a mesh
    across processes must hold a shard of every rank); without it the
    given devices are this process's.
    """
    if devices is None:
        devices, processes = mesh_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name axes "
                         f"{tuple(axis_names)}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices
    if processes is not None:
        processes = np.asarray(list(processes), dtype=np.int64)
        world = _group_size()
        if world is None:
            raise RuntimeError("make_mesh: processes were given but no "
                               "torch.distributed group is initialized")
        if processes.shape != (n,) or \
                sorted(set(processes.tolist())) != list(range(world)):
            raise ValueError(
                f"make_mesh: processes {processes.tolist()} must give one "
                f"rank per device and hold every rank of {world}")
        processes = processes.reshape(shape)
    return Mesh(tuple(axis_names), dev_array.reshape(shape), processes)
