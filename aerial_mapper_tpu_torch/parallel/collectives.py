"""Collectives between the shards of a mesh, in one process or across the
ranks of a ``torch.distributed`` group.

JAX takes these from ``jax.lax`` inside ``shard_map``. Here a sharded value
is a list of per-shard tensors in the mesh's flat (row-major) order, and a
collective over one or more named axes acts on each group of shards that
share every coordinate outside those axes; within a group the shards are
ordered by their index along the named axes (row-major in the order the
axes are given), which is JAX's ``axis_index``.

- Every result lands on its shard's device and is a new tensor, also where
  two logical shards share a device: JAX's collectives return values, and
  an in-place write on one shard must never reach another.
- Reductions run in shard order in one place and the total is copied to
  every member, so all members hold the same bits and two runs agree bit
  for bit (no float atomics, no order that depends on timing).
- Callers never move a tensor to another shard's device themselves: this
  module is where the process group takes over the copies.

A mesh across processes (``Mesh.spans_processes``) keeps the same lists,
with ``None`` for the shards of other ranks: :func:`each` runs only this
rank's shards, :func:`replicate` and :func:`scatter` fill them from the
input every rank holds, and every block that a shard reads from ANOTHER
shard travels through the process group (one ``all_to_all_single`` of raw
bytes per collective; also between two shards of one rank, so a group of
one rank runs the same path). Each rank then computes its shards' results
from the same blocks in the same shard order as one process does: every
rank holds the bits of the one-process mesh, and no reduction runs in an
order set by the backend. Gloo moves host tensors (blocks are copied to
the host before the call and to their shard's device after it); NCCL moves
the blocks on this rank's first card. A collective that times out raises,
and there is no fallback to the one-process path.
"""

from __future__ import annotations

import contextlib
import time
from typing import Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from aerial_mapper_tpu_torch.parallel.mesh import Mesh

Axes = Union[str, Sequence[str]]

# what this process sent through the process group: exchanges (collective
# calls), bytes (its send buffers, blocks to its own rank included) and
# host seconds inside the exchanges (with the wait for this rank's queued
# device work before the copy to the host, and for the other ranks)
traffic = {"exchanges": 0, "bytes": 0, "seconds": 0.0}


def _axes(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def groups(mesh: Mesh, axes: Axes) -> list:
    """Flat shard ids of each group over ``axes``: one list per group, in
    axis-index order; groups in flat order of their first member."""
    axes = _axes(axes)
    ids = np.arange(mesh.size).reshape(mesh.devices.shape)
    pos = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(ids.ndim) if i not in pos]
    return np.transpose(ids, rest + pos).reshape(
        -1, axis_size(mesh, axes)).tolist()


def axis_size(mesh: Mesh, axes: Axes) -> int:
    """The number of shards in each group over ``axes`` (JAX's
    ``psum(1, axes)``)."""
    return int(np.prod([mesh.shape[a] for a in _axes(axes)]))


def axis_index(mesh: Mesh, axes: Axes) -> list:
    """Per flat shard: its index within its group over ``axes``."""
    out = [0] * mesh.size
    for g in groups(mesh, axes):
        for i, f in enumerate(g):
            out[f] = i
    return out


def on_shard(device: torch.device):
    """Context in which a shard's work runs: its CUDA device current (a
    launch on another device's stream would fail), nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def each(mesh: Mesh, fn, *per_shard):
    """``[fn(f, *args_f) for each flat shard f]``, each call under
    :func:`on_shard` of its device; ``per_shard`` are lists in flat
    order. Only this rank's shards run; the others' entries are None."""
    devs = mesh.flat_devices()
    out = [None] * mesh.size
    for f in mesh.local_shards():
        with on_shard(devs[f]):
            out[f] = fn(f, *(x[f] for x in per_shard))
    return out


def unzip(xs: list, n: int) -> tuple:
    """A sharded list of n-tuples as n sharded lists (None stays None)."""
    return tuple([None if x is None else x[i] for x in xs]
                 for i in range(n))


def first_local(mesh: Mesh, xs: list):
    """This rank's first shard's entry (a replicated value's replica)."""
    return xs[mesh.local_shards()[0]]


def _send(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A copy of ``x`` on ``dev`` (a new tensor even on the same device)."""
    return x.to(dev, copy=True)


def _piece(x: torch.Tensor, key) -> torch.Tensor:
    """The whole tensor (``key=None``) or block ``i`` of ``n`` along
    ``dim`` (``key=(dim, n, i)``)."""
    if key is None:
        return x
    dim, n, i = key
    return torch.chunk(x, n, dim=dim)[i]


def _exchange(mesh: Mesh, xs: list, needs: list) -> dict:
    """Move pieces between ranks: ``needs`` lists ``(f, key, rank)`` (rank
    reads piece ``key`` of shard f), in an order every rank computes alike.
    One ``all_to_all_single`` of raw bytes; the receiver takes each piece's
    shape and dtype from its own shards (a sharded value's shards share
    them, as under ``shard_map``). Returns ``{(f, key): piece}`` for this
    rank, on the wire device (the host for Gloo)."""
    if not needs:
        return {}
    t0 = time.perf_counter()
    me, world = dist.get_rank(), dist.get_world_size()
    backend = dist.get_backend()
    home = mesh.home_device()
    if backend == "gloo":
        wire = torch.device("cpu")
    elif backend == "nccl":
        if home.type != "cuda":
            raise ValueError("collectives: the NCCL group needs shards on "
                             f"CUDA devices, this rank's first is {home}")
        wire = home
    else:
        raise NotImplementedError(
            f"collectives: process-group backend {backend!r}; use gloo or "
            "nccl")
    owner = mesh.processes.reshape(-1)
    template = first_local(mesh, xs)
    send = [[] for _ in range(world)]
    recv = [[] for _ in range(world)]
    for f, key, q in needs:
        p = int(owner[f])
        if p == me:
            send[q].append(_piece(xs[f], key))
        if q == me:
            recv[p].append((f, key, _piece(template, key)))

    def nbytes(t):
        return t.numel() * t.element_size()

    parts = [t.contiguous().reshape(-1).view(torch.uint8)
             for ts in send for t in ts]
    if len({p.device for p in parts}) > 1:
        parts = [p.to(wire) for p in parts]
    # one copy to the wire for the pieces of one device
    inp = torch.cat(parts).to(wire) if parts else \
        torch.empty(0, dtype=torch.uint8, device=wire)
    out_sizes = [sum(nbytes(t) for _f, _k, t in rs) for rs in recv]
    out = torch.empty(sum(out_sizes), dtype=torch.uint8, device=wire)
    with on_shard(wire):
        dist.all_to_all_single(
            out, inp, output_split_sizes=out_sizes,
            input_split_sizes=[sum(nbytes(t) for t in ts) for ts in send])
    traffic["exchanges"] += 1
    traffic["bytes"] += inp.numel()
    got, off = {}, 0
    for rs in recv:
        for f, key, t in rs:
            n = nbytes(t)
            got[(f, key)] = out[off:off + n].view(t.dtype).reshape(t.shape)
            off += n
    traffic["seconds"] += time.perf_counter() - t0
    return got


def _reader(mesh: Mesh, xs: list, wants: dict):
    """``get(g, f, key)``: piece ``key`` of shard f's tensor as shard g
    reads it. ``wants`` maps every shard g that reads (on any rank) to its
    ``[(f, key)]``, built alike on every rank; across processes the pieces
    with f != g come through :func:`_exchange`."""
    if not mesh.spans_processes:
        return lambda g, f, key=None: _piece(xs[f], key)
    owner = mesh.processes.reshape(-1)
    needs = {}
    for g, pieces in wants.items():
        for f, key in pieces:
            if f != g:
                needs.setdefault((f, key, int(owner[g])), None)
    got = _exchange(mesh, xs, list(needs))

    def get(g, f, key=None):
        return _piece(xs[f], key) if f == g else got[(f, key)]

    return get


def _first_of_each_rank(mesh: Mesh, group: list) -> list:
    """The members of ``group`` that compute for their rank: the first
    member on each rank (every member in one process: the first)."""
    if not mesh.spans_processes:
        return group[:1]
    owner = mesh.processes.reshape(-1)
    seen = {}
    for f in group:
        seen.setdefault(int(owner[f]), f)
    return list(seen.values())


def replicate(mesh: Mesh, x: torch.Tensor) -> list:
    """A read-only operand on every shard: shards that share a device
    share one tensor (its bytes are held once per device). Across
    processes every rank holds ``x`` and fills its own shards."""
    devs = mesh.flat_devices()
    out = [None] * mesh.size
    for f in mesh.local_shards():
        out[f] = x.to(devs[f])
    return out


def scatter(mesh: Mesh, x: torch.Tensor, axes: Axes, dim: int = 0) -> list:
    """Split ``x`` along ``dim`` into ``axis_size(axes)`` equal blocks;
    each shard gets a copy of the block of its index over ``axes`` (so it
    is replicated over the other axes). The length must divide. Across
    processes every rank holds ``x`` and fills its own shards."""
    n = axis_size(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"length {x.shape[dim]} along dim {dim} does not "
                         f"divide into {n} shards")
    blocks = torch.chunk(x, n, dim=dim)
    idx = axis_index(mesh, axes)
    devs = mesh.flat_devices()
    out = [None] * mesh.size
    for f in mesh.local_shards():
        out[f] = _send(blocks[idx[f]], devs[f])
    return out


def concat(mesh: Mesh, xs: list, axes: Axes, dim: int = 0,
           device=None) -> torch.Tensor:
    """The blocks of the first group over ``axes`` (one replica of each),
    concatenated in axis-index order along ``dim`` on ``device`` (default:
    this rank's first shard's device): the inverse of :func:`scatter`.
    Across processes every rank gathers the blocks and gets the whole."""
    g = groups(mesh, axes)[0]
    dev = mesh.home_device() if device is None else torch.device(device)
    # every rank reads the blocks through its first shard
    readers = _first_of_each_rank(mesh, list(range(mesh.size)))
    get = _reader(mesh, xs, {r: [(f, None) for f in g] for r in readers})
    me = mesh.local_shards()[0]
    return torch.cat([get(me, f).to(dev) for f in g], dim=dim)


def ppermute(mesh: Mesh, xs: list, axes: Axes, perm) -> list:
    """Within each group, shard ``src`` sends its tensor to ``dst`` for
    every ``(src, dst)`` of ``perm`` (axis indices); a shard that receives
    nothing gets zeros, as in JAX."""
    devs = mesh.flat_devices()
    pairs = [(g[src], g[dst]) for g in groups(mesh, axes)
             for src, dst in perm]
    wants = {}
    for f, g in pairs:
        wants.setdefault(g, []).append((f, None))
    get = _reader(mesh, xs, wants)
    out = [None] * mesh.size
    local = set(mesh.local_shards())
    for f, g in pairs:
        if g in local:
            out[g] = _send(get(g, f), devs[g])
    for f in local:
        if out[f] is None:
            out[f] = torch.zeros_like(xs[f])
    return out


def _reduce(mesh: Mesh, xs: list, axes: Axes, op) -> list:
    devs = mesh.flat_devices()
    grps = groups(mesh, axes)
    wants = {c: [(f, None) for f in g] for g in grps
             for c in _first_of_each_rank(mesh, g)}
    get = _reader(mesh, xs, wants)
    local = set(mesh.local_shards())
    out = [None] * mesh.size
    for g in grps:
        mine = [f for f in g if f in local]
        if not mine:
            continue
        c = mine[0]
        home = devs[c]
        acc = _send(get(c, g[0]), home)
        for f in g[1:]:
            acc = op(acc, get(c, f).to(home))
        for f in mine:
            out[f] = _send(acc, devs[f])
    return out


def psum(mesh: Mesh, xs: list, axes: Axes) -> list:
    """The sum over each group, added in shard order, on every member."""
    return _reduce(mesh, xs, axes, torch.add)


def pmin(mesh: Mesh, xs: list, axes: Axes) -> list:
    """The elementwise minimum over each group, on every member."""
    return _reduce(mesh, xs, axes, torch.minimum)


def pmax(mesh: Mesh, xs: list, axes: Axes) -> list:
    """The elementwise maximum over each group, on every member."""
    return _reduce(mesh, xs, axes, torch.maximum)


def all_gather(mesh: Mesh, xs: list, axes: Axes, dim: int = 0) -> list:
    """Each group's tensors concatenated along ``dim`` in axis-index order
    (JAX's ``all_gather(..., tiled=True)``), on every member."""
    devs = mesh.flat_devices()
    grps = groups(mesh, axes)
    get = _reader(mesh, xs, {f: [(j, None) for j in g]
                             for g in grps for f in g})
    local = set(mesh.local_shards())
    out = [None] * mesh.size
    for g in grps:
        for f in local.intersection(g):
            out[f] = torch.cat([get(f, j).to(devs[f]) for j in g], dim=dim)
    return out


def all_to_all(mesh: Mesh, xs: list, axes: Axes, split_dim: int = 0,
               concat_dim: int = 0) -> list:
    """Each member splits its tensor along ``split_dim`` into one block per
    member; member i receives block i of every member, concatenated along
    ``concat_dim`` in axis-index order (JAX's ``all_to_all(...,
    tiled=True)``). Every shard's tensor has one shape, as under
    ``shard_map``, so the check below, on this rank's first shard, raises
    alike on every rank before any exchange."""
    devs = mesh.flat_devices()
    grps = groups(mesh, axes)
    n = len(grps[0])
    length = first_local(mesh, xs).shape[split_dim]
    if length % n:
        raise ValueError(
            f"all_to_all: length {length} does not split into {n} blocks")
    get = _reader(mesh, xs, {f: [(j, (split_dim, n, i)) for j in g]
                             for g in grps for i, f in enumerate(g)})
    local = set(mesh.local_shards())
    out = [None] * mesh.size
    for g in grps:
        for i, f in enumerate(g):
            if f in local:
                out[f] = torch.cat(
                    [get(f, j, (split_dim, n, i)).to(devs[f]) for j in g],
                    dim=concat_dim)
    return out


def run_psum_programs(mesh: Mesh, programs: list, axes: Axes) -> list:
    """Run one generator per shard in lock step (the body of a
    ``shard_map`` whose only collective is ``psum``): each ``yield x``
    hands a partial sum to this driver, and the :func:`psum` over
    ``axes`` comes back as the value of the ``yield``. Every program must
    yield the same number of times. Returns each program's return value
    (None for another rank's shards, whose programs never start)."""
    devs = mesh.flat_devices()
    local = mesh.local_shards()

    def step(f, value=None, first=False):
        with on_shard(devs[f]):
            try:
                return False, (next(programs[f]) if first
                               else programs[f].send(value))
            except StopIteration as stop:
                return True, stop.value

    states = {f: step(f, first=True) for f in local}
    while True:
        done = [d for d, _ in states.values()]
        if all(done):
            return [states[f][1] if f in states else None
                    for f in range(mesh.size)]
        if any(done):
            raise RuntimeError("run_psum_programs: the shard programs "
                               "yielded different numbers of partial sums")
        partial = [states[f][1] if f in states else None
                   for f in range(mesh.size)]
        totals = psum(mesh, partial, axes)
        states = {f: step(f, totals[f]) for f in local}
