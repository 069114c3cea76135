"""Halo exchange for row-band-sharded rasters.

Twin of ``aerial_mapper_tpu/parallel/halo.py``. The DSM's IDW window reads
up to ``halo`` rows beyond a tile boundary; when map row bands live on
different shards those rows come from the neighbours: each shard sends its
top ``halo`` rows to the previous shard and its bottom ``halo`` rows to the
next (two ``ppermute``s), so every local band becomes
[halo + band + halo]. The values are per-shard lists over a mesh
(``parallel/collectives.py``); the exchange runs along ``axis_name`` within
each group of the other axes. The strips are cut with ``each``, so across
processes each rank cuts its own shards' and the strips cross ranks in the
``ppermute``.
"""

from __future__ import annotations

import torch

from aerial_mapper_tpu_torch.parallel import collectives as cl
from aerial_mapper_tpu_torch.parallel.mesh import Mesh


def halo_exchange_rows(mesh: Mesh, bands: list, halo: int,
                       axis_name: str) -> list:
    """[band, W, ...] per shard -> [halo + band + halo, W, ...] with the
    neighbours' rows; the edge tiles get zeros on their outer side (the
    map boundary). A general layer-halo utility: the routed map step uses
    :func:`halo_exchange_extended`, because edge tiles bin their own
    out-of-map halo content, which must not be zeroed."""
    n = cl.axis_size(mesh, axis_name)
    idx = cl.axis_index(mesh, axis_name)
    # my top rows go up (they are the bottom halo there), my bottom rows
    # go down
    from_below = cl.ppermute(mesh, cl.each(mesh, lambda f, x: x[:halo],
                                           bands),
                             axis_name, [(i, i - 1) for i in range(1, n)])
    from_above = cl.ppermute(mesh, cl.each(mesh, lambda f, x: x[-halo:],
                                           bands),
                             axis_name, [(i, i + 1) for i in range(n - 1)])

    def body(f, x, up, down):
        zeros = torch.zeros_like(x[:halo])
        upper = up if idx[f] > 0 else zeros
        lower = down if idx[f] < n - 1 else zeros
        return torch.cat([upper, x, lower], dim=0)

    return cl.each(mesh, body, bands, from_above, from_below)


def halo_exchange_extended(mesh: Mesh, exts: list, halo: int,
                           axis_name: str, axis: int = 0) -> list:
    """Overwrite the halo strips of ALREADY-extended arrays with the
    neighbours' adjacent band rows.

    Each ``exts[f]`` has ``halo + band + halo`` rows along ``axis``; rows
    [halo, halo + band) are the tile's own band. An interior strip becomes
    the neighbour's adjacent BAND rows (the top strip the previous tile's
    last ``halo`` band rows, the bottom strip the next tile's first
    ``halo``); the edge tiles keep their own outer strips (the out-of-map
    halo they binned themselves). ``axis=1`` serves the [K, rows, W] bin
    arrays of the routed DSM band update.
    """
    n = cl.axis_size(mesh, axis_name)
    idx = cl.axis_index(mesh, axis_name)
    xs = cl.each(mesh, lambda f, e: torch.movedim(e, axis, 0), exts)
    band = cl.first_local(mesh, xs).shape[0] - 2 * halo
    from_below = cl.ppermute(
        mesh, cl.each(mesh, lambda f, x: x[halo:2 * halo], xs), axis_name,
        [(i, i - 1) for i in range(1, n)])
    from_above = cl.ppermute(
        mesh, cl.each(mesh, lambda f, x: x[band:band + halo], xs), axis_name,
        [(i, i + 1) for i in range(n - 1)])

    def body(f, x, up, down):
        upper = up if idx[f] > 0 else x[:halo]
        lower = down if idx[f] < n - 1 else x[band + halo:]
        out = torch.cat([upper, x[halo:band + halo], lower], dim=0)
        return torch.movedim(out, 0, axis)

    return cl.each(mesh, body, xs, from_above, from_below)
