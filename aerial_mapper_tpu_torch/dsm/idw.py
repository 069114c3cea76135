"""Grid-binned inverse-distance-weighted rasterization.

Twin of ``aerial_mapper_tpu/dsm/idw.py``: points are binned into their
owning map cell (capacity K slots, nearest-K policy), then every query cell
accumulates 1/d^2 weights over a static circular window of cells with the
adaptive radius ladder. ``binned_idw`` is the plain version of the CUDA
kernel in ``dsm/cuda_idw.py`` (which replaces ``dsm/pallas_idw.py``).

Parity notes kept from the reference (``dsm.cc:36-111``): the radius is in
m^2 (nanoflann's squared distances) and the weights are 1/d^2; the adaptive
growth is the closed-form smallest ``radius_sq * growth^k`` strictly above
the nearest squared distance, capped at ``max_radius_sq``; a point exactly
on a cell center short-circuits to its payload.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from aerial_mapper_tpu_torch.config import DsmConfig
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry

_FAR = 1.0e9  # sentinel coordinate offset for empty bin slots
_EXACT_EPS = 1.0e-12  # d^2 below this counts as a perfect match


class BinnedPoints(NamedTuple):
    """Points scattered into per-cell capacity-K slots.

    ``de``/``dn``: [K, H, W] offsets of each stored point from its owning
    cell's center (meters; _FAR for empty slots). ``payload``: [K, H, W].
    ``count``: [H, W] number of points binned (pre-capacity-clip).
    """

    de: torch.Tensor
    dn: torch.Tensor
    payload: torch.Tensor
    count: torch.Tensor


def bin_points(points_xy: torch.Tensor, payload: torch.Tensor,
               valid: torch.Tensor, geom: MapGeometry, capacity: int,
               north=None, west=None, row_offset: int = 0,
               col_offset: int = 0) -> BinnedPoints:
    """Scatter points (x=easting, y=northing) into per-cell slots.

    Out-of-grid points and slots beyond ``capacity`` are dropped; an
    over-capacity cell keeps its K points nearest to its own center, ties by
    input index. ``north``/``west`` are the edges used for cell assignment
    and cell-center arithmetic (default: ``geom``'s); ``row_offset`` /
    ``col_offset`` shift the assigned indices into this grid's frame after
    assignment (the halo-extended grid of ``idw_to_grid``).
    """
    h, w, k = geom.height, geom.width, capacity
    n = points_xy.shape[0]
    dev = points_xy.device
    dtype = points_xy.dtype
    if n == 0:
        return BinnedPoints(
            de=torch.full((k, h, w), _FAR, dtype=dtype, device=dev),
            dn=torch.full((k, h, w), _FAR, dtype=dtype, device=dev),
            payload=torch.zeros((k, h, w), dtype=payload.dtype, device=dev),
            count=torch.zeros((h, w), dtype=torch.int32, device=dev),
        )
    north_edge = geom.north if north is None else north
    west_edge = geom.west if west is None else west

    px, py = points_xy[:, 0], points_xy[:, 1]
    col = torch.floor((px - west_edge) / geom.resolution) + col_offset
    row = torch.floor((north_edge - py) / geom.resolution) + row_offset
    in_map = (valid & (col >= 0) & (col < w) & (row >= 0) & (row < h)
              & torch.isfinite(px) & torch.isfinite(py))
    # clamp in float before the cast: identical to JAX's cast-then-clip on
    # every finite value, and defined for the NaN/inf of invalid points
    coli = torch.nan_to_num(col, nan=0.0).clamp(0, w - 1).long()
    rowi = torch.nan_to_num(row, nan=0.0).clamp(0, h - 1).long()
    cell_id = torch.where(in_map, rowi * w + coli,
                          torch.full_like(coli, h * w))  # invalid: sentinel

    ce = west_edge + ((coli - col_offset).to(dtype) + 0.5) * geom.resolution
    cn = north_edge - ((rowi - row_offset).to(dtype) + 0.5) * geom.resolution
    de_pt = px - ce
    dn_pt = py - cn
    d2_own = de_pt * de_pt + dn_pt * dn_pt
    qscale = float(2 ** 22) / (geom.resolution * geom.resolution * 0.5)
    qd2 = torch.where(in_map, torch.clamp(d2_own * qscale, max=2.0 ** 30),
                      torch.full_like(d2_own, 2.0 ** 30)).long()

    # DETERMINISM: the JAX version runs an unstable 3-key sort over (cell
    # id, quantized own-center distance, point index); it is deterministic
    # because the index key makes every tuple distinct. Here the first two
    # keys are packed into one int64 (qd2 < 2^31) and sorted STABLY, so
    # ties fall to the input index: the same total order, the same slots.
    key = cell_id * (2 ** 31) + qd2
    sorted_key, sorted_idx = torch.sort(key, stable=True)
    sorted_ids = sorted_key >> 31
    # bounds[c] = #sorted ids < c: searchsorted is the exact function the
    # JAX version's two-level block search (_bounds_of_sorted) reproduces
    cells = torch.arange(h * w + 1, dtype=sorted_ids.dtype, device=dev)
    bounds = torch.searchsorted(sorted_ids, cells)
    # slot-major [K, H*W] sorted positions; a plain gather replaces the JAX
    # version's 8-way grouped select (a TPU gather-cost trick)
    pos = bounds[None, :-1] + torch.arange(k, device=dev)[:, None]
    slot_ok = (pos < bounds[None, 1:]).reshape(-1)
    point_idx = sorted_idx[pos.clamp(max=n - 1).reshape(-1)]
    far = torch.full((), _FAR, dtype=dtype, device=dev)
    de = torch.where(slot_ok, de_pt[point_idx], far)
    dn = torch.where(slot_ok, dn_pt[point_idx], far)
    pl = torch.where(slot_ok, payload.to(dtype)[point_idx],
                     torch.zeros((), dtype=dtype, device=dev))
    count = torch.diff(bounds).to(torch.int32)
    return BinnedPoints(
        de=de.reshape(k, h, w),
        dn=dn.reshape(k, h, w),
        payload=pl.to(payload.dtype).reshape(k, h, w),
        count=count.reshape(h, w),
    )


def _window_halfwidth(max_radius_sq: float, resolution: float) -> int:
    """Cells needed so the window covers the max search radius."""
    r_max = math.sqrt(max_radius_sq)
    return max(1, int(math.ceil(r_max / resolution)) + 1)


def _circular_offsets(hw: int, resolution: float, r2_cap: float):
    """Static (oi, oj) window offsets whose cells can contain an in-radius
    point (the others can neither pass ``d2 < r_eff`` nor move the ladder)."""
    win = 2 * hw + 1

    def min_d2(di: int, dj: int) -> float:
        ee = max(abs(dj) - 0.5, 0.0) * resolution
        nn = max(abs(di) - 0.5, 0.0) * resolution
        return ee * ee + nn * nn

    return [
        (oi, oj)
        for oi in range(win)
        for oj in range(win)
        if min_d2(oi - hw, oj - hw) <= r2_cap * (1.0 + 1e-6)
    ]


def _f32(x: float) -> float:
    """A Python float rounded to float32 (what JAX does to a weak scalar)."""
    return float(np.float32(x))


def effective_radius_sq(d2min: torch.Tensor, radius_sq: float,
                        growth: float, max_radius_sq: float) -> torch.Tensor:
    """The adaptive ladder: per cell, the smallest ``radius_sq * growth^k``
    strictly above its nearest squared distance ``d2min`` (``radius_sq``
    when ``d2min`` is inside it), or 0 (no neighbour) past
    ``max_radius_sq``."""
    ratio = torch.clamp(d2min / radius_sq, min=1e-30)
    kk = torch.ceil(torch.log(ratio) / _f32(math.log(growth)))
    g = torch.full_like(kk, growth)
    kk = torch.where(radius_sq * torch.pow(g, kk) <= d2min, kk + 1.0, kk)
    kk = torch.clamp(kk, min=0.0)
    r_eff = radius_sq * torch.pow(g, kk)
    r_eff = torch.where(d2min < radius_sq,
                        torch.full_like(r_eff, radius_sq), r_eff)
    ok = r_eff <= _f32(max_radius_sq * (1.0 + 1e-6))
    return torch.where(ok, r_eff, torch.zeros_like(r_eff))


def binned_idw(binned: BinnedPoints, geom: MapGeometry, radius_sq: float,
               adaptive: bool = True, growth: float = 1.1,
               max_radius_sq: float = 7.0):
    """Plain PyTorch IDW of ``binned.payload`` onto every map cell.

    Returns ``(values [H, W], hit [H, W] bool)``. The arithmetic is that of
    the CUDA kernel (``csrc/idw.cu``) in the same order: the K slots of an
    offset summed in slot order, then added to the running sums.
    """
    k, h, w = binned.de.shape
    dev = binned.de.device
    r2_cap = max_radius_sq if adaptive else radius_sq
    hw = _window_halfwidth(r2_cap, geom.resolution)
    offsets = _circular_offsets(hw, geom.resolution, r2_cap)
    res = _f32(geom.resolution)

    pad = (hw, hw, hw, hw)
    de_p = torch.nn.functional.pad(binned.de, pad, value=_FAR)
    dn_p = torch.nn.functional.pad(binned.dn, pad, value=_FAR)
    pl_p = torch.nn.functional.pad(binned.payload.float(), pad, value=0.0)

    def d2_at(oi, oj):
        de = de_p[:, oi:oi + h, oj:oj + w] + _f32(_f32(oj - hw) * res)
        dn = dn_p[:, oi:oi + h, oj:oj + w] - _f32(_f32(oi - hw) * res)
        return de * de + dn * dn

    if adaptive:
        d2min = torch.full((h, w), _FAR, dtype=torch.float32, device=dev)
        for oi, oj in offsets:
            d2min = torch.minimum(d2min, d2_at(oi, oj).amin(dim=0))
        r_eff = effective_radius_sq(d2min, radius_sq, growth, max_radius_sq)
    else:
        r_eff = torch.full((h, w), radius_sq, dtype=torch.float32,
                           device=dev)

    zeros = torch.zeros((h, w), dtype=torch.float32, device=dev)
    num, den, exact_val = zeros, zeros, zeros
    exact_hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for oi, oj in offsets:
        d2 = d2_at(oi, oj)
        pl = pl_p[:, oi:oi + h, oj:oj + w]
        in_r = d2 < r_eff
        is_exact = in_r & (d2 <= _EXACT_EPS)
        wgt = torch.where(in_r & ~is_exact,
                          1.0 / torch.clamp(d2, min=_EXACT_EPS),
                          torch.zeros_like(d2))
        pnum, pden = zeros, zeros
        for s in range(k):  # slot order, as the kernel sums
            pnum = pnum + wgt[s] * pl[s]
            pden = pden + wgt[s]
        num = num + pnum
        den = den + pden
        any_exact = is_exact.any(dim=0)
        # first exact slot: argmax on uint8 (torch has no argmax on bool)
        slot = is_exact.to(torch.uint8).argmax(dim=0)
        first = torch.gather(pl, 0, slot[None])[0]
        exact_val = torch.where(~exact_hit & any_exact, first, exact_val)
        exact_hit = exact_hit | any_exact

    hit = (den > 0.0) | exact_hit
    values = torch.where(
        exact_hit, exact_val,
        num / torch.where(den > 0.0, den, torch.ones_like(den)))
    return values, hit


def bin_with_halo(points_xy: torch.Tensor, payload: torch.Tensor,
                  valid: torch.Tensor, geom: MapGeometry, capacity: int,
                  window_radius_sq: float):
    """``geom`` grown by the IDW window's half-width on every side and the
    points binned onto it: ``(binned, ext_geom, halo)``, the operands of
    the IDW kernel."""
    halo = _window_halfwidth(window_radius_sq, geom.resolution)
    ext_geom = MapGeometry(
        geom.center_easting, geom.center_northing, geom.resolution,
        geom.height + 2 * halo, geom.width + 2 * halo,
    )
    binned = bin_points(
        points_xy, payload, valid, ext_geom, capacity,
        north=geom.north, west=geom.west,
        row_offset=halo, col_offset=halo,
    )
    return binned, ext_geom, halo


def idw_to_grid(points_xy: torch.Tensor, payload: torch.Tensor,
                valid: torch.Tensor, geom: MapGeometry, capacity: int,
                radius_sq: float, adaptive: bool, growth: float,
                max_radius_sq: float, kernel: str = "pallas"):
    """Bin + IDW onto ``geom``'s grid, halo-extended so points just outside
    the map still contribute to edge cells (the reference's kd-tree holds
    every point, dsm.cc:36-52).

    ``kernel``: "pallas" and "xla" compute the same function
    (``pallas_idw.py:12-15``), so both run the fused path: the CUDA kernel
    for a CUDA tensor, its plain version for a CPU tensor.
    """
    from aerial_mapper_tpu_torch.dsm.cuda_idw import binned_idw_cuda

    if kernel not in ("xla", "pallas"):
        raise ValueError(
            f"idw kernel must be 'xla' or 'pallas', got {kernel!r}"
        )
    binned, ext_geom, halo = bin_with_halo(
        points_xy, payload, valid, geom, capacity,
        max_radius_sq if adaptive else radius_sq)
    values, hit = binned_idw_cuda(
        binned, ext_geom, radius_sq=radius_sq, adaptive=adaptive,
        growth=growth, max_radius_sq=max_radius_sq,
    )
    return (values[halo:halo + geom.height, halo:halo + geom.width],
            hit[halo:halo + geom.height, halo:halo + geom.width])


def update_elevation_layer(map_layers: dict, points_xyz: torch.Tensor,
                           valid: torch.Tensor, geom: MapGeometry,
                           cfg: DsmConfig) -> dict:
    """DSM entry point: IDW of point z onto the ``elevation`` layer; cells
    without neighbours keep their previous value (dsm.cc:186-201)."""
    values, hit = idw_to_grid(
        points_xyz[:, :2], points_xyz[:, 2], valid, geom, cfg.bin_capacity,
        radius_sq=cfg.interpolation_radius_sq,
        adaptive=cfg.adaptive_interpolation,
        growth=cfg.adaptive_growth_factor,
        max_radius_sq=cfg.max_radius_sq,
        kernel=cfg.idw_kernel,
    )
    new = dict(map_layers)
    new["elevation"] = torch.where(hit, values, map_layers["elevation"])
    return new
