"""Windowed IDW: CUDA kernel ``csrc/idw.cu`` (replaces ``dsm/pallas_idw.py``).

The plain version is ``dsm/idw.py::binned_idw``; the kernel computes the
same function (nearest-distance pass, adaptive ladder, 1/d^2 accumulation
with the exact-match shortcut) bit for bit, with each cell's window split
across 8 lanes, each slot loop cut at ``min(count, K)`` and the second pass
restricted to the offsets with a slot inside the cell's radius.
"""

from __future__ import annotations

import functools
import math

import torch

from aerial_mapper_tpu_torch import _build
from aerial_mapper_tpu_torch.dsm.idw import (
    BinnedPoints,
    _circular_offsets,
    _window_halfwidth,
    binned_idw,
)
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry


@functools.lru_cache(maxsize=16)
def _offsets_table(hw: int, resolution: float, r2_cap: float,
                   device: torch.device) -> torch.Tensor:
    """The window offsets ``[M, 2]`` int32 on ``device``, built once per
    window (a host list and a copy each call would cost more host time
    than the kernel)."""
    return torch.tensor(_circular_offsets(hw, resolution, r2_cap),
                        dtype=torch.int32, device=device).contiguous()


def binned_idw_cuda(binned: BinnedPoints, geom: MapGeometry,
                    radius_sq: float, adaptive: bool = True,
                    growth: float = 1.1, max_radius_sq: float = 7.0):
    """``(values [H, W], hit [H, W] bool)``: the CUDA kernel for CUDA
    tensors, the plain :func:`binned_idw` for CPU tensors."""
    dev = binned.de.device
    if dev.type == "cpu":
        return binned_idw(binned, geom, radius_sq, adaptive, growth,
                          max_radius_sq)
    if dev.type != "cuda":
        raise ValueError(f"binned_idw_cuda: unsupported device {dev}")
    k, h, w = binned.de.shape
    if binned.dn.shape != (k, h, w) or binned.payload.shape != (k, h, w):
        raise ValueError("binned_idw_cuda: de/dn/payload must share [K, H, W]")
    if binned.count.shape != (h, w):
        raise ValueError("binned_idw_cuda: count must be [H, W]")
    r2_cap = max_radius_sq if adaptive else radius_sq
    hw = _window_halfwidth(r2_cap, geom.resolution)
    offs = _offsets_table(hw, float(geom.resolution), float(r2_cap), dev)
    de = binned.de.float().contiguous()
    dn = binned.dn.float().contiguous()
    pl = binned.payload.float().contiguous()
    # slots [count, K) are empty (bin_points): the kernel stops there
    count = binned.count.to(torch.int32).contiguous()
    values = torch.empty((h, w), dtype=torch.float32, device=dev)
    hit = torch.empty((h, w), dtype=torch.bool, device=dev)
    lib = _build.load()
    err = lib.amt_idw_launch(
        de.data_ptr(), dn.data_ptr(), pl.data_ptr(), count.data_ptr(),
        offs.data_ptr(),
        offs.shape[0], values.data_ptr(), hit.data_ptr(), k, h, w, hw,
        float(geom.resolution), float(radius_sq), int(bool(adaptive)),
        float(growth), math.log(growth), max_radius_sq * (1.0 + 1e-6),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "amt_idw_launch")
    binned_idw_cuda.launches += 1
    return values, hit


binned_idw_cuda.launches = 0
