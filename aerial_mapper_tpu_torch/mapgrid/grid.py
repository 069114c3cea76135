"""The map substrate: a dict of ``[H, W]`` float32 layers plus static geometry.

Twin of ``aerial_mapper_tpu/mapgrid/grid.py``. Map state in the port is a
plain ``dict[str, Tensor]``, which every port caller passes: JAX's
``MapState`` NamedTuple exists to make the layers a pytree, and has no
twin. Row 0 is the northern edge, column 0 the
western edge; cell (i, j)'s center is at::

    easting  = center_easting  - delta_easting/2  + (j + 0.5) * resolution
    northing = center_northing + delta_northing/2 - (i + 0.5) * resolution
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from aerial_mapper_tpu_torch.config import GridMapConfig
from aerial_mapper_tpu_torch.device import resolve_device

# The 9 reference layers (aerial-mapper-grid-map.cc:25-28).
LAYERS = (
    "ortho",
    "elevation",
    "elevation_angle",
    "num_observations",
    "elevation_angle_first_view",
    "delta",
    "observation_index",
    "observation_index_first",
    "colored_ortho",
)

_INIT_VALUES = {
    "ortho": 255.0,
    "elevation": float("nan"),
    "elevation_angle": 0.0,
    "num_observations": 0.0,
    "elevation_angle_first_view": float("nan"),
    "delta": float("nan"),
    "observation_index": float("nan"),
    "observation_index_first": float("nan"),
    "colored_ortho": float("nan"),
}


class MapGeometry(NamedTuple):
    """Static (hashable) raster geometry."""

    center_easting: float
    center_northing: float
    resolution: float
    height: int  # rows (northing extent / resolution)
    width: int  # cols (easting extent / resolution)

    @classmethod
    def from_config(cls, cfg: GridMapConfig) -> "MapGeometry":
        return cls(
            center_easting=float(cfg.center_easting),
            center_northing=float(cfg.center_northing),
            resolution=float(cfg.resolution),
            height=cfg.height,
            width=cfg.width,
        )

    @property
    def west(self) -> float:
        return self.center_easting - 0.5 * self.width * self.resolution

    @property
    def north(self) -> float:
        return self.center_northing + 0.5 * self.height * self.resolution

    @property
    def geotransform(self):
        """GDAL-style geotransform (x0, dx, 0, y0, 0, -dy) for GeoTiff
        export."""
        return (self.west, self.resolution, 0.0, self.north, 0.0,
                -self.resolution)


def create_map_state(geom: MapGeometry, device=None,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Fresh layers with the reference's init values."""
    dev = resolve_device(device)
    return {
        name: torch.full((geom.height, geom.width), _INIT_VALUES[name],
                         dtype=dtype, device=dev)
        for name in LAYERS
    }


def cell_centers(geom: MapGeometry, device=None, dtype=torch.float32):
    """Return (easting [H, W], northing [H, W]) cell-center grids."""
    dev = resolve_device(device)
    i = torch.arange(geom.height, dtype=dtype, device=dev)[:, None]
    j = torch.arange(geom.width, dtype=dtype, device=dev)[None, :]
    easting = geom.west + (j + 0.5) * geom.resolution
    northing = geom.north - (i + 0.5) * geom.resolution
    return (easting.expand(geom.height, geom.width),
            northing.expand(geom.height, geom.width))


def position_to_index(geom: MapGeometry, easting, northing):
    """Float (easting, northing) -> (row, col) int32 cell indices (floor).
    Tensors keep their device; other inputs become float32 tensors on the
    CPU."""
    easting = torch.as_tensor(easting, dtype=torch.float32)
    northing = torch.as_tensor(northing, dtype=torch.float32)
    col = torch.floor((easting - geom.west) / geom.resolution).to(torch.int32)
    row = torch.floor((geom.north - northing) / geom.resolution) \
        .to(torch.int32)
    return row, col
