"""Typed stage artifacts: checkpoint/resume between pipeline stages.

Twin of ``aerial_mapper_tpu/io/artifacts.py``, in the same npz format, so a
checkpoint written by either package loads in the other:

- ``points``:  points [N, 3] f32, intensities [N] f32, valid [N] bool
- ``layers``:  the full map layer dict + geometry metadata

Arrays may be numpy or tensors on any device (a tensor is read back once).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry

_SCHEMA_POINTS = 1
_SCHEMA_LAYERS = 1


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tmp_name(filename: str) -> str:
    # atomic write (temp + rename): np.savez appends .npz to names without
    # the suffix, so the temp file carries it (the final name is kept)
    d, base = os.path.split(filename)
    tmp = os.path.join(d, f".tmp{os.getpid()}_{base}")
    return tmp if tmp.endswith(".npz") else tmp + ".npz"


def save_points(filename: str, points, intensities, valid) -> None:
    tmp = _tmp_name(filename)
    np.savez_compressed(
        tmp,
        schema=np.int32(_SCHEMA_POINTS),
        kind="points",
        points=_host(points).astype(np.float32),
        intensities=_host(intensities).astype(np.float32),
        valid=_host(valid).astype(bool),
    )
    os.replace(tmp, filename)


def load_points(filename: str):
    with np.load(filename, allow_pickle=False) as z:
        if str(z["kind"]) != "points":
            raise ValueError(f"{filename} is not a points artifact")
        return z["points"], z["intensities"], z["valid"]


def save_layers(filename: str, layers: Dict, geom: MapGeometry) -> None:
    tmp = _tmp_name(filename)
    payload = {f"layer_{k}": _host(v) for k, v in layers.items()}
    np.savez_compressed(
        tmp,
        schema=np.int32(_SCHEMA_LAYERS),
        kind="layers",
        geom=np.asarray(
            [geom.center_easting, geom.center_northing, geom.resolution,
             geom.height, geom.width],
            np.float64,
        ),
        **payload,
    )
    os.replace(tmp, filename)


def load_layers(filename: str) -> Tuple[Dict[str, np.ndarray], MapGeometry]:
    with np.load(filename, allow_pickle=False) as z:
        if str(z["kind"]) != "layers":
            raise ValueError(f"{filename} is not a layers artifact")
        g = z["geom"]
        geom = MapGeometry(
            center_easting=float(g[0]),
            center_northing=float(g[1]),
            resolution=float(g[2]),
            height=int(g[3]),
            width=int(g[4]),
        )
        layers = {
            k[len("layer_"):]: z[k] for k in z.files if k.startswith("layer_")
        }
    return layers, geom
