"""ctypes bindings for the native CPU reference loops (twin of
``aerial_mapper_tpu/native.py``).

``native/reference_baseline.cc`` (at the repository's root, beside both
packages) holds the reference's two rasterizing loops in plain C++ with a
thread pool: the backward-grid best-angle ortho
(``backward_grid_baseline``) and the all-neighbours radius-search IDW of
the DSM (``dsm_idw_baseline``). They are an oracle written independently
of the port's kernels and of their plain PyTorch versions, and the CPU
denominator of a benchmark's ``vs_baseline``. They run on the host only.

``load_native`` builds ``native/libambaseline.so`` on first use with
``make -C native libambaseline.so``: that target alone, so the build needs
only a C++ compiler and not the image loader's libjpeg / libpng headers.
It returns None where the library cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_TARGET = "libambaseline.so"
_LIB_PATH = os.path.join(_NATIVE_DIR, _TARGET)

_lib = None


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the baseline library; None on failure."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, _TARGET], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.backward_grid_baseline.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
    ]
    lib.backward_grid_baseline.restype = None
    lib.dsm_idw_baseline.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
    ]
    lib.dsm_idw_baseline.restype = None
    lib.hardware_threads.argtypes = []
    lib.hardware_threads.restype = ctypes.c_int
    _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _require(lib):
    if lib is None:
        raise RuntimeError("native baseline library unavailable")
    return lib


def _threads(lib, num_threads: int) -> int:
    return num_threads if num_threads > 0 else lib.hardware_threads()


def backward_grid_cpu(cells, R_cw, t, images, fx, fy, cx, cy,
                      num_threads: int = 0):
    """Run the native reference backward-grid loop.

    cells [M, 3] f64; R_cw [N, 3, 3] f64 (world->camera); t [N, 3] f64;
    images [N, H, W] f32. Returns (ortho [M], angle [M], obs [M]) f32; a
    cell that no camera sees keeps ortho 255, angle 0 and obs -1.
    """
    lib = _require(load_native())
    cells = np.ascontiguousarray(cells, np.float64)
    R_cw = np.ascontiguousarray(R_cw, np.float64)
    t = np.ascontiguousarray(t, np.float64)
    images = np.ascontiguousarray(images, np.float32)
    m = cells.shape[0]
    n, h, w = images.shape
    if cells.shape != (m, 3) or R_cw.shape != (n, 3, 3) \
            or t.shape != (n, 3):
        raise ValueError(
            f"shapes cells {cells.shape}, R_cw {R_cw.shape}, t {t.shape} "
            f"do not fit {n} images")
    ortho = np.empty(m, np.float32)
    angle = np.empty(m, np.float32)
    obs = np.empty(m, np.float32)
    lib.backward_grid_baseline(
        _ptr(cells, ctypes.c_double), m,
        _ptr(R_cw, ctypes.c_double), _ptr(t, ctypes.c_double), n,
        _ptr(images, ctypes.c_float), h, w,
        float(fx), float(fy), float(cx), float(cy),
        _ptr(ortho, ctypes.c_float), _ptr(angle, ctypes.c_float),
        _ptr(obs, ctypes.c_float), _threads(lib, num_threads),
    )
    return ortho, angle, obs


def dsm_idw_cpu(points, qx, qy, radius_sq, adaptive, growth, max_radius_sq,
                num_threads: int = 0):
    """Run the native reference DSM IDW loop.

    points [N, 3] f64; qx/qy [M] f64 query cell centers.
    Returns (values [M] f32, hit [M] bool).
    """
    lib = _require(load_native())
    points = np.ascontiguousarray(points, np.float64)
    qx = np.ascontiguousarray(qx, np.float64)
    qy = np.ascontiguousarray(qy, np.float64)
    m = qx.shape[0]
    if points.ndim != 2 or points.shape[1] != 3 or qy.shape != (m,) \
            or qx.shape != (m,):
        raise ValueError(f"shapes points {points.shape}, qx {qx.shape}, "
                         f"qy {qy.shape}: want [N, 3], [M] and [M]")
    val = np.empty(m, np.float32)
    hit = np.empty(m, np.uint8)
    lib.dsm_idw_baseline(
        _ptr(points, ctypes.c_double), points.shape[0],
        _ptr(qx, ctypes.c_double), _ptr(qy, ctypes.c_double), m,
        float(radius_sq), int(adaptive), float(growth), float(max_radius_sq),
        _ptr(val, ctypes.c_float), _ptr(hit, ctypes.c_uint8),
        _threads(lib, num_threads),
    )
    return val, hit.astype(bool)


def hardware_threads() -> int:
    """The threads the loops use by default (``num_threads=0``)."""
    return _require(load_native()).hardware_threads()
