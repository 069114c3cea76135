"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process, all started together,
then linked into one shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``aerial_mapper_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name keyed by a hash of the sources and flags, so
an unchanged tree reuses it and an edited one rebuilds. Nothing here runs at
import time: the first CUDA launch calls :func:`load`.

No ``--use_fast_math``: the IDW kernel's adaptive ladder compares
``d2 < r_eff`` on values from ``logf``/``powf``/``ceilf``, and fast-math
intrinsics would move those knife edges away from the plain version's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signature of each kernel's launcher; each returns cudaGetLastError()
# of its launch (0 = success).
SIGNATURES = {
    # lf, rf, best, bestd, cm, cp, runner, B, H, W, num_disp, min_disp, r,
    # stream (the integer entry of csrc/bm.cu, the float entry's ring and
    # wide kernels)
    "amt_bm_int_launch": [_P] * 7 + [_I] * 6 + [_P],
    "amt_bm_float_launch": [_P] * 7 + [_I] * 6 + [_P],
    "amt_bm_float_wide_launch": [_P] * 7 + [_I] * 6 + [_P],
    # de, dn, payload, count, offsets, num_offsets, values, hit, K, H, W, hw,
    # resolution, radius_sq, adaptive, growth, log_growth, max_r2_tol, stream
    "amt_idw_launch": [_P] * 5 + [_I] + [_P] * 2 + [_I] * 4 + [_F] * 2
    + [_I] + [_F] * 3 + [_P],
    # cells, bank, T, N, grid h (0 = runs of cells), grid w, fx, fy, cx, cy,
    # width, height, best, q, u, v, n_vis, stream
    "amt_score_launch": [_P] * 2 + [_I] * 4 + [_F] * 6 + [_P] * 5 + [_P],
    # cost, out, B, H, W, D, pass, pallas_form, p1, p2, stream
    "amt_sgm_launch": [_P] * 2 + [_I] * 6 + [_F] * 2 + [_P],
    # lf, rf, out, B, H, W, D, min_disp, block, stream (csrc/sgm_cost.cu)
    "amt_sgm_cost_launch": [_P] * 3 + [_I] * 6 + [_P],
    # cost, disp, c0, best, pixels, D, min_disp, stream (csrc/sgm_select.cu)
    "amt_sgm_wta_launch": [_P] * 4 + [_L] + [_I] * 2 + [_P],
    # cost, best, c0, valid, pixels, D, off, factor, stream
    "amt_sgm_uniqueness_launch": [_P] * 4 + [_L] + [_I] * 2 + [_F] + [_P],
    # cost, best, valid, rows, W, D, min_disp, max_diff, stream
    "amt_sgm_lr_launch": [_P] * 3 + [_I] * 5 + [_P],
}

_lib = None
build_log = ""  # nvcc's output (register / shared-memory report)


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of aerial_mapper_tpu_torch "
            "are built from csrc/ at first use and need the CUDA toolkit"
        )
    return nvcc


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libamt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library (if not cached)."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + f".{tag}.o")
            for src in _sources()]
    tmp = out + f".{tag}.tmp"
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_sources(), objs)
        ]
        logs, failed = [], []
        for src, p in zip(_sources(), procs):
            text, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{text}")
            if p.returncode != 0:
                failed.append(os.path.basename(src))
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n{build_log}")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; argtypes set per launcher."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
