"""Batched virtual stereo: every pair of the batch in one pass.

Twin of ``aerial_mapper_tpu/stereo/batched.py``. The host prepares per-pair
rectification operands in float64 once (``prepare_pair_operands``); the
rectification remaps, the matcher and triangulation then run on the device
with the pair axis as a real batch dimension (the block-matching kernel is
one launch for the whole batch, or per ``batch_chunk`` pairs).
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from aerial_mapper_tpu_torch.camera.models import Camera
from aerial_mapper_tpu_torch.config import BlockMatchingConfig, SgmConfig
from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.image.sample import point_in_quad
from aerial_mapper_tpu_torch.stereo.cuda_bm import (
    block_matching_disparity_cuda,
)
from aerial_mapper_tpu_torch.stereo.cuda_sgm import sgm_disparity_cuda
from aerial_mapper_tpu_torch.stereo.matching import (
    block_matching_disparity,
    sgm_disparity,
)
from aerial_mapper_tpu_torch.stereo.rectify import (
    _rectify_image,
    rectification_transforms,
)
from aerial_mapper_tpu_torch.stereo.triangulate import triangulate_disparity


class PairOperands(NamedTuple):
    """Per-pair device operands, batch-stacked ([B, ...] each)."""

    image1: torch.Tensor  # [B, H, W] float32
    image2: torch.Tensor
    T1_inv: torch.Tensor  # [B, 3, 3]
    T2_inv: torch.Tensor
    corners_rect: torch.Tensor  # [B, 4, 2]
    R_G_C_rect: torch.Tensor  # [B, 3, 3]
    t_G_C1: torch.Tensor  # [B, 3]
    baseline: torch.Tensor  # [B]


def prepare_pair_operands(
    K: np.ndarray,
    Rs: np.ndarray,  # [N, 3, 3] camera-to-world
    ts: np.ndarray,  # [N, 3]
    images,  # [N, H, W] array, tensor or list
    use_every_nth: int = 1,
    phase: int = None,
    device=None,
) -> PairOperands:
    """Host side: consecutive (subsampled) frames -> stacked pair operands.

    ``phase`` selects which frames the stride keeps; the default is the
    reference's pre-incremented skip counter (frames n-1, 2n-1, ...);
    ``phase=0`` keeps frames 0, n, 2n, ... (the bench workload).
    """
    dev = resolve_device(device)
    if phase is None:
        phase = use_every_nth - 1
    idx = list(range(phase, len(images), use_every_nth)) \
        if use_every_nth > 1 else list(range(len(images)))
    if len(idx) < 2:
        raise ValueError("Need at least two frames for a stereo pair")
    h, w = images[0].shape[-2], images[0].shape[-1]

    T1i, T2i, corners, rrect, bases, t1s, i1s, i2s = ([] for _ in range(8))
    corner_px = np.array(
        [[0.0, 0.0, 1.0], [w - 1.0, 0.0, 1.0], [w - 1.0, h - 1.0, 1.0],
         [0.0, h - 1.0, 1.0]]
    ).T
    for a, b in zip(idx[:-1], idx[1:]):
        tf = rectification_transforms(K, Rs[a], Rs[b], ts[a], ts[b])
        warped = tf.T1 @ corner_px
        corners.append((warped[:2] / warped[2:3]).T)
        T1i.append(np.linalg.inv(tf.T1))
        T2i.append(np.linalg.inv(tf.T2))
        rrect.append(tf.R_G_C_rect)
        bases.append(tf.baseline)
        t1s.append(ts[a])
        i1s.append(a)
        i2s.append(b)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def stack_img(ii):
        return torch.stack(
            [torch.as_tensor(images[i], device=dev).float() for i in ii])

    return PairOperands(
        image1=stack_img(i1s),
        image2=stack_img(i2s),
        T1_inv=f32(np.stack(T1i)),
        T2_inv=f32(np.stack(T2i)),
        corners_rect=f32(np.stack(corners)),
        R_G_C_rect=f32(np.stack(rrect)),
        t_G_C1=f32(np.stack(t1s)),
        baseline=f32(np.asarray(bases)),
    )


def disparity_range_from_slab(
    K: np.ndarray,
    Rs: np.ndarray,  # [N, 3, 3] camera-to-world
    ts: np.ndarray,  # [N, 3]
    image_hw,
    z_min: float,
    z_max: float,
    use_every_nth: int = 1,
    phase: int = None,
    margin_px: float = 8.0,
    quantize: int = 16,
    outlier_factor: float = 3.0,
) -> tuple:
    """(min_disparity, num_disparities) bracketing a world-z slab; host
    float64, the JAX twin's arithmetic.

    The pairs are frames ``phase``, ``phase + n``, ... for ``use_every_nth``
    n; ``phase=None`` means n - 1 (the incremental driver's pairing chain).
    In the rectified frame a pixel
    (u, v) seeing world elevation z has disparity d = b * a(u, v) /
    (z - t_z) with a(u, v) = R_rect[:, 2] . q(u, v) and q = [u - cx,
    (fx/fy)(v - cy), fx] (the Q-matrix triangulation inverted). ``a`` is
    affine in (u, v), so the 4 image corners x the 2 slab ends bound d for
    every pixel whose elevation lies in [z_min, z_max]. The window widens
    by ``margin_px`` and quantizes (min down to a multiple of 8, count up
    to a multiple of ``quantize``). Pairs whose upper bound exceeds
    ``outlier_factor`` x the median pair's (a cross-flight-line turn pair)
    are left out of the window and stay unmatched, as at the fixed
    default. Degenerate geometry (slab at or above the cameras, a
    degenerate range) raises ValueError.
    """
    if phase is None:
        phase = use_every_nth - 1
    n = len(Rs)
    idx = list(range(phase, n, use_every_nth)) \
        if use_every_nth > 1 else list(range(n))
    if len(idx) < 2:
        raise ValueError("need at least two frames for a disparity range")
    h, w = image_hw
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    corners = np.array(
        [[0.0, 0.0], [w - 1.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0]]
    )
    q = np.stack([
        corners[:, 0] - cx,
        (fx / fy) * (corners[:, 1] - cy),
        np.full(4, fx),
    ], axis=0)  # [3, 4]
    pair_lo, pair_hi = [], []
    for a_i, b_i in zip(idx[:-1], idx[1:]):
        tf = rectification_transforms(K, Rs[a_i], Rs[b_i], ts[a_i], ts[b_i])
        a_vals = tf.R_G_C_rect[:, 2] @ q  # [4]
        denom = np.array([z_min, z_max]) - ts[a_i][2]
        if (denom >= 0).any():
            raise ValueError(
                f"slab [{z_min}, {z_max}] reaches camera altitude "
                f"{ts[a_i][2]:.1f} — disparity range undefined"
            )
        d = tf.baseline * a_vals[:, None] / denom[None, :]
        pair_lo.append(float(d.min()))
        pair_hi.append(float(d.max()))
    pair_lo, pair_hi = np.asarray(pair_lo), np.asarray(pair_hi)
    med_hi = float(np.median(pair_hi))
    keep = pair_hi <= outlier_factor * max(med_hi, 1e-9)
    if not keep.any():
        keep = np.ones_like(keep)
    dropped = int((~keep).sum())
    if dropped:
        logging.getLogger("aerial_mapper_tpu_torch").info(
            "disparity_range_from_slab: %d outlier-baseline pair(s) "
            "excluded from the window (max bound %.0f px vs median "
            "%.0f) — they stay unmatched, as at the fixed default",
            dropped, float(pair_hi.max()), med_hi,
        )
    d_lo = float(pair_lo[keep].min())
    d_hi = float(pair_hi[keep].max())
    if not np.isfinite(d_lo) or d_hi <= 0:
        raise ValueError(
            f"degenerate disparity range [{d_lo}, {d_hi}] for slab "
            f"[{z_min}, {z_max}]"
        )
    lo = max(0, int(np.floor((d_lo - margin_px) / 8.0)) * 8)
    hi = d_hi + margin_px
    num = max(quantize, int(np.ceil((hi - lo) / quantize)) * quantize)
    return lo, num


def filter_points_z(points, valid, z_min=None, z_max=None):
    """Opt-in world-z bounds on triangulated points (StereoConfig.z_min /
    z_max); None keeps everything."""
    if z_min is not None:
        valid = valid & (points[..., 2] >= z_min)
    if z_max is not None:
        valid = valid & (points[..., 2] <= z_max)
    return valid


def _process_chunk(ops: PairOperands, cam: Camera, matcher: str,
                   bm_cfg: BlockMatchingConfig, sgm_cfg: SgmConfig):
    """Rectify, match and triangulate one batch of pairs."""
    b, h, w = ops.image1.shape
    dev = ops.image1.device
    rect1 = _rectify_image(ops.image1, ops.T1_inv)
    rect2 = _rectify_image(ops.image2, ops.T2_inv)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    mask = point_in_quad(u, v, ops.corners_rect)  # [B, H, W]
    if matcher == "bm":
        match = (block_matching_disparity_cuda if bm_cfg.kernel == "pallas"
                 else block_matching_disparity)
        disp = match(rect1, rect2, mask, bm_cfg)
    else:
        match = (sgm_disparity_cuda if sgm_cfg.kernel == "pallas"
                 else sgm_disparity)
        disp = match(rect1, rect2, mask, sgm_cfg)
    return triangulate_disparity(
        disp, rect1, ops.R_G_C_rect, ops.t_G_C1, ops.baseline,
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
    )


def process_pairs_batched(ops: PairOperands, cam: Camera,
                          bm_cfg: BlockMatchingConfig = BlockMatchingConfig(),
                          device=None, *, matcher: str = "bm",
                          sgm_cfg: SgmConfig = SgmConfig(),
                          batch_chunk: Optional[int] = None):
    """All pairs -> (points [B, H*W, 3], intensities [B, H*W], valid [B, H*W]).

    ``matcher`` "bm" or "sgm", dispatched as the JAX ``_process_one_pair``:
    BM ``kernel="pallas"`` is the fused scan (``csrc/bm.cu``), "xla" the
    cost-volume matcher; SGM "pallas" is ``sgm_disparity_cuda`` and "xla"
    ``sgm_disparity`` (both scan through ``csrc/sgm.cu``). Kernels run on a
    CUDA device, their plain versions on the CPU.

    ``batch_chunk=None`` matches every pair in one batch (one BM launch);
    an integer processes that many pairs per pass and concatenates the
    results, which bounds the memory of SGM's cost volumes and changes no
    result.
    """
    dev = resolve_device(device)
    if matcher not in ("bm", "sgm"):
        raise ValueError(f"matcher must be 'bm' or 'sgm', got {matcher!r}")
    kernel = bm_cfg.kernel if matcher == "bm" else sgm_cfg.kernel
    if kernel not in ("xla", "pallas"):
        raise ValueError(
            f"{matcher} kernel must be 'xla' or 'pallas', got {kernel!r}"
        )
    if batch_chunk is not None and batch_chunk < 1:
        raise ValueError(f"batch_chunk must be >= 1, got {batch_chunk}")
    ops = PairOperands(*(x.to(dev) for x in ops))
    b = ops.image1.shape[0]
    chunk = b if batch_chunk is None else batch_chunk
    parts = [
        _process_chunk(PairOperands(*(x[i:i + chunk] for x in ops)), cam,
                       matcher, bm_cfg, sgm_cfg)
        for i in range(0, b, chunk)
    ]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p) for p in zip(*parts))
