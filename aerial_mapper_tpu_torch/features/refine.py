"""End-to-end pose refinement: detect -> match -> tracks -> triangulate ->
BA (twin of ``aerial_mapper_tpu/features/refine.py``, one device).

Refines a PIX4D/COLMAP (or otherwise approximate) trajectory by windowed
bundle adjustment over feature tracks before rasterization. Detection,
description, matching, triangulation and BA run on the device; the host
picks each pair's kept matches (one read per pair) and chains the match
graph into tracks.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from aerial_mapper_tpu_torch.ba.bundle_adjust import BAState, bundle_adjust
from aerial_mapper_tpu_torch.camera.models import Camera
from aerial_mapper_tpu_torch.config import BundleAdjustmentConfig
from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.features.describe import describe_patches
from aerial_mapper_tpu_torch.features.detect import detect_corners
from aerial_mapper_tpu_torch.features.match import (
    epipolar_gate,
    match_descriptors,
)
from aerial_mapper_tpu_torch.features.tracks import (
    build_tracks,
    triangulate_tracks,
)
from aerial_mapper_tpu_torch.io.poses import _rot_matrix_np

logger = logging.getLogger("aerial_mapper_tpu_torch")


def _bucket(x: int, floor: int = 256) -> int:
    """The power of two (at least ``floor``) that holds ``x``."""
    b = floor
    while b < x:
        b *= 2
    return b


def refine_poses(
    images: Sequence,
    quats_G_C: np.ndarray,  # [N, 4] camera-to-world (approximate)
    trans_G_C: np.ndarray,  # [N, 3]
    cam: Camera,
    ba_cfg: BundleAdjustmentConfig = BundleAdjustmentConfig(),
    num_corners: int = 512,
    match_window: int = 2,
    epipolar_threshold_px: float = 4.0,
    min_track_length: int = 2,
    device=None,
):
    """Returns (quats_refined [N, 4], trans_refined [N, 3], stats dict),
    the poses as float64 numpy. ``images`` are [H, W] gray frames (numpy
    arrays or tensors); ``device=None`` means CUDA (raises without it)."""
    dev = resolve_device(device)
    n = len(images)
    uvs, kps, descs, valids = [], [], [], []
    for i in range(n):
        img = torch.as_tensor(images[i], dtype=torch.float32, device=dev)
        uv, score = detect_corners(img, num_corners=num_corners)
        uvs.append(uv)
        kps.append(uv.cpu().numpy())
        descs.append(describe_patches(img, uv))
        valids.append(score > 0)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    Rs = f32(np.stack([_rot_matrix_np(q) for q in np.asarray(quats_G_C)]))
    trans = f32(trans_G_C)
    pair_matches = []
    total_matches = 0
    for i in range(n):
        for j in range(i + 1, min(i + 1 + match_window, n)):
            idx2, matched = match_descriptors(
                descs[i], descs[j], valids[i], valids[j]
            )
            gate = epipolar_gate(
                uvs[i], uvs[j][idx2], Rs[i], trans[i], Rs[j], trans[j],
                cam.fx, cam.fy, cam.cx, cam.cy,
                threshold_px=epipolar_threshold_px,
                cam=cam,  # keypoints live in distorted image space
            )
            # one read per pair: the kept matches go to the host's tracks
            keep = (matched & gate).cpu().numpy()
            ii = np.nonzero(keep)[0]
            if ii.size == 0:
                continue
            pair_matches.append((i, j, ii, idx2.cpu().numpy()[ii]))
            total_matches += ii.size

    problem, num_tracks = build_tracks(
        pair_matches, kps, min_track_length=min_track_length, device=dev
    )
    if num_tracks < 8:
        logger.warning("refine_poses: only %d tracks; returning input poses",
                       num_tracks)
        return quats_G_C, trans_G_C, {"tracks": num_tracks,
                                      "matches": total_matches}

    # bucket observation and landmark counts to powers of two, as the JAX
    # version does for its compiled shapes: padded observations carry
    # valid=False, padded landmarks have no observations (triangulation
    # regularizes them, BA gives them damped no-op solves). The padding
    # fixes the arrays' shapes, and so the sums' order, to JAX's.
    m_real = problem.valid.shape[0]
    problem, _ = build_tracks(
        pair_matches, kps, min_track_length=min_track_length,
        max_observations=_bucket(m_real), device=dev,
    )
    n_lms = _bucket(num_tracks)

    quats = f32(quats_G_C)
    landmarks = triangulate_tracks(
        problem, quats, trans, n_lms, cam.fx, cam.fy, cam.cx, cam.cy,
    )
    state0 = BAState(quats=quats, trans=trans, landmarks=landmarks)
    refined = bundle_adjust(
        state0, problem, cam, ba_cfg,
        n_cams=n, n_lms=n_lms, device=dev,
    )
    stats = {"tracks": num_tracks, "matches": total_matches,
             "observations": m_real}
    logger.info("refine_poses: %s", stats)
    return (
        refined.quats.cpu().numpy().astype(np.float64),
        refined.trans.cpu().numpy().astype(np.float64),
        stats,
    )


def refine_poses_windowed(
    images: Sequence,
    quats_G_C: np.ndarray,
    trans_G_C: np.ndarray,
    cam: Camera,
    window_size: int = 20,
    overlap: int = 5,
    ba_cfg: BundleAdjustmentConfig = BundleAdjustmentConfig(),
    device=None,
    **refine_kwargs,
):
    """Sliding-window pose refinement over long sequences.

    Each window is refined with :func:`refine_poses`; the already-refined
    overlap poses carry the previous window's result forward (they re-enter
    the next window as its initialization, and the position prior in the BA
    keeps the windows consistent). Memory stays bounded by the window size
    regardless of sequence length. ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    n = len(images)
    if n <= window_size:
        return refine_poses(images, quats_G_C, trans_G_C, cam,
                            ba_cfg=ba_cfg, device=dev, **refine_kwargs)

    quats = np.array(quats_G_C, np.float64)
    trans = np.array(trans_G_C, np.float64)
    stats_all = {"tracks": 0, "matches": 0, "windows": 0}
    stride = max(window_size - overlap, 1)
    start = 0
    while start < n - overlap:
        stop = min(start + window_size, n)
        q_w, t_w, stats = refine_poses(
            images[start:stop], quats[start:stop], trans[start:stop], cam,
            ba_cfg=ba_cfg, device=dev, **refine_kwargs,
        )
        quats[start:stop] = q_w
        trans[start:stop] = t_w
        stats_all["tracks"] += stats.get("tracks", 0)
        stats_all["matches"] += stats.get("matches", 0)
        stats_all["windows"] += 1
        if stop == n:
            break
        start += stride
    logger.info("refine_poses_windowed: %s", stats_all)
    return quats, trans, stats_all
