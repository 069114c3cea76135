"""Shi-Tomasi corner detection (twin of
``aerial_mapper_tpu/features/detect.py``).

Sobel gradients, the structure tensor summed over a window by the stereo
box filter, non-max suppression as a max-pool comparison, and a fixed-size
corner list: the ``num_corners`` best scores, ties to the lowest flat
index, as ``lax.top_k`` orders them. ``torch.topk`` does not promise that
order, and flat score maps are full of ties (every suppressed pixel scores
-1), so the list comes from a stable descending sort instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aerial_mapper_tpu_torch.stereo.matching import _box_filter, _edge_index


def _gradients(image: torch.Tensor):
    """Sobel gradients (edge-padded)."""
    h, w = image.shape
    p = image.index_select(0, _edge_index(h, 1, 1, image.device))
    p = p.index_select(1, _edge_index(w, 1, 1, image.device))
    gx = (
        (p[:-2, 2:] - p[:-2, :-2])
        + 2.0 * (p[1:-1, 2:] - p[1:-1, :-2])
        + (p[2:, 2:] - p[2:, :-2])
    ) / 8.0
    gy = (
        (p[2:, :-2] - p[:-2, :-2])
        + 2.0 * (p[2:, 1:-1] - p[:-2, 1:-1])
        + (p[2:, 2:] - p[:-2, 2:])
    ) / 8.0
    return gx, gy


def _maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k window maximum of [H, W], SAME size, -inf beyond the edges."""
    return F.max_pool2d(x[None, None], k, stride=1, padding=k // 2)[0, 0]


def detect_corners(
    image: torch.Tensor,
    num_corners: int = 512,
    window: int = 5,
    nms_radius: int = 4,
    border: int = 12,
):
    """Top-K Shi-Tomasi corners of one [H, W] image, on its device.

    Returns (uv [K, 2] float32, score [K]); weak slots have score <= 0 and
    should be masked by callers. Scores are the structure tensor's minimum
    eigenvalue over a ``window`` x ``window`` patch.
    """
    h, w = image.shape
    gx, gy = _gradients(image.float())
    ixx = _box_filter(gx * gx, window)
    iyy = _box_filter(gy * gy, window)
    ixy = _box_filter(gx * gy, window)
    # min eigenvalue of [[ixx, ixy], [ixy, iyy]]
    tr = 0.5 * (ixx + iyy)
    det_rad = torch.sqrt(
        torch.clamp(0.25 * (ixx - iyy) ** 2 + ixy * ixy, min=0.0)
    )
    score = tr - det_rad

    # non-max suppression + border mask
    is_max = score >= _maxpool_same(score, 2 * nms_radius + 1)
    row = torch.arange(h, device=image.device)[:, None]
    col = torch.arange(w, device=image.device)[None, :]
    inside = (
        (row >= border) & (row < h - border)
        & (col >= border) & (col < w - border)
    )
    score = torch.where(is_max & inside, score, -1.0)

    top_scores, top_idx = torch.sort(score.reshape(-1), descending=True,
                                     stable=True)
    top_scores = top_scores[:num_corners]
    top_idx = top_idx[:num_corners]
    uv = torch.stack([(top_idx % w).float(), (top_idx // w).float()],
                     dim=-1)
    return uv, top_scores
