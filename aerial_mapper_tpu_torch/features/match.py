"""Descriptor matching: similarity product + mutual-NN + ratio + epipolar
gate (twin of ``aerial_mapper_tpu/features/match.py``).

One [K, D] @ [D, K] product computes every pairwise zero-mean NCC (in full
float32: the port never turns on TF32); mutual nearest neighbors with
Lowe's ratio test give putative matches; since approximate poses are always
available in this system (PIX4D/COLMAP trajectories), geometric
verification is a vectorized epipolar-distance gate instead of RANSAC.
"""

from __future__ import annotations

import torch

from aerial_mapper_tpu_torch.camera.models import undistort_points


def match_descriptors(
    desc1: torch.Tensor,  # [K, D]
    desc2: torch.Tensor,  # [K, D]
    valid1: torch.Tensor,  # [K] bool (detector score > 0)
    valid2: torch.Tensor,
    min_similarity: float = 0.6,
    ratio: float = 1.0,
):
    """Mutual-NN matches. Returns (idx2_of_1 [K] int64, matched [K] bool):
    corner i of image 1 matches corner idx2_of_1[i] of image 2. Ties go to
    the lowest index (``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does).

    ``ratio`` defaults to 1.0 (off): on repetitive aerial textures the
    second-best NCC is legitimately high; mutual-NN + the epipolar gate do
    the disambiguation. Set ~0.9 for distinctive scenes.
    """
    neg = -2.0
    sim = torch.where(valid1[:, None] & valid2[None, :],
                      desc1.float() @ desc2.float().T, neg)

    best12 = torch.argmax(sim, dim=1)  # [K]
    best21 = torch.argmax(sim, dim=0)  # [K]
    rows = torch.arange(desc1.shape[0], device=sim.device)
    best_sim = sim[rows, best12]

    # Lowe ratio on similarity: second best must be clearly worse
    sim_wo_best = sim.clone()
    sim_wo_best[rows, best12] = neg
    second = torch.amax(sim_wo_best, dim=1)
    mutual = best21[best12] == rows
    matched = mutual & (best_sim > min_similarity) & valid1
    if ratio < 1.0:
        # strict < would also reject EXACT similarity ties at ratio=1.0
        # (repetitive textures, the very case the default disables the
        # test for), so >= 1 skips the comparison entirely
        matched &= second < best_sim * ratio + (1 - ratio) * neg
    return best12, matched


def epipolar_gate(
    uv1: torch.Tensor,  # [K, 2] pixels in image 1
    uv2: torch.Tensor,  # [K, 2] matched pixels in image 2
    R1: torch.Tensor, t1: torch.Tensor,  # camera-to-world pose of image 1
    R2: torch.Tensor, t2: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    threshold_px: float = 3.0,
    cam=None,
):
    """[K] bool: symmetric epipolar distance below threshold.

    E = [t_rel]_x R_rel in camera-2-from-camera-1 coordinates; distances
    are evaluated in pixels using the focal length scale. Pass ``cam`` (a
    ``camera.models.Camera``) when the keypoints live in DISTORTED image
    space: the normalized coordinates are then pushed through
    ``undistort_points`` before the epipolar algebra (a radtan lens
    displaces peripheral pixels by tens of px, far beyond the threshold).
    """
    R_rel = R2.T @ R1  # cam1 -> cam2 rotation
    t_rel = R2.T @ (t1 - t2)  # cam1 origin in cam2 frame
    zero = torch.zeros((), dtype=t_rel.dtype, device=t_rel.device)
    tx = torch.stack([
        torch.stack([zero, -t_rel[2], t_rel[1]]),
        torch.stack([t_rel[2], zero, -t_rel[0]]),
        torch.stack([-t_rel[1], t_rel[0], zero]),
    ])
    E = tx @ R_rel

    def norm_coords(uv):
        return torch.stack(
            [(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
             torch.ones_like(uv[:, 0])],
            dim=-1,
        )

    x1 = norm_coords(uv1)
    x2 = norm_coords(uv2)
    if cam is not None and cam.dist_kind != "none":
        x1 = torch.cat([undistort_points(cam, x1[:, :2]), x1[:, 2:]], dim=-1)
        x2 = torch.cat([undistort_points(cam, x2[:, :2]), x2[:, 2:]], dim=-1)
    Ex1 = x1 @ E.T  # [K, 3] epipolar lines in image 2
    Etx2 = x2 @ E  # lines in image 1
    x2tEx1 = torch.sum(x2 * Ex1, dim=-1)
    f = 0.5 * (fx + fy)
    d2 = x2tEx1**2 * (
        1.0 / torch.clamp(Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2, min=1e-12)
        + 1.0 / torch.clamp(Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2, min=1e-12)
    )
    return torch.sqrt(d2) * f < threshold_px
