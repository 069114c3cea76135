"""Track building (host union-find) and landmark triangulation (twin of
``aerial_mapper_tpu/features/tracks.py``).

Pairwise matches between consecutive frames are chained into multi-frame
tracks with a union-find on the host: orchestration-scale work (thousands
of matches), not kernel work. Triangulation of every track is a batched
linear least squares on the device: for rays (o_i, d_i) the point
minimizing the sum of squared ray distances solves
``sum(I - d d^T) X = sum (I - d d^T) o``, a batched 3x3 solve (the classic
midpoint method). Its per-track sums are the bundle adjustment's
deterministic segment sums.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from aerial_mapper_tpu_torch.ba.bundle_adjust import (
    BAProblem,
    _segment_sum,
    _segments,
)
from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.geo.se3 import quat_rotate


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        while self.parent.setdefault(x, x) != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(
    pair_matches: List[Tuple[int, int, np.ndarray, np.ndarray]],
    keypoints: List[np.ndarray],
    min_track_length: int = 2,
    max_observations: int = 0,
    device=None,
):
    """Chain pairwise matches into tracks.

    ``pair_matches``: list of (frame_i, frame_j, idx_i [M], idx_j [M]).
    ``keypoints``: per-frame [K, 2] pixel arrays.

    Returns a BAProblem (tensors on ``device``, ``None`` meaning CUDA;
    padded to ``max_observations`` if given) plus the track count. Tracks
    observing the same frame twice are dropped (inconsistent chains).
    """
    dev = resolve_device(device)
    uf = _UnionFind()
    for fi, fj, idx_i, idx_j in pair_matches:
        for a, b in zip(np.asarray(idx_i), np.asarray(idx_j)):
            uf.union((fi, int(a)), (fj, int(b)))

    groups = {}
    for key in list(uf.parent.keys()):
        groups.setdefault(uf.find(key), []).append(key)

    cam_idx, lm_idx, uvs = [], [], []
    track_id = 0
    for members in groups.values():
        frames = [m[0] for m in members]
        if len(members) < min_track_length or len(set(frames)) != len(frames):
            continue
        for f, k in members:
            cam_idx.append(f)
            lm_idx.append(track_id)
            uvs.append(keypoints[f][k])
        track_id += 1

    cam_idx = np.asarray(cam_idx, np.int64)
    lm_idx = np.asarray(lm_idx, np.int64)
    uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
    valid = np.ones(cam_idx.shape[0], bool)

    if max_observations:
        pad = max_observations - cam_idx.shape[0]
        if pad < 0:
            raise ValueError("max_observations too small")
        cam_idx = np.pad(cam_idx, (0, pad))
        lm_idx = np.pad(lm_idx, (0, pad))
        uvs = np.pad(uvs, ((0, pad), (0, 0)))
        valid = np.pad(valid, (0, pad))

    problem = BAProblem(
        cam_idx=torch.as_tensor(cam_idx, device=dev),
        lm_idx=torch.as_tensor(lm_idx, device=dev),
        uv=torch.as_tensor(uvs, device=dev),
        valid=torch.as_tensor(valid, device=dev),
    )
    return problem, track_id


def triangulate_tracks(
    problem: BAProblem,
    quats: torch.Tensor,  # [N, 4] camera-to-world
    trans: torch.Tensor,  # [N, 3]
    num_landmarks: int,
    fx: float, fy: float, cx: float, cy: float,
) -> torch.Tensor:
    """[L, 3] midpoint triangulation of every track from all observations,
    on the tensors' device."""
    xn = (problem.uv[:, 0] - cx) / fx
    yn = (problem.uv[:, 1] - cy) / fy
    d_cam = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    q = quats[problem.cam_idx]
    o = trans[problem.cam_idx]
    d = quat_rotate(q, d_cam)  # world-frame ray directions

    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    P = eye[None] - d[:, :, None] * d[:, None, :]  # [M, 3, 3]
    P = torch.where(problem.valid[:, None, None], P, 0.0)
    rhs = torch.einsum("mij,mj->mi", P, o)

    seg = _segments(problem.lm_idx, num_landmarks)
    A = _segment_sum(P, seg)
    b = _segment_sum(rhs, seg)
    # regularize empty/degenerate tracks
    A = A + 1e-6 * eye[None]
    return torch.linalg.solve(A, b[..., None])[..., 0]
