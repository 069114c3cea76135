"""Ortho backend A: backward-grid projective texturing with best-angle reduce.

Twin of ``aerial_mapper_tpu/ortho/backward_grid.py`` (pinhole cameras).
Two passes over all map cells:

1. score pass: each cell against every camera; the first camera with the
   largest q = z^2/|p|^2 (monotone in the reference's angle score
   ``asin(|z|/|p|)``, ortho-backward-grid.cc:83-87) wins, ties to the lowest
   index (the reference's sequential strict ``>``). ``_score_pass`` is the
   plain version of the CUDA kernel in ``ortho/cuda_score.py``.
2. texel pass: one gather fetches each cell's nearest pixel from its winner.

Invisible cells (no camera sees them): the score pass returns ``best = N``
(one past the last camera) with ``q = -inf``. JAX clamps out-of-range
gather indices silently; PyTorch does not (on CUDA an out-of-range index
is a device-side assert), so ``best`` is clamped to ``N - 1`` before the
texel gather, and ``improved`` (``alpha = -inf`` never improves) keeps such
cells unchanged, as in JAX.
"""

from __future__ import annotations

import torch

from aerial_mapper_tpu_torch.camera.models import DIST_NONE, Camera
from aerial_mapper_tpu_torch.config import OrthoBackwardGridConfig
from aerial_mapper_tpu_torch.geo.se3 import quat_conjugate, quat_to_matrix
from aerial_mapper_tpu_torch.image.color import pack_rgb_to_float
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry


def _alpha_from_q(best_q: torch.Tensor) -> torch.Tensor:
    """Winner score q -> observation angle asin(sqrt(q)); -inf stays -inf."""
    alpha = torch.asin(torch.sqrt(torch.clamp(best_q, 0.0, 1.0)))
    return torch.where(best_q > -torch.inf, alpha,
                       torch.full_like(alpha, -torch.inf))


def camera_bank(R_cw: torch.Tensor, t_G_C: torch.Tensor) -> torch.Tensor:
    """[N, 12] per camera: R_cw row-major, then R_cw @ t (the offsets),
    written as multiply-adds (full float32 on any device)."""
    offs = torch.stack(
        [R_cw[:, i, 0] * t_G_C[:, 0] + R_cw[:, i, 1] * t_G_C[:, 1]
         + R_cw[:, i, 2] * t_G_C[:, 2] for i in range(3)], dim=1)
    return torch.cat([R_cw.reshape(-1, 9), offs], dim=1).contiguous()


def _score_pass(cells: torch.Tensor, bank: torch.Tensor, cam: Camera):
    """Plain PyTorch score pass: cells [T, 3] x bank [N, 12] ->
    (best int32, best_q, u, v, n_vis), all [T].

    The arithmetic of ``pallas_score.py:57-76`` in the same order; the
    first maximum is a masked argmax that takes the first index.
    """
    n = bank.shape[0]
    c0, c1, c2 = cells[:, 0:1], cells[:, 1:2], cells[:, 2:3]  # [T, 1]
    r = bank.T  # [12, N]
    x = c0 * r[0] + c1 * r[1] + c2 * r[2] - r[9]
    y = c0 * r[3] + c1 * r[4] + c2 * r[5] - r[10]
    z = c0 * r[6] + c1 * r[7] + c2 * r[8] - r[11]
    safe_z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    u = cam.fx * (x / safe_z) + cam.cx
    v = cam.fy * (y / safe_z) + cam.cy
    visible = (
        (z > 1e-6)
        & (u >= 0.0) & (v >= 0.0)
        & (u < cam.width) & (v < cam.height)
        & torch.isfinite(u) & torch.isfinite(v)
    )
    q = (z * z) / torch.clamp(x * x + y * y + z * z, min=1e-18)
    q_m = torch.where(visible, q, torch.full_like(q, -torch.inf))
    best_q = q_m.amax(dim=1)
    # first index attaining the max (argmax on uint8 returns the first)
    first = (q_m == best_q[:, None]).to(torch.uint8).argmax(dim=1)
    seen = best_q > -torch.inf
    best = torch.where(seen, first, torch.full_like(first, n))
    bu = torch.where(seen, torch.gather(u, 1, first[:, None])[:, 0], 0.0)
    bv = torch.where(seen, torch.gather(v, 1, first[:, None])[:, 0], 0.0)
    n_vis = visible.float().sum(dim=1)
    return best.to(torch.int32), best_q, bu, bv, n_vis


def _texel_pass(best: torch.Tensor, bu: torch.Tensor, bv: torch.Tensor,
                images: torch.Tensor, colored: bool) -> torch.Tensor:
    """Each cell's nearest texel from its winning camera (clamped lookup,
    ortho-backward-grid.cc:100-103). ``best`` must already be in range."""
    img_h, img_w = images.shape[1], images.shape[2]
    kp_x = torch.clamp(torch.round(bu), 0, img_w - 1).long()
    kp_y = torch.clamp(torch.round(bv), 0, img_h - 1).long()
    texel = images[best.long(), kp_y, kp_x]
    if colored:
        return pack_rgb_to_float(texel.float() / 255.0)
    return texel.float()


def score_operands(layers: dict, quats_G_C: torch.Tensor,
                   t_G_C: torch.Tensor, geom: MapGeometry,
                   cfg: OrthoBackwardGridConfig):
    """The score pass's operands for a map and an image batch: the cells
    ``[H*W, 3]`` (centre easting, northing, and the DSM elevation or the
    flat plane's) and the camera bank of the poses."""
    h, w = layers["elevation_angle"].shape
    dev = layers["elevation_angle"].device
    i = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ce = (geom.west + (j + 0.5) * geom.resolution).expand(h, w)
    cn = (geom.north - (i + 0.5) * geom.resolution).expand(h, w)
    if cfg.use_digital_elevation_map:
        elev = layers["elevation"]
    else:
        elev = torch.full((h, w), cfg.orthomosaic_elevation_m,
                          dtype=layers["elevation"].dtype, device=dev)
    cells = torch.stack([ce.reshape(-1), cn.reshape(-1), elev.reshape(-1)],
                        dim=-1).contiguous()
    R_cw = quat_to_matrix(quat_conjugate(quats_G_C))  # world->cam
    return cells, camera_bank(R_cw, t_G_C)


def backward_grid_update(layers: dict, quats_G_C: torch.Tensor,
                         t_G_C: torch.Tensor, images: torch.Tensor,
                         geom: MapGeometry, cam: Camera,
                         cfg: OrthoBackwardGridConfig,
                         image_ids=None) -> dict:
    """One backward-grid pass over all map cells.

    Updates ``ortho`` (or ``colored_ortho``), ``elevation_angle``,
    ``observation_index`` and ``num_observations`` where a strictly better
    (more nadir) observation exists (ortho-backward-grid.cc:56-121), so
    calling it again with another image batch is the incremental mode.
    ``score_kernel`` "pallas", and "xla" with a pinhole camera, run the
    fused score pass: the CUDA kernel on CUDA, its plain version on CPU.

    ``image_ids`` (optional int [N] tensor): the global index of each image
    operand; ``observation_index`` then holds ``image_ids[best]`` instead
    of the operand slot ``best`` (the multicam incremental driver's global
    ids). Invisible cells index it with the clamped ``best`` and stay
    unchanged through ``improved``.
    """
    from aerial_mapper_tpu_torch.ortho.cuda_score import score_pass_cuda

    if cfg.score_kernel not in ("xla", "pallas"):
        raise ValueError(
            f"score_kernel must be 'xla' or 'pallas', got "
            f"{cfg.score_kernel!r}"
        )
    if cam.dist_kind != DIST_NONE:
        raise NotImplementedError(
            "backward_grid_update: distorted cameras are not ported yet "
            "(ROADMAP queue 1: the distorted-camera ortho); got "
            f"dist_kind={cam.dist_kind!r}"
        )
    h, w = layers["elevation_angle"].shape
    colored = cfg.colored_ortho
    n = quats_G_C.shape[0]
    cells, bank = score_operands(layers, quats_G_C, t_G_C, geom, cfg)
    prev_angle = layers["elevation_angle"].reshape(-1)
    best, best_q, bu, bv, n_vis = score_pass_cuda(cells, bank, cam,
                                                  grid_shape=(h, w))
    best_alpha = _alpha_from_q(best_q)
    # invisible cells carry best = N: clamp before the gather (see module
    # docstring); `improved` masks them below
    best_c = torch.clamp(best, max=n - 1)
    value = _texel_pass(best_c, bu, bv, images, colored)
    improved = (best_alpha > prev_angle) & torch.isfinite(best_alpha)
    if image_ids is None:
        best_idx = best_c.float()
    else:
        best_idx = image_ids[best_c.long()].float()

    new = dict(layers)
    target = "colored_ortho" if colored else "ortho"
    new[target] = torch.where(improved, value, layers[target].reshape(-1)) \
        .reshape(h, w)
    new["elevation_angle"] = torch.where(improved, best_alpha,
                                         prev_angle).reshape(h, w)
    new["observation_index"] = torch.where(
        improved, best_idx,
        layers["observation_index"].reshape(-1)).reshape(h, w)
    new["num_observations"] = layers["num_observations"] \
        + n_vis.reshape(h, w)
    return new
