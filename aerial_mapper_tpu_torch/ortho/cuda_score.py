"""Best-angle score pass: CUDA kernel ``csrc/score.cu`` (replaces
``ortho/pallas_score.py``). The plain version is
``ortho/backward_grid.py::_score_pass``.

The kernel gives each block a tile of map cells and walks only the cameras
that an exact per-tile cull keeps (see the note in ``csrc/score.cu``).
:func:`tile_camera_mask_plain` is that cull in plain PyTorch, for the tests
and ``chip_smoke.py``; nothing on the main path calls it.
"""

from __future__ import annotations

import torch

from aerial_mapper_tpu_torch import _build
from aerial_mapper_tpu_torch.camera.models import DIST_NONE, Camera
from aerial_mapper_tpu_torch.ortho.backward_grid import _score_pass

TILE = (16, 16)  # csrc/score.cu TILE_H, TILE_W: cells per block with a grid
RUN = 256  # csrc/score.cu RUN: consecutive cells per block without one

# the cull's error factors (csrc/score.cu: G4 = 6 u32, G2 = 3 u32,
# EPS_ABS = 2^-120, Z_MIN = float32 1e-6)
_U32 = 2.0 ** -24
_G4 = 6.0 * _U32
_G2 = 3.0 * _U32
_EPS_ABS = 2.0 ** -120
_Z_MIN = float(torch.tensor(1e-6, dtype=torch.float32).double())


def _tiling(t: int, grid_shape):
    """(gh, gw, th, tw): the cells as a gh x gw grid in th x tw tiles."""
    if grid_shape is None:
        return 1, t, 1, RUN
    gh, gw = (int(s) for s in grid_shape)
    if gh < 1 or gw < 1 or gh * gw != t:
        raise ValueError(f"grid_shape {tuple(grid_shape)} does not hold "
                         f"{t} cells")
    return gh, gw, *TILE


def cell_tiles(t: int, grid_shape=None) -> torch.Tensor:
    """[t] int64: the tile (row-major over the tile grid) of each cell, as
    ``csrc/score.cu`` assigns cells to blocks."""
    gh, gw, th, tw = _tiling(t, grid_shape)
    i = torch.arange(gh)[:, None] // th
    j = torch.arange(gw)[None, :] // tw
    return (i * (-(-gw // tw)) + j).reshape(-1)


def tile_camera_mask_plain(cells: torch.Tensor, bank: torch.Tensor,
                           cam: Camera, grid_shape=None, *,
                           margin_scale: float = 1.0) -> torch.Tensor:
    """[tiles, N] bool: whether ``csrc/score.cu`` keeps camera n for tile i.

    The kernel's float64 formula and margin in its order (``margin_scale``
    only exists to show that the tests can fail without the margin). A
    kept camera may see a cell of the tile; a dropped one sees none.
    """
    t, n = cells.shape[0], bank.shape[0]
    gh, gw, th, tw = _tiling(t, grid_shape)
    ph, pw = -(-gh // th), -(-gw // tw)
    grid = torch.full((ph * th, pw * tw, 3), float("nan"),
                      dtype=torch.float64, device=cells.device)
    grid[:gh, :gw] = cells.double().reshape(gh, gw, 3)
    tiles = grid.reshape(ph, th, pw, tw, 3).permute(0, 2, 1, 3, 4) \
        .reshape(ph * pw, th * tw, 3)
    valid = ~torch.isnan(tiles).any(-1)  # [tiles, cells]
    has_inf = (valid & torch.isinf(tiles).any(-1)).any(1)
    has_valid = valid.any(1)
    lo = torch.where(valid[..., None], tiles, torch.inf).amin(1)  # [tiles, 3]
    hi = torch.where(valid[..., None], tiles, -torch.inf).amax(1)
    # [tiles, 1] each, against [N] camera columns
    bc = [((lo[:, k] + hi[:, k]) * 0.5)[:, None] for k in range(3)]
    bh = [((hi[:, k] - lo[:, k]) * 0.5)[:, None] for k in range(3)]
    ba = [torch.maximum(lo[:, k].abs(), hi[:, k].abs())[:, None]
          for k in range(3)]
    r = bank.double().T  # [12, N]
    cv, rad, e, m = [], [], [], []
    for k in range(3):
        a = r[3 * k:3 * k + 3]
        cv.append(a[0] * bc[0] + a[1] * bc[1] + a[2] * bc[2] - r[9 + k])
        rad.append(a[0].abs() * bh[0] + a[1].abs() * bh[1]
                   + a[2].abs() * bh[2])
        s = (a[0].abs() * ba[0] + a[1].abs() * ba[1] + a[2].abs() * ba[2]
             + r[9 + k].abs())
        e.append(_G4 * s + _EPS_ABS)
        m.append(cv[k].abs() + rad[k] + e[k])
    keep = ~(cv[2] + rad[2] - _Z_MIN < -(e[2] * margin_scale))
    # the kernel's float32 arguments, widened to double as it does
    fx, fy, cx, cy, width, height = torch.tensor(
        [cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height],
        dtype=torch.float32).double().tolist()
    for k, p, q, f in ((0, fx, cx, fx), (0, -fx, width - cx, fx),
                       (1, fy, cy, fy), (1, -fy, height - cy, fy)):
        lc = p * cv[k] + q * cv[2]
        lr = ((p * r[3 * k] + q * r[6]).abs() * bh[0]
              + (p * r[3 * k + 1] + q * r[7]).abs() * bh[1]
              + (p * r[3 * k + 2] + q * r[8]).abs() * bh[2])
        margin = (abs(f) * (_G2 * m[k] + e[k]) + abs(q) * e[2]
                  + (abs(f) + 1.0) * (m[2] * _EPS_ABS))
        keep &= ~(lc + lr < -(margin * margin_scale))
    keep = torch.where(has_inf[:, None], True, keep)
    return keep & has_valid[:, None]


def score_pass_cuda(cells: torch.Tensor, bank: torch.Tensor, cam: Camera, *,
                    grid_shape=None):
    """cells [T, 3] x bank [N, 12] -> (best int32, best_q, u, v, n_vis).

    The CUDA kernel for CUDA tensors, the plain :func:`_score_pass` for CPU
    tensors. Invisible cells get ``best = N`` and ``best_q = -inf``.
    ``grid_shape=(h, w)`` says the cells are a row-major h x w map grid:
    the kernel then culls cameras per 16 x 16 tile, and per run of 256
    cells without it. The result is the same either way.
    """
    if cam.dist_kind != DIST_NONE:
        raise NotImplementedError(
            "score_pass_cuda supports undistorted (pinhole) cameras only; "
            f"got dist_kind={cam.dist_kind!r}"
        )
    if cells.dim() != 2 or cells.shape[1] != 3 or bank.dim() != 2 \
            or bank.shape[1] != 12 or bank.device != cells.device:
        raise ValueError("score_pass_cuda: cells [T, 3] and bank [N, 12] "
                         "on one device")
    gh, gw, _th, _tw = _tiling(cells.shape[0], grid_shape)
    if cells.device.type == "cpu":
        return _score_pass(cells, bank, cam)
    if cells.device.type != "cuda":
        raise ValueError(f"score_pass_cuda: unsupported device {cells.device}")
    cells = cells.float().contiguous()
    bank = bank.float().contiguous()
    if bank.data_ptr() % 16:  # the kernel reads a camera as 3 float4
        bank = bank.clone()
    t, n = cells.shape[0], bank.shape[0]
    best = torch.empty(t, dtype=torch.int32, device=cells.device)
    q, u, v, n_vis = (torch.empty(t, dtype=torch.float32, device=cells.device)
                      for _ in range(4))
    lib = _build.load()
    err = lib.amt_score_launch(
        cells.data_ptr(), bank.data_ptr(), t, n,
        gh if grid_shape is not None else 0, gw, float(cam.fx),
        float(cam.fy), float(cam.cx), float(cam.cy), float(cam.width),
        float(cam.height), best.data_ptr(), q.data_ptr(), u.data_ptr(),
        v.data_ptr(), n_vis.data_ptr(),
        torch.cuda.current_stream(cells.device).cuda_stream,
    )
    _build.check(err, "amt_score_launch")
    score_pass_cuda.launches += 1
    return best, q, u, v, n_vis


score_pass_cuda.launches = 0
