"""The per-tile camera cull of csrc/score.cu, on the CPU.

``tile_camera_mask_plain`` is the kernel's cull in plain PyTorch. These
tests show that it is conservative (every pair that ``_score_pass`` finds
visible has its camera kept for that cell's tile), on adversarial inputs
at local and UTM-sized coordinates, and that a tiled scan over the kept
cameras only, the kernel's design, equals ``_score_pass`` bit for bit on all
five outputs. With the margin negated the conservativeness test fails on
cells that project onto the image border."""

import os
import re

import numpy as np
import pytest
import torch

from aerial_mapper_tpu_torch.camera.models import Camera
from aerial_mapper_tpu_torch.ortho.backward_grid import _score_pass, camera_bank
from aerial_mapper_tpu_torch.ortho.cuda_score import (
    RUN,
    TILE,
    cell_tiles,
    score_pass_cuda,
    tile_camera_mask_plain,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = Camera(fx=320.0, fy=320.0, cx=160.0, cy=120.0, width=320, height=240)
UTM = (500000.0, 5000000.0)
GROUND = 410.0


def cameras(n, origin, seed, tilt=0.05, spread=80.0):
    """n near-nadir cameras 104 m above the ground around ``origin``
    (R_G_C, t in float64), then one camera below the ground (every cell is
    behind it) and duplicates of cameras 1 and 2 (ties to the lower
    index)."""
    rng = np.random.default_rng(seed)
    ang = tilt * rng.normal(size=(n, 3))
    R = []
    for a in ang:
        c, s = np.cos(a), np.sin(a)
        rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
        ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
        rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
        R.append(np.diag([1.0, -1.0, -1.0]) @ rx @ ry @ rz)
    R = np.asarray(R)
    t = np.concatenate([rng.random((n, 2)) * spread - spread / 2,
                        np.full((n, 1), GROUND + 104.0)], axis=1)
    t[:, :2] += origin
    R = np.concatenate([R, R[:1], R[1:3]])
    below = t[:1] + [0.0, 0.0, -200.0]
    t = np.concatenate([t, below, t[1:3]])
    return R, t


def bank_of(R_gc, t):
    """The [N, 12] float32 bank as backward_grid_update builds it."""
    R_cw = torch.as_tensor(np.transpose(R_gc, (0, 2, 1)), dtype=torch.float32)
    return camera_bank(R_cw.contiguous(), torch.as_tensor(t, dtype=torch.float32))


def border_cluster(R_gc, t, u, v, ulps, along):
    """16 x 16 float32 cells around the ground point seen at pixel (u, v),
    each a few float32 steps away from it (``along`` 0: easting steps, 1:
    northing steps), so that some cells project just inside the image edge
    and some just outside."""
    d = R_gc @ np.array([(u - CAM.cx) / CAM.fx, (v - CAM.cy) / CAM.fy, 1.0])
    p = t + (GROUND - t[2]) / d[2] * d
    p32 = p.astype(np.float32)
    out = np.repeat(p32[None, None], 16, 0).repeat(16, 1)
    for a in range(16):
        x = p32[along]
        for _ in range(abs(a - 8) * ulps // 8):
            x = np.nextafter(x, np.float32(np.inf if a > 8 else -np.inf))
        out[:, a, along] = x
    for b in range(16):  # elevation steps down the rows
        out[b, :, 2] = np.float32(GROUND) + np.float32(b - 8) * np.float32(3e-5)
    return out


def adversarial(origin, seed=0, n=13, ulps=8):
    """(cells [T, 3] float32, bank, grid_shape) with grid_shape not a
    multiple of the tile: the first 16 rows hold 8 border clusters (four
    image edges of two cameras), the rest a 2 m map grid with a NaN tile,
    NaN rows and +inf / -inf elevations."""
    R, t = cameras(n, origin, seed)
    clusters = []
    for j in (0, 3 if n > 3 else 0):
        for u, v, along in ((0.0, 120.0, 0), (320.0, 120.0, 0),
                            (160.0, 0.0, 1), (160.0, 240.0, 1)):
            clusters.append(border_cluster(R[j], t[j], u, v, ulps, along))
    gh, gw = 37, 16 * len(clusters) + 7
    rng = np.random.default_rng(seed + 1)
    jj, ii = np.meshgrid(np.arange(gw), np.arange(gh))
    grid = np.stack([origin[0] - 135.0 + 2.0 * jj,
                     origin[1] + 37.0 - 2.0 * ii,
                     GROUND + 5.0 * rng.random((gh, gw))], -1)
    grid = grid.astype(np.float32)
    for k, c in enumerate(clusters):
        grid[:16, 16 * k:16 * k + 16] = c
    grid[16:32, 16:32, 2] = np.nan  # a tile the DSM has not reached
    grid[34:, :, 2] = np.nan  # NaN rows in the ragged last tile row
    grid[20, 40, 2] = np.inf
    grid[25, 100, 2] = -np.inf
    cells = torch.as_tensor(grid.reshape(-1, 3))
    return cells, bank_of(R, t), (gh, gw)


def visible_pairs(cells, bank):
    """[T, N] bool: the pairs that _score_pass finds visible (its n_vis
    with one camera at a time)."""
    return torch.stack([_score_pass(cells, bank[c:c + 1], CAM)[4] > 0
                        for c in range(bank.shape[0])], dim=1)


def missed_pairs(cells, bank, grid_shape, margin_scale=1.0):
    """Visible pairs whose camera the cull drops for the cell's tile."""
    mask = tile_camera_mask_plain(cells, bank, CAM, grid_shape,
                                  margin_scale=margin_scale)
    kept = mask[cell_tiles(cells.shape[0], grid_shape)]
    vis = visible_pairs(cells, bank)
    return int((vis & ~kept).sum()), int(vis.sum()), mask


def tiled_scan(cells, bank, grid_shape):
    """The kernel's design in plain PyTorch: each tile runs _score_pass on
    its kept cameras only; winners map back to bank indices."""
    t, n = cells.shape[0], bank.shape[0]
    mask = tile_camera_mask_plain(cells, bank, CAM, grid_shape)
    tiles = cell_tiles(t, grid_shape)
    best = torch.full((t,), n, dtype=torch.int32)
    q = torch.full((t,), -torch.inf)
    u, v, nv = torch.zeros(t), torch.zeros(t), torch.zeros(t)
    for i in range(mask.shape[0]):
        sel = (tiles == i).nonzero()[:, 0]
        kept = mask[i].nonzero()[:, 0]
        if len(sel) == 0 or len(kept) == 0:
            continue
        b, q[sel], u[sel], v[sel], nv[sel] = _score_pass(cells[sel],
                                                         bank[kept], CAM)
        seen = b < len(kept)
        best[sel] = torch.where(seen, kept[b.clamp(max=len(kept) - 1)]
                                .to(torch.int32), n)
    return best, q, u, v, nv


def test_tile_constants_match_the_kernel():
    with open(os.path.join(ROOT, "aerial_mapper_tpu_torch", "csrc",
                           "score.cu")) as f:
        src = f.read()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert (int(const("TILE_H")), int(const("TILE_W"))) == TILE
    assert int(const("RUN")) == RUN
    assert const("G4") == "6.0 * U32" and const("G2") == "3.0 * U32"
    assert float(const("EPS_ABS")) == 2.0 ** -120


@pytest.mark.parametrize("origin", [(0.0, 0.0), UTM], ids=["local", "utm"])
@pytest.mark.parametrize("tiled", [True, False], ids=["tiles", "runs"])
def test_cull_keeps_every_visible_pair(origin, tiled):
    cells, bank, grid_shape = adversarial(origin)
    missed, n_vis, mask = missed_pairs(cells, bank,
                                       grid_shape if tiled else None)
    assert n_vis > 1000
    assert missed == 0
    # the cull does work: the camera below the ground is dropped everywhere
    # but in the (at most two) tiles with an infinite elevation
    assert 0 < mask[:, 13].sum() <= 2
    assert mask.float().mean() < 1.0


@pytest.mark.parametrize("origin", [(0.0, 0.0), UTM], ids=["local", "utm"])
def test_border_cells_are_visible_at_each_edge(origin):
    """The border clusters straddle each image edge: for each, some cells
    are visible and some are not, and the nearest visible one projects
    within one float32 step of the edge (1.5 px for a northing of 5e6 m)."""
    cells, bank, (gh, gw) = adversarial(origin)
    grid = cells.reshape(gh, gw, 3)
    for k, j in enumerate((0, 0, 0, 0, 3, 3, 3, 3)):
        c = grid[:16, 16 * k:16 * k + 16].reshape(-1, 3)
        _b, _q, u, v, nv = _score_pass(c, bank[j:j + 1], CAM)
        assert 0 < int(nv.sum()) < 256, (k, int(nv.sum()))
        edge = (u, u, v, v)[k % 4][nv > 0]
        target = (0.0, 320.0, 0.0, 240.0)[k % 4]
        assert (edge - target).abs().min() < 2.0


@pytest.mark.parametrize("origin", [(0.0, 0.0), UTM], ids=["local", "utm"])
def test_cull_without_its_margin_misses_border_pairs(origin):
    """The mutation check: with the margin negated the cull drops cameras
    that see border cells, so the conservativeness test can fail."""
    cells, bank, grid_shape = adversarial(origin, ulps=2)
    missed, _n, _m = missed_pairs(cells, bank, grid_shape, margin_scale=-1.0)
    assert missed > 0
    missed, _n, _m = missed_pairs(cells, bank, grid_shape)
    assert missed == 0


@pytest.mark.parametrize("n_cams,origin,tiled", [
    (13, (0.0, 0.0), True), (13, UTM, True), (13, (0.0, 0.0), False),
    (300, (0.0, 0.0), True), (1, (0.0, 0.0), True)],
    ids=["local", "utm", "runs", "n300", "n1"])
def test_tiled_scan_over_kept_cameras_is_bit_equal(n_cams, origin, tiled):
    cells, bank, grid_shape = adversarial(origin, n=n_cams)
    if n_cams == 1:
        bank = bank[:1]
    assert bank.shape[0] == max(n_cams + 3 * (n_cams > 1), 1)
    gs = grid_shape if tiled else None
    ref = _score_pass(cells, bank, CAM)
    got = tiled_scan(cells, bank, gs)
    for name, a, b in zip(("best", "q", "u", "v", "n_vis"), got, ref):
        assert torch.equal(a, b), name
    assert (ref[0] < bank.shape[0]).any()
    # the wrapper's CPU path is the plain version with or without a grid
    for a, b in zip(score_pass_cuda(cells, bank, CAM, grid_shape=gs), ref):
        assert torch.equal(a, b)


def test_duplicate_cameras_tie_to_the_lower_index():
    cells, bank, grid_shape = adversarial((0.0, 0.0), n=13)
    best = tiled_scan(cells, bank, grid_shape)[0]
    # cameras 14 and 15 duplicate cameras 1 and 2: never a winner
    assert ((best == 1) | (best == 2)).any()
    assert not ((best == 14) | (best == 15)).any()


def test_tiles_keep_fewer_pairs_than_runs_on_a_survey_map():
    """On a map far larger than one footprint the tiles drop most cameras,
    and keep fewer than runs of 256 cells; every visible pair stays."""
    rng = np.random.default_rng(5)
    R, t = cameras(40, (0.0, 0.0), seed=4, tilt=0.01, spread=360.0)
    jj, ii = np.meshgrid(np.arange(100), np.arange(100))
    cells = np.stack([-198.0 + 4.0 * jj, 198.0 - 4.0 * ii,
                      GROUND + 5.0 * rng.random((100, 100))], -1)
    cells = torch.as_tensor(cells.reshape(-1, 3).astype(np.float32))
    bank = bank_of(R, t)
    shares = {}
    for gs in ((100, 100), None):
        missed, n_vis, mask = missed_pairs(cells, bank, gs)
        assert missed == 0
        kept = mask[cell_tiles(cells.shape[0], gs)].float().mean().item()
        shares[gs] = (kept, n_vis / mask.shape[1] / cells.shape[0])
    kept_tiles, vis_share = shares[(100, 100)]
    assert vis_share <= kept_tiles < 0.3
    assert kept_tiles < shares[None][0]


def test_grid_shape_must_hold_the_cells():
    cells, bank, (gh, gw) = adversarial((0.0, 0.0))
    with pytest.raises(ValueError, match="grid_shape"):
        score_pass_cuda(cells, bank, CAM, grid_shape=(gh, gw + 1))
    with pytest.raises(ValueError, match="grid_shape"):
        tile_camera_mask_plain(cells, bank, CAM, (gh + 1, gw))
    tiles = cell_tiles(gh * gw, (gh, gw)).reshape(gh, gw)
    assert tiles[0, 0] == 0 and tiles[15, 15] == 0 and tiles[16, 0] == 9
    assert int(tiles.max()) + 1 == -(-gh // 16) * -(-gw // 16)
    assert torch.equal(cell_tiles(600), torch.arange(600) // RUN)
