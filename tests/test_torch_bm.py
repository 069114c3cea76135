"""Port block matching (plain version of csrc/bm.cu, on the CPU) vs the JAX
package's fused Pallas matcher in interpret mode, on the same rectified
pairs. Bars: tests/test_pallas_bm.py:101-102 on the exact-parity config;
validity on >= 99.9 % of pixels and disparity atol 1e-5 where both accept
on the default config (the speckle filter's float cumsums round
differently in the two frameworks, so a few knife-edge pixels may flip)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_mapper_tpu.camera import Camera as JCam
from aerial_mapper_tpu.config import BlockMatchingConfig as JBM
from aerial_mapper_tpu.stereo import rectify_pair
from aerial_mapper_tpu.stereo.batched import PairOperands as JOps
from aerial_mapper_tpu.stereo.batched import (
    process_pairs_batched as jax_process_pairs_batched,
)
from aerial_mapper_tpu.stereo.pallas_bm import block_matching_disparity_pallas
from aerial_mapper_tpu.synth import SyntheticScene, make_survey_poses, render_image
from aerial_mapper_tpu_torch.camera.models import Camera as TCam
from aerial_mapper_tpu_torch.config import BlockMatchingConfig as TBM
from aerial_mapper_tpu_torch.stereo.batched import (
    PairOperands,
    process_pairs_batched,
)
from aerial_mapper_tpu_torch.stereo.cuda_bm import (
    FLOAT_RING_MAX_R,
    INT_MAX_BLOCK,
    SMEM_PER_BLOCK,
    block_matching_disparity_cuda,
    bm_scan,
    bm_scan_plain,
    float_entry,
    float_ring_smem,
    float_wide_smem,
)
from aerial_mapper_tpu_torch.stereo.matching import use_integer_costs

torch.set_num_threads(2)

# 100 rows: not a multiple of the Pallas tile (48) nor of the CUDA tile (16)
CAM = dict(fx=160.0, fy=160.0, cx=64.0, cy=50.0, width=128, height=100)
SCENE = SyntheticScene(base_elevation=414.0, relief_amplitude=5.0)


def rect_pair():
    Rs, ts = make_survey_poses(2, altitude=514.0, spacing=6.0)
    cam = JCam(**CAM)
    imgs = [render_image(SCENE, cam, jnp.asarray(R, jnp.float32),
                         jnp.asarray(t, jnp.float32)) for R, t in zip(Rs, ts)]
    rect = rectify_pair(cam.K, Rs[0], Rs[1], ts[0], ts[1], *imgs)
    return (np.array(rect.image_left), np.array(rect.image_right),
            np.array(rect.mask))


def both(cfg_kw, tile_h=48):
    left, right, mask = rect_pair()
    d_jax = np.asarray(block_matching_disparity_pallas(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(mask),
        JBM(**cfg_kw), tile_h=tile_h, interpret=True))
    d_port = block_matching_disparity_cuda(
        torch.as_tensor(left)[None], torch.as_tensor(right)[None],
        torch.as_tensor(mask)[None], TBM(kernel="pallas", **cfg_kw))[0]
    return d_jax, d_port.numpy()


@pytest.mark.parametrize("tile_h", [48, 64])
def test_bm_exact_parity_config_matches_pallas(tile_h):
    d_jax, d_port = both(dict(num_disparities=16, uniqueness_ratio=-1,
                              disp_12_max_diff=-1), tile_h=tile_h)
    assert (d_jax > 1.0).mean() > 0.25
    np.testing.assert_array_equal(d_port > 1.0, d_jax > 1.0)
    np.testing.assert_allclose(d_port, d_jax, atol=1e-5)


def test_bm_default_config_matches_pallas():
    d_jax, d_port = both(dict(num_disparities=16))
    vj, vp = d_jax > 1.0, d_port > 1.0
    assert vj.mean() > 0.2
    assert (vj == vp).mean() >= 0.999
    b = vj & vp
    np.testing.assert_allclose(d_port[b], d_jax[b], atol=1e-5)


def test_bm_scan_is_batched_per_pair():
    """The pair axis is a real batch: each pair's scan equals its own."""
    rng = np.random.default_rng(0)
    lf = torch.as_tensor(rng.integers(0, 62, (3, 21, 37)).astype(np.float32))
    rf = torch.as_tensor(rng.integers(0, 62, (3, 21, 37)).astype(np.float32))
    for integer_costs in (True, False):  # both entries, on the CPU
        full = bm_scan(lf, rf, 9, 1, 5, integer_costs=integer_costs)
        assert full[1].dtype == torch.int32
        for i in range(3):
            one = bm_scan_plain(lf[i:i + 1], rf[i:i + 1], 9, 1, 5)
            for a, b in zip(full, one):
                assert torch.equal(a[i:i + 1], b)


def test_bm_scan_rejects_bad_arguments():
    """The argument checks run before the device dispatch, so the CPU path
    rejects what the kernels reject."""
    lf = torch.zeros(1, 8, 12)
    for integer_costs in (True, False):
        with pytest.raises(ValueError, match="odd block"):
            bm_scan(lf, lf, 4, 0, 4, integer_costs=integer_costs)
        with pytest.raises(ValueError, match="num_disp >= 1"):
            bm_scan(lf, lf, 0, 0, 5, integer_costs=integer_costs)
        with pytest.raises(ValueError, match="min_disp >= 0"):
            bm_scan(lf, lf, 4, -1, 5, integer_costs=integer_costs)
        with pytest.raises(ValueError, match="one device"):
            bm_scan(lf, lf[:, :4], 4, 0, 5, integer_costs=integer_costs)


# ---- a numpy model of csrc/bm.cu's integer kernel, index for index ----

BM_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "aerial_mapper_tpu_torch", "csrc", "bm.cu")


def _tile_constants():
    """The integer kernel's compile-time tile sizes, read from its source."""
    with open(BM_CU) as f:
        src = f.read()
    return [int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in ("TH", "TW", "WARPS", "MAX_R")]


def bm_scan_int_model(lf, rf, num_disp, min_disp, block):
    """``bm_scan_int_kernel`` in numpy: its tiles and halos, byte tiles, the
    right tile's column offsets, disparity chunks of WARPS, the vertical
    running sums (stage A; the leaving row's AD comes from a ring of the
    last 2r+1 ADs), the in-place horizontal running sums one step
    behind (stage B, uint16 storage), the int32 state scan (stage C) and
    the edge rules (AD edge-replicated, right pixel 0-filled, rows
    clamped)."""
    th, tw, warps, max_r = _tile_constants()
    assert th % warps == 0 and tw % 32 == 0 and th == 32
    assert block // 2 <= max_r  # an instantiation exists
    big = 10 ** 9
    b_, h, w = lf.shape
    r = block // 2
    ah, aw = th + 2 * r, tw + 2 * r
    rw = aw + num_disp - 1
    pitch = aw + (6 - aw % 4) % 4
    assert pitch >= aw and pitch % 4 == 2  # stage B conflict-free
    # stage C's thread -> pixel map covers the tile once
    vs = [wid + py * warps for wid in range(warps)
          for py in range(th // warps)]
    us = [lane + px * 32 for lane in range(32) for px in range(tw // 32)]
    assert sorted(vs) == list(range(th)) and sorted(us) == list(range(tw))
    outs = [np.zeros((b_, h, w), np.int64) for _ in range(5)]
    for b in range(b_):
        for v0 in range(0, h, th):
            for u0 in range(0, w, tw):
                rows = np.clip(v0 - r + np.arange(ah), 0, h - 1)
                cols = np.clip(u0 - r + np.arange(aw), 0, w - 1)
                sl = lf[b][rows][:, cols]
                rb = u0 - r - (num_disp - 1) - min_disp
                rc = rb + np.arange(rw)
                sr = np.where((rc >= 0) & (rc < w),
                              rf[b][rows][:, np.clip(rc, 0, w - 1)], 0)
                assert np.all(sl == np.round(sl)) and sl.max() <= 255
                sl = sl.astype(np.uint8).astype(np.int64)
                sr = sr.astype(np.uint8).astype(np.int64)
                best = np.full((th, tw), big)
                cm, cp, prev, runner = (best.copy() for _ in range(4))
                bestd = np.full((th, tw), -2)
                for d0 in range(0, num_disp, warps):
                    dc = min(warps, num_disp - d0)
                    cs = np.zeros((warps, th, pitch), np.int64)
                    for wid in range(dc):  # A: lanes = halo columns
                        d = d0 + wid
                        s = d + min_disp
                        shifted = cols >= s
                        rj = cols - (u0 - r) + (num_disp - 1 - d)
                        assert rj.min() >= 0 and rj.max() < rw
                        ad = np.where(shifted, np.abs(sl - sr[:, rj]), sl)
                        acc = ad[:2 * r + 1].sum(0)
                        ring = list(ad[:2 * r + 1])
                        cs[wid, 0, :aw] = acc
                        for v in range(1, th):
                            slot = (v - 1) % (2 * r + 1)
                            leaving = ring[slot]
                            ring[slot] = ad[v + 2 * r]
                            acc = acc + ad[v + 2 * r] - leaving
                            cs[wid, v, :aw] = acc
                    for wid in range(dc):  # B: lanes = rows, in place
                        row = cs[wid]
                        acc = row[:, :2 * r + 1].sum(1)
                        for u in range(1, tw):
                            leaving = row[:, u - 1].copy()
                            entering = row[:, u + 2 * r].copy()
                            row[:, u - 1] = acc
                            acc = acc + entering - leaving
                        row[:, tw - 1] = acc
                    assert cs.max() < 2 ** 16  # fits the uint16 storage
                    for dd in range(dc):  # C: the state, increasing d
                        d = d0 + dd
                        s = d + min_disp
                        cost = cs[dd, :, :tw].copy()
                        cost[:, u0 + np.arange(tw) < s] = big
                        is_better = cost < best
                        away = np.abs(bestd - d) > 1
                        runner = np.minimum(runner, np.where(
                            is_better, np.where(away, best, big),
                            np.where(away, cost, big)))
                        cp = np.where(d == bestd + 1, cost, cp)
                        cm = np.where(is_better, prev, cm)
                        bestd = np.where(is_better, d, bestd)
                        best = np.minimum(best, cost)
                        prev = cost
                hh, ww = min(th, h - v0), min(tw, w - u0)
                for out, val in zip(outs, (best, bestd, cm, cp, runner)):
                    out[b, v0:v0 + hh, u0:u0 + ww] = val[:hh, :ww]
    return tuple(o.astype(np.int32) if i == 1 else o.astype(np.float32)
                 for i, o in enumerate(outs))


@pytest.mark.parametrize("block,min_disp,num_disp,h,w", [
    (1, 0, 80, 37, 75),    # W < D + r, ragged in both axes
    (5, 3, 40, 37, 75),
    (15, 0, 80, 37, 75),
    (15, 2, 9, 33, 130),   # three column tiles, a one-row last row tile
    (5, 1, 13, 70, 20),    # W < TW, three row tiles
])
def test_bm_int_kernel_model_matches_plain(block, min_disp, num_disp, h, w):
    """The integer kernel's decomposition equals bm_scan_plain bit for bit
    on integer inputs (0..62, the default cap's range)."""
    rng = np.random.default_rng(block * 100 + num_disp)
    lf = rng.integers(0, 63, (2, h, w)).astype(np.float32)
    rf = rng.integers(0, 63, (2, h, w)).astype(np.float32)
    model = bm_scan_int_model(lf, rf, num_disp, min_disp, block)
    plain = bm_scan_plain(torch.as_tensor(lf), torch.as_tensor(rf),
                          num_disp, min_disp, block)
    for name, a, b in zip(("best", "bestd", "cm", "cp", "runner"),
                          model, plain):
        np.testing.assert_array_equal(a, b.numpy(), name)


@pytest.mark.parametrize("block,hi", [
    (41, 10),   # the ring longer than the tile: only rows 0..TH-2 leave
    (127, 3),   # the largest instantiation, at the values cap 1 gives
])
def test_bm_int_kernel_model_large_blocks(block, hi):
    """Blocks past the default, up to the integer guard's limit, with values
    whose window sums stay below 2^15 as use_integer_costs requires."""
    assert (hi - 1) * block ** 2 < 32767
    rng = np.random.default_rng(block)
    lf = rng.integers(0, hi, (1, 37, 75)).astype(np.float32)
    rf = rng.integers(0, hi, (1, 37, 75)).astype(np.float32)
    model = bm_scan_int_model(lf, rf, 12, 2, block)
    plain = bm_scan_plain(torch.as_tensor(lf), torch.as_tensor(rf), 12, 2,
                          block)
    for a, b in zip(model, plain):
        np.testing.assert_array_equal(a, b.numpy())


def test_bm_int_max_block_is_the_integer_guards_limit():
    """The integer kernel is built for every block the guard admits (at cap
    1 the guard's limit is 127), and bm_scan rejects a larger one on every
    device."""
    assert 2 * _tile_constants()[3] + 1 == INT_MAX_BLOCK
    cfg = TBM(pre_filter_cap=1, block_size=INT_MAX_BLOCK)
    assert use_integer_costs(cfg)
    assert not use_integer_costs(TBM(pre_filter_cap=1,
                                     block_size=INT_MAX_BLOCK + 2))
    lf = torch.zeros(1, 8, 12)
    with pytest.raises(ValueError, match="block <= 127"):
        bm_scan(lf, lf, 4, 0, INT_MAX_BLOCK + 2, integer_costs=True)
    bm_scan(lf, lf, 4, 0, INT_MAX_BLOCK + 2, integer_costs=False)


def test_bm_int_kernel_model_worst_case():
    """Left at 2 * cap everywhere, right at 0: the largest window sums
    (62 * 15^2 = 13,950) and the u < min_disp + d border everywhere."""
    lf = np.full((1, 40, 70), 62.0, np.float32)
    rf = np.zeros((1, 40, 70), np.float32)
    model = bm_scan_int_model(lf, rf, 80, 1, 15)
    plain = bm_scan_plain(torch.as_tensor(lf), torch.as_tensor(rf), 80, 1, 15)
    best = plain[0]
    assert float(best[best < 1e9].max()) == 62 * 15 ** 2
    for a, b in zip(model, plain):
        np.testing.assert_array_equal(a, b.numpy())


def test_bm_xla_and_cc_match_jax_and_bad_args_raise():
    """BM ``kernel="xla"`` (through ``process_pairs_batched``) and
    ``speckle_mode="cc"`` (on the fused matcher) run and match the JAX
    package at this file's default-config bars; an unknown kernel or
    matcher raises ValueError."""
    left, right, mask = rect_pair()
    h, w = left.shape
    corners = np.array([[[2.0, 1.0], [w - 3.0, 0.0], [w - 1.0, h - 2.0],
                         [0.0, h - 1.0]]], np.float32)
    arrays = [left[None], right[None], np.eye(3)[None], np.eye(3)[None],
              corners, np.eye(3)[None], np.zeros((1, 3)), np.ones(1)]
    ops = PairOperands(*(torch.as_tensor(np.asarray(a, np.float32))
                         for a in arrays))
    j_ops = JOps(*(jnp.asarray(a, jnp.float32) for a in arrays))
    cfg = dict(num_disparities=16, kernel="xla")
    ref = jax_process_pairs_batched(j_ops, JCam(**CAM), matcher="bm",
                                    bm_cfg=JBM(**cfg), batch_chunk=1)
    ours = process_pairs_batched(ops, TCam(**CAM), TBM(**cfg), device="cpu")
    vj, vp = np.asarray(ref[2]), ours[2].numpy()
    assert vj.mean() > 0.2
    assert (vj == vp).mean() >= 0.999
    b = vj & vp
    np.testing.assert_allclose(ours[0].numpy()[b], np.asarray(ref[0])[b],
                               rtol=1e-5)

    d_jax, d_port = both(dict(num_disparities=16, speckle_mode="cc"))
    vj, vp = d_jax > 1.0, d_port > 1.0
    assert vj.mean() > 0.2
    assert (vj == vp).mean() >= 0.999
    np.testing.assert_allclose(d_port[vj & vp], d_jax[vj & vp], atol=1e-5)

    with pytest.raises(ValueError, match="bm kernel"):
        process_pairs_batched(ops, TCam(**CAM), TBM(kernel="mosaiq"),
                              device="cpu")
    with pytest.raises(ValueError, match="matcher"):
        process_pairs_batched(ops, TCam(**CAM), device="cpu",
                              matcher="census")


# ---- the float path: JAX parity, and a numpy model of its ring kernel ----


@pytest.mark.parametrize("cfg_kw", [
    dict(block_size=25),  # the integer guard sends it to the float path
    dict(block_size=25, uniqueness_ratio=-1, disp_12_max_diff=-1),
    dict(block_size=15, integer_costs=False),
], ids=["block25", "block25-exact", "integer_costs-off"])
def test_bm_float_path_matches_pallas_exactly(cfg_kw):
    """The float path against JAX's Pallas matcher: every disparity equal.
    Exact equality holds (measured on this pair): both fold each window in
    the same order in float32, and the speckle filter gets the same maps."""
    cfg_kw = dict(num_disparities=16, **cfg_kw)
    assert not use_integer_costs(TBM(**cfg_kw))
    d_jax, d_port = both(cfg_kw)
    assert (d_jax > 1.0).mean() > 0.2
    np.testing.assert_array_equal(d_port, d_jax)


def _float_tile_constants():
    """The float ring kernel's tile sizes and largest radius, and the wide
    kernel's tile, read from its source."""
    with open(BM_CU) as f:
        src = f.read()
    return [int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in ("FTH", "FTW", "FWARPS", "FR_MAX", "WTH", "WTW")]


def bm_scan_float_model(lf, rf, num_disp, min_disp, block):
    """``bm_scan_float_kernel`` in numpy, float32 throughout: its tiles and
    halos, the float strips and the right strip's column offsets, disparity
    chunks of FWARPS (vectorised over a chunk's warps), stage A's ring of
    the last 2r+1 ADs down each halo column with each column sum folded
    top-down from the ring, stage B's ring of the last 2r+1 column sums
    along each row with each cost folded left to right and written over
    its column sum, stage C's state scan, and the edge rules (AD
    edge-replicated, right pixel 0-filled, rows clamped)."""
    th, tw, warps, r_max = _float_tile_constants()[:4]
    assert th == 32 and th % warps == 0 and tw % 32 == 0
    r = block // 2
    assert r <= r_max  # an instantiation exists
    k = 2 * r + 1
    big = np.float32(1e9)
    b_, h, w = lf.shape
    ah, aw = th + 2 * r, tw + 2 * r
    rw = aw + num_disp - 1
    pitch = aw | 1
    # stage B's lanes (rows) at one column hit 32 different banks
    assert len({lane * pitch % 32 for lane in range(32)}) == 32
    vs = [wid + py * warps for wid in range(warps)
          for py in range(th // warps)]
    us = [lane + px * 32 for lane in range(32) for px in range(tw // 32)]
    assert sorted(vs) == list(range(th)) and sorted(us) == list(range(tw))
    outs = [np.zeros((b_, h, w), np.float32) for _ in range(5)]
    outs[1] = np.zeros((b_, h, w), np.int32)
    for b in range(b_):
        for v0 in range(0, h, th):
            for u0 in range(0, w, tw):
                rows = np.clip(v0 - r + np.arange(ah), 0, h - 1)
                cols = np.clip(u0 - r + np.arange(aw), 0, w - 1)
                sl = lf[b][rows][:, cols]
                rb = u0 - r - (num_disp - 1) - min_disp
                rc = rb + np.arange(rw)
                sr = np.where((rc >= 0) & (rc < w),
                              rf[b][rows][:, np.clip(rc, 0, w - 1)],
                              np.float32(0))
                best = np.full((th, tw), big, np.float32)
                cm, cp, prev, runner = (best.copy() for _ in range(4))
                bestd = np.full((th, tw), -2, np.int64)
                for d0 in range(0, num_disp, warps):
                    dc = min(warps, num_disp - d0)
                    d = d0 + np.arange(dc)[:, None]  # warp wid: d0 + wid
                    shifted = cols[None, :] >= d + min_disp  # [dc, aw]
                    rj = cols[None, :] - (u0 - r) + (num_disp - 1 - d)
                    assert rj.min() >= 0 and rj.max() < rw
                    cs = np.zeros((dc, th, pitch), np.float32)
                    ring = [None] * k  # A: lanes = halo columns
                    for ti in range(ah):
                        l = np.broadcast_to(sl[ti], (dc, aw))
                        ring[ti % k] = np.where(
                            shifted, np.abs(l - sr[ti][rj]), l)
                        if ti >= 2 * r:
                            v = ti - 2 * r
                            acc = ring[v % k]
                            for o in range(1, k):
                                acc = acc + ring[(v + o) % k]
                            cs[:, v, :aw] = acc
                    ring = [None] * k  # B: lanes = rows, in place
                    for o in range(2 * r):
                        ring[o] = cs[:, :, o].copy()
                    for x in range(tw):
                        ring[(x + 2 * r) % k] = cs[:, :, x + 2 * r].copy()
                        acc = ring[x % k]
                        for o in range(1, k):
                            acc = acc + ring[(x + o) % k]
                        cs[:, :, x] = acc
                    for dd in range(dc):  # C: the state, increasing d
                        dv = d0 + dd
                        cost = cs[dd, :, :tw].copy()
                        cost[:, np.arange(tw) < dv + min_disp - u0] = big
                        is_better = cost < best
                        t = bestd - dv  # the winner's offset from d
                        runner = np.where(
                            (t + 1 < 0) | (t + 1 > 2),
                            np.minimum(runner,
                                       np.where(is_better, best, cost)),
                            runner)
                        cp = np.where(t == -1, cost, cp)
                        cm = np.where(is_better, prev, cm)
                        bestd = np.where(is_better, dv, bestd)
                        best = np.minimum(best, cost)
                        prev = cost
                hh, ww = min(th, h - v0), min(tw, w - u0)
                for out, val in zip(outs, (best, bestd, cm, cp, runner)):
                    out[b, v0:v0 + hh, u0:u0 + ww] = val[:hh, :ww]
    return tuple(outs)


@pytest.mark.parametrize("block,min_disp,num_disp,h,w", [
    (1, 0, 80, 37, 75),    # W < D + r, ragged in both axes
    (5, 3, 40, 37, 75),
    (15, 0, 80, 37, 75),
    (23, 1, 80, 45, 83),   # the first block the guard sends here at cap 31
    (25, 0, 80, 45, 83),
    (15, 2, 9, 33, 130),   # three column tiles, a one-row last row tile
])
def test_bm_float_kernel_model_matches_plain(block, min_disp, num_disp, h,
                                             w):
    """The float ring kernel's decomposition equals bm_scan_plain bit for
    bit on non-integer float32 inputs in the prefilter's range [0, 62]."""
    rng = np.random.default_rng(block * 100 + num_disp)
    lf = rng.uniform(0.0, 62.0, (2, h, w)).astype(np.float32)
    rf = rng.uniform(0.0, 62.0, (2, h, w)).astype(np.float32)
    assert not np.array_equal(lf, np.round(lf))
    model = bm_scan_float_model(lf, rf, num_disp, min_disp, block)
    plain = bm_scan_plain(torch.as_tensor(lf), torch.as_tensor(rf),
                          num_disp, min_disp, block)
    for name, a, b in zip(("best", "bestd", "cm", "cp", "runner"),
                          model, plain):
        np.testing.assert_array_equal(a, b.numpy(), name)


def test_bm_float_entry_choice_matches_the_kernels_source():
    """The wrapper's shared-memory figures and ring limit mirror csrc/bm.cu:
    the ring kernel takes blocks 1..55 at 80 disparities, the wide one
    57..89, and the CUDA branch raises ValueError past that (chosen before
    any launch); the CPU path takes any block."""
    th, tw, warps, r_max, wth, wtw = _float_tile_constants()
    assert r_max == FLOAT_RING_MAX_R
    for r, num_disp in ((7, 80), (12, 80), (30, 256)):
        ah, aw = th + 2 * r, tw + 2 * r
        assert float_ring_smem(r, num_disp) == 4 * (
            warps * th * (aw | 1) + ah * aw + ah * (aw + num_disp - 1))
        ah, aw = wth + 2 * r, wtw + 2 * r
        assert float_wide_smem(r, num_disp) == 4 * (
            2 * ah * aw + ah * (aw + num_disp - 1) + wth * aw)
    ring = [b for b in range(1, 90, 2)
            if float_entry(b, 80) == "amt_bm_float_launch"]
    assert ring == list(range(1, 2 * FLOAT_RING_MAX_R + 2, 2))
    assert float_entry(57, 80) == float_entry(89, 80) \
        == "amt_bm_float_wide_launch"
    assert float_wide_smem(44, 80) <= SMEM_PER_BLOCK \
        < float_wide_smem(45, 80)
    with pytest.raises(ValueError, match="block 91 at 80 disparities"):
        float_entry(91, 80)
    # more disparities widen the right strip: the ring kernel hands over
    # to the wide one at a smaller block
    assert float_entry(55, 256) == "amt_bm_float_wide_launch"
    lf = torch.zeros(1, 6, 9)
    out = bm_scan(lf, lf, 4, 0, 91, integer_costs=False)
    assert torch.equal(out[0], torch.zeros(1, 6, 9))
