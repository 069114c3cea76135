"""SGM's cost and post-filter kernels (``csrc/sgm_cost.cu``,
``csrc/sgm_select.cu``) on the CPU: their plain versions, and numpy models
of each kernel's own formulation, held to each other and to the PyTorch ops
that the SGM route used before.

- The cost's plain version (``sgm_cost_volume_plain``: shifted-slice window
  sums, rows then columns) against the cumsum-difference route
  (``_box_filter``): exactly equal on integer-valued images, where every sum
  is exact in both; on float images at rtol 1e-6 beside an atol of the
  cumsum route's own rounding (its prefix sums carry ~eps of the running
  total, not of the window), and against the float64 window mean of the same
  BT values at rtol (2k - 1) eps, the bound of k - 1 + k - 1 float32 adds of
  nonnegative terms and one division.
- The cost kernel's model (the BT of each clamped cost-plane column against
  the right image at column c - min_disp - d, 0 where that is < 0; the ring
  of K rows; K columns; the division) equals the plain version bit for bit.
- The post-filter kernels' models (WTA: the minimum, then the first d that
  holds it; the runner-up from 1e9 down; the LR check's column
  minima along the diagonals and its per-pixel test) equal the plain
  versions, which are the PyTorch functions on the volume's [..., D, H, W]
  view, bit for bit, on volumes with ties, all-1e9 columns and rows, and on
  a real aggregated volume.
- The port's SGM cost (``_sgm_cost``, now the cost kernel's plain version)
  against the cost that the JAX ``sgm_disparity`` builds: exact on
  integer-valued images, at the float bars above otherwise.
- On a CPU tensor the SGM route takes the plain versions and counts no
  launch; other devices raise before any launch; the BM cost-volume path
  never reaches the SGM wrappers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_mapper_tpu.stereo import matching as jm
from aerial_mapper_tpu_torch.config import BlockMatchingConfig, SgmConfig
from aerial_mapper_tpu_torch.stereo import matching as tm
from aerial_mapper_tpu_torch.stereo.cuda_sgm import (
    aggregate_passes,
    sgm_disparity_cuda,
)

torch.set_num_threads(2)

F32 = np.float32
EPS32 = float(np.finfo(np.float32).eps)
BIG = F32(1e9)
WRAPPERS = ("sgm_cost_volume", "sgm_wta", "sgm_uniqueness", "sgm_lr_check")


def launches():
    return {name: getattr(tm, name).launches for name in WRAPPERS}


def sobel_pair(rng, b=2, h=23, w=41, integer=False):
    """x-Sobel images of a random pair, as ``_sgm_cost`` makes them."""
    left = rng.uniform(0, 255, (b, h, w))
    right = rng.uniform(0, 255, (b, h, w))
    if integer:
        left, right = np.round(left), np.round(right)
    return (tm._xsobel_prefilter(torch.tensor(x, dtype=torch.float32), 35.0)
            for x in (left, right))


def cumsum_route(lf, rf, num_disp, min_disp, k):
    """The SGM cost as the route before the kernel built it: BT, the
    cumsum-difference box filter, the border, the copy to D last."""
    h, w = lf.shape[-2:]
    cost = tm._bt_cost(lf, rf, num_disp, min_disp)
    if k > 1:
        cost = tm._box_filter(cost, k) / float(k * k)
    border = tm._border_mask(h, w, num_disp, min_disp, lf.device)
    return torch.where(border, cost, 1e4).movedim(-3, -1).contiguous()


def window_mean64(bt, k):
    """float64 mean over the k x k window (edge-padded) of BT [..., H, W]."""
    r = k // 2
    pad = [(0, 0)] * (bt.ndim - 2) + [(r, k - 1 - r)] * 2
    p = np.pad(bt.astype(np.float64), pad, mode="edge")
    h, w = bt.shape[-2:]
    out = np.zeros(bt.shape)
    for i in range(k):
        for j in range(k):
            out += p[..., i:i + h, j:j + w]
    return out / (k * k)


@pytest.mark.parametrize("k,min_disp", [(1, 0), (3, 1), (8, 2), (9, 1),
                                        (15, 0)])
@pytest.mark.parametrize("integer", [True, False])
def test_cost_plain_against_cumsum_route(k, min_disp, integer):
    rng = np.random.default_rng(k + 20 * integer)
    lf, rf = sobel_pair(rng, integer=integer)
    d = 24
    ours = tm.sgm_cost_volume_plain(lf, rf, d, min_disp, k)
    ref = cumsum_route(lf, rf, d, min_disp, k)
    assert ours.shape == (2, 23, 41, d)
    if integer:  # half-integer BT values: every sum exact in both routes
        assert torch.equal(ours, ref)
        return
    # the cumsum route rounds on its prefix sums: the second pass's running
    # total reaches (W + k) window sums of k BT values at most
    bt = tm._bt_cost(lf, rf, d, min_disp)
    prefix = (41 + k) * k * float(bt.max())
    np.testing.assert_allclose(ours, ref, rtol=1e-6,
                               atol=4 * EPS32 * prefix / (k * k))
    exact = window_mean64(bt.numpy(), k)
    border = tm._border_mask(23, 41, d, min_disp, "cpu").numpy()
    exact = np.moveaxis(np.where(border, exact, 1e4), -3, -1)
    np.testing.assert_allclose(ours.numpy(), exact,
                               rtol=(2 * k - 1) * EPS32, atol=0)


@pytest.mark.parametrize("integer", [True, False])
def test_sgm_cost_matches_jax(integer):
    """``_sgm_cost`` against the cost of the JAX ``sgm_disparity`` (x-Sobel,
    BT, cumsum box filter over k^2, 1e4 on the border planes), one pair at
    a time."""
    rng = np.random.default_rng(5 + integer)
    cfg = SgmConfig(num_disparities=20, block_size=9)
    left = rng.uniform(0, 255, (2, 23, 41)).astype(F32)
    right = np.roll(left, -4, axis=-1) + rng.normal(0, 3, left.shape)
    right = right.astype(F32)
    if integer:
        left, right = np.round(left), np.round(right)
    ours = tm._sgm_cost(torch.from_numpy(left), torch.from_numpy(right),
                        cfg)[1].numpy()
    k, cap = cfg.block_size, float(cfg.pre_filter_cap)
    for b in range(2):
        lf = jm._xsobel_prefilter(jnp.asarray(left[b]), cap)
        rf = jm._xsobel_prefilter(jnp.asarray(right[b]), cap)
        bt = jm._bt_cost(lf, rf, cfg.num_disparities, cfg.min_disparity)
        cost = jm._box_filter(bt, k) / float(k * k)
        border = jm._border_mask(23, 41, cfg.num_disparities,
                                 cfg.min_disparity)
        ref = np.moveaxis(np.asarray(jnp.where(border, cost, 1e4)), 0, -1)
        if integer:
            np.testing.assert_array_equal(ours[b], ref)
        else:
            prefix = (41 + k) * k * float(bt.max())
            np.testing.assert_allclose(ours[b], ref, rtol=1e-6,
                                       atol=4 * EPS32 * prefix / (k * k))


def cost_kernel_model(lf, rf, num_disp, min_disp, k):
    """csrc/sgm_cost.cu's formulation in numpy float32: per cost-plane
    column c (clamped) and d, BT of the left interval at c against the right
    one at q = c - min_disp - d (value and interval 0 where q < 0); the sum
    of the K clamped rows top to bottom, then of the K clamped columns left
    to right; the division by K * K; 1e4 where w - min_disp - d < 0."""
    lf, rf = lf.numpy(), rf.numpy()
    _b, h, w = lf.shape
    r = k // 2

    def interval(img):
        prev = img[..., np.r_[0, 0:w - 1]]
        nxt = img[..., np.r_[1:w, w - 1]]
        lo = F32(0.5) * (img + prev)
        hi = F32(0.5) * (img + nxt)
        return (img, np.minimum(np.minimum(lo, hi), img),
                np.maximum(np.maximum(lo, hi), img))

    lv, lmn, lmx = (x[..., None] for x in interval(lf))
    q = np.arange(w)[:, None] - min_disp - np.arange(num_disp)[None, :]
    inside = q >= 0
    rv, rmn, rmx = (np.where(inside, x[..., np.where(inside, q, 0)], F32(0))
                    for x in interval(rf))
    d_lr = np.maximum(np.maximum(lv - rmx, rmn - lv), F32(0))
    d_rl = np.maximum(np.maximum(rv - lmx, lmn - rv), F32(0))
    bt = np.minimum(d_lr, d_rl)  # [B, H, W, D]
    rows = np.clip(np.arange(h)[:, None] - r + np.arange(k)[None, :], 0,
                   h - 1)
    cols = np.clip(np.arange(w)[:, None] - r + np.arange(k)[None, :], 0,
                   w - 1)
    v = bt[:, rows[:, 0]]
    for i in range(1, k):
        v = v + bt[:, rows[:, i]]
    out = v[:, :, cols[:, 0]]
    for j in range(1, k):
        out = out + v[:, :, cols[:, j]]
    if k > 1:
        out = out / F32(k * k)
    return np.where(inside[None, None], out, F32(1e4)).astype(F32)


@pytest.mark.parametrize("k,min_disp,num_disp", [(1, 0, 7), (3, 1, 33),
                                                 (4, 0, 16), (9, 1, 40),
                                                 (15, 0, 9)])
def test_cost_kernel_model_is_the_plain_version(k, min_disp, num_disp):
    rng = np.random.default_rng(k)
    lf, rf = sobel_pair(rng, b=2, h=19, w=37)
    ours = tm.sgm_cost_volume_plain(lf, rf, num_disp, min_disp, k).numpy()
    np.testing.assert_array_equal(
        cost_kernel_model(lf, rf, num_disp, min_disp, k), ours)


# the tiling of csrc/sgm_cost.cu: most threads of a block, output rows of a
# block, most strip columns, most disparities of a block, columns of a run,
# output row segments in flight
COST_NTMAX, COST_TH, COST_TWMAX, COST_DCMAX, COST_RUN, COST_NSEG = \
    512, 192, 64, 256, 8, 2


def ring_entries(k):
    """The kernel's ring entries per thread at window k (<= 72 registers of
    ring)."""
    return min(16, 72 // k)


def cost_tiling(h, w, d, k):
    """``tiling<K>()`` of csrc/sgm_cost.cu: (strip columns, disparities of a
    block, pitch of the vertical-sum tile, strips, row blocks, chunks,
    dynamic shared bytes, disparity groups, threads)."""
    e = ring_entries(k)
    nv4 = (k + COST_RUN - 1 + 3) // 4
    most = e * (COST_NTMAX // (COST_RUN + k - 1))
    dc = d if d <= COST_DCMAX and d <= most else min(most, COST_DCMAX) & ~3
    g = -(-dc // e)
    tw = min((COST_NTMAX // g - (k - 1)) & ~(COST_RUN - 1), COST_TWMAX)
    s = tw + k - 1
    ib = 2 * s + dc - 1
    threads = (max(s * g, ib) + 31) & ~31
    sp = (max(s, tw - COST_RUN + 4 * nv4) + 3) & ~3
    if sp % 8 == 0:
        sp += 4
    smem = 4 * (2 * 4 * ib + 2 * dc * sp + COST_NSEG * tw * dc)
    assert tw >= COST_RUN and threads <= COST_NTMAX and smem <= 227 * 1024
    return (tw, dc, sp, -(-w // tw), -(-h // COST_TH), -(-d // dc), smem, g,
            threads)


def _intervals(row, q, ok):
    """Staged (value, min, max) of image row ``row`` at columns ``q``; 0
    where not ``ok``."""
    w = row.shape[0]
    qc = np.clip(q, 0, w - 1)
    v, prev, nxt = row[qc], row[np.maximum(qc - 1, 0)], \
        row[np.minimum(qc + 1, w - 1)]
    lo = F32(0.5) * (v + prev)
    hi = F32(0.5) * (v + nxt)
    mn = np.minimum(np.minimum(lo, hi), v)
    mx = np.maximum(np.maximum(lo, hi), v)
    return tuple(np.where(ok, a, F32(0)) for a in (v, mn, mx))


def cost_tiling_model(lf, rf, num_disp, min_disp, k):
    """csrc/sgm_cost.cu's walk in numpy float32, block by block and row by
    row, with the kernel's own index arithmetic: each ring owner's halo
    column and disparities g + j G with their staged-interval and
    vertical-sum slots, the ring slot t % K, the 4-column runs reached by
    the threads' stepping, the double-buffered vertical-sum tiles, the NSEG
    output segments, and the stores of each segment (one contiguous run
    where the block holds all of D). The division is numpy's (correctly
    rounded, as ``div_k2``)."""
    lf, rf = lf.numpy(), rf.numpy()
    nb, h, w = lf.shape
    d_all = num_disp
    tw, dcm, sp, strips, rowblocks, chunks, _smem, gn, nt = cost_tiling(
        h, w, d_all, k)
    r, e_per = k // 2, ring_entries(k)
    nv4 = (k + COST_RUN - 1 + 3) // 4
    s_n = tw + k - 1
    out = np.full((nb, h, w, d_all), np.nan, F32)
    written = np.zeros(out.shape, np.int32)
    for bx in range(strips * rowblocks * chunks * nb):
        strip, rest = bx % strips, bx // strips
        rb, rest = rest % rowblocks, rest // rowblocks
        chunk, b = rest % chunks, rest // chunks
        w0, h0, d0 = strip * tw, rb * COST_TH, chunk * dcm
        dc = min(dcm, d_all - d0)
        rows = min(COST_TH, h - h0)
        twv = min(tw, w - w0)
        rs = s_n + dc - 1
        ib_n = s_n + rs
        cc0 = min(max(w0 - r, 0), w - 1)
        # the ring entries: owner tid (column s, group g) holds disparities
        # g + j G for j < nlive
        tid = np.arange(nt)
        s, g = tid % s_n, tid // s_n
        nlive = np.where((g < gn) & (g < dc), (dc - g + gn - 1) // gn, 0)
        rbase = s_n + np.clip(w0 - r + s, 0, w - 1) - cc0 + dc - 1 - g
        j = np.arange(e_per)
        own = j[None, :] < nlive[:, None]
        li = np.broadcast_to(s[:, None], own.shape)[own]
        ri = (rbase[:, None] - j[None, :] * gn)[own]
        vi = ((g * sp + s)[:, None] + j[None, :] * gn * sp)[own]
        dd = (g[:, None] + j[None, :] * gn)[own]
        assert np.array_equal(np.sort(dd * s_n + li), np.arange(s_n * dc))
        assert ri.min() >= s_n and ri.max() < ib_n and vi.max() < dcm * sp
        # the staging threads
        tid = np.arange(ib_n)
        st_l = tid < s_n
        sq = np.where(st_l, np.clip(w0 - r + tid, 0, w - 1),
                      cc0 - min_disp - d0 - (dc - 1) + (tid - s_n))
        st_q = st_l | ((sq >= 0) & (sq < w))
        ring = np.zeros((li.size, k), F32)
        vt = [np.full(dcm * sp, np.nan, F32) for _ in range(2)]
        seg = [np.full(tw * dcm, np.nan, F32) for _ in range(COST_NSEG)]
        nrows = rows + k - 1
        for t in range(nrows + 1):
            if t < nrows:
                y = min(max(h0 - r + t, 0), h - 1)
                lv, lmn, lmx = _intervals(lf[b, y], sq, st_l & st_q)
                rv, rmn, rmx = _intervals(rf[b, y], sq, ~st_l & st_q)
                iv = np.where(st_l, lv, rv)
                imn = np.where(st_l, lmn, rmn)
                imx = np.where(st_l, lmx, rmx)
                d_lr = np.maximum(np.maximum(iv[li] - imx[ri],
                                             imn[ri] - iv[li]), F32(0))
                d_rl = np.maximum(np.maximum(iv[ri] - imx[li],
                                             imn[li] - iv[ri]), F32(0))
                ring[:, t % k] = np.minimum(d_lr, d_rl)
                if t >= k - 1:
                    v = ring[:, (t + 1) % k].copy()
                    for i in range(1, k):
                        v = v + ring[:, (t + 1 + i) % k]
                    vt[t & 1][vi] = v
            if t < k:
                continue
            # the runs: each thread's first, then NT runs on
            vsrc, sdst = vt[(t - 1) & 1], seg[(t - k) % COST_NSEG]
            nruns = -(-twv // COST_RUN) * dc
            thr = np.arange(nt)
            hd, hg, rr = thr % dc, thr // dc, thr.copy()
            sd, sg = nt % dc, nt // dc
            while (rr < nruns).any():
                on = rr < nruns
                rd, rgp = hd[on], hg[on]
                assert (rd == rr[on] % dc).all() and \
                    (rgp == rr[on] // dc).all()
                x = vsrc[(rd * sp + rgp * COST_RUN)[:, None]
                         + np.arange(4 * nv4)[None, :]]
                edge = w0 + rgp * COST_RUN - min_disp - (d0 + rd)
                for i in range(COST_RUN):
                    o = rgp * COST_RUN + i
                    ok = o < twv
                    v = x[:, i].copy()
                    for j in range(1, k):
                        v = v + x[:, i + j]
                    if k > 1:
                        v = v / F32(k * k)
                    val = np.where(edge + i >= 0, v, F32(1e4))
                    sdst[(o * dc + rd)[ok]] = val[ok]
                hd, hg, rr = hd + sd, hg + sg, rr + nt
                carry = hd >= dc
                hd, hg = np.where(carry, hd - dc, hd), hg + carry
            # the store of output row h0 + t - K
            hh = h0 + t - k
            n = twv * dc
            if dc == d_all:
                flat = out[b, hh].reshape(-1)
                flat[w0 * d_all + d0:w0 * d_all + d0 + n] = sdst[:n]
                written[b, hh].reshape(-1)[w0 * d_all:w0 * d_all + n] += 1
            else:
                i = np.arange(n)
                o = i // dc
                out[b, hh, w0 + o, d0 + i - o * dc] = sdst[:n]
                written[b, hh, w0 + o, d0 + i - o * dc] += 1
    assert (written == 1).all()
    return out


# (pairs, H, W, D, min_disp, K): one strip and D odd (segments that are
# neither aligned nor a multiple of 4 floats); several strips with a ragged
# last one; more rows than a block walks; the step's D at K = 9 (36-column
# strips); D cut into chunks of 112 at K = 15; K = 15 over a strip wider than
# the image; K = 2
COST_TILINGS = [(2, 11, 37, 7, 0, 1), (1, 9, 70, 13, 3, 2),
                (2, 13, 150, 40, 0, 9), (1, 200, 10, 5, 3, 9),
                (1, 7, 41, 80, 3, 9), (1, 6, 9, 120, 0, 15),
                (1, 17, 23, 33, 3, 15), (1, 5, 80, 16, 0, 15)]


def test_cost_tiling_fits_every_window_and_disparity_count():
    """``tiling<K>()`` finds a launch for every window the kernel takes and
    any D: a strip of at least one run, at most 512 threads, the block's
    shared memory within 227 KB, every ring owner's disparities in its
    chunk (``cost_tiling`` asserts each)."""
    for k in range(1, tm.SGM_COST_MAX_BLOCK + 1):
        for d in list(range(1, 300)) + [511, 1000]:
            tw, dc, _sp, _s, _r, chunks, _m, g, threads = cost_tiling(
                480, 752, d, k)
            assert dc * chunks >= d and g * ring_entries(k) >= dc
            assert threads >= (tw + k - 1) * g

@pytest.mark.parametrize("b,h,w,d,min_disp,k", COST_TILINGS)
def test_cost_tiling_model_is_the_plain_version(b, h, w, d, min_disp, k):
    rng = np.random.default_rng(h * w + k)
    lf, rf = sobel_pair(rng, b=b, h=h, w=w)
    ours = tm.sgm_cost_volume_plain(lf, rf, d, min_disp, k).numpy()
    np.testing.assert_array_equal(
        cost_tiling_model(lf, rf, d, min_disp, k), ours)


def test_cost_tilings_reach_every_edge():
    """The shapes above hold the edges the kernel's tiling has: a chunk of
    D, ragged strips, row blocks, odd D, K of 1, 2, 9 and 15, min_disp 0 and
    3; and the step's shape tiles as its comments say (40 columns, all 80
    disparities in one block of 480 threads, 10 groups of 8)."""
    tilings = [cost_tiling(h, w, d, k) for _b, h, w, d, _m, k
               in COST_TILINGS]
    assert any(t[5] > 1 for t in tilings)  # D in chunks
    assert any(t[3] > 1 and w % t[0] for t, (_b, _h, w, *_r)
               in zip(tilings, COST_TILINGS))  # a ragged last strip
    assert any(t[4] > 1 for t in tilings)  # several row blocks
    assert {k for *_r, k in COST_TILINGS} == {1, 2, 9, 15}
    assert {m for *_r, m, _k in COST_TILINGS} == {0, 3}
    assert any(d % 4 for _b, _h, _w, d, _m, _k in COST_TILINGS)
    step = cost_tiling(480, 752, 80, 9)
    assert step[:6] == (40, 80, 52, 19, 3, 1) and step[7:] == (10, 480)


# -- the post-filters --------------------------------------------------------


def wta_kernel_model(cost, min_disp):
    """csrc/sgm_select.cu's WTA on [..., D] float32: the minimum, then the
    first d that holds it; the sub-pixel step in the kernel's operation
    order."""
    d = cost.shape[-1]
    best_v = cost.min(-1)
    best_i = np.argmax(cost == best_v[..., None], axis=-1)
    cm = np.take_along_axis(cost, np.maximum(best_i - 1, 0)[..., None],
                            -1)[..., 0]
    cp = np.take_along_axis(cost, np.minimum(best_i + 1, d - 1)[..., None],
                            -1)[..., 0]
    two = F32(2)
    denom = (cm - two * best_v) + cp
    with np.errstate(divide="ignore", invalid="ignore"):
        step = (cm - cp) / (two * denom)
    delta = np.where(np.abs(denom) > F32(1e-9), step, F32(0))
    delta = np.minimum(np.maximum(delta, F32(-0.5)), F32(0.5))
    interior = (best_i > 0) & (best_i < d - 1)
    disp = (best_i.astype(F32) + np.where(interior, delta, F32(0))) \
        + F32(min_disp)
    return disp, best_v, best_i


def uniqueness_kernel_model(cost, best, c0, ratio):
    if ratio < 0:
        return np.ones(best.shape, bool)
    d = np.arange(cost.shape[-1])
    away = np.abs(d - best[..., None]) > 1
    runner = np.minimum(BIG, np.where(away, cost, np.inf).min(-1))
    return runner > c0 * F32(1.0 + ratio / 100.0)


def lr_kernel_model(cost, best, min_disp, max_diff):
    """The LR kernel: per row the column minima along the diagonals
    (1e9 past the image), then each pixel's test at u_r = u - min_disp -
    best against cost[v, u + off, best + off]."""
    *_lead, h, w, d = cost.shape
    x = np.arange(w)[:, None] + min_disp + np.arange(d)[None, :]  # [W, D]
    diag = np.where(x < w, cost[..., np.minimum(x, w - 1),
                                np.arange(d)[None, :]], BIG)
    colmin = diag.min(-1)  # [..., H, W]
    u = np.arange(w)
    u_r = u - min_disp - best
    ok = np.zeros(best.shape, bool)
    cmin = np.take_along_axis(colmin, np.maximum(u_r, 0), -1)
    for off in range(-max_diff, max_diff + 1):
        d2, u2 = best + off, u + off
        inside = (d2 >= 0) & (d2 < d) & (u2 >= 0) & (u2 < w)
        at_u2 = cost[..., np.clip(u2, 0, w - 1), :]  # [..., H, W, D]
        val = np.take_along_axis(at_u2, np.clip(d2, 0, d - 1)[..., None],
                                 -1)[..., 0]
        ok |= inside & (val == cmin)
    return ok & (u_r >= 0)


def order_keys(x):
    """sgm_select.cu's ``entry_key``: -0 as +0, then the order-keeping
    unsigned key of each float32."""
    u = (x.astype(F32) + F32(0)).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def lr_scatter_model(cost, best, min_disp, max_diff):
    """The LR kernel's one pass: every entry (w, d) of a row with
    x = w - min_disp - d >= 0 goes by key into colmin[x] (initialised to the
    key of 1e9 where the column's diagonal leaves the image, else of +inf)
    and, where d = best[w - off] + off, into pixel w - off's candidate
    minimum; a pixel passes iff u_r >= 0 and the two keys are equal."""
    *lead, h, w, d = cost.shape
    flat = cost.reshape(-1, w, d)
    bst = best.reshape(-1, w)
    big = order_keys(np.array([BIG]))[0]
    inf = order_keys(np.array([np.inf], F32))[0]
    ww, dd = np.meshgrid(np.arange(w), np.arange(d), indexing="ij")
    x = ww - min_disp - dd
    seen = x >= 0
    valid = np.zeros(bst.shape, bool)
    for row in range(flat.shape[0]):
        keys = order_keys(flat[row])
        colmin = np.where(np.arange(w) + min_disp + d - 1 >= w, big, inf)
        colmin = colmin.astype(np.uint32)
        np.minimum.at(colmin, x[seen], keys[seen])
        candmin = np.full(w, 0xffffffff, np.uint32)
        for off in range(-max_diff, max_diff + 1):
            u = ww - off
            uc = np.clip(u, 0, w - 1)
            hit = seen & (u >= 0) & (u < w) & (bst[row][uc] + off == dd)
            np.minimum.at(candmin, u[hit], keys[hit])
        u_r = np.arange(w) - min_disp - bst[row]
        valid[row] = (u_r >= 0) & (candmin == colmin[np.maximum(u_r, 0)])
    return valid.reshape(best.shape)


def crafted_volume(rng, shape=(2, 9, 23, 13)):
    """Integer-valued costs in 0..12 (ties everywhere), an all-1e9 image
    column, an all-1e9 row, and 1e9 at d = 0 of the last pair."""
    vol = np.round(rng.uniform(0, 12, shape)).astype(F32)
    vol[:, :, 5, :] = BIG
    vol[0, 3] = BIG
    vol[-1, ..., 0] = BIG
    return vol


def real_volume():
    """The aggregated volume of a textured pair with a shift of 7."""
    rng = np.random.default_rng(7)
    h, w = 24, 48
    scene = rng.uniform(0, 255, (h, w + 20)).astype(F32)
    left = torch.from_numpy(scene[:, 12:12 + w] + rng.normal(
        0, 2, (h, w)).astype(F32))
    right = torch.from_numpy(np.ascontiguousarray(scene[:, 19:19 + w]))
    cfg = SgmConfig(num_disparities=16, kernel="pallas")
    cost = tm._sgm_cost(left, right, cfg)[1]
    return aggregate_passes(cost[None], cfg.p1, cfg.p2, 8, True).numpy()


VOLUMES = ("crafted D=13", "crafted D=40", "uniform D=5", "real D=16")


def volume(name):
    rng = np.random.default_rng(VOLUMES.index(name))
    if name == "crafted D=13":
        return crafted_volume(rng)
    if name == "crafted D=40":
        return crafted_volume(rng, (1, 7, 50, 40))
    if name == "uniform D=5":
        return rng.uniform(0, 50, (2, 6, 11, 5)).astype(F32)
    return real_volume()


@pytest.mark.parametrize("name", VOLUMES)
def test_post_filter_models_are_the_plain_versions(name):
    vol = volume(name)
    t = torch.from_numpy(vol)
    for min_disp in (0, 1, 3):
        disp, c0, best = tm.sgm_wta_plain(t, min_disp)
        m_disp, m_c0, m_best = wta_kernel_model(vol, min_disp)
        np.testing.assert_array_equal(best.numpy(), m_best)
        np.testing.assert_array_equal(c0.numpy(), m_c0)
        np.testing.assert_array_equal(disp.numpy(), m_disp)
        assert best.dtype == torch.int64 and c0.dtype == torch.float32
        for ratio in (-1, 0, 10, 15):
            np.testing.assert_array_equal(
                tm.sgm_uniqueness_plain(t, best, c0, ratio).numpy(),
                uniqueness_kernel_model(vol, m_best, m_c0, ratio),
                err_msg=f"{ratio=}")
        for max_diff in (0, 1, 2):
            ours = tm.sgm_lr_check_plain(t, best, min_disp, max_diff)
            np.testing.assert_array_equal(
                ours.numpy(), lr_kernel_model(vol, m_best, min_disp,
                                              max_diff),
                err_msg=f"{min_disp=} {max_diff=}")
    # the models are not vacuous: ties, sentinels, both outcomes
    if name.startswith("crafted"):
        assert (vol == vol.min(-1, keepdims=True)).sum(-1).max() > 1
    lr = tm.sgm_lr_check_plain(t, best, 3, 0).numpy()
    assert 0 < lr.mean() < 1


@pytest.mark.parametrize("min_disp", [0, 1, 3])
@pytest.mark.parametrize("name", VOLUMES)
def test_lr_scatter_model_is_the_plain_version(name, min_disp):
    """The redesigned LR kernel's pass (column minima by scatter-min, the
    candidates captured in the same pass) equals the plain version; on the
    crafted volumes a -0 beside a +0 minimum too."""
    vol = volume(name)
    if name.startswith("crafted"):
        vol = np.where(vol == 0, F32(-0.0), vol)
        vol[..., ::2, :] = np.where(vol[..., ::2, :] == 0, F32(0.0),
                                    vol[..., ::2, :])
    t = torch.from_numpy(vol)
    _disp, _c0, best = tm.sgm_wta_plain(t, min_disp)
    for max_diff in (0, 1, 2):
        ours = tm.sgm_lr_check_plain(t, best, min_disp, max_diff).numpy()
        np.testing.assert_array_equal(
            lr_scatter_model(vol, best.numpy(), min_disp, max_diff), ours,
            err_msg=f"{max_diff=}")
    assert 0 < ours.mean() < 1


def test_d_last_routes_equal_the_dhw_functions():
    """``d_last=True`` on a CPU [..., H, W, D] volume gives what the
    functions give on its [..., D, H, W] view, with no launch."""
    vol = torch.from_numpy(volume("real D=16"))
    dhw = vol.movedim(-1, -3)
    before = launches()
    disp, c0, best = tm._wta_subpixel(vol, 1, d_last=True)
    for a, b in zip((disp, c0, best), tm._wta_subpixel(dhw, 1)):
        assert torch.equal(a, b)
    assert torch.equal(tm._uniqueness_mask(vol, best, c0, 10, d_last=True),
                       tm._uniqueness_mask(dhw, best, c0, 10))
    for max_diff in (0, 1):
        assert torch.equal(
            tm._lr_consistency_mask(vol, best, 1, max_diff, d_last=True),
            tm._lr_consistency_mask(dhw, best, 1, max_diff))
    assert launches() == before


def test_sgm_route_takes_the_plain_versions_on_the_cpu(monkeypatch):
    """``sgm_disparity_cuda`` on CPU tensors goes through each wrapper's
    plain version once and counts no launch."""
    calls = {}
    for name in WRAPPERS:
        plain = getattr(tm, name + "_plain")

        def spy(*a, _name=name, _plain=plain, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a, **k)

        monkeypatch.setattr(tm, name + "_plain", spy)
    rng = np.random.default_rng(2)
    left = torch.from_numpy(rng.uniform(0, 255, (2, 20, 36)).astype(F32))
    right = torch.roll(left, -3, dims=-1)
    mask = torch.ones(2, 20, 36, dtype=torch.bool)
    before = launches()
    out = sgm_disparity_cuda(left, right, mask,
                             SgmConfig(num_disparities=8, kernel="pallas"))
    assert out.shape == (2, 20, 36)
    assert calls == dict.fromkeys(WRAPPERS, 1)
    assert launches() == before


def test_wrappers_raise_off_the_cpu_and_the_card():
    """A tensor on neither the CPU nor the card (``meta``) raises before
    any launch: no wrapper falls back to the PyTorch ops."""
    img = torch.empty(2, 8, 16, device="meta")
    vol = torch.empty(2, 8, 16, 4, device="meta")
    best = torch.empty(2, 8, 16, dtype=torch.int64, device="meta")
    c0 = torch.empty(2, 8, 16, device="meta")
    before = launches()
    with pytest.raises(ValueError):
        tm.sgm_cost_volume(img, img, 4, 1, 3)
    with pytest.raises(ValueError):
        tm.sgm_wta(vol, 1)
    with pytest.raises(ValueError):
        tm.sgm_uniqueness(vol, best, c0, 10)
    with pytest.raises(ValueError):
        tm.sgm_lr_check(vol, best, 1, 0)
    # the cost kernel's grid is one dimension of blocks, so 70000 pairs at
    # 80 disparities meet only the device check; a window past 15 raises
    # its own error; the LR kernel's three [W] key arrays fit 227 KB of
    # shared memory up to its width limit, one column past it raises
    many = torch.empty(70000, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported devices meta"):
        tm.sgm_cost_volume(many, many, 80, 1, 9)
    with pytest.raises(ValueError, match="block 16"):
        tm.sgm_cost_volume(img, img, 4, 1, 16)
    assert 12 * tm._SGM_LR_MAX_WIDTH <= 227 * 1024
    for w, match in ((tm._SGM_LR_MAX_WIDTH, "unsupported device meta"),
                     (tm._SGM_LR_MAX_WIDTH + 1, "width 12289")):
        wide = torch.empty(1, 2, w, 4, device="meta")
        wbest = torch.empty(1, 2, w, dtype=torch.int64, device="meta")
        with pytest.raises(ValueError, match=match):
            tm.sgm_lr_check(wide, wbest, 1, 0)
    assert launches() == before


def test_bm_cost_volume_path_keeps_its_pytorch_ops(monkeypatch):
    """BM ``kernel="xla"`` (the [D, H, W] cost volume, int16 or float)
    reaches none of the SGM wrappers, and its result is what it was."""
    rng = np.random.default_rng(4)
    left = torch.from_numpy(rng.uniform(0, 255, (1, 24, 48)).astype(F32))
    right = torch.roll(left, -5, dims=-1)  # left(u) sees right(u - 5)
    mask = torch.ones(1, 24, 48, dtype=torch.bool)
    outs = {}
    for integer in (True, False):
        cfg = BlockMatchingConfig(num_disparities=16, block_size=5,
                                  integer_costs=integer)
        outs[integer] = tm.block_matching_disparity(left, right, mask, cfg)

    def refuse(*_a, **_k):
        raise AssertionError("the BM path reached an SGM wrapper")

    for name in WRAPPERS:
        monkeypatch.setattr(tm, name, refuse)
        monkeypatch.setattr(tm, name + "_plain", refuse)
    for integer in (True, False):
        cfg = BlockMatchingConfig(num_disparities=16, block_size=5,
                                  integer_costs=integer)
        again = tm.block_matching_disparity(left, right, mask, cfg)
        assert torch.equal(again, outs[integer])
        assert (again > 1.0).float().mean() > 0.3
