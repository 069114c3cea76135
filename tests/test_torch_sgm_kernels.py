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
