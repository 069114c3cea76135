"""Port DSM binning and IDW (plain version of csrc/idw.cu, on the CPU) vs
the JAX package: bin_points exactly; binned_idw_pallas in interpret mode at
the bar of tests/test_pallas_idw.py:31-34 (hit equal, values rtol 1e-6 /
atol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_mapper_tpu.dsm import idw as jidw
from aerial_mapper_tpu.dsm.pallas_idw import binned_idw_pallas
from aerial_mapper_tpu.mapgrid import MapGeometry as JGeom
from aerial_mapper_tpu_torch.dsm import idw as tidw
from aerial_mapper_tpu_torch.dsm.cuda_idw import binned_idw_cuda
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry as TGeom

torch.set_num_threads(2)

GEOM = (0.0, 0.0, 0.5, 50, 70)


def cloud(seed=0, n=20000):
    """Random cloud plus an over-capacity cell (12 points, capacity 8)
    and a point exactly on the center of cell (7, 10)."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 2)) * 60 - 30).astype(np.float32)
    payload = (410 + 5 * rng.random(n)).astype(np.float32)
    valid = rng.random(n) > 0.3
    g = JGeom(*GEOM)
    crowd = np.stack([g.west + 20.5 * g.resolution
                      + 0.2 * rng.random(12) - 0.1,
                      g.north - 30.5 * g.resolution
                      + 0.2 * rng.random(12) - 0.1], axis=1)
    center = np.array([[g.west + 10.5 * g.resolution,
                        g.north - 7.5 * g.resolution]])
    pts = np.concatenate([pts, crowd, center]).astype(np.float32)
    payload = np.concatenate([payload, np.full(12, 420.0),
                              [999.0]]).astype(np.float32)
    valid = np.concatenate([valid, np.ones(13, bool)])
    return pts, payload, valid


def binned_both(seed=0):
    pts, payload, valid = cloud(seed)
    jb = jidw.bin_points(jnp.asarray(pts), jnp.asarray(payload),
                         jnp.asarray(valid), JGeom(*GEOM), 8)
    tb = tidw.bin_points(torch.as_tensor(pts), torch.as_tensor(payload),
                         torch.as_tensor(valid), TGeom(*GEOM), 8)
    return jb, tb


def test_bin_points_slots_equal_jax():
    jb, tb = binned_both()
    for name in ("de", "dn", "payload", "count"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    assert int(tb.count.max()) > 8  # the over-capacity cell


def test_bin_points_halo_offsets_equal_jax():
    pts, payload, valid = cloud(1)
    kw = dict(north=12.5, west=-17.5, row_offset=3, col_offset=3)
    jb = jidw.bin_points(jnp.asarray(pts), jnp.asarray(payload),
                         jnp.asarray(valid), JGeom(*GEOM), 8, **kw)
    tb = tidw.bin_points(torch.as_tensor(pts), torch.as_tensor(payload),
                         torch.as_tensor(valid), TGeom(*GEOM), 8, **kw)
    for name in ("de", "dn", "payload", "count"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)


@pytest.mark.parametrize("adaptive", [True, False])
def test_idw_matches_pallas(adaptive):
    jb, tb = binned_both()
    kw = dict(radius_sq=2.0, adaptive=adaptive, growth=1.1,
              max_radius_sq=7.0)
    vj, hj = binned_idw_pallas(jb, JGeom(*GEOM), tile_h=16, interpret=True,
                               **kw)
    vt, ht = binned_idw_cuda(tb, TGeom(*GEOM), **kw)
    hj = np.asarray(hj)
    np.testing.assert_array_equal(ht.numpy(), hj)
    np.testing.assert_allclose(vt.numpy()[hj], np.asarray(vj)[hj],
                               rtol=1e-6, atol=1e-4)
    assert float(vt[7, 10]) == 999.0  # exact-match shortcut


def test_idw_to_grid_both_switches_match_jax():
    pts, payload, valid = cloud(2)
    kw = dict(radius_sq=2.0, adaptive=True, growth=1.1, max_radius_sq=7.0)
    vj, hj = jidw.idw_to_grid(jnp.asarray(pts), jnp.asarray(payload),
                              jnp.asarray(valid), JGeom(*GEOM), 8,
                              kernel="pallas", **kw)
    hj = np.asarray(hj)
    for kernel in ("xla", "pallas"):  # the same function in the port
        vt, ht = tidw.idw_to_grid(
            torch.as_tensor(pts), torch.as_tensor(payload),
            torch.as_tensor(valid), TGeom(*GEOM), 8, kernel=kernel, **kw)
        np.testing.assert_array_equal(ht.numpy(), hj)
        np.testing.assert_allclose(vt.numpy()[hj], np.asarray(vj)[hj],
                                   rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="idw kernel"):
        tidw.idw_to_grid(torch.as_tensor(pts), torch.as_tensor(payload),
                         torch.as_tensor(valid), TGeom(*GEOM), 8,
                         kernel="mosaic", **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_points_leaves_slots_past_count_empty(seed):
    """Slots [count, K) hold de = dn = 1e9 and payload 0, also where
    count > K (the over-capacity cell keeps K points); slots [0, count)
    hold real offsets. The IDW kernel's slot loop stops at min(count, K)
    on this invariant."""
    pts, payload, valid = cloud(seed)
    tb = tidw.bin_points(torch.as_tensor(pts), torch.as_tensor(payload),
                         torch.as_tensor(valid), TGeom(*GEOM), 8)
    k = tb.de.shape[0]
    empty = torch.arange(k)[:, None, None] >= tb.count[None]
    assert bool((tb.count > k).any()) and bool((tb.count == 0).any())
    assert bool(empty.any()) and bool((~empty).any())
    assert bool(torch.all(tb.de[empty] == 1e9))
    assert bool(torch.all(tb.dn[empty] == 1e9))
    assert bool(torch.all(tb.payload[empty] == 0.0))
    assert bool(torch.all(tb.de[~empty].abs() <= 0.5))  # within its cell
    assert bool(torch.all(tb.dn[~empty].abs() <= 0.5))


def _binned_idw_cut(binned, geom, radius_sq, adaptive, growth,
                    max_radius_sq, needed_only=False):
    """``tidw.binned_idw`` with each cell's slot loop cut at
    ``min(count, K)``, as the kernel runs it: a slot at or past its cell's
    count takes no part in either pass. ``needed_only``: pass 2 adds an
    offset's partials only where one of its live slots lies strictly inside
    the cell's radius, as the kernel's visiting list does."""
    k, h, w = binned.de.shape
    r2_cap = max_radius_sq if adaptive else radius_sq
    hw = tidw._window_halfwidth(r2_cap, geom.resolution)
    offsets = tidw._circular_offsets(hw, geom.resolution, r2_cap)
    res = tidw._f32(geom.resolution)
    pad = (hw, hw, hw, hw)
    de_p = torch.nn.functional.pad(binned.de, pad, value=tidw._FAR)
    dn_p = torch.nn.functional.pad(binned.dn, pad, value=tidw._FAR)
    pl_p = torch.nn.functional.pad(binned.payload.float(), pad, value=0.0)
    n_p = torch.nn.functional.pad(binned.count.clamp(max=k), pad, value=0)
    slot = torch.arange(k)[:, None, None]

    def at(oi, oj):
        de = de_p[:, oi:oi + h, oj:oj + w] + tidw._f32(
            tidw._f32(oj - hw) * res)
        dn = dn_p[:, oi:oi + h, oj:oj + w] - tidw._f32(
            tidw._f32(oi - hw) * res)
        return de * de + dn * dn, slot < n_p[None, oi:oi + h, oj:oj + w]

    if adaptive:
        d2min = torch.full((h, w), tidw._FAR)
        for oi, oj in offsets:
            d2, live = at(oi, oj)
            d2 = torch.where(live, d2, torch.full_like(d2, float("inf")))
            d2min = torch.minimum(d2min, d2.amin(dim=0))
        r_eff = tidw.effective_radius_sq(d2min, radius_sq, growth,
                                         max_radius_sq)
    else:
        r_eff = torch.full((h, w), radius_sq)
    zeros = torch.zeros((h, w))
    num, den, exact_val = zeros, zeros, zeros
    exact_hit = torch.zeros((h, w), dtype=torch.bool)
    for oi, oj in offsets:
        d2, live = at(oi, oj)
        pl = pl_p[:, oi:oi + h, oj:oj + w]
        in_r = d2 < r_eff
        is_exact = in_r & (d2 <= tidw._EXACT_EPS) & live
        wgt = torch.where(in_r & ~is_exact,
                          1.0 / torch.clamp(d2, min=tidw._EXACT_EPS),
                          torch.zeros_like(d2))
        pnum, pden = zeros, zeros
        for s in range(k):
            pnum = torch.where(live[s], pnum + wgt[s] * pl[s], pnum)
            pden = torch.where(live[s], pden + wgt[s], pden)
        if needed_only:
            needed = (live & in_r).any(dim=0)
            num = torch.where(needed, num + pnum, num)
            den = torch.where(needed, den + pden, den)
        else:
            num = num + pnum
            den = den + pden
        any_exact = is_exact.any(dim=0)
        first = torch.gather(pl, 0, is_exact.to(torch.uint8).argmax(
            dim=0)[None])[0]
        exact_val = torch.where(~exact_hit & any_exact, first, exact_val)
        exact_hit = exact_hit | any_exact
    hit = (den > 0.0) | exact_hit
    values = torch.where(
        exact_hit, exact_val,
        num / torch.where(den > 0.0, den, torch.ones_like(den)))
    return values, hit


@pytest.mark.parametrize("adaptive,needed_only",
                         [(True, False), (False, False), (True, True)])
def test_idw_slot_loop_cut_at_count_gives_same_bits(adaptive, needed_only):
    """Cutting every cell's slot loop at min(count, K), and with
    ``needed_only`` also leaving out of pass 2 every offset without a slot
    inside the cell's radius, leaves binned_idw's values and hits bit for
    bit as they were, exact-match cell and over-capacity cell included."""
    _, tb = binned_both()
    kw = dict(radius_sq=2.0, adaptive=adaptive, growth=1.1,
              max_radius_sq=7.0)
    v_all, h_all = tidw.binned_idw(tb, TGeom(*GEOM), **kw)
    v_cut, h_cut = _binned_idw_cut(tb, TGeom(*GEOM), needed_only=needed_only,
                                   **kw)
    assert bool(h_all.any()) and float(v_all[7, 10]) == 999.0
    assert torch.equal(h_cut, h_all)
    assert torch.equal(v_cut, v_all)
