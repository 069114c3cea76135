"""Port vs JAX package: nearest sampling, remap, the homography warp, the
grid's index and geotransform helpers, the timer's ``time_fn`` and the
slab window's tuning arguments. The same seeded numpy inputs go through
both; nearest gathers and integer outputs equal, bilinear ones at atol
1e-4 on images in [0, 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_mapper_tpu.image import sample as jsample
from aerial_mapper_tpu.mapgrid import grid as jgrid
from aerial_mapper_tpu.stereo.batched import (
    disparity_range_from_slab as jax_disparity_range,
)
from aerial_mapper_tpu.synth.scene import make_survey_poses
from aerial_mapper_tpu.utils.timing import StageTimer as JTimer
from aerial_mapper_tpu_torch import image as timage
from aerial_mapper_tpu_torch.image import sample as tsample
from aerial_mapper_tpu_torch.mapgrid import grid as tgrid
from aerial_mapper_tpu_torch.stereo.batched import disparity_range_from_slab
from aerial_mapper_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(2)

ATOL = dict(rtol=0, atol=1e-4)
H, W = 24, 32


def _image(rng, lead=()):
    return rng.random(lead + (H, W)).astype(np.float32)


def _coords(rng, shape):
    """Coordinates over and past the image, with exact half-pixel ties
    (rounded half to even) and exact edges among them."""
    u = rng.uniform(-2.0, W + 1.0, shape).astype(np.float32)
    v = rng.uniform(-2.0, H + 1.0, shape).astype(np.float32)
    flat_u, flat_v = u.reshape(-1), v.reshape(-1)
    flat_u[:6] = [0.5, 1.5, -0.5, W - 0.5, W - 1.5, 2.5]
    flat_v[:6] = [0.5, 2.5, 3.5, H - 0.5, -0.5, H - 1.5]
    return u, v


def test_nearest_sample_matches_jax():
    rng = np.random.default_rng(1)
    img = _image(rng)
    u, v = _coords(rng, (17, 19))
    want = np.asarray(jsample.nearest_sample(jnp.asarray(img), jnp.asarray(u),
                                             jnp.asarray(v), 7.0))
    got = tsample.nearest_sample(torch.from_numpy(img), torch.from_numpy(u),
                                 torch.from_numpy(v), 7.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 7.0).any() and (want != 7.0).any()


def test_nearest_sample_batched_matches_jax_per_image():
    """A [B, H, W] batch with per-image coordinates equals JAX image by
    image."""
    rng = np.random.default_rng(2)
    img = _image(rng, (3,))
    u, v = _coords(rng, (3, 5, 7))
    got = tsample.nearest_sample(torch.from_numpy(img), torch.from_numpy(u),
                                 torch.from_numpy(v)).numpy()
    for b in range(3):
        want = jsample.nearest_sample(jnp.asarray(img[b]), jnp.asarray(u[b]),
                                      jnp.asarray(v[b]))
        np.testing.assert_array_equal(got[b], np.asarray(want))


@pytest.mark.parametrize("nearest", [False, True])
def test_remap_matches_jax(nearest):
    rng = np.random.default_rng(3)
    img = _image(rng)
    u, v = _coords(rng, (H, W))
    want = np.asarray(jsample.remap(jnp.asarray(img), jnp.asarray(u),
                                    jnp.asarray(v), 0.0, nearest=nearest))
    got = tsample.remap(torch.from_numpy(img), torch.from_numpy(u),
                        torch.from_numpy(v), 0.0, nearest=nearest).numpy()
    if nearest:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **ATOL)


# A projective warp: scale, shear, shift and a perspective row
H_GENERAL = np.array([[0.9, 0.12, 3.0],
                      [-0.08, 1.1, -2.0],
                      [1e-3, -2e-3, 1.0]])
# one whose inverse both frameworks compute exactly (powers of two and
# integers): the source coordinates agree bit for bit by construction
H_EXACT = np.array([[0.5, 0.0, 2.0],
                    [0.0, 2.0, -4.0],
                    [0.0, 0.0, 1.0]])


@pytest.mark.parametrize("nearest,h_matrix", [
    (False, H_GENERAL), (True, H_GENERAL), (True, H_EXACT),
    (False, H_EXACT)])
def test_homography_warp_matches_jax(nearest, h_matrix):
    rng = np.random.default_rng(4)
    img = _image(rng)
    out_shape = (20, 28)
    want = np.asarray(jsample.homography_warp(
        jnp.asarray(img), jnp.asarray(h_matrix, jnp.float32), out_shape,
        5.0, nearest=nearest))
    got = tsample.homography_warp(torch.from_numpy(img), h_matrix, out_shape,
                                  5.0, nearest=nearest).numpy()
    assert got.shape == want.shape == out_shape
    assert (want == 5.0).any() and (want != 5.0).any()
    if nearest:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **ATOL)


def test_homography_warp_channels_lead():
    """A [C, H, W] image warps each channel as JAX warps [H, W, C]."""
    rng = np.random.default_rng(5)
    img = _image(rng, (3,))
    want = np.asarray(jsample.homography_warp(
        jnp.asarray(np.moveaxis(img, 0, -1)),
        jnp.asarray(H_GENERAL, jnp.float32), (20, 28)))
    got = tsample.homography_warp(torch.from_numpy(img), H_GENERAL,
                                  (20, 28)).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 0, -1), want, **ATOL)


def test_image_package_exports_as_jax():
    from aerial_mapper_tpu import image as jimage

    for name in ("bilinear_sample", "nearest_sample", "remap",
                 "homography_warp", "point_in_quad", "rgb_to_gray",
                 "pack_rgb_to_float", "unpack_float_to_rgb"):
        assert hasattr(jimage, name) and hasattr(timage, name), name


GEOM = (3.0, -2.0, 0.5, 12, 10)


def test_position_to_index_and_geotransform_match_jax():
    rng = np.random.default_rng(6)
    jg, tg = jgrid.MapGeometry(*GEOM), tgrid.MapGeometry(*GEOM)
    assert tg.geotransform == jg.geotransform
    # across and past the map, with exact cell edges among the points
    e = rng.uniform(jg.west - 2.0, jg.west + 7.0, 64).astype(np.float32)
    n = rng.uniform(jg.north - 8.0, jg.north + 2.0, 64).astype(np.float32)
    e[:3] = [jg.west, jg.west + 0.5, jg.west - 0.5]
    n[:3] = [jg.north, jg.north - 1.0, jg.north + 0.5]
    want = jgrid.position_to_index(jg, jnp.asarray(e), jnp.asarray(n))
    got = tgrid.position_to_index(tg, torch.from_numpy(e), torch.from_numpy(n))
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # plain floats give the same cell
    row, col = tgrid.position_to_index(tg, float(e[5]), float(n[5]))
    assert (int(row), int(col)) == (int(want[0][5]), int(want[1][5]))


def test_time_fn_matches_jax_bookkeeping():
    """The same stage, work and result as JAX's ``time_fn``; the time is
    the host clock around the call (CPU timer)."""
    calls = []

    def fn(a, b, scale=1.0):
        calls.append((a, b, scale))
        return torch.full((2,), (a + b) * scale)

    timer, jtimer = StageTimer(device="cpu"), JTimer()
    out = timer.time_fn("add", fn, 1.0, 2.0, work_items=3.0, scale=2.0)
    jout = jtimer.time_fn("add", lambda *a, **k: jnp.asarray(fn(*a, **k)),
                          1.0, 2.0, work_items=3.0, scale=2.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert calls == [(1.0, 2.0, 2.0)] * 2
    timer.time_fn("add", fn, 0.0, 0.0)
    assert timer.work == jtimer.work == {"add": 3.0}
    assert set(timer.durations) == set(jtimer.durations) == {"add"}
    assert timer.durations["add"] > 0.0
    assert timer.throughput("add") == pytest.approx(
        3.0 / timer.durations["add"])


@pytest.mark.parametrize("kw", [
    dict(phase=2, margin_px=4.0, quantize=8, outlier_factor=1.5),
    dict(phase=0, margin_px=20.0, quantize=32, outlier_factor=10.0),
    dict(phase=5, margin_px=0.0, quantize=16, outlier_factor=3.0),
])
def test_disparity_range_from_slab_arguments_match_jax(kw):
    """``phase``, ``margin_px``, ``quantize`` and ``outlier_factor`` at
    values other than the defaults, at the bench geometry (two flight
    lines, so the turn pair is an outlier at the default factor)."""
    Rs, ts = make_survey_poses(249, altitude=514.0, spacing=200.0 / 124,
                               num_lines=2, line_spacing=60.0,
                               start_easting=-100.0, start_northing=-30.0)
    K = np.array([[480.0, 0, 376.0], [0, 480.0, 240.0], [0, 0, 1.0]])
    args = (K, np.asarray(Rs), np.asarray(ts), (480, 752), 398.0, 430.0)
    got = disparity_range_from_slab(*args, use_every_nth=7, **kw)
    assert got == jax_disparity_range(*args, use_every_nth=7, **kw)
    assert all(isinstance(x, int) for x in got)
    assert got != disparity_range_from_slab(*args, use_every_nth=7)
