"""``parallel/sharded.py::band_image_operands`` of the port against the JAX
package's twin, on the same numpy inputs, at small sizes on the CPU.

The cull runs on the host from the poses; the port gathers each band's
image slots on the device from one copy of the frames. Held here, bit for
bit: the call with ``images`` as numpy, the same call with ``images`` as a
CPU tensor, the host fill the layouts had before the gather moved to the
device (``host_fill``), and JAX's ``ids`` / ``quats`` / ``ts`` /
``images``. A rank's ``tiles=`` subset keeps the other bands as padding
(zero images, parked poses, id -1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_mapper_tpu.camera import Camera as JCam
from aerial_mapper_tpu.geo.se3 import matrix_to_quat
from aerial_mapper_tpu.mapgrid import MapGeometry as JGeom
from aerial_mapper_tpu.parallel import sharded as jsh
from aerial_mapper_tpu.synth import make_survey_poses
from aerial_mapper_tpu_torch.camera.models import Camera as TCam
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry as TGeom
from aerial_mapper_tpu_torch.parallel import sharded as tsh
from aerial_mapper_tpu_torch.parallel.mesh import make_mesh

N_TILES = 4
N_IMAGES = 9
GEOM = (40.0, 0.0, 1.0, 192, 48)  # tests/test_torch_parallel.py's cull map
SMALL_CAM = (160.0, 160.0, 80.0, 60.0, 160, 120)
RADTAN = ("radial-tangential", (-0.28, 0.07, 1e-4, -2e-4))
SLAB = dict(elev_min=395.0, elev_max=435.0)

# name: (camera, frame shape and dtype, keyword arguments, band layout)
# "differ": the bands keep different members; "all": every band keeps
# every image in order (the frames expanded along the band axis); "same":
# every band holds the same slots (one band expanded)
CASES = {
    "culled": (SMALL_CAM, ((12, 16), np.float32), SLAB, "differ"),
    # the slab's low end far below the terrain (as BM outliers put it):
    # every footprint spans the map
    "every_band": (SMALL_CAM, ((12, 16), np.float32),
                   dict(elev_min=-500.0, elev_max=435.0), "all"),
    "no_slab": (SMALL_CAM, ((12, 16), np.float32), {}, "all"),
    # every band alike, but padded past the frames: one gathered band
    "no_slab_padded": (SMALL_CAM, ((12, 16), np.float32),
                       dict(capacity_multiple=4), "same"),
    "tiles_subset": (SMALL_CAM, ((12, 16), np.float32),
                     dict(SLAB, tiles=[3, 1]), "differ"),
    "capacity_multiple": (SMALL_CAM, ((12, 16), np.float32),
                          dict(SLAB, capacity_multiple=2), "differ"),
    "colored": (SMALL_CAM, ((12, 16, 3), np.uint8), SLAB, "differ"),
    "distorted": (SMALL_CAM + RADTAN, ((12, 16), np.float32), SLAB,
                  "differ"),
}


def survey(frame_shape, dtype, seed=0):
    """The nadir attitudes of ``tests/test_parallel.py``'s cull survey (9
    frames at 474 m) at positions 22 m apart from north to south across
    the map, so that each band keeps its own members, and random frames
    from ``seed``."""
    Rs, ts = make_survey_poses(N_IMAGES, altitude=474.0, spacing=8.0)
    ts = np.array(ts)
    ts[:, 1] = 20.0 - 22.0 * np.arange(N_IMAGES)
    quats = np.asarray(matrix_to_quat(jnp.asarray(Rs, jnp.float32)))
    rng = np.random.default_rng(seed)
    images = rng.uniform(0.0, 255.0, (N_IMAGES,) + frame_shape)
    if dtype == np.uint8:
        images = np.round(images)
    return quats, ts, images.astype(dtype)


def host_fill(images: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The image layout as the host filled it before the gather moved to
    the device: ``images[ids[t, j]]`` in each real slot, zeros in
    padding."""
    out = np.zeros(ids.shape + images.shape[1:], images.dtype)
    for t in range(ids.shape[0]):
        k = int((ids[t] >= 0).sum())
        out[t, :k] = images[ids[t, :k]]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_band_image_operands_matches_host_fill_and_jax(case):
    cam, (frame_shape, dtype), kw, layout = CASES[case]
    quats, ts, images = survey(frame_shape, dtype)
    tiles = kw.get("tiles")
    jkw = {k: v for k, v in kw.items() if k != "tiles"}
    jband = jsh.band_image_operands(JGeom(*GEOM), N_TILES, quats, ts,
                                    images, JCam(*cam), **jkw)
    args = (TGeom(*GEOM), N_TILES, quats, ts)
    given = images.copy()
    from_np = tsh.band_image_operands(*args, given, TCam(*cam),
                                      device="cpu", **kw)
    frames = torch.as_tensor(images.copy())
    from_tensor = tsh.band_image_operands(*args, frames, TCam(*cam),
                                          device="cpu", **kw)

    for a, b in zip(from_np, from_tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert from_np.images.dtype == torch.from_numpy(images).dtype
    ids = from_np.ids.numpy()
    assert ids.shape == np.asarray(jband.ids).shape
    np.testing.assert_array_equal(from_np.images.numpy(),
                                  host_fill(images, ids))

    # JAX fills every band; the port fills the bands of ``tiles`` and
    # parks the others
    fill = sorted(set(tiles)) if tiles is not None else list(range(N_TILES))
    rest = [t for t in range(N_TILES) if t not in fill]
    for got, want in zip(from_np, jband):
        np.testing.assert_array_equal(got.numpy()[fill],
                                      np.asarray(want)[fill])
    assert (ids[rest] == -1).all()
    assert (from_np.images[rest] == 0).all()
    assert (from_np.ts[rest][..., 2] == 1.0e9).all()
    assert (from_np.quats[rest] == torch.tensor([1.0, 0, 0, 0])).all()

    kept = (ids >= 0).sum(axis=1)
    if layout in ("all", "same"):  # one band, expanded
        assert (kept == N_IMAGES).all()
        assert from_np.images.stride(0) == 0
        # the frames themselves, or a band of their own
        assert (from_tensor.images[0].data_ptr() == frames.data_ptr()) \
            == (layout == "all")
    else:
        assert kept[fill].min() < N_IMAGES  # the cull has bite
        assert len(set(map(tuple, ids[fill]))) > 1
    if "capacity_multiple" in kw:
        assert ids.shape[1] % kw["capacity_multiple"] == 0
        assert ids.shape[1] > kept.max()  # a padded slot to round up
    # numpy input is copied: the result never aliases the caller's array
    given[...] = 0
    np.testing.assert_array_equal(from_np.images.numpy(),
                                  host_fill(images, ids))


@pytest.mark.parametrize("layout", ["every_band", "culled"])
def test_band_image_shards_are_own_copies(layout):
    """Each shard of a 4-band tiles mesh gets its band as a tensor of its
    own (the expanded layout too): equal to the band, sharing no bytes
    with another shard or with the caller's frames."""
    cam, (frame_shape, dtype), kw, _layout = CASES[layout]
    quats, ts, images = survey(frame_shape, dtype)
    frames = torch.as_tensor(images)
    banded = tsh.band_image_operands(TGeom(*GEOM), N_TILES, quats, ts,
                                     frames, TCam(*cam), device="cpu", **kw)
    mesh = make_mesh(("tiles",), shape=(N_TILES,),
                     devices=["cpu"] * N_TILES)
    _q, _t, shard_images, _ids = tsh._band_image_shards(mesh, banded,
                                                        "tiles")
    ptrs = {frames.data_ptr()}
    for t, im in enumerate(shard_images):
        assert torch.equal(im, banded.images[t])
        assert im.is_contiguous() and im.data_ptr() not in ptrs
        ptrs.add(im.data_ptr())
