"""Tile- and pair-sharded map operators over a mesh, in one process or
across processes.

Twin of ``aerial_mapper_tpu/parallel/sharded.py``. Map rasters are split
into row bands over the ``tiles`` axis; stereo pair batches are split over
the mesh with RING frames (one frame per pair slot; the boundary frame
moves to the neighbour by ``ppermute``). Where JAX runs a ``shard_map``
body, this module runs the body once per shard (``collectives.each``) and
the collectives of ``parallel/collectives.py`` between the phases.

A sharded layer dict is ``{name: [band per shard]}`` in the mesh's flat
order (a band is replicated over the axes other than ``tiles``):
:func:`shard_layers` builds it and :func:`unshard_layers` concatenates the
bands on one device (the JAX global array needs no such step). On a mesh
across processes each rank holds its own shards' entries (the others are
None), runs only its shards' bodies, and every operand that all ranks hold
alike is placed by each on its own shards; :func:`unshard_layers` gathers
the whole raster on every rank.

The fused :func:`sharded_map_step` scales the per-shard footprint down
with the mesh: stereo points are ROUTED to their owner tile with a
fixed-capacity ``all_to_all`` (each shard bins ~1/n_tiles of the cloud),
the interior halo rows of the binned structure are completed by trading
[K, halo, W] strips (``halo_exchange_extended``), and each band's ortho
pass textures from a conservatively CULLED image subset
(:func:`band_image_operands`). :func:`sharded_dsm_update` and
:func:`sharded_backward_grid_update` keep the simpler replicated-operand
layout of the batch drivers.

Every op launches the port's kernels per shard on band operands: the BM
scan per pair, the IDW per band, the score pass per band. All of them are
bit-identical to their single-device counterparts (binning against the
global edges with the global-rank tie-break, window order and the first-max
argmax are deterministic and band-local); the routed step additionally
needs its routing ``overflow`` to be 0 and, with a culled image subset,
the elevations inside the cull's slab (:meth:`StepDiagnostics.check`).
The float ``psum``s of the homography mosaic and of
``ba/bundle_adjust.py::sharded_bundle_adjust`` agree with one device to
float rounding of the summation order, and two sharded runs bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from aerial_mapper_tpu_torch.camera.models import (
    DIST_NONE,
    Camera,
    undistort_points,
)
from aerial_mapper_tpu_torch.config import (
    BlockMatchingConfig,
    DsmConfig,
    OrthoBackwardGridConfig,
    SgmConfig,
)
from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.dsm.cuda_idw import binned_idw_cuda
from aerial_mapper_tpu_torch.dsm.idw import _window_halfwidth, bin_points
from aerial_mapper_tpu_torch.io.poses import _rot_matrix_np
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry
from aerial_mapper_tpu_torch.ortho.backward_grid import backward_grid_update
from aerial_mapper_tpu_torch.parallel import collectives as cl
from aerial_mapper_tpu_torch.parallel.halo import halo_exchange_extended
from aerial_mapper_tpu_torch.parallel.mesh import Mesh
from aerial_mapper_tpu_torch.stereo.batched import (
    PairOperands,
    filter_points_z,
    prepare_pair_operands,
    process_pairs_batched,
)

_MAX_RANK = 2 ** 31 - 1  # the rank of a padding row: never wins a tie


def _halo(geom: MapGeometry, cfg: DsmConfig) -> int:
    return _window_halfwidth(
        cfg.max_radius_sq if cfg.adaptive_interpolation
        else cfg.interpolation_radius_sq,
        geom.resolution,
    )


def _check_halo_fits_band(geom: MapGeometry, n_tiles: int,
                          cfg: DsmConfig) -> None:
    """The routed DSM band update trades halo strips with IMMEDIATE
    neighbours only, so a point can influence another tile's cells only
    when the IDW window half-width fits inside one band. A halo wider than
    the band would silently lose contributions from tiles two hops away:
    reject the configuration instead."""
    halo = _halo(geom, cfg)
    band_h = geom.height // n_tiles
    if halo > band_h:
        raise ValueError(
            f"IDW halo ({halo} rows at resolution {geom.resolution}) "
            f"exceeds the per-tile band height ({band_h} rows = "
            f"{geom.height} / {n_tiles} tiles); halo exchange only spans "
            "immediate neighbors. Use fewer tiles, a taller map, or a "
            "smaller max_radius_sq."
        )


def _band_geom(geom: MapGeometry, band_h: int, halo: int) -> MapGeometry:
    """A halo-extended band of ``geom`` (the IDW reads only its shape and
    resolution; binning uses the global edges)."""
    return MapGeometry(geom.center_easting, geom.center_northing,
                       geom.resolution, band_h + 2 * halo,
                       geom.width + 2 * halo)


def _binned_idw_band(binned, ext_geom: MapGeometry, cfg: DsmConfig):
    """Shared band tail of the replicated and the routed band updates: the
    IDW of a halo-extended binned structure. "pallas" and "xla" compute
    the same function and both run ``binned_idw_cuda`` (the CUDA kernel on
    a CUDA tensor, its plain version on a CPU one), as ``idw_to_grid``
    does."""
    if cfg.idw_kernel not in ("xla", "pallas"):
        raise ValueError(
            f"idw kernel must be 'xla' or 'pallas', got {cfg.idw_kernel!r}"
        )
    return binned_idw_cuda(
        binned, ext_geom, radius_sq=cfg.interpolation_radius_sq,
        adaptive=cfg.adaptive_interpolation,
        growth=cfg.adaptive_growth_factor,
        max_radius_sq=cfg.max_radius_sq,
    )


def _band_result(elevation_band, binned, geom, cfg, halo):
    band_h = elevation_band.shape[0]
    values, hit = _binned_idw_band(binned, _band_geom(geom, band_h, halo),
                                   cfg)
    values = values[halo:halo + band_h, halo:halo + geom.width]
    hit = hit[halo:halo + band_h, halo:halo + geom.width]
    return torch.where(hit, values, elevation_band)


def _dsm_band_update(elevation_band, points, valid, geom: MapGeometry,
                     cfg: DsmConfig, tile: int):
    """Update one tile's elevation row band from the full point set: the
    band and its halo rows are binned directly from the replicated cloud,
    against the GLOBAL edges (only the integer row shift is band-local),
    so every float operation is that of the single-device path."""
    halo = _halo(geom, cfg)
    band_h = elevation_band.shape[0]
    binned = bin_points(
        points[:, :2], points[:, 2], valid,
        _band_geom(geom, band_h, halo), cfg.bin_capacity,
        north=geom.north, west=geom.west,
        row_offset=halo - tile * band_h, col_offset=halo,
    )
    return _band_result(elevation_band, binned, geom, cfg, halo)


def sharded_dsm_update(
    elevation: list,  # [band_h, W] per shard
    points: torch.Tensor,  # [N, 3] (replicated)
    valid: torch.Tensor,  # [N]
    geom: MapGeometry,
    cfg: DsmConfig,
    mesh: Mesh,
    axis_name: str = "tiles",
) -> list:
    """Row-band-sharded DSM update; bit-identical to the single-device
    ``update_elevation_layer`` (no halo/band constraint: each band bins its
    halo rows directly from the replicated cloud). ``elevation`` and the
    result are sharded layers (:func:`shard_layers`)."""
    tile = cl.axis_index(mesh, axis_name)
    return cl.each(
        mesh,
        lambda f, e, p, v: _dsm_band_update(e, p, v, geom, cfg, tile[f]),
        elevation, cl.replicate(mesh, points), cl.replicate(mesh, valid))


def _layer_shards(layers: dict, mesh: Mesh) -> list:
    """{name: [band per shard]} -> [{name: band} per shard]."""
    return [{k: v[f] for k, v in layers.items()} for f in range(mesh.size)]


def _shard_layers_of(per_shard: list) -> dict:
    """[{name: band} per shard] -> {name: [band per shard]} (another
    rank's shards: None)."""
    names = next(d for d in per_shard if d is not None)
    return {k: [None if d is None else d[k] for d in per_shard]
            for k in names}


def _ortho_bands(layers: dict, quats: list, ts: list, images: list,
                 ids: list, geom: MapGeometry, cam: Camera,
                 cfg: OrthoBackwardGridConfig, mesh: Mesh,
                 axis_name: str) -> dict:
    """Each tile's backward-grid pass on its band (global row offset)
    against its own image operands; sharded layers in and out."""
    tile = cl.axis_index(mesh, axis_name)

    def body(f, band, q, t, im, i):
        return backward_grid_update(
            band, q, t, im, geom, cam, cfg, image_ids=i,
            row_offset=tile[f] * band["elevation_angle"].shape[0])

    return _shard_layers_of(cl.each(mesh, body, _layer_shards(layers, mesh),
                                    quats, ts, images, ids))


def sharded_backward_grid_update(
    layers: dict,
    quats_G_C: torch.Tensor,
    t_G_C: torch.Tensor,
    images: torch.Tensor,
    geom: MapGeometry,
    cam: Camera,
    cfg: OrthoBackwardGridConfig,
    mesh: Mesh,
    axis_name: str = "tiles",
    image_ids=None,
) -> dict:
    """Row-band-sharded backward-grid ortho (cells are independent, so the
    only distribution cost is the replicated image operands).
    ``image_ids`` (optional [M] int tensor): explicit global observation
    ids (the multicam drivers' convention); None keeps the positional
    0..M-1 ids. ``layers`` and the result are sharded layers."""
    rep = functools.partial(cl.replicate, mesh)
    ids = [None] * mesh.size if image_ids is None else rep(image_ids)
    return _ortho_bands(layers, rep(quats_G_C), rep(t_G_C), rep(images),
                        ids, geom, cam, cfg, mesh, axis_name)


def sharded_backward_grid_update_banded(
    layers: dict,
    banded: "BandedImages",
    geom: MapGeometry,
    cam: Camera,
    cfg: OrthoBackwardGridConfig,
    mesh: Mesh,
    axis_name: str = "tiles",
) -> dict:
    """Row-band-sharded backward-grid ortho with per-band CULLED image
    subsets (:func:`band_image_operands`, [n_tiles, M, ...]): each tile
    holds only its band's images instead of the full stack, the batch
    driver's scale-out path. The caller owns the cull slab's validity;
    the batch driver derives it from the actual post-DSM elevation range,
    so it is exact by construction."""
    return _ortho_bands(layers, *_band_image_shards(mesh, banded, axis_name),
                        geom, cam, cfg, mesh, axis_name)


# ---------------------------------------------------------------------------
# Fused multi-shard map step: ring-pass pair-sharded stereo -> owner-tile
# routed points -> halo-strip-exchanged binned DSM -> band-culled ortho.
# ---------------------------------------------------------------------------


class RingPairOperands(NamedTuple):
    """Pair operands with ONE frame per pair slot (ring layout).

    ``frames[j]`` is pair j's LEFT frame; the right frame is the next
    slot's left frame: within a shard a local shift, across the shard
    boundary one ``ppermute`` of one frame (the ring pass of the shared
    boundary frame, the analogue of the reference's previous-frame reuse,
    stereo.cpp:127-147). Halves the image bytes of the duplicated-image
    layout. ``tail`` is the right frame of the LAST pair (replicated).

    ``pair_valid`` (optional [B] bool) marks real pair slots; padding slots
    appended by :func:`pad_ring_pairs` carry False and contribute no
    points (their triangulated output is masked invalid before routing).
    """

    frames: torch.Tensor  # [B, H, W]
    tail: torch.Tensor  # [H, W]
    T1_inv: torch.Tensor  # [B, 3, 3]
    T2_inv: torch.Tensor
    corners_rect: torch.Tensor  # [B, 4, 2]
    R_G_C_rect: torch.Tensor  # [B, 3, 3]
    t_G_C1: torch.Tensor  # [B, 3]
    baseline: torch.Tensor  # [B]
    pair_valid: Optional[torch.Tensor] = None  # [B] bool (None: all real)


_PAIR_FIELDS = ("T1_inv", "T2_inv", "corners_rect", "R_G_C_rect", "t_G_C1",
                "baseline")


def pad_ring_pairs(ring: RingPairOperands,
                   multiple: int) -> RingPairOperands:
    """Pad the pair batch up to a multiple of the shard count.

    Padding slots are appended at the END so every real pair keeps its
    global slot index (the nearest-K rank tie-break stays that of the
    unpadded single-device cloud). A padding slot's LEFT frame is the ring
    ``tail``, so the last REAL pair still receives its true right frame
    from the next slot over the ring pass; padding pairs match ``tail``
    against ``tail`` and are masked out through ``pair_valid``.
    """
    b = ring.frames.shape[0]
    pad = (-b) % multiple
    pv = ring.pair_valid
    if pv is None:
        pv = torch.ones(b, dtype=torch.bool, device=ring.frames.device)
    if pad == 0:
        return ring._replace(pair_valid=pv)

    def pad_tail(x):
        return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])

    return RingPairOperands(
        frames=torch.cat([ring.frames,
                          ring.tail[None].expand((pad,) + ring.tail.shape)]),
        tail=ring.tail,
        **{k: pad_tail(getattr(ring, k)) for k in _PAIR_FIELDS},
        pair_valid=torch.cat([pv, torch.zeros(pad, dtype=torch.bool,
                                              device=pv.device)]),
    )


def pad_map_geometry(geom: MapGeometry, n_tiles: int):
    """(padded_geom, pad_rows): extend the map SOUTH to a height divisible
    by ``n_tiles``; crop results with ``layers[k][:geom.height]``.

    The north and west edges are kept, so cell assignment, cell-centre
    arithmetic and the IDW halo reads of every ORIGINAL row are those of
    the unpadded map (the padding only appends southern rows whose results
    are discarded)."""
    pad = (-geom.height) % n_tiles
    if pad == 0:
        return geom, 0
    h = geom.height + pad
    return MapGeometry(
        center_easting=geom.center_easting,
        center_northing=geom.north - 0.5 * h * geom.resolution,
        resolution=geom.resolution,
        height=h,
        width=geom.width,
    ), pad


def prepare_ring_pair_operands(K, Rs, ts, images, use_every_nth: int = 1,
                               phase: int = None,
                               device=None) -> RingPairOperands:
    """Host side: consecutive (subsampled) frames -> ring pair operands on
    ``device`` (``None`` means CUDA). Consecutive pairs share frames (pair
    j = frames a_j, a_{j+1}), so the ring layout stores each frame once
    instead of twice. ``phase`` as in ``prepare_pair_operands``."""
    ops = prepare_pair_operands(K, Rs, ts, images,
                                use_every_nth=use_every_nth, phase=phase,
                                device=device)
    return RingPairOperands(
        frames=ops.image1, tail=ops.image2[-1],
        **{k: getattr(ops, k) for k in _PAIR_FIELDS},
    )


def _shard_ring(mesh: Mesh, ring: RingPairOperands, axes) -> list:
    """The ring operands of each shard: the pair slots split over ``axes``
    (flattened), ``tail`` replicated."""
    fields = {k: cl.scatter(mesh, getattr(ring, k), axes)
              for k in ("frames",) + _PAIR_FIELDS}
    pv = (None if ring.pair_valid is None
          else cl.scatter(mesh, ring.pair_valid, axes))
    tail = cl.replicate(mesh, ring.tail)
    return cl.each(mesh, lambda f, t: RingPairOperands(
        tail=t, pair_valid=None if pv is None else pv[f],
        **{k: v[f] for k, v in fields.items()}), tail)


def _ring_stereo(mesh: Mesh, rings: list, cam: Camera, matcher: str,
                 bm_cfg: BlockMatchingConfig, sgm_cfg: SgmConfig, axes):
    """The shared front end of the sharded bodies: ring-pass the boundary
    frame, then run each shard's stereo pairs one per pass
    (``batch_chunk=1``: one BM launch per pair). Returns per-shard lists
    (pts [b_loc, HW, 3], intens [b_loc, HW], valid [b_loc, HW]) with the
    padding slots masked."""
    n = cl.axis_size(mesh, axes)
    idx = cl.axis_index(mesh, axes)
    # each pair's right frame is the NEXT slot's left frame; only the
    # shard-boundary frame moves between shards
    from_next = cl.ppermute(mesh, cl.each(mesh, lambda f, r: r.frames[0],
                                          rings),
                            axes, [(i + 1, i) for i in range(n - 1)])

    def body(f, ring, nxt):
        last_right = ring.tail if idx[f] == n - 1 else nxt
        pair_ops = PairOperands(
            image1=ring.frames,
            image2=torch.cat([ring.frames[1:], last_right[None]]),
            **{k: getattr(ring, k) for k in _PAIR_FIELDS},
        )
        pts, intens, valid = process_pairs_batched(
            pair_ops, cam, bm_cfg, device=ring.frames.device,
            matcher=matcher, sgm_cfg=sgm_cfg, batch_chunk=1)
        if ring.pair_valid is not None:
            # padding slots (pad_ring_pairs) contribute no points
            valid = valid & ring.pair_valid[:, None]
        return pts, intens, valid

    return cl.unzip(cl.each(mesh, body, rings, from_next), 3)


def sharded_process_pairs(
    ops: RingPairOperands,
    cam: Camera,
    mesh: Mesh,
    matcher: str = "bm",
    bm_cfg: BlockMatchingConfig = BlockMatchingConfig(),
    sgm_cfg: SgmConfig = SgmConfig(),
    axis_name: str = "tiles",
):
    """Pair-data-parallel stereo for the BATCH drivers: the ring pair batch
    (pad with :func:`pad_ring_pairs` first) is split over the shards; each
    runs its pairs through the same per-pair program and the outputs
    concatenate back in global pair order on the operands' device, bit for
    bit ``process_pairs_batched(..., batch_chunk=1)`` per pair (the
    reference's sequential stereo loop, stereo.cpp:91-110, scaled out)."""
    b = ops.frames.shape[0]
    n_dev = mesh.shape[axis_name]
    if b % n_dev != 0:
        raise ValueError(
            f"pair batch {b} not divisible by {n_dev} devices; pad with "
            "pad_ring_pairs"
        )
    outs = _ring_stereo(mesh, _shard_ring(mesh, ops, axis_name), cam,
                        matcher, bm_cfg, sgm_cfg, axis_name)
    return tuple(cl.concat(mesh, o, axis_name, device=ops.frames.device)
                 for o in outs)


class BandedImages(NamedTuple):
    """Per-tile-band image subsets for the ortho pass.

    Cells in one row band see a bounded camera subset, so each band holds
    only the images whose ground footprint can overlap it (a conservative
    frustum cull on the host from the poses, the images gathered on the
    device, :func:`band_image_operands`): per-shard image bytes shrink
    with the mesh instead of replicating the full stack. ``ids`` maps
    local slot -> global image index; -1 marks padding slots (zero
    images) whose pose is parked 1e9 m above ground (invisible to every
    finite cell, so they contribute nothing and keep ``num_observations``
    exact). The replicated layout (:func:`replicated_band_images`) has no
    band axis: ``ids`` is [M] there, [n_tiles, M] when culled. Where every
    band holds the same slots, the culled ``images`` are one band expanded
    along the band axis (a read-only view holding one band's bytes).
    """

    images: torch.Tensor  # [n_tiles, M, H, W(, 3)] or [M, H, W(, 3)]
    quats: torch.Tensor  # [n_tiles, M, 4] or [M, 4]
    ts: torch.Tensor  # [n_tiles, M, 3] or [M, 3]
    ids: torch.Tensor  # [n_tiles, M] or [M] int32, -1 = padding


def replicated_band_images(quats_G_C, t_G_C, images,
                           device=None) -> BandedImages:
    """Every-band (unculled) operands in the REPLICATED layout: [M, ...]
    tensors shared by every tile instead of an [n_tiles, M, ...] copy per
    band. Use when no elevation slab is known (see the slab obligation of
    :func:`sharded_map_step`). ``device=None`` means CUDA; tensors stay
    as they are (the images keep their dtype), arrays are copied."""
    dev = resolve_device(device)

    def on_dev(x, dtype=None):  # tensors as they are, arrays copied
        x = x if torch.is_tensor(x) else torch.as_tensor(np.array(x))
        return x.to(dev, dtype)

    return BandedImages(
        images=on_dev(images), quats=on_dev(quats_G_C, torch.float32),
        ts=on_dev(t_G_C, torch.float32),
        ids=torch.arange(len(t_G_C), dtype=torch.int32, device=dev),
    )


@functools.lru_cache(maxsize=16)
def _boundary_ray_dirs(cam: Camera) -> np.ndarray:
    """[3, B] camera-frame rays through every image-BOUNDARY pixel centre
    plus the half-pixel outer corners, through the lens model (read-only;
    memoized per camera: it depends on nothing else).

    For a distorted camera the ground footprint's extremes need not lie at
    the 4 corners, but the image boundary maps to a closed curve on any
    ground plane and the interior maps inside it (continuity), so rays
    through the full boundary ring bound the footprint; per-pixel sampling
    plus the caller's margin covers sub-pixel curvature between samples.
    Reference projection semantics under distortion:
    ortho-backward-grid.cc:66-81."""
    w, h = cam.width, cam.height
    us = np.arange(w, dtype=np.float64) + 0.5
    vs = np.arange(h, dtype=np.float64) + 0.5
    ring = np.concatenate([
        np.stack([us, np.full(w, 0.5)], 1),
        np.stack([us, np.full(w, h - 0.5)], 1),
        np.stack([np.full(h, 0.5), vs], 1),
        np.stack([np.full(h, w - 0.5), vs], 1),
        np.array([[-0.5, -0.5], [w - 0.5, -0.5], [w - 0.5, h - 0.5],
                  [-0.5, h - 0.5]]),
    ])  # [B, 2]
    xy = np.stack([(ring[:, 0] - cam.cx) / cam.fx,
                   (ring[:, 1] - cam.cy) / cam.fy], axis=1)
    if cam.dist_kind != DIST_NONE:
        # float32 through the lens model, as the JAX twin's device call
        xy = undistort_points(
            cam, torch.as_tensor(xy, dtype=torch.float32)).double().numpy()
    rays = np.concatenate([xy, np.ones((xy.shape[0], 1))], axis=1).T
    rays.setflags(write=False)
    return rays


def band_image_operands(
    geom: MapGeometry,
    n_tiles: int,
    quats_G_C,
    t_G_C,
    images,
    cam: Camera,
    elev_min=None,
    elev_max=None,
    margin_cells: float = 2.0,
    capacity_multiple: int = 1,
    device=None,
    tiles=None,
) -> BandedImages:
    """Conservative per-band image cull, on ``device`` (``None`` means
    CUDA): the cull runs on the host from the poses alone, the image
    slots are gathered on ``device``.

    An image can texture a cell only if the cell is inside its view
    frustum; intersecting the frustum boundary rays with the elevation
    slab [elev_min, elev_max] bounds the footprint's northing range (for a
    pinhole the 4 corner rays are exact; for a distorted camera the full
    boundary ring of rays through the lens model is used, plus
    ``margin_cells``). Bands whose row range misses it skip the image.
    Cameras with any non-descending boundary ray (horizon in view) go to
    every band (correct, no cull); so does ``elev_min=None`` (no slab
    known).

    SLAB OBLIGATION: the cull is exact only if every cell elevation the
    ortho pass reads, including values written by the SAME step's DSM
    update, lies in [elev_min, elev_max]. :func:`sharded_map_step` returns
    the post-update elevation range in its diagnostics so callers can
    verify; with no trustworthy slab use :func:`replicated_band_images`.

    ``capacity_multiple`` rounds the per-band capacity m up to a multiple
    (bucketing the operand shapes for a caller that culls per update).
    ``images`` ([N, H, W(, 3)]) is host numpy, copied to ``device`` once,
    or a tensor, moved there if it is elsewhere (and then used as it is:
    the result may be a view of it); each band's slots are gathered from
    it on ``device`` (``BandedImages``: one expanded band where every band
    holds the same slots). ``tiles`` (default: every band) names the bands
    the caller reads, as a rank of a mesh across processes reads its own:
    the capacity is still the whole cull's, and the other bands hold only
    padding slots (zero images): only their gathers are saved.
    """
    dev = resolve_device(device)
    quats_np = np.asarray(quats_G_C, np.float64)
    ts_np = np.asarray(t_G_C, np.float64)
    n = quats_np.shape[0]
    band_h = geom.height // n_tiles
    dirs_cam = _boundary_ray_dirs(cam)  # [3, B]
    margin = margin_cells * geom.resolution
    members = [[] for _ in range(n_tiles)]
    for i in range(n):
        every_band = elev_min is None or elev_max is None
        if not every_band:
            dirs = _rot_matrix_np(quats_np[i]) @ dirs_cam  # world rays
            if np.any(dirs[2] >= -1e-12):  # horizon / ascending ray
                every_band = True
            else:
                ns = []
                for z0 in (elev_min, elev_max):
                    s = (z0 - ts_np[i, 2]) / dirs[2]
                    ns.append(ts_np[i, 1] + s * dirs[1])
                n_lo = min(v.min() for v in ns) - margin
                n_hi = max(v.max() for v in ns) + margin
                r_lo = int(np.floor((geom.north - n_hi) / geom.resolution))
                r_hi = int(np.ceil((geom.north - n_lo) / geom.resolution))
                t_lo = max(r_lo // band_h, 0)
                t_hi = min(r_hi // band_h, n_tiles - 1)
                for t in range(t_lo, t_hi + 1):
                    members[t].append(i)
        if every_band:
            for t in range(n_tiles):
                members[t].append(i)

    m = max(1, max(len(mm) for mm in members))
    m = -(-m // capacity_multiple) * capacity_multiple
    out_quats = np.zeros((n_tiles, m, 4), np.float32)
    out_quats[..., 0] = 1.0  # identity padding
    out_ts = np.zeros((n_tiles, m, 3), np.float32)
    out_ts[..., 2] = 1.0e9  # padding pose far above ground: never visible
    out_ids = np.full((n_tiles, m), -1, np.int32)
    fill = range(n_tiles) if tiles is None else sorted(set(tiles))
    for t in fill:
        mm = members[t]
        out_quats[t, :len(mm)] = quats_np[mm]
        out_ts[t, :len(mm)] = ts_np[mm]
        out_ids[t, :len(mm)] = mm
    frames = (images.to(dev) if torch.is_tensor(images)
              else torch.tensor(np.asarray(images), device=dev))
    ids = torch.as_tensor(out_ids, device=dev)
    return BandedImages(
        images=_gather_band_images(frames, out_ids, ids),
        quats=torch.as_tensor(out_quats, device=dev),
        ts=torch.as_tensor(out_ts, device=dev), ids=ids)


def _gather_band_images(frames: torch.Tensor, ids_np: np.ndarray,
                        ids: torch.Tensor) -> torch.Tensor:
    """[n_tiles, M, ...] image slots on ``frames``' device: slot (t, j)
    holds ``frames[ids[t, j]]``, a padding slot (-1) zeros. ``ids_np`` is
    the host copy of ``ids``; each band's real slots come first. Where
    every band holds the same slots, one band is built (the frames
    themselves when the slots are every frame in order) and expanded
    along the band axis."""
    n_tiles, m = ids_np.shape
    rows = 1 if (ids_np == ids_np[0]).all() else n_tiles
    if rows == 1 and np.array_equal(ids_np[0], np.arange(len(frames))):
        out = frames[None]
    else:
        out = frames.new_zeros((rows, m) + frames.shape[1:])
        for t in range(rows):
            k = int((ids_np[t] >= 0).sum())
            torch.index_select(frames, 0, ids[t, :k], out=out[t, :k])
    return out.expand((n_tiles,) + out.shape[1:])


def _band_image_shards(mesh: Mesh, banded: BandedImages,
                       axis_name: str) -> list:
    """Each shard's [quats, ts, images, ids] lists: the culled layout
    ([n_tiles, M, ...]) split by tile, the replicated one ([M, ...])
    shared. The layouts are told apart by the ids' rank: the images' rank
    is ambiguous once colour channels enter."""
    fields = (banded.quats, banded.ts, banded.images, banded.ids)
    if banded.ids.dim() == 1:
        return [cl.replicate(mesh, a) for a in fields]
    return [cl.each(mesh, lambda f, x: x[0], cl.scatter(mesh, a, axis_name))
            for a in fields]


def _route_points(pts, valid, rank, geom: MapGeometry, n_tiles: int,
                  cap: int):
    """One shard's send buffers for the owner-tile routing: (rows
    [n_tiles * cap, 4] of xyz + valid, ranks [n_tiles * cap] int32,
    overflow), bucket t holding the points of tile t.

    The destination row uses the floor arithmetic of ``bin_points``
    against the GLOBAL north edge, so a routed point always lands inside
    its owner's extended band; out-of-map rows clamp to the edge tiles
    (their extended bands hold the out-of-map halo). ``overflow`` counts
    valid points dropped because a bucket exceeded ``cap``: exactness
    needs it to be 0 (the caller sizes ``cap`` and checks).
    """
    n = pts.shape[0]
    dev = pts.device
    band_h = geom.height // n_tiles
    row_g = torch.floor((geom.north - pts[:, 1]) / geom.resolution)
    row_i = torch.nan_to_num(row_g, nan=0.0).clamp(-2.0 ** 30, 2.0 ** 30) \
        .to(torch.int32)
    dest = torch.div(row_i, band_h, rounding_mode="floor") \
        .clamp(0, n_tiles - 1)
    ok_pt = valid & torch.isfinite(pts[:, 0]) & torch.isfinite(pts[:, 1])
    dest = torch.where(ok_pt, dest, torch.full_like(dest, n_tiles)).long()

    # JAX sorts (dest, index): a stable sort of dest is the same order
    sidx = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=n_tiles + 1)
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos = starts[:n_tiles, None] + torch.arange(cap, device=dev)[None]
    in_bucket = (pos < (starts[:n_tiles] + counts[:n_tiles])[:, None]) \
        .reshape(-1)
    src = sidx[pos.clamp(max=n - 1).reshape(-1)]  # [n_tiles * cap]

    # the float payload (xyz + valid) in one row; the int32 rank in its
    # own buffer, never carried in a float channel (a small rank's bit
    # pattern is a denormal, which a flushing copy would zero)
    packed = torch.cat([pts.float(), valid.float()[:, None]], dim=1)
    rows = torch.where(in_bucket[:, None], packed[src], 0.0)
    ranks = torch.where(in_bucket, rank.to(torch.int32)[src],
                        torch.full_like(src, _MAX_RANK, dtype=torch.int32))
    overflow = torch.clamp(counts[:n_tiles] - cap, min=0).sum()
    return rows, ranks, overflow


def _dsm_band_update_routed(elevation: list, pts: list, valid: list,
                            rank: list, geom: MapGeometry, cfg: DsmConfig,
                            mesh: Mesh, tiles_axis: str) -> list:
    """Band DSM update from OWNER-ROUTED points only.

    Each tile bins its own points into its halo-extended band (global-edge
    arithmetic, global-rank tie-break), then completes the interior halo
    rows by trading [K, halo, W] strips of the binned structure with its
    neighbours (:func:`halo_exchange_extended`): bit-identical to binning
    a replicated cloud, at 1/n_tiles of the points per shard.
    """
    halo = _halo(geom, cfg)
    tile = cl.axis_index(mesh, tiles_axis)

    def bin_band(f, e, p, v, r):
        band_h = e.shape[0]
        return bin_points(
            p[:, :2], p[:, 2], v, _band_geom(geom, band_h, halo),
            cfg.bin_capacity, north=geom.north, west=geom.west,
            row_offset=halo - tile[f] * band_h, col_offset=halo, rank=r,
        )

    binned = cl.each(mesh, bin_band, elevation, pts, valid, rank)

    def ex(name, axis):
        return halo_exchange_extended(
            mesh, cl.each(mesh, lambda f, b: getattr(b, name), binned), halo,
            tiles_axis, axis=axis)

    fields = dict(de=ex("de", 1), dn=ex("dn", 1),
                  payload=ex("payload", 1), count=ex("count", 0))
    binned = cl.each(mesh, lambda f, b: b._replace(
        **{k: v[f] for k, v in fields.items()}), binned)
    return cl.each(
        mesh, lambda f, e, b: _band_result(e, b, geom, cfg, halo),
        elevation, binned)


class StepDiagnostics(NamedTuple):
    """Validity signals of one :func:`sharded_map_step`.

    ``overflow``: valid points dropped by the fixed-capacity routing;
    exactness needs 0. ``elev_min`` / ``elev_max``: the global post-DSM
    elevation range the ortho pass read (+/-inf on an all-NaN map): the
    caller of a slab-culled :func:`band_image_operands` must check that it
    lies inside the slab the cull was built with, or the
    bit-identical-to-one-device invariant is void. ``routed``: [n_tiles]
    valid points each tile received from the routing (sums to the valid
    cloud when ``overflow`` is 0)."""

    overflow: torch.Tensor  # int scalar
    elev_min: torch.Tensor  # float32 scalar
    elev_max: torch.Tensor  # float32 scalar
    routed: Optional[torch.Tensor] = None  # [n_tiles] int

    def check(self, slab_min=None, slab_max=None):
        """Host-side validation (reads back three scalars); raises on
        routing overflow or a slab violation."""
        overflow = int(self.overflow)
        if overflow:
            raise RuntimeError(
                f"sharded_map_step dropped {overflow} routed points "
                "(raise route_capacity_factor)"
            )
        if slab_min is not None:
            lo, hi = float(self.elev_min), float(self.elev_max)
            if lo < slab_min or hi > slab_max:
                raise RuntimeError(
                    f"elevation range [{lo:.2f}, {hi:.2f}] escapes the "
                    f"band-cull slab [{slab_min:.2f}, {slab_max:.2f}]; "
                    "culled bands may have skipped visible images"
                )


def route_capacity(b: int, hw: int, n_pairs: int, n_tiles: int,
                   route_capacity_factor: float) -> int:
    """Points each shard may send to each tile: ``route_capacity_factor``
    times the fair share of its ``n_loc`` points, at most ``n_loc``."""
    n_loc = (b // (n_pairs * n_tiles)) * hw
    return min(n_loc, int(-(-route_capacity_factor * n_loc // n_tiles)))


def sharded_map_step(
    layers: dict,
    ops: RingPairOperands,
    banded: BandedImages,
    geom: MapGeometry,
    cam: Camera,
    dsm_cfg: DsmConfig,
    ortho_cfg: OrthoBackwardGridConfig,
    mesh: Mesh,
    matcher: str = "bm",
    bm_cfg: BlockMatchingConfig = BlockMatchingConfig(),
    sgm_cfg: SgmConfig = SgmConfig(),
    pairs_axis: str = "pairs",
    tiles_axis: str = "tiles",
    route_capacity_factor: float = 2.0,
    z_min=None,
    z_max=None,
):
    """One fused multi-shard mapping step over a (``pairs_axis``,
    ``tiles_axis``) mesh. Returns ``(layers, StepDiagnostics)``, the
    layers sharded (:func:`shard_layers`).

    The stereo pair batch is data-parallel over the flattened mesh with
    RING frames; the map rasters are row-band-sharded over ``tiles`` and
    replicated over ``pairs``. Points are ROUTED to their owner tile with
    a fixed-capacity ``all_to_all`` (capacity = ``route_capacity_factor``
    x the fair share) and gathered over ``pairs``, the binned halo strips
    are exchanged, and each band textures from its image subset: the
    conservatively CULLED per-band layout (:func:`band_image_operands`)
    or the replicated every-band layout (:func:`replicated_band_images`).

    Bit-identical to the single-device composition whenever
    ``diag.overflow == 0`` and (for a slab-culled ``banded``) the
    post-update elevation range lies inside the cull's slab:
    ``diag.check(slab_min, slab_max)`` validates both. A pair batch not
    divisible by the shard count must be padded first
    (:func:`pad_ring_pairs`); a map height not divisible by the tile
    count, through :func:`pad_map_geometry`.
    """
    axes = (pairs_axis, tiles_axis)
    n_pairs = mesh.shape[pairs_axis]
    n_tiles = mesh.shape[tiles_axis]
    b = ops.frames.shape[0]
    if b % (n_pairs * n_tiles) != 0:
        raise ValueError(
            f"pair batch {b} not divisible by device count "
            f"{n_pairs * n_tiles}; pad with pad_ring_pairs"
        )
    hw = ops.frames.shape[1] * ops.frames.shape[2]
    b_loc = b // (n_pairs * n_tiles)
    cap = route_capacity(b, hw, n_pairs, n_tiles, route_capacity_factor)
    _check_halo_fits_band(geom, n_tiles, dsm_cfg)
    flat_idx = cl.axis_index(mesh, axes)

    # 1-2) ring pass + local stereo (data-parallel over every shard)
    pts, _intens, valid = _ring_stereo(mesh, _shard_ring(mesh, ops, axes),
                                       cam, matcher, bm_cfg, sgm_cfg, axes)

    # 3) owner-tile routing: the send buffers, with each point's global
    #    rank (its index in the single-device full-batch cloud: the pair
    #    batch is sharded row-major over the flattened mesh)
    def route(f, p, v):
        v = filter_points_z(p, v, z_min, z_max)
        rank = flat_idx[f] * (b_loc * hw) + torch.arange(
            b_loc * hw, dtype=torch.int32, device=p.device)
        return _route_points(p.reshape(-1, 3), v.reshape(-1), rank, geom,
                             n_tiles, cap)

    rows, ranks, overflow = cl.unzip(cl.each(mesh, route, pts, valid), 3)
    del pts, valid
    rows = cl.all_gather(mesh, cl.all_to_all(mesh, rows, tiles_axis),
                         pairs_axis)
    ranks = cl.all_gather(mesh, cl.all_to_all(mesh, ranks, tiles_axis),
                          pairs_axis)
    overflow = cl.psum(mesh, cl.psum(mesh, overflow, tiles_axis),
                       pairs_axis)

    def unpack(f, r, k):
        r_valid = r[:, 3] > 0.5
        # padding rows carry the max rank: they never displace a real
        # point in the nearest-K tie-break
        return (r[:, :3], r_valid,
                torch.where(r_valid, k, torch.full_like(k, _MAX_RANK)))

    r_pts, r_valid, r_rank = cl.unzip(cl.each(mesh, unpack, rows, ranks),
                                      3)
    del rows, ranks
    # scale-out evidence: valid points each tile received
    routed = cl.each(mesh, lambda f, v: v.sum()[None], r_valid)

    # 4) tile-sharded DSM band update from routed points + halo strips
    layers = dict(layers)
    layers["elevation"] = _dsm_band_update_routed(
        layers["elevation"], r_pts, r_valid, r_rank, geom, dsm_cfg, mesh,
        tiles_axis)
    del r_pts, r_valid, r_rank

    # the slab diagnostic: global post-update elevation range (NaN cells
    # skipped; an all-NaN map gives the +/-inf sentinels)
    elev = layers["elevation"]
    inf = float("inf")
    lo = cl.each(mesh, lambda f, e: torch.where(torch.isnan(e), inf,
                                                e).amin(), elev)
    hi = cl.each(mesh, lambda f, e: torch.where(torch.isnan(e), -inf,
                                                e).amax(), elev)
    lo = cl.pmin(mesh, cl.pmin(mesh, lo, tiles_axis), pairs_axis)
    hi = cl.pmax(mesh, cl.pmax(mesh, hi, tiles_axis), pairs_axis)

    # 5) tile-sharded backward-grid ortho against each band's image
    #    subset (culled or replicated)
    layers = _ortho_bands(layers,
                          *_band_image_shards(mesh, banded, tiles_axis),
                          geom, cam, ortho_cfg, mesh, tiles_axis)
    # the diagnostics are replicated: read this rank's first replica
    # (shard 0 lives on rank 0 only)
    diag = StepDiagnostics(
        overflow=cl.first_local(mesh, overflow),
        elev_min=cl.first_local(mesh, lo), elev_max=cl.first_local(mesh, hi),
        routed=cl.concat(mesh, routed, tiles_axis),
    )
    return layers, diag


def sharded_plane_sweep(
    ops,  # PlaneSweepOperands, [B, ...] with B % n_shards == 0
    cam: Camera,
    cfg,
    mesh: Mesh,
    axis_name: str = "tiles",
):
    """Reference-view-data-parallel plane-sweep MVS: the batched view
    SLOTS (``prepare_plane_sweep_operands(pad_to_multiple=n_shards)``)
    are split over the shards; the unique image stack stays replicated
    (every shard may reference any frame through ``view_idx``) and each
    shard runs ``plane_sweep_batched`` on its slots, one slot per pass as
    the one-device sweep runs its views (on the card the box filters'
    cumsums round with the batch's shape), so every view's points are
    those of ``process_sequence_plane_sweep`` bit for bit. The outputs
    concatenate back in global view order on the operands' device (no
    exchange: a reference view owns its whole neighbourhood)."""
    from aerial_mapper_tpu_torch.stereo.plane_sweep import (
        PlaneSweepOperands,
        plane_sweep_batched,
    )

    b = ops.view_idx.shape[0]
    n_dev = mesh.shape[axis_name]
    if b % n_dev != 0:
        raise ValueError(
            f"reference-view batch {b} not divisible by {n_dev} devices; "
            "pad with prepare_plane_sweep_operands(pad_to_multiple=...)"
        )
    images = cl.replicate(mesh, ops.images)
    slots = {k: cl.scatter(mesh, getattr(ops, k), axis_name)
             for k in PlaneSweepOperands._fields if k != "images"}
    shard_ops = cl.each(mesh, lambda f, im: PlaneSweepOperands(
        images=im, **{k: v[f] for k, v in slots.items()}), images)

    def body(f, o):
        parts = [plane_sweep_batched(
            o._replace(**{k: getattr(o, k)[i:i + 1] for k in slots}), cam,
            cfg, device=o.images.device) for i in range(o.view_idx.shape[0])]
        return tuple(torch.cat(p) for p in zip(*parts))

    outs = cl.each(mesh, body, shard_ops)
    return tuple(cl.concat(mesh, o, axis_name, device=ops.images.device)
                 for o in cl.unzip(outs, len(cl.first_local(mesh, outs))))


def sharded_homography_mosaic_batch(
    images: torch.Tensor,  # [N, H, W]
    quats_G_C: torch.Tensor,  # [N, 4]
    t_G_C: torch.Tensor,  # [N, 3]
    cam: Camera,
    cfg,
    mesh: Mesh,
    needs_undistortion: bool = True,
    axis_name: str = "tiles",
    return_state: bool = False,
):
    """Image-sharded forward-homography feather mosaic, on the images'
    device.

    The feather blend is a weighted SUM over images
    (ortho-forward-homography.cc:197-202, cv::detail::FeatherBlender), so
    it is commutative: each shard folds its images into local
    (weighted_sum, weight_sum) accumulators and two ``psum``s complete
    the blend. Equal to the single-device ``homography_mosaic_batch`` up
    to float summation order (allclose, not bit-identical). The batch is
    padded to the shard count with copies of the last image whose slots
    are masked: a masked slot leaves the accumulators as they were, so the
    fold skips it.
    """
    from aerial_mapper_tpu_torch.camera.undistort import undistort_image
    from aerial_mapper_tpu_torch.ortho.homography import (
        MosaicState,
        _accumulate_fn,
        create_mosaic_state,
    )

    n = images.shape[0]
    n_dev = mesh.shape[axis_name]
    pad = (-n) % n_dev
    if pad:
        def pad_tail(x):
            return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])

        images, quats_G_C, t_G_C = (pad_tail(x)
                                    for x in (images, quats_G_C, t_G_C))
    valid = cl.scatter(mesh, torch.arange(n + pad) < n, axis_name)
    accumulate = _accumulate_fn(cfg)
    undistort = needs_undistortion and cam.dist_kind != DIST_NONE

    def fold(f, ims, qs, ts, ok):
        state = create_mosaic_state(cfg, device=ims.device)
        for image, q, t, keep in zip(ims, qs, ts.float(), ok.tolist()):
            if not keep:  # a padding slot
                continue
            if undistort:
                image = undistort_image(cam, image)
            state = accumulate(state, image, q.float(), t, cam, cfg)
        return state

    states = cl.each(mesh, fold, *(cl.scatter(mesh, x, axis_name)
                                   for x in (images, quats_G_C, t_G_C)),
                     valid)
    num = cl.psum(mesh, cl.each(mesh, lambda f, s: s.weighted_sum, states),
                  axis_name)
    den = cl.psum(mesh, cl.each(mesh, lambda f, s: s.weight_sum, states),
                  axis_name)
    # the single-device blend epsilon, verbatim (MosaicState.mosaic)
    st = MosaicState(cl.first_local(mesh, num).to(images.device),
                     cl.first_local(mesh, den).to(images.device))
    return st if return_state else st.mosaic


def shard_layers(layers: dict, mesh: Mesh, axis_name: str = "tiles") -> dict:
    """Place a layer dict row-band-sharded on the mesh: {name: [band per
    shard]}, each band a copy on its shard's device (replicated over the
    other axes; across processes each rank places only its own bands, from
    the whole layers every rank holds). The height must divide by the tile
    count (:func:`pad_map_geometry`)."""
    return {k: cl.scatter(mesh, v, axis_name) for k, v in layers.items()}


def unshard_layers(layers: dict, mesh: Mesh, axis_name: str = "tiles",
                   device=None) -> dict:
    """The bands of a sharded layer dict concatenated into [H, W] layers on
    ``device`` (default: this rank's first shard's device); across
    processes every rank gathers the whole raster."""
    return {k: cl.concat(mesh, v, axis_name, device=device)
            for k, v in layers.items()}
