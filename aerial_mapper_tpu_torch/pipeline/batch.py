"""Batch pipeline drivers — one per reference demo executable.

Twin of ``aerial_mapper_tpu/pipeline/batch.py``.
Each function replays one of the reference mains end to end (SURVEY.md §3
call stacks) and returns / persists typed artifacts:

- ``run_dense_pcl``       <- aerial_mapper_demos_dense_pcl (main-dense-pcl.cc)
- ``run_dsm``             <- aerial_mapper_demos_dsm (main-dsm.cc)
- ``run_ortho_backward_grid`` <- ..._ortho_backward_grid (batch mode)
- ``run_ortho_forward_homography`` <- ..._ortho_forward_homography
- ``run_ortho_from_pcl``  <- ..._ortho_from_pcl

The stereo front-end turns the frames to gray and, with
``images_need_undistortion``, undistorts them through the camera's lens
model (``camera/undistort.py``). The pair densifier matches one pair per
pass (``batch_chunk=1``, as the JAX driver does), so the BM kernel
(``csrc/bm.cu``) launches once per pair and the SGM kernel
(``csrc/sgm.cu``) eight times per pair. The plane-sweep densifier
(``densifier="plane_sweep"``, ``stereo/plane_sweep.py``) sweeps one
reference view at a time in plain PyTorch; a missing z bound of its range,
or of ``disparity_from_slab``'s slab, comes from the ``auto_z_range`` BM
prepass (one BM launch per prepass pair). The DSM and the from-points
ortho run one IDW launch each (``csrc/idw.cu``) and the backward-grid
ortho one score pass per stream: the score kernel (``csrc/score.cu``) for
a pinhole camera, the general PyTorch path for a distorted one (its
``score_kernel="pallas"`` raises ``ValueError``, as in JAX). The
homography undistorts each image of a distorted camera before its warp.
On a CPU device every wrapper runs its plain version. Results are float32
tensors on the device; every writer gets a host copy made once.

With ``cfg.auto_shard`` and more than one device in
``parallel/mesh.py::mesh_devices`` (of the driver's device type), the
drivers take the JAX package's sharded branches over a ``tiles`` mesh of
those devices (``parallel/sharded.py``): the pair stereo on ring frames
(one pair per pass on each shard), the plane sweep by reference view, the
DSM and the backward-grid ortho by map row band (the ortho against each
band's culled image subset, the cull's slab read from the DSM just made)
and the homography by image. Their maps equal the one-device run bit for
bit; the homography's float sums agree to rounding. With one device (one
card, or the CPU unless a test patches ``default_devices``) the drivers run
as before. ``run_ortho_from_pcl`` is not sharded, as in JAX.

Under an initialized ``torch.distributed`` group (``torchrun``, or
``parallel/distributed.py::initialize_distributed``) the ``tiles`` mesh
spans every rank's devices and each rank runs its own shards; the
collectives cross the group (``parallel/collectives.py``). Every rank must
call the driver with the same dataset and config, so that all make the
same collective calls in the same order. Every rank returns the whole
result (the clouds and bands are gathered on each rank, bit-equal to the
one-process mesh of the same shard count), and only rank 0 writes files,
the rank-0 export convention of JAX's ``parallel/distributed.py``. The JAX
drivers read their sharded arrays to the host here, which JAX refuses
across processes; the port fixes these semantics itself. A run under a
group without a mesh (``auto_shard=False``, or one device in all) runs
whole on every rank and writes on rank 0 too.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from aerial_mapper_tpu_torch.camera.models import DIST_NONE
from aerial_mapper_tpu_torch.config import PipelineConfig
from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.dsm.idw import (
    ortho_from_points,
    update_elevation_layer,
)
from aerial_mapper_tpu_torch.image.color import unpack_float_to_rgb
from aerial_mapper_tpu_torch.io.artifacts import (
    save_layers,
    save_points,
    to_host,
)
from aerial_mapper_tpu_torch.io.geotiff import write_geotiff
from aerial_mapper_tpu_torch.io.images import save_image
from aerial_mapper_tpu_torch.io.pointcloud import save_point_cloud_txt
from aerial_mapper_tpu_torch.io.poses import _rot_matrix_np
from aerial_mapper_tpu_torch.io.report import write_html_report
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry, create_map_state
from aerial_mapper_tpu_torch.ortho.backward_grid import backward_grid_update
from aerial_mapper_tpu_torch.ortho.homography import (
    MosaicState,
    auto_window,
    homography_mosaic_batch,
    validate_window,
)
from aerial_mapper_tpu_torch.parallel import mesh as pmesh
from aerial_mapper_tpu_torch.parallel.distributed import is_rank0
from aerial_mapper_tpu_torch.parallel.sharded import (
    band_image_operands,
    pad_map_geometry,
    pad_ring_pairs,
    prepare_ring_pair_operands,
    shard_layers,
    sharded_backward_grid_update_banded,
    sharded_dsm_update,
    sharded_homography_mosaic_batch,
    sharded_plane_sweep,
    sharded_process_pairs,
    unshard_layers,
)
from aerial_mapper_tpu_torch.pipeline.dataset import Dataset
from aerial_mapper_tpu_torch.pipeline.incremental import (
    _stereo_image_from,
    _to_device,
)
from aerial_mapper_tpu_torch.stereo.batched import (
    disparity_range_from_slab,
    filter_points_z,
    prepare_pair_operands,
    process_pairs_batched,
)
from aerial_mapper_tpu_torch.stereo.plane_sweep import (
    auto_z_range,
    prepare_plane_sweep_operands,
    process_sequence_plane_sweep,
    resolve_z_range,
    warn_boundary_pileup,
)
from aerial_mapper_tpu_torch.utils.timing import (
    StageTimer,
    config_banner,
    log_config,
)

logger = logging.getLogger("aerial_mapper_tpu_torch")


def _auto_mesh(cfg: PipelineConfig, dev: torch.device):
    """Row-band ``tiles`` mesh over ``mesh_devices`` of ``dev``'s type, or
    None with ``auto_shard`` off or one device. Map heights that do not
    divide are handled by the drivers through ``pad_map_geometry`` (south
    padding, cropped from every output). Under a process group the mesh
    spans every rank's devices in rank order (``Mesh.processes``), and
    ``mesh_devices`` gathers them through the group: every rank must reach
    each call, which it does when all run the driver on the same config."""
    if not cfg.auto_shard:
        return None
    devices, processes = pmesh.mesh_devices(dev.type)
    if len(devices) <= 1:
        return None
    return pmesh.make_mesh(("tiles",), shape=(len(devices),),
                           devices=devices, processes=processes)


def _rank0_paths(*paths):
    """The writers' output paths as given on rank 0 (and without a process
    group), Nones on every other rank: every rank holds the whole result,
    and only rank 0 writes it. The writers read only tensors every rank
    already holds, so no rank waits in a collective that another skips."""
    return paths if is_rank0() else (None,) * len(paths)


def _pad_layers(layers: dict, geom: MapGeometry,
                geom_pad: MapGeometry) -> dict:
    """Append init-valued southern rows so an [H, W] layer dict fits the
    padded band-sharded geometry (the original rows are untouched; the pad
    rows' results are cropped before anything reads them)."""
    if geom_pad.height == geom.height:
        return layers
    pad_rows = geom_pad.height - geom.height
    init = create_map_state(geom_pad, device=layers["elevation"].device)
    return {k: torch.cat([v, init[k][-pad_rows:]]) for k, v in layers.items()}


def _crop_layers(layers: dict, geom: MapGeometry) -> dict:
    return {k: v[:geom.height] for k, v in layers.items()}


def _slab_bounded(cfg: PipelineConfig, dataset: Dataset, Rs, trans_c,
                  images, dev: torch.device):
    """(bm_cfg, sgm_cfg) for ``StereoConfig.disparity_from_slab``: the
    search window bounded to the disparities the z slab can produce (the
    matcher scales ~linearly with the disparity count). The slab is the
    stereo config's [z_min, z_max] when both are set, else the
    ``auto_z_range`` BM prepass's range; a degenerate slab or geometry
    falls back to the full search."""
    bm_cfg, sgm_cfg = cfg.bm, cfg.sgm
    if not cfg.stereo.disparity_from_slab:
        return bm_cfg, sgm_cfg
    try:
        z_lo, z_hi = cfg.stereo.z_min, cfg.stereo.z_max
        if z_lo is None or z_hi is None:
            z_lo, z_hi = auto_z_range(images, Rs, trans_c,
                                      dataset.rig.camera, bm_cfg=cfg.bm,
                                      device=dev)
        lo, num = disparity_range_from_slab(
            dataset.rig.camera.K, Rs, trans_c,
            tuple(images[0].shape[-2:]), z_lo, z_hi,
            use_every_nth=cfg.stereo.use_every_nth_image,
        )
    except ValueError as e:
        # degenerate slab/geometry: an opt-in optimization must not
        # abort the run — fall back to the full search range
        logger.warning(
            "disparity_from_slab: %s — falling back to the full "
            "%d-disparity search", e, cfg.bm.num_disparities,
        )
        return bm_cfg, sgm_cfg
    logger.info(
        "slab-bounded disparity search: slab [%.1f, %.1f] m -> "
        "disparities [%d, %d) (%d vs %d full)",
        z_lo, z_hi, lo, lo + num, num, cfg.bm.num_disparities,
    )
    return (dataclasses.replace(bm_cfg, min_disparity=lo,
                                num_disparities=num),
            dataclasses.replace(sgm_cfg, min_disparity=max(lo, 1),
                                num_disparities=num))


def _stereo_cloud(dataset: Dataset, cfg: PipelineConfig, timer: StageTimer,
                  dev: torch.device):
    """Shared stereo front-end: images + poses -> flat point buffers
    (points [N, 3], intensities [N], valid [N]) on ``dev``.

    The pair densifier runs the subsampled sequence through the batched
    pair path (``stereo/batched.py``) one pair per pass, instead of the
    reference's serial per-pair loop (stereo.cpp:91-110); the plane sweep
    runs one reference view per sweep. With a mesh (``_auto_mesh``) the
    pairs, on ring frames, or the reference views are split over its
    shards; the cloud comes back in the same order, bit for bit.
    """
    cam = dataset.rig.camera
    quats_c, trans_c = dataset.camera_poses()
    Rs = np.stack([_rot_matrix_np(q) for q in quats_c])
    # matching runs on grayscale (stereo.cpp:117-125), undistorted when
    # the images need it
    images = [_stereo_image_from(_to_device(im, dev), dataset, cfg)
              for im in dataset.images]
    if cfg.stereo.densifier == "plane_sweep":
        ps_cam = cam
        if cfg.stereo.images_need_undistortion and \
                ps_cam.dist_kind != DIST_NONE:
            # the images were already undistorted above: sweep with the
            # pinhole model, or rays get undistorted twice and neighbour
            # samples land at distorted positions in undistorted images
            ps_cam = ps_cam._replace(dist_kind=DIST_NONE,
                                     dist_params=(0.0, 0.0, 0.0, 0.0))
        # an unset z bound comes from a BM prepass, so that the planes
        # bracket the actual terrain
        ps_cfg = resolve_z_range(
            cfg.plane_sweep, images, Rs, trans_c, ps_cam, bm_cfg=cfg.bm,
            use_every_nth=cfg.stereo.use_every_nth_image, device=dev,
        )
        mesh = _auto_mesh(cfg, dev)
        if mesh is not None:
            n_dev = mesh.shape["tiles"]
            ps_ops = prepare_plane_sweep_operands(
                images, Rs, trans_c, cfg=ps_cfg,
                use_every_nth=cfg.stereo.use_every_nth_image,
                pad_to_multiple=n_dev, device=dev,
            )
            b_real = int(ps_ops.ref_valid.sum())
            with timer.stage("dense_pcl", work_items=len(images)):
                points, intens, valid = sharded_plane_sweep(
                    ps_ops, ps_cam, ps_cfg, mesh)
            logger.info(
                "dense_pcl: %d plane-sweep reference views sharded over "
                "%d devices", b_real, n_dev)
            # the padding slots (appended) out: the cloud of the one-device
            # sweep, whatever the shard count (the JAX driver keeps them,
            # masked invalid)
            points, intens, valid = (
                points[:b_real], intens[:b_real], valid[:b_real])
        else:
            with timer.stage("dense_pcl", work_items=len(images)):
                points, intens, valid = process_sequence_plane_sweep(
                    images, Rs, trans_c, ps_cam, cfg=ps_cfg,
                    use_every_nth=cfg.stereo.use_every_nth_image,
                    device=dev,
                )
        warn_boundary_pileup(points, valid, ps_cfg)
        return points.reshape(-1, 3), intens.reshape(-1), valid.reshape(-1)
    bm_cfg, sgm_cfg = _slab_bounded(cfg, dataset, Rs, trans_c, images, dev)
    mesh = _auto_mesh(cfg, dev)
    if mesh is not None:
        # pair-data-parallel stereo on ring frames, padded to the shard
        # count (per-pair outputs are those of the sequential batched
        # path, bit for bit)
        n_dev = mesh.shape["tiles"]
        ring = prepare_ring_pair_operands(
            cam.K, Rs, trans_c, images,
            use_every_nth=cfg.stereo.use_every_nth_image, device=dev,
        )
        b_real = ring.frames.shape[0]
        ring = pad_ring_pairs(ring, n_dev)
        with timer.stage("dense_pcl", work_items=len(images)):
            points, intens, valid = sharded_process_pairs(
                ring, cam, mesh, matcher=cfg.stereo.matcher,
                bm_cfg=bm_cfg, sgm_cfg=sgm_cfg,
            )
        logger.info("dense_pcl: %d pairs sharded over %d devices", b_real,
                    n_dev)
        points, intens, valid = (
            points[:b_real], intens[:b_real], valid[:b_real])
    else:
        ops = prepare_pair_operands(
            cam.K, Rs, trans_c, images,
            use_every_nth=cfg.stereo.use_every_nth_image, device=dev,
        )
        with timer.stage("dense_pcl", work_items=len(images)):
            points, intens, valid = process_pairs_batched(
                ops, cam, bm_cfg, device=dev, matcher=cfg.stereo.matcher,
                sgm_cfg=sgm_cfg, batch_chunk=1,
            )
    valid = filter_points_z(points, valid, cfg.stereo.z_min,
                            cfg.stereo.z_max)
    return points.reshape(-1, 3), intens.reshape(-1), valid.reshape(-1)


def run_dense_pcl(
    dataset: Dataset,
    cfg: PipelineConfig = PipelineConfig(),
    output_cloud_txt: Optional[str] = None,
    output_cloud_npz: Optional[str] = None,
    datasets=None,
    device=None,
):
    """Dense reconstruction demo (main-dense-pcl.cc:35-75): returns
    (points [N, 3], intensities [N], valid [N]) on ``device`` (``None``
    means CUDA). ``datasets`` (optional per-camera list) merges every rig
    camera's stream."""
    dev = resolve_device(device)
    timer = StageTimer(dev)
    points, intens, valid = _resolve_cloud(dataset, cfg, timer, dev,
                                           datasets=datasets)
    logger.info("dense_pcl: %d valid points", int(valid.sum()))
    output_cloud_txt, output_cloud_npz = _rank0_paths(output_cloud_txt,
                                                      output_cloud_npz)
    if output_cloud_npz:
        save_points(output_cloud_npz, points, intens, valid)
    if output_cloud_txt:
        v = to_host(valid)
        save_point_cloud_txt(output_cloud_txt, to_host(points)[v],
                             to_host(intens)[v])
    logger.info(timer.report())
    return points, intens, valid


def _resolve_cloud(dataset, cfg, timer, dev, point_cloud=None,
                   datasets=None):
    if point_cloud is not None:
        points, intens = point_cloud
        points = _to_device(points, dev)
        intens = _to_device(intens, dev)
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
        return points, intens, valid
    if datasets is not None and len(datasets) > 1:
        return multicam_cloud(datasets, cfg, timer, dev)
    return _stereo_cloud(dataset, cfg, timer, dev)


def multicam_cloud(datasets, cfg: PipelineConfig, timer: StageTimer,
                   dev: torch.device):
    """Merged dense cloud from every rig camera's image stream.

    Each per-camera Dataset (``load_multicam_datasets``) runs the stereo
    front-end against its OWN stream and camera-j poses (T_G_Cj = T_G_B *
    T_B_Cj via the promoted rig slot); the world-frame point buffers
    concatenate into one cloud for the DSM/ortho stages. The reference
    hardcodes camera 0 of its rig (stereo.cpp:37-40), so this fusion is a
    framework extension with no parity quirk to preserve.
    """
    parts = [_stereo_cloud(ds, cfg, timer, dev) for ds in datasets]
    points = torch.cat([p for p, _, _ in parts])
    intens = torch.cat([i for _, i, _ in parts])
    valid = torch.cat([v for _, _, v in parts])
    counts = torch.stack([v.sum() for _, _, v in parts]).tolist()
    logger.info(
        "multicam: merged %d camera streams -> %d points (%s valid)",
        len(parts), points.shape[0], "/".join(str(c) for c in counts),
    )
    return points, intens, valid


def run_dsm(
    dataset: Dataset,
    cfg: PipelineConfig = PipelineConfig(),
    point_cloud: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    output_geotiff: Optional[str] = None,
    output_layers_npz: Optional[str] = None,
    output_report_html: Optional[str] = None,
    utm_zone: int = 32,
    datasets=None,
    device=None,
):
    """DSM demo (main-dsm.cc:46-111): cloud (given or generated) -> elevation
    layer -> float32 GeoTiff. Returns (layers, geom), the layers float32
    tensors on ``device`` (``None`` means CUDA). ``datasets`` (optional
    list of per-camera Datasets from ``load_multicam_datasets``) fuses
    every rig camera's stream into the cloud."""
    dev = resolve_device(device)
    log_config("DSM", cfg.dsm)
    timer = StageTimer(dev)
    geom = MapGeometry.from_config(cfg.grid)
    points, intens, valid = _resolve_cloud(dataset, cfg, timer, dev,
                                           point_cloud, datasets)
    layers = create_map_state(geom, device=dev)
    mesh = _auto_mesh(cfg, dev)
    with timer.stage("dsm", work_items=geom.height * geom.width / 1e6):
        if mesh is not None:
            n_tiles = mesh.shape["tiles"]
            geom_pad, _ = pad_map_geometry(geom, n_tiles)
            sharded = shard_layers(_pad_layers(layers, geom, geom_pad),
                                   mesh)
            sharded["elevation"] = sharded_dsm_update(
                sharded["elevation"], points, valid, geom_pad, cfg.dsm,
                mesh)
            layers = _crop_layers(unshard_layers(sharded, mesh, device=dev),
                                  geom)
            logger.info("dsm: row-band sharded over %d devices", n_tiles)
        else:
            layers = update_elevation_layer(layers, points, valid, geom,
                                            cfg.dsm)
    output_geotiff, output_layers_npz, output_report_html = _rank0_paths(
        output_geotiff, output_layers_npz, output_report_html)
    if output_layers_npz:
        save_layers(output_layers_npz, layers, geom)
    if output_geotiff:
        write_geotiff(
            output_geotiff, to_host(layers["elevation"]).astype(np.float32),
            west=geom.west, north=geom.north, resolution=geom.resolution,
            utm_zone=utm_zone,
        )
    if output_report_html:
        write_html_report(
            output_report_html, layers, geom, title="DSM run",
            config_banner=config_banner("DSM", cfg.dsm),
            timings=timer.durations,
        )
    logger.info(timer.report())
    return layers, geom


def _ortho_image(layers: dict, colored: bool) -> np.ndarray:
    """The ortho as a host image: the gray layer, or the packed RGB layer
    unpacked to uint8 [H, W, 3]. colored_ortho packs RGB into float bits
    (grid_map's colorVectorToValue convention); unobserved cells keep the
    NaN init — bit-casting that would give (192, 0, 0) — so they export
    white, like the grayscale path's 255."""
    if not colored:
        return to_host(layers["ortho"])
    packed = to_host(layers["colored_ortho"])
    rgb01 = unpack_float_to_rgb(torch.from_numpy(packed)).numpy()
    rgb = np.round(rgb01 * 255.0).astype(np.uint8)  # [H, W, 3]
    return np.where(np.isnan(packed)[..., None], np.uint8(255), rgb)


def _ortho_backward_sharded(layers: dict, geom: MapGeometry, streams,
                            cfg: PipelineConfig, mesh) -> dict:
    """The backward-grid passes row-band-sharded over ``mesh``, each band
    against its culled image subset (``band_image_operands``). The cull's
    slab is the ACTUAL post-DSM elevation range (one host read of the
    layer the DSM stage just made, whole on every rank), so the subsets
    are conservative by construction: no slab assumption to violate. A
    stream's frames go to the card once; each rank gathers only its own
    bands' slots from them there (``tiles=``); the capacity is the whole
    cull's, so the shapes agree across ranks."""
    ocfg = cfg.ortho_backward
    dev = layers["elevation"].device
    elev = to_host(layers["elevation"])
    finite = np.isfinite(elev)
    if ocfg.use_digital_elevation_map and finite.any():
        elev_lo = float(elev[finite].min()) - 1e-3
        elev_hi = float(elev[finite].max()) + 1e-3
    else:
        e0 = ocfg.orthomosaic_elevation_m
        elev_lo, elev_hi = e0 - 1e-3, e0 + 1e-3
    n_tiles = mesh.shape["tiles"]
    # a 1-D tiles mesh: a shard's flat id is its band
    bands = mesh.local_shards()
    geom_pad, _ = pad_map_geometry(geom, n_tiles)
    sharded = shard_layers(_pad_layers(layers, geom, geom_pad), mesh)
    id_offset = 0
    for ds in streams:
        quats_c, trans_c = ds.camera_poses()
        images = torch.stack([_to_device(im, dev) for im in ds.images])
        n_images = images.shape[0]
        banded = band_image_operands(
            geom_pad, n_tiles, quats_c, trans_c, images, ds.rig.camera,
            elev_min=elev_lo, elev_max=elev_hi, device=dev, tiles=bands,
        )
        del images  # the bands hold what they need of it
        if id_offset:
            banded = banded._replace(ids=torch.where(
                banded.ids >= 0, banded.ids + id_offset, banded.ids))
        sharded = sharded_backward_grid_update_banded(
            sharded, banded, geom_pad, ds.rig.camera, ocfg, mesh)
        # the other ranks' bands hold only padding slots here: the count
        # is this rank's
        logger.info(
            "ortho: row-band sharded over %d devices; band cull kept %d/%d "
            "image slots of bands %s (slab [%.1f, %.1f])", n_tiles,
            int((banded.ids >= 0).sum()), len(bands) * n_images,
            bands, elev_lo, elev_hi,
        )
        id_offset += n_images
        del banded
    return _crop_layers(unshard_layers(sharded, mesh, device=dev), geom)


def run_ortho_backward_grid(
    dataset: Dataset,
    cfg: PipelineConfig = PipelineConfig(),
    point_cloud: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    output_geotiff: Optional[str] = None,
    output_jpg: Optional[str] = None,
    output_layers_npz: Optional[str] = None,
    output_report_html: Optional[str] = None,
    utm_zone: int = 32,
    datasets=None,
    device=None,
):
    """Batch backward-grid demo (main-ortho-backward-grid.cc:66-145):
    DSM first, then best-angle ortho texturing against all images.
    Returns (layers, geom) as ``run_dsm``.

    ``datasets`` (optional list of per-camera Datasets): fuse every rig
    camera's stream — merged cloud for the DSM, then one best-angle
    texturing pass per stream over the same layers. The per-cell update
    only replaces on a STRICTLY more-nadir observation (the incremental
    contract, ortho-backward-grid.cc:90), so the passes compose exactly
    like the reference's incremental batches; exact cross-camera angle
    ties keep the earlier camera. The ``observation_index`` layer uses
    global ids: stream j's image i maps to ``sum(len(earlier streams)) +
    i``.
    """
    dev = resolve_device(device)
    log_config("Orthomosaic (backward grid)", cfg.ortho_backward)
    timer = StageTimer(dev)
    layers, geom = run_dsm(dataset, cfg, point_cloud=point_cloud,
                           datasets=datasets, device=dev)

    streams = list(datasets) if datasets else [dataset]
    mesh = _auto_mesh(cfg, dev)
    with timer.stage(
        "ortho_backward", work_items=geom.height * geom.width / 1e6
    ):
        if mesh is not None:
            layers = _ortho_backward_sharded(layers, geom, streams, cfg,
                                             mesh)
        else:
            id_offset = 0
            for ds in streams:
                quats_c, trans_c = ds.camera_poses()
                images = torch.stack([_to_device(im, dev)
                                      for im in ds.images])
                ids = None
                if len(streams) > 1:
                    ids = torch.arange(images.shape[0], dtype=torch.int32,
                                       device=dev) + id_offset
                layers = backward_grid_update(
                    layers, _to_device(quats_c, dev),
                    _to_device(trans_c, dev), images, geom, ds.rig.camera,
                    cfg.ortho_backward, image_ids=ids,
                )
                id_offset += images.shape[0]
                del images
    ortho = _ortho_image(layers, cfg.ortho_backward.colored_ortho)
    output_geotiff, output_jpg, output_layers_npz, output_report_html = \
        _rank0_paths(output_geotiff, output_jpg, output_layers_npz,
                     output_report_html)
    if output_layers_npz:
        save_layers(output_layers_npz, layers, geom)
    if output_jpg:
        save_image(output_jpg, ortho)
    if output_geotiff:
        write_geotiff(
            output_geotiff, np.clip(ortho, 0, 255).astype(np.uint8),
            west=geom.west, north=geom.north, resolution=geom.resolution,
            utm_zone=utm_zone,
        )
    if output_report_html:
        extra = ([("orthomosaic (RGB)", ortho)]
                 if cfg.ortho_backward.colored_ortho else None)
        write_html_report(
            output_report_html, layers, geom,
            title="Backward-grid orthomosaic run",
            config_banner=config_banner("Orthomosaic (backward grid)",
                                        cfg.ortho_backward),
            timings=timer.durations, extra_images=extra,
        )
    logger.info(timer.report())
    return layers, geom


def _homography_stream_prep(dataset: Dataset, cfg: PipelineConfig,
                            dev: torch.device):
    """Per-stream preparation, outside the timed mosaic stage: the image
    stack on the device and the window sizing / validation."""
    quats_c, trans_c = dataset.camera_poses()
    images = torch.stack([_to_device(im, dev) for im in dataset.images])
    hcfg = cfg.ortho_homography
    cam = dataset.rig.camera
    if hcfg.auto_window and hcfg.window_rows == 0 and hcfg.window_cols == 0:
        win = auto_window(hcfg, cam, quats_c, trans_c)
        if win is not None:
            hcfg = dataclasses.replace(
                hcfg, window_rows=win[0], window_cols=win[1]
            )
            logger.info("homography window: %dx%d of %dx%d mosaic",
                        win[0], win[1], hcfg.height_mosaic_pixels,
                        hcfg.width_mosaic_pixels)
    elif hcfg.window_rows > 0 or hcfg.window_cols > 0:
        # hand-set window: the device fit-check silently zeroes any image
        # whose footprint cannot fit — refuse to run such a config
        dropped = validate_window(hcfg, cam, quats_c, trans_c)
        if dropped:
            raise ValueError(
                f"hand-set homography window {hcfg.window_rows}x"
                f"{hcfg.window_cols} would drop the entire contribution of "
                f"{len(dropped)} image(s) (first indices {dropped[:8]}); "
                "enlarge the window or use auto_window"
            )
    return (images, _to_device(quats_c, dev), _to_device(trans_c, dev), cam,
            hcfg)


def _homography_stream_pass(prep, return_state: bool, mesh=None):
    """One stream's feather pass over prepped operands, image-sharded over
    ``mesh`` when there is one: the mosaic, or the raw accumulators
    (``return_state``, for the multi-camera sum)."""
    images, quats, trans, cam, hcfg = prep
    if mesh is not None:
        out = sharded_homography_mosaic_batch(
            images, quats, trans, cam, hcfg, mesh,
            needs_undistortion=cam.dist_kind != "none",
            return_state=return_state,
        )
        logger.info("homography mosaic: image-sharded over %d devices",
                    mesh.shape["tiles"])
        return out
    return homography_mosaic_batch(
        images, quats, trans, cam, hcfg,
        needs_undistortion=cam.dist_kind != "none",
        return_state=return_state, device=images.device,
    )


def run_ortho_forward_homography(
    dataset: Dataset,
    cfg: PipelineConfig = PipelineConfig(),
    output_jpg: Optional[str] = None,
    output_geotiff: Optional[str] = None,
    output_report_html: Optional[str] = None,
    utm_zone: int = 32,
    datasets=None,
    device=None,
):
    """Homography mosaic demo (main-ortho-forward-homography.cc:42-103):
    returns the [Hm, Wm] float32 mosaic on ``device`` (``None`` means
    CUDA; the JAX driver returns it as numpy).

    ``datasets`` (per-camera list): the feather blend is a weighted SUM
    over images (cv::detail::FeatherBlender semantics), so multi-camera
    fusion folds each stream into shared (weighted_sum, weight_sum)
    accumulators — one pass per stream with its own camera/window — and
    divides once. Single-stream results are unchanged."""
    dev = resolve_device(device)
    timer = StageTimer(dev)
    streams = list(datasets) if datasets else [dataset]
    preps = [_homography_stream_prep(ds, cfg, dev) for ds in streams]
    mesh = _auto_mesh(cfg, dev)
    with timer.stage(
        "ortho_homography",
        work_items=(cfg.ortho_homography.width_mosaic_pixels
                    * cfg.ortho_homography.height_mosaic_pixels / 1e6),
    ):
        if len(streams) == 1:
            mosaic = _homography_stream_pass(preps[0], False, mesh)
        else:
            num = den = None
            for prep in preps:
                state = _homography_stream_pass(prep, True, mesh)
                if num is None:
                    num, den = state.weighted_sum, state.weight_sum
                else:
                    num = num + state.weighted_sum
                    den = den + state.weight_sum
            mosaic = MosaicState(num, den).mosaic
    del preps
    hcfg = cfg.ortho_homography
    output_jpg, output_geotiff, output_report_html = _rank0_paths(
        output_jpg, output_geotiff, output_report_html)
    host = to_host(mosaic) if (output_jpg or output_geotiff
                               or output_report_html) else None
    if output_jpg:
        save_image(output_jpg, host)
    if output_geotiff:
        half_w = hcfg.width_mosaic_pixels / 2 * hcfg.resolution
        half_h = hcfg.height_mosaic_pixels / 2 * hcfg.resolution
        west, north = hcfg.origin[0] - half_w, hcfg.origin[1] + half_h
        # overview_nodata=0: the batch blend zeroes unobserved pixels
        # (ortho-forward-homography.cc:177-186), so pyramid levels must
        # not average that black background into footprint edges
        write_geotiff(
            output_geotiff, np.clip(host, 0, 255).astype(np.uint8),
            west=west, north=north, resolution=hcfg.resolution,
            utm_zone=utm_zone, overview_nodata=0,
        )
    if output_report_html:
        geom = MapGeometry(
            center_easting=hcfg.origin[0], center_northing=hcfg.origin[1],
            resolution=hcfg.resolution, height=hcfg.height_mosaic_pixels,
            width=hcfg.width_mosaic_pixels,
        )
        write_html_report(
            output_report_html, {}, geom,
            title="Forward-homography mosaic run",
            config_banner=config_banner("Orthomosaic (homography)", hcfg),
            timings=timer.durations,
            extra_images=[("mosaic", host)],
        )
    logger.info(timer.report())
    return mosaic


def run_ortho_from_pcl(
    dataset: Optional[Dataset],
    cfg: PipelineConfig = PipelineConfig(),
    point_cloud: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    output_jpg: Optional[str] = None,
    output_geotiff: Optional[str] = None,
    output_report_html: Optional[str] = None,
    utm_zone: int = 32,
    datasets=None,
    device=None,
):
    """Ortho-from-points demo (main-ortho-from-pcl.cc): IDW of intensities.
    Returns (layers, geom) as ``run_dsm``. ``datasets`` (per-camera list)
    rasterizes the merged multi-camera cloud's intensities."""
    dev = resolve_device(device)
    timer = StageTimer(dev)
    geom = MapGeometry.from_config(cfg.grid)
    points, intens, valid = _resolve_cloud(dataset, cfg, timer, dev,
                                           point_cloud, datasets)
    layers = create_map_state(geom, device=dev)
    with timer.stage(
        "ortho_from_pcl", work_items=geom.height * geom.width / 1e6
    ):
        layers = ortho_from_points(
            layers, points, intens, valid, geom, cfg.ortho_from_pcl
        )
    ortho = to_host(layers["ortho"])
    output_jpg, output_geotiff, output_report_html = _rank0_paths(
        output_jpg, output_geotiff, output_report_html)
    if output_jpg:
        save_image(output_jpg, ortho)
    if output_geotiff:
        write_geotiff(
            output_geotiff, np.clip(ortho, 0, 255).astype(np.uint8),
            west=geom.west, north=geom.north, resolution=geom.resolution,
            utm_zone=utm_zone,
        )
    if output_report_html:
        write_html_report(
            output_report_html, layers, geom,
            title="Ortho-from-points run",
            config_banner=config_banner("Orthomosaic (from points)",
                                        cfg.ortho_from_pcl),
            timings=timer.durations,
        )
    logger.info(timer.report())
    return layers, geom
