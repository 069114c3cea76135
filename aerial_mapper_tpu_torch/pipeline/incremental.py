"""Incremental "mapping on the fly" driver, single device.

Twin of the single-device path of ``aerial_mapper_tpu/pipeline/
incremental.py``. Replays ``main-ortho-backward-grid-incremental.cc:143-166``
(SURVEY.md §3.4): stream frames one by one; every n-th frame, run virtual
stereo against the frame kept at the previous update, merge that cloud into
the DSM, and re-rasterize the backward-grid ortho against only the frames
that arrived since. The best-angle layer makes the ortho update idempotent
and order-independent (ortho-backward-grid.cc:180-183), which is what makes
this incremental contract valid.

Each update runs the kernels of the fused step on one pair: the BM scan
(``csrc/bm.cu``) or the SGM scans (``csrc/sgm.cu``), the IDW
(``csrc/idw.cu``) and one score pass per stream against that update's
cameras (``csrc/score.cu``). On a CPU device every wrapper runs its plain
version.

The JAX package's mesh-sharded driver is not ported (ROADMAP item 10): its
knobs (``cull_images``, ``check_every``, ``slab_margin_m``,
``route_capacity_factor``) stay in the signature at their defaults, and any
other value raises ``NotImplementedError`` rather than doing nothing.
``cfg.auto_shard`` with more than one visible CUDA device logs a warning
and runs on the given device. JAX holds its sharded result bit-identical to
the single-device one, so the map is the same.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from aerial_mapper_tpu_torch.config import PipelineConfig
from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.dsm.idw import update_elevation_layer
from aerial_mapper_tpu_torch.image.color import rgb_to_gray
from aerial_mapper_tpu_torch.io.poses import _rot_matrix_np
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry, create_map_state
from aerial_mapper_tpu_torch.ortho.backward_grid import backward_grid_update
from aerial_mapper_tpu_torch.pipeline.dataset import Dataset
from aerial_mapper_tpu_torch.stereo.batched import (
    disparity_range_from_slab,
    filter_points_z,
    prepare_pair_operands,
    process_pairs_batched,
)
from aerial_mapper_tpu_torch.utils.timing import StageTimer

logger = logging.getLogger("aerial_mapper_tpu_torch")


def _stereo_image_from(image: torch.Tensor) -> torch.Tensor:
    """An already-on-device frame prepared for matching: grayscale (the
    batch driver's preprocessing). Taking the device tensor avoids moving
    the frame a second time."""
    if image.ndim == 3:
        image = rgb_to_gray(image)
    return image


def _to_device(image, dev) -> torch.Tensor:
    """A host array as a float32 tensor on ``dev`` (always a copy: the
    caller's arrays may be read-only)."""
    return torch.tensor(np.asarray(image, np.float32), device=dev)


def _frame_stream(dataset: Dataset, prestage: bool, dev, start: int = 0):
    """Device-resident (frame_index, frame) pairs from ``start`` on.

    ``prestage=False`` (streaming semantics): each frame moves to the
    device as it 'arrives', the honest mapping-on-the-fly mode (from
    pageable host memory, each copy blocks the host until it is done).
    ``True``: the whole sequence moves in ONE transfer up front, so the
    loop measures dispatch + compute (the throughput mode for a dataset
    already on disk)."""
    if prestage:
        stack = torch.as_tensor(
            np.stack(dataset.images[start:]).astype(np.float32, copy=False),
            device=dev)
        for i in range(start, dataset.num_frames):
            yield i, stack[i - start]
    else:
        for i in range(start, dataset.num_frames):
            yield i, _to_device(dataset.images[i], dev)


def _frame_streams(streams, prestage: bool, dev, start: int = 0):
    """Multi-stream analogue of ``_frame_stream``: yields
    ``(frame_index, [frame_per_stream])`` — each rig camera's frame i
    'arrives' together (synchronized rig capture)."""
    its = [_frame_stream(ds, prestage, dev, start) for ds in streams]
    for items in zip(*its):
        yield items[0][0], [frame for _i, frame in items]


def _validate_streams(streams):
    """Multicam stream list sanity: equal lengths and one shared body
    trajectory (load_multicam_datasets guarantees both; hand-built lists
    must too, or the per-update pairing would silently mix frames)."""
    n = streams[0].num_frames
    for s, ds in enumerate(streams[1:], start=1):
        if ds.num_frames != n:
            raise ValueError(
                f"multicam stream {s} has {ds.num_frames} frames, "
                f"stream 0 has {n} — streams must be synchronized"
            )
        # quaternion double cover: q and -q are the same rotation, so a
        # stream normalized to the opposite hemisphere must still pass
        q0, q1 = np.asarray(streams[0].quats_G_B), np.asarray(ds.quats_G_B)
        quat_match = np.all(
            np.minimum(np.abs(q1 - q0).max(axis=1),
                       np.abs(q1 + q0).max(axis=1)) < 1e-8
        )
        if not (quat_match
                and np.allclose(ds.trans_G_B, streams[0].trans_G_B)):
            raise ValueError(
                f"multicam stream {s} carries a different body "
                "trajectory than stream 0 — per-camera datasets must "
                "share the rig's body poses"
            )


def _resume_state(dataset: Dataset, start_frame: int, update_every_nth: int,
                  dev):
    """(prev, prev_stereo) for a resumed stream: the frame kept at the
    last update before ``start_frame`` (= start_frame - 1, which is why
    resume points must sit on an update boundary). It goes through the
    streaming path's transfer and preparation, so a resumed run computes
    every later update exactly as the uninterrupted one."""
    if start_frame == 0:
        return None, None
    if start_frame % update_every_nth != 0:
        raise ValueError(
            f"start_frame {start_frame} must be a multiple of "
            f"update_every_nth {update_every_nth} (resume continues from "
            "an update boundary so the previous-frame pairing chain is "
            "reconstructible)"
        )
    prev = start_frame - 1
    return prev, _stereo_image_from(_to_device(dataset.images[prev], dev))


def _maybe_bound_disparity_incremental(cfg: PipelineConfig, streams,
                                       update_every_nth: int):
    """Apply ``StereoConfig.disparity_from_slab`` to the matcher configs.

    Honoured only when BOTH ``z_min`` and ``z_max`` are set: that declared
    envelope already z-filters every triangulated point, so bounding the
    search window to the disparities it can produce drops only points the
    filter would drop anyway. A slab tracked from the map itself would be
    unsound here (a bounded search cannot discover terrain outside its own
    window). Without the envelope the flag is ignored with a warning."""
    if not cfg.stereo.disparity_from_slab:
        return cfg
    if cfg.stereo.z_min is None or cfg.stereo.z_max is None:
        logger.warning(
            "disparity_from_slab ignored by the incremental driver: set "
            "BOTH --stereo_z_min and --stereo_z_max (the declared "
            "envelope is the only sound slab here — the tracked slab "
            "cannot validate a window it bounded itself); running the "
            "full %d-disparity search", cfg.bm.num_disparities,
        )
        return cfg
    lo_all, hi_all = None, None
    h, w = streams[0].images[0].shape[0], streams[0].images[0].shape[1]
    try:
        for ds in streams:
            quats_c, trans_c = ds.camera_poses()
            Rs = np.stack([_rot_matrix_np(q) for q in quats_c])
            # pairing cadence: updates match frames n-1, 2n-1, ... (the
            # (prev, i) chain), the stride and phase of use_every_nth
            lo, num = disparity_range_from_slab(
                ds.rig.camera.K, Rs, trans_c, (h, w),
                cfg.stereo.z_min, cfg.stereo.z_max,
                use_every_nth=update_every_nth,
            )
            lo_all = lo if lo_all is None else min(lo_all, lo)
            hi_all = lo + num if hi_all is None else max(hi_all, lo + num)
    except ValueError as e:
        logger.warning(
            "disparity_from_slab: %s — falling back to the full "
            "%d-disparity search", e, cfg.bm.num_disparities,
        )
        return cfg
    num_all = hi_all - lo_all
    logger.info(
        "incremental slab-bounded disparity search: envelope [%.1f, "
        "%.1f] m -> disparities [%d, %d) (%d vs %d full)",
        cfg.stereo.z_min, cfg.stereo.z_max, lo_all, hi_all, num_all,
        cfg.bm.num_disparities,
    )
    return dataclasses.replace(
        cfg,
        bm=dataclasses.replace(cfg.bm, min_disparity=lo_all,
                               num_disparities=num_all),
        sgm=dataclasses.replace(cfg.sgm, min_disparity=max(lo_all, 1),
                                num_disparities=num_all),
    )


def run_incremental(
    dataset: Dataset,
    cfg: PipelineConfig = PipelineConfig(),
    update_every_nth: int = 5,
    on_update: Optional[Callable] = None,
    prestage_images: bool = False,
    initial_layers: Optional[dict] = None,
    start_frame: int = 0,
    cull_images: bool = True,
    check_every: int = 8,
    slab_margin_m: float = 20.0,
    route_capacity_factor: float = 2.0,
    datasets=None,
    on_cloud: Optional[Callable] = None,
    cloud_stride: int = 67,
    device=None,
):
    """Stream the sequence; returns the final (layers, geom), layers as
    float32 tensors on ``device`` (``None`` means CUDA and raises without
    it; pass ``"cpu"`` for the plain versions).

    ``on_update(step, layers, geom)`` is called after every map update with
    the device layers — the framework's substitute for the reference's
    per-update ROS publish (main-ortho-backward-grid-incremental.cc:160).

    ``on_cloud(step, points, valid)`` (optional) receives each update's
    newly triangulated stereo points decimated by ``cloud_stride``, as host
    numpy: one packed device-to-host readback per update (valid rides as a
    4th column). The default stride is prime: the flat point buffer is
    row-major over the image, so a stride sharing a factor with the image
    width samples only a few pixel columns.

    ``prestage_images``: move the whole sequence to the device in one
    transfer up front instead of per frame as the stream arrives (see
    ``_frame_stream``).

    ``initial_layers`` + ``start_frame``: resume mapping onto a previously
    saved map state (``io.artifacts.load_layers``), continuing the stream
    from ``start_frame`` (a multiple of ``update_every_nth`` — the frame
    right after the checkpointed run's last update). The result is exactly
    the uninterrupted run's map. Shapes must match ``cfg.grid``. With
    several streams the global ids count the streams' full length, so the
    checkpoint must come from a run over the same streams (an
    ``on_update`` payload), not over a cut copy of them.

    ``datasets``: one ``Dataset`` per rig camera (synchronized streams over
    one body trajectory). Each update matches one pair per stream, merges
    the clouds into one DSM update and runs one ortho pass per stream with
    global observation ids (stream s's frame j -> s * n_frames + j); a
    single stream keeps the reference's subset-relative ids.

    ``cull_images``, ``check_every``, ``slab_margin_m`` and
    ``route_capacity_factor`` configure the JAX package's sharded driver,
    which is not ported: a value other than the default raises
    ``NotImplementedError`` (see the module docstring).
    """
    dev = resolve_device(device)
    sharded = dict(cull_images=(cull_images, True),
                   check_every=(check_every, 8),
                   slab_margin_m=(slab_margin_m, 20.0),
                   route_capacity_factor=(route_capacity_factor, 2.0))
    changed = [k for k, (v, default) in sharded.items() if v != default]
    if changed:
        raise NotImplementedError(
            f"run_incremental: {', '.join(changed)} configure the sharded "
            "incremental driver, which is not ported yet (ROADMAP item 10)"
        )
    if cfg.stereo.densifier != "stereo":
        raise ValueError(
            f"the incremental driver streams consecutive-pair virtual "
            f"stereo (the reference's mapping-on-the-fly contract, "
            f"stereo.cpp:127-147); densifier={cfg.stereo.densifier!r} is "
            "for the batch drivers (run_dsm/run_dense_pcl/..., not ported "
            "yet: ROADMAP items 3 and 8)"
        )
    if cfg.stereo.images_need_undistortion:
        raise NotImplementedError(
            "run_incremental: images_need_undistortion is not ported yet "
            "(ROADMAP item 5: the distorted-camera path, "
            "camera/undistort.py)"
        )
    geom = MapGeometry.from_config(cfg.grid)
    if initial_layers is not None:
        bad = {
            k: tuple(v.shape) for k, v in initial_layers.items()
            if tuple(v.shape[:2]) != (geom.height, geom.width)
        }
        if bad:
            raise ValueError(
                f"initial_layers shapes {bad} do not match the configured "
                f"{geom.height}x{geom.width} grid"
            )
    streams = list(datasets) if datasets else [dataset]
    if len(streams) > 1:
        _validate_streams(streams)
    multicam = len(streams) > 1
    cfg = _maybe_bound_disparity_incremental(cfg, streams, update_every_nth)
    if (cfg.auto_shard and dev.type == "cuda"
            and torch.cuda.device_count() > 1):
        logger.warning(
            "auto_shard: %d CUDA devices are visible, but the sharded "
            "incremental driver is not ported; running on %s (the JAX "
            "package's sharded map is bit-identical to this one)",
            torch.cuda.device_count(), dev,
        )

    n_frames = streams[0].num_frames
    layers = create_map_state(geom, device=dev)
    if initial_layers is not None:
        layers.update({
            k: (v.to(dev, torch.float32) if isinstance(v, torch.Tensor)
                else _to_device(v, dev))
            for k, v in initial_layers.items()
        })
    poses = [ds.camera_poses() for ds in streams]  # [(quats_c, trans_c)]
    Rs_s = [np.stack([_rot_matrix_np(q) for q in qc]) for qc, _t in poses]

    timer = StageTimer(dev)
    images_subset = [[] for _ in streams]
    # frames kept at the previous update + their matcher-ready images
    prev = None
    prev_stereo = [None] * len(streams)
    for s, ds in enumerate(streams):
        prev, prev_stereo[s] = _resume_state(ds, start_frame,
                                             update_every_nth, dev)
    num_updates = 0

    for i, frames in _frame_streams(streams, prestage_images, dev,
                                    start_frame):
        for s, frame in enumerate(frames):
            images_subset[s].append(frame)

        if (i + 1) % update_every_nth != 0:
            continue

        cur_stereo = [_stereo_image_from(frame) for frame in frames]
        # stereo against the frames kept at the previous update (the
        # stereo.addFrame previous-frame chain, stereo.cpp:127-147) — one
        # pair per stream, MERGED into a single DSM update; the first
        # update has no previous frame and skips the DSM delta
        if prev is not None:
            with timer.stage("incremental_dsm"):
                all_pts, all_valid = [], []
                for s, ds in enumerate(streams):
                    _quats_c, trans_c = poses[s]
                    ops = prepare_pair_operands(
                        ds.rig.camera.K, Rs_s[s][[prev, i]],
                        trans_c[[prev, i]],
                        [prev_stereo[s], cur_stereo[s]], device=dev,
                    )
                    pts, _intens, valid = process_pairs_batched(
                        ops, ds.rig.camera, cfg.bm, device=dev,
                        matcher=cfg.stereo.matcher, sgm_cfg=cfg.sgm,
                        batch_chunk=1,
                    )
                    valid = filter_points_z(pts, valid, cfg.stereo.z_min,
                                            cfg.stereo.z_max)
                    all_pts.append(pts.reshape(-1, 3))
                    all_valid.append(valid.reshape(-1))
                merged_pts = torch.cat(all_pts)
                merged_valid = torch.cat(all_valid)
                layers = update_elevation_layer(
                    layers, merged_pts, merged_valid, geom, cfg.dsm,
                )
                if on_cloud is not None:
                    packed = torch.cat([
                        merged_pts[::cloud_stride],
                        merged_valid[::cloud_stride, None].float(),
                    ], dim=1).cpu().numpy()
                    on_cloud(i, packed[:, :3], packed[:, 3] > 0.5)

        with timer.stage("incremental_ortho"):
            # one best-angle pass per stream; multicam carries GLOBAL
            # observation ids (the batch driver's convention), a single
            # stream the reference's subset-relative ids
            frame_lo = i - len(images_subset[0]) + 1
            sub = slice(frame_lo, i + 1)
            for s, ds in enumerate(streams):
                quats_c, trans_c = poses[s]
                ids = None
                if multicam:
                    ids = torch.arange(frame_lo, i + 1, dtype=torch.int32,
                                       device=dev) + s * n_frames
                layers = backward_grid_update(
                    layers,
                    _to_device(quats_c[sub], dev),
                    _to_device(trans_c[sub], dev),
                    torch.stack(images_subset[s]),
                    geom,
                    ds.rig.camera,
                    cfg.ortho_backward,
                    image_ids=ids,
                )
        prev = i
        prev_stereo = cur_stereo
        num_updates += 1
        if on_update is not None:
            on_update(i, layers, geom)
        for sub_list in images_subset:
            sub_list.clear()

    logger.info("incremental: %d map updates (%d camera streams)",
                num_updates, len(streams))
    logger.info(timer.report())
    return layers, geom
