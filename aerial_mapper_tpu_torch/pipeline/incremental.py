"""Incremental "mapping on the fly" driver, single-device or mesh-sharded.

Twin of ``aerial_mapper_tpu/pipeline/incremental.py``. Replays
``main-ortho-backward-grid-incremental.cc:143-166`` (SURVEY.md §3.4):
stream frames one by one; every n-th frame, run virtual stereo against the
frame kept at the previous update, merge that cloud into the DSM, and
re-rasterize the backward-grid ortho against only the frames
that arrived since. The best-angle layer makes the ortho update idempotent
and order-independent (ortho-backward-grid.cc:180-183), which is what makes
this incremental contract valid.

Each update runs the kernels of the fused step on one pair: the BM scan
(``csrc/bm.cu``) or the SGM scans (``csrc/sgm.cu``), the IDW
(``csrc/idw.cu``) and one score pass per stream against that update's
cameras (``csrc/score.cu``; for a distorted camera the general PyTorch
path of ``ortho/backward_grid.py``). With ``images_need_undistortion`` the
stereo frames are undistorted first; the ortho pass textures the raw frames
through the rig's camera, lens model and all, as in JAX. On a CPU device
every wrapper runs its plain version. The plane-sweep densifier is refused
(``ValueError``), as in JAX: it belongs to the batch drivers.

Multi-device mode (``cfg.auto_shard`` and more than one device in
``parallel/mesh.py::mesh_devices`` of the driver's device type), the twin
of JAX's ``_run_incremental_sharded``: every update is ONE fused
``parallel/sharded.py::sharded_map_step`` on a (pairs=1, tiles=n) mesh. The
pair is padded to the shard count (``pad_ring_pairs``), the map is split
into row bands on a south-padded geometry (``pad_map_geometry``), points
are routed to their owner band, and each band's ortho pass textures from
an image subset CULLED against a slab tracked across updates. Each window
of ``check_every`` updates culls against the previous window's measured
post-DSM elevation range widened by ``slab_margin_m``; ONE host read per
window then validates it (routing overflow 0 and the measured range inside
the slab). A window that fails is replayed from its snapshot with the
replicated image layout (and a doubled route capacity on overflow), so the
map equals the one-device driver's bit for bit. ``on_update`` calls are
deferred until their window validates, with host numpy payloads. A mesh
spans one process (logical shards of one card, or one shard per card) or,
under an initialized ``torch.distributed`` group, every rank's devices
(``parallel/distributed.py``): each rank then runs the same driver on the
same stream, steps its own shards, reads its own replica of the window's
diagnostics (so every rank takes the same branch) and returns the whole
map, as JAX's multi-process driver does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from aerial_mapper_tpu_torch.camera.undistort import undistort_image
from aerial_mapper_tpu_torch.config import PipelineConfig
from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.dsm.idw import update_elevation_layer
from aerial_mapper_tpu_torch.image.color import rgb_to_gray
from aerial_mapper_tpu_torch.io.poses import _rot_matrix_np
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry, create_map_state
from aerial_mapper_tpu_torch.ortho.backward_grid import backward_grid_update
from aerial_mapper_tpu_torch.parallel import collectives as cl
from aerial_mapper_tpu_torch.parallel import mesh as pmesh
from aerial_mapper_tpu_torch.parallel.sharded import (
    RingPairOperands,
    StepDiagnostics,
    band_image_operands,
    pad_map_geometry,
    pad_ring_pairs,
    replicated_band_images,
    shard_layers,
    sharded_backward_grid_update,
    sharded_backward_grid_update_banded,
    sharded_map_step,
    unshard_layers,
)
from aerial_mapper_tpu_torch.pipeline.dataset import Dataset
from aerial_mapper_tpu_torch.stereo.batched import (
    disparity_range_from_slab,
    filter_points_z,
    prepare_pair_operands,
    process_pairs_batched,
)
from aerial_mapper_tpu_torch.utils.timing import StageTimer

logger = logging.getLogger("aerial_mapper_tpu_torch")


def _incremental_mesh(cfg: PipelineConfig, dev: torch.device):
    """(pairs=1, tiles=n) mesh over ``mesh_devices`` of ``dev``'s type
    (every rank's under a process group), or None with ``auto_shard`` off
    or one device."""
    if not cfg.auto_shard:
        return None
    devices, processes = pmesh.mesh_devices(dev.type)
    if len(devices) <= 1:
        return None
    return pmesh.make_mesh(("pairs", "tiles"), shape=(1, len(devices)),
                           devices=devices, processes=processes)


def _stereo_image_from(image: torch.Tensor, dataset: Dataset,
                       cfg: PipelineConfig) -> torch.Tensor:
    """An already-on-device frame prepared for matching: grayscale, and
    undistorted when ``images_need_undistortion`` (the batch driver's
    preprocessing). Taking the device tensor avoids moving the frame a
    second time."""
    if image.ndim == 3:
        image = rgb_to_gray(image)
    if cfg.stereo.images_need_undistortion:
        image = undistort_image(dataset.rig.camera, image)
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


def _resume_state(dataset: Dataset, cfg: PipelineConfig, start_frame: int,
                  update_every_nth: int, dev):
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
    return prev, _stereo_image_from(_to_device(dataset.images[prev], dev),
                                    dataset, cfg)


def _interleaved_multicam_ring(pair_ops_list) -> RingPairOperands:
    """S per-stream single-pair ``PairOperands`` -> one valid-masked
    ``RingPairOperands`` with 2S-1 slots.

    The ring layout reconstructs pair j's right frame from slot j+1's left
    frame: true for consecutive pairs of ONE stream, not across streams.
    Interleaving [L0, R0, L1, R1, .. L_{S-1}] (tail = R_{S-1}) keeps that
    property for the REAL pairs at even slots (slot 2s: left L_s, the next
    slot's frame is R_s), while the cross-stream filler slots at odd
    indices (R_s matched against L_{s+1}) carry ``pair_valid=False`` and
    contribute no points, so one fused ``sharded_map_step`` routes ALL
    streams' pairs as a single merged cloud. S=1 is exactly the
    single-stream ring (one slot, no fillers)."""
    s_count = len(pair_ops_list)
    frames = []
    fields = {f: [] for f in ("T1_inv", "T2_inv", "corners_rect",
                              "R_G_C_rect", "t_G_C1", "baseline")}
    for s, ops in enumerate(pair_ops_list):
        lefts = [ops.image1[0]]
        if s < s_count - 1:
            # filler slot: left = R_s, right = L_{s+1}; operands are the
            # real pair's (any value: the slot's output is masked)
            lefts.append(ops.image2[0])
        for frame in lefts:
            frames.append(frame)
            for f in fields:
                fields[f].append(getattr(ops, f)[0])
    frames = torch.stack(frames)
    return RingPairOperands(
        frames=frames,
        tail=pair_ops_list[-1].image2[0],
        **{f: torch.stack(v) for f, v in fields.items()},
        # the real pairs sit at the even slots (made on the device: no
        # host-to-device copy, so no synchronize per update)
        pair_valid=torch.arange(frames.shape[0], device=frames.device) % 2
        == 0,
    )


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

    ``on_update(step, layers, geom)`` is called after every map update — the
    framework's substitute for the reference's per-update ROS publish
    (main-ortho-backward-grid-incremental.cc:160). On one device it gets the
    device layers. In the sharded mode the calls are deferred until the
    update's validation window passes and then flushed in order, with the
    layers as host numpy (see ``_run_incremental_sharded``).

    ``on_cloud(step, points, valid)`` (optional) receives each update's
    newly triangulated stereo points decimated by ``cloud_stride``, as host
    numpy: one packed device-to-host readback per update (valid rides as a
    4th column). The default stride is prime: the flat point buffer is
    row-major over the image, so a stride sharing a factor with the image
    width samples only a few pixel columns. Single-device driver only: the
    sharded fused step never materializes the cloud outside the mesh (a
    warning is logged and the callback skipped there).

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

    Sharded-mode scale-out knobs (ignored on a single device):
    ``cull_images`` enables the slab-tracked per-band image cull;
    ``check_every`` sets the validation window in updates (one host read
    each: smaller detects a fault sooner, larger stalls the stream less);
    ``slab_margin_m`` widens the measured elevation range into the next
    window's cull slab (it must exceed the terrain relief newly discovered
    within one window; violations are detected and replayed exactly, so
    the margin only sets how often the replay pays the replicated layout);
    ``route_capacity_factor`` is the initial owner-routing bucket capacity
    in fair shares (doubled on each overflow replay until the window
    routes losslessly).
    """
    dev = resolve_device(device)
    if cfg.stereo.densifier != "stereo":
        raise ValueError(
            f"the incremental driver streams consecutive-pair virtual "
            f"stereo (the reference's mapping-on-the-fly contract, "
            f"stereo.cpp:127-147); densifier={cfg.stereo.densifier!r} is "
            "available in the batch drivers (run_dsm/run_dense_pcl/...)"
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
    mesh = _incremental_mesh(cfg, dev)
    if mesh is not None:
        if on_cloud is not None:
            logger.warning(
                "on_cloud is unavailable in the sharded incremental "
                "driver (the fused step routes points inside the mesh "
                "and never materializes the cloud); skipping the "
                "callback — run with auto_shard=False for the live "
                "cloud feed"
            )
        return _run_incremental_sharded(
            streams, cfg, geom, mesh, update_every_nth, on_update,
            prestage_images, initial_layers, start_frame, dev,
            cull_images=cull_images, check_every=check_every,
            slab_margin_m=slab_margin_m,
            route_capacity_factor=route_capacity_factor,
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
        prev, prev_stereo[s] = _resume_state(ds, cfg, start_frame,
                                             update_every_nth, dev)
    num_updates = 0

    for i, frames in _frame_streams(streams, prestage_images, dev,
                                    start_frame):
        for s, frame in enumerate(frames):
            images_subset[s].append(frame)

        if (i + 1) % update_every_nth != 0:
            continue

        cur_stereo = [_stereo_image_from(frame, ds, cfg)
                      for frame, ds in zip(frames, streams)]
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


def _read_scalars(ovf: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """ONE host read of (overflow, elev_lo, elev_hi): the only
    synchronize of a validation window (float64 holds the count and both
    float32 elevations exactly). The scalars are this rank's replica of
    the window's diagnostics: every rank reads the same values and takes
    the same branch."""
    vals = torch.stack([ovf.double(), lo.double(), hi.double()]).tolist()
    return int(vals[0]), vals[1], vals[2]


class _HostStaging:
    """A layer dict's device-to-host copy, started now and resolved later:
    on a CUDA device, non-blocking copies into pinned host tensors and an
    event recorded after them (``resolve`` waits on that event before the
    host reads a byte); on the CPU, a plain copy."""

    def __init__(self, layers: dict):
        self._source = layers  # kept until resolved: the copies read it
        self.host, self.event = {}, None
        dev = next(iter(layers.values())).device  # one device for all
        for k, v in layers.items():
            if dev.type == "cuda":
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
            else:
                h = v.clone()
            self.host[k] = h
        if dev.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def resolve(self) -> dict:
        """The layers as host numpy (the device tensors are let go)."""
        if self.event is not None:
            self.event.synchronize()
        self._source = None
        return {k: h.numpy() for k, h in self.host.items()}


def _run_incremental_sharded(
    streams,
    cfg: PipelineConfig,
    geom: MapGeometry,
    mesh,
    update_every_nth: int,
    on_update: Optional[Callable],
    prestage_images: bool,
    initial_layers: Optional[dict],
    start_frame: int,
    dev: torch.device,
    cull_images: bool = True,
    check_every: int = 8,
    slab_margin_m: float = 20.0,
    route_capacity_factor: float = 2.0,
):
    """Mesh-sharded incremental driver: one fused ``sharded_map_step`` per
    update, with slab-tracked per-band image culling validated (and, on a
    slab violation or a routing overflow, replayed exactly) once per
    ``check_every``-update window: one host read each, so the stream stays
    asynchronous between windows (the reference re-rasterizes against only
    the new image subset, main-ortho-backward-grid-incremental.cc:143-166;
    this is that contract with per-shard image bytes shrinking).

    ``streams``: per-camera Dataset list (length 1 = the single-stream
    mode). Multicam: each update runs ONE stereo pair per stream, the pairs
    interleaved into a single valid-masked ring so the fused step routes
    the MERGED cloud in one pass (``_interleaved_multicam_ring``), then one
    banded best-angle ortho pass per stream with GLOBAL observation ids
    (stream s's frame j -> s * n_frames + j). The fused stereo triangulates
    through stream 0's intrinsics, so every stream's camera must share
    (fx, fy, cx, cy, W, H); other rigs get a ``ValueError`` and can run
    with ``auto_shard=False`` (per-stream intrinsics).

    The window snapshot is the driver state at the window's start, held by
    reference: no op of the sharded path writes into its input tensors.
    Deferred ``on_update`` payloads are staged to HOST memory as they are
    recorded: each update's cropped layer set starts a non-blocking copy
    into pinned memory and resolves to numpy one update later, so the copy
    overlaps a full update. The device holds the snapshot and at most one
    staged layer set whatever ``check_every`` is; the host holds up to
    ``check_every`` numpy layer sets (9 x H x W x 4 bytes each), and the
    callbacks receive numpy arrays in this mode. Across processes each
    payload is gathered whole on every rank, so it stays host numpy there
    too (JAX keeps device payloads with several processes, whose global
    arrays no one rank can materialize)."""
    cam = streams[0].rig.camera
    multicam = len(streams) > 1
    n_frames = streams[0].num_frames
    if multicam:
        for s, ds in enumerate(streams[1:], start=1):
            c = ds.rig.camera
            if (c.fx, c.fy, c.cx, c.cy, c.width, c.height) != (
                    cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height):
                raise ValueError(
                    f"sharded multicam incremental requires every stream "
                    f"to share stream 0's intrinsics (fused-step "
                    f"triangulation is static in one camera); stream {s} "
                    "differs — run with auto_shard=False for per-stream "
                    "intrinsics"
                )
    n_devices = mesh.size
    n_tiles = mesh.shape["tiles"]
    home = mesh.home_device()  # where the window's accumulators live
    # the bands this rank steps (None: every band, in one process)
    tile_of = cl.axis_index(mesh, "tiles")
    my_tiles = ([tile_of[f] for f in mesh.local_shards()]
                if mesh.spans_processes else None)
    geom_pad, pad_rows = pad_map_geometry(geom, n_tiles)
    start = create_map_state(geom_pad, device=dev)
    if initial_layers is not None:
        # resume: splice the saved rows above the fresh southern padding
        for k, v in initial_layers.items():
            v = (v.to(dev, torch.float32) if isinstance(v, torch.Tensor)
                 else _to_device(v, dev))
            start[k] = torch.cat([v, start[k][geom.height:]]) \
                if pad_rows else v
    layers = shard_layers(start, mesh, "tiles")
    del start
    poses = [ds.camera_poses() for ds in streams]  # [(quats_c, trans_c)]
    Rs_s = [np.stack([_rot_matrix_np(q) for q in qc]) for qc, _t in poses]

    timer = StageTimer(dev)
    prev = None
    prev_stereo = [None] * len(streams)
    for s, ds in enumerate(streams):
        prev, prev_stereo[s] = _resume_state(ds, cfg, start_frame,
                                             update_every_nth, dev)
    num_updates = 0
    capacity_factor = route_capacity_factor
    # cull slab (lo, hi) host floats; None = no trustworthy slab yet.
    # FLAT-PLANE ortho (use_digital_elevation_map=False) reads every cell
    # at orthomosaic_elevation_m, NOT the DSM: its cull slab is that
    # constant, exact from update 1, and the measured DSM range is
    # irrelevant to it (validating against it could both miss real
    # violations and flag false ones)
    flat_plane = not cfg.ortho_backward.use_digital_elevation_map
    if flat_plane:
        e0 = cfg.ortho_backward.orthomosaic_elevation_m
        slab = (e0 - 1e-3, e0 + 1e-3)
    else:
        slab = None

    def crop(ls):
        """The sharded layers as [H, W] tensors on ``dev``, the southern
        padding cut off."""
        return {k: v[:geom.height]
                for k, v in unshard_layers(ls, mesh, device=dev).items()}

    def make_banded(s, imgs_dev, frame_ids, use_cull):
        """Stream s's per-band (or replicated) image layout for one
        update's subset, with GLOBAL observation ids under multicam."""
        quats_c, trans_c = poses[s]
        q_np = np.asarray(quats_c[frame_ids])
        t_np = np.asarray(trans_c[frame_ids])
        if use_cull and slab is not None:
            # the cull reads the poses on the host and gathers each band's
            # slots from the device subset on the device. capacity_multiple
            # buckets the padded capacity so a cull tightness drifting by
            # one image keeps the shapes
            banded = band_image_operands(
                geom_pad, n_tiles, q_np, t_np, imgs_dev,
                streams[s].rig.camera,
                elev_min=slab[0], elev_max=slab[1], capacity_multiple=2,
                device=dev, tiles=my_tiles,
            )
        else:
            banded = replicated_band_images(q_np, t_np, imgs_dev,
                                            device=dev)
        if multicam:
            # global ids: the banded ids index the passed subset stack
            # (frames frame_ids[0]..frame_ids[-1] in order), so the
            # absolute id is ids + frame_ids[0], offset by the stream base
            offset = s * n_frames + frame_ids[0]
            banded = banded._replace(ids=torch.where(
                banded.ids >= 0, banded.ids + offset, banded.ids))
        return banded

    def ortho_only(layers, s, banded):
        """One stream's banded or replicated sharded ortho pass."""
        scam = streams[s].rig.camera
        if banded.ids.dim() == 1:  # the replicated every-band layout
            return sharded_backward_grid_update(
                layers, banded.quats, banded.ts, banded.images,
                geom_pad, scam, cfg.ortho_backward, mesh,
                image_ids=banded.ids if multicam else None,
            )
        return sharded_backward_grid_update_banded(
            layers, banded, geom_pad, scam, cfg.ortho_backward, mesh)

    def do_update(state, i, imgs_dev_s, frame_ids, cur_stereo, use_cull):
        """One fused map update (all streams); returns (state', diag or
        None). ``imgs_dev_s`` / ``cur_stereo``: per-stream lists (subset
        stacks, matcher-ready current frames)."""
        layers, prev, prev_stereo = state
        bandeds = [make_banded(s, imgs_dev_s[s], frame_ids, use_cull)
                   for s in range(len(streams))]
        if prev is not None:
            pair_ops = [
                prepare_pair_operands(
                    streams[s].rig.camera.K, Rs_s[s][[prev, i]],
                    poses[s][1][[prev, i]],
                    [prev_stereo[s], cur_stereo[s]], device=dev,
                )
                for s in range(len(streams))
            ]
            ring = pad_ring_pairs(_interleaved_multicam_ring(pair_ops),
                                  n_devices)
            layers, diag = sharded_map_step(
                layers, ring, bandeds[0], geom_pad, cam, cfg.dsm,
                cfg.ortho_backward, mesh, matcher=cfg.stereo.matcher,
                bm_cfg=cfg.bm, sgm_cfg=cfg.sgm,
                route_capacity_factor=capacity_factor,
                z_min=cfg.stereo.z_min, z_max=cfg.stereo.z_max,
            )
            for s in range(1, len(streams)):
                layers = ortho_only(layers, s, bandeds[s])
        else:
            # first update: no stereo pair exists yet; an ortho-only
            # update, exactly the single-device driver's first step. The
            # layout may already be CULLED here (flat-plane mode's
            # constant slab is exact from update 1)
            for s in range(len(streams)):
                layers = ortho_only(layers, s, bandeds[s])
            diag = None
        return (layers, i, cur_stereo), diag

    def fresh_window():
        """(overflow, elev_lo, elev_hi) accumulators on the device."""
        return (torch.zeros((), dtype=torch.int64, device=home),
                torch.full((), float("inf"), device=home),
                torch.full((), float("-inf"), device=home))

    def accumulated(acc, diag: Optional[StepDiagnostics]):
        """The accumulators with one update's diagnostics folded in, on
        the device (no host read)."""
        if diag is None:
            return acc
        ovf, lo, hi = acc
        return (ovf + diag.overflow.to(home),
                torch.minimum(lo, diag.elev_min.to(home)),
                torch.maximum(hi, diag.elev_max.to(home)))

    # ---- validation-window state ------------------------------------
    # snapshot = the driver state at window start (the rewind target);
    # records = what replays every update of the window; the accumulators
    # stay on the device and are read once per window
    state = (layers, prev, prev_stereo)
    win_snapshot = state
    win_records = []  # (i, [frame indices of the subset])
    win_culled = False  # any update in this window used a culled layout
    win_acc = fresh_window()
    pending = []  # resolved deferred payloads: (i, layers dict)
    staged = None  # (i, _HostStaging) with its copy under way

    def flush_staged():
        """Resolve the staged copy to numpy and let go of its device
        tensors."""
        nonlocal staged
        if staged is not None:
            si, copy = staged
            pending.append((si, copy.resolve()))
            staged = None

    def stage_pending(i, cropped):
        """Record a deferred on_update payload: start its host copy now,
        resolve it at the NEXT record (or window close) so the copy
        overlaps a full update step."""
        nonlocal staged
        flush_staged()
        staged = (i, _HostStaging(cropped))

    def reset_window():
        nonlocal win_snapshot, win_records, win_culled, win_acc
        win_snapshot = state
        win_records = []
        win_culled = False
        win_acc = fresh_window()

    def replay_window():
        """Redo every update of the failed window from its snapshot with
        the always-exact replicated layout; retries with a doubled routing
        capacity while overflow persists (bounded: the capacity reaches
        the no-drop bound of one full local cloud)."""
        nonlocal state, capacity_factor, win_acc, pending
        for _attempt in range(6):
            state_r = win_snapshot
            acc = fresh_window()
            redo_pending = []
            for i, frame_ids in win_records:
                imgs_s = [torch.stack([_to_device(ds.images[j], dev)
                                       for j in frame_ids])
                          for ds in streams]
                cur = [_stereo_image_from(imgs_s[s][-1], ds, cfg)
                       for s, ds in enumerate(streams)]
                state_r, diag = do_update(state_r, i, imgs_s, frame_ids,
                                          cur, use_cull=False)
                acc = accumulated(acc, diag)
                if on_update is not None:
                    # replay is the rare error path: resolve to host now
                    # (the same bounded device retention)
                    redo_pending.append(
                        (i, _HostStaging(crop(state_r[0])).resolve()))
            n_ovf, r_lo, r_hi = _read_scalars(*acc)
            if n_ovf == 0:
                state = state_r
                win_acc = acc
                pending = redo_pending
                return r_lo, r_hi
            capacity_factor *= 2.0
            logger.warning(
                "incremental window replay dropped %d routed points; "
                "retrying with route_capacity_factor=%.1f",
                n_ovf, capacity_factor,
            )
        raise RuntimeError(
            "incremental sharded window kept overflowing after capacity "
            f"retries (route_capacity_factor={capacity_factor})"
        )

    def close_window():
        """Validate the window; on failure rewind and replay it exactly.
        Updates the slab from the (validated) measured elevation range and
        flushes the deferred on_update callbacks."""
        nonlocal slab, capacity_factor, pending
        flush_staged()
        if win_records:
            overflow, lo, hi = _read_scalars(*win_acc)
            bad_slab = (
                win_culled and slab is not None and not flat_plane
                and np.isfinite(lo)
                and (lo < slab[0] or hi > slab[1])
            )
            if overflow or bad_slab:
                if overflow:
                    capacity_factor *= 2.0
                logger.warning(
                    "incremental window invalid (overflow=%d, slab %s, "
                    "measured [%.2f, %.2f]); replaying %d updates with "
                    "replicated images%s",
                    overflow, slab, lo, hi, len(win_records),
                    f" and route_capacity_factor={capacity_factor}"
                    if overflow else "",
                )
                lo, hi = replay_window()
            if not flat_plane and np.isfinite(lo) and np.isfinite(hi):
                slab = (lo - slab_margin_m, hi + slab_margin_m)
            if on_update is not None:
                for i, cropped in pending:
                    on_update(i, cropped, geom)
        pending = []
        reset_window()

    images_subset = [[] for _ in streams]
    for i, frames in _frame_streams(streams, prestage_images, dev,
                                    start_frame):
        for s, frame in enumerate(frames):
            images_subset[s].append(frame)

        if (i + 1) % update_every_nth != 0:
            continue

        cur_stereo = [_stereo_image_from(frame, ds, cfg)
                      for frame, ds in zip(frames, streams)]
        frame_ids = list(range(i - len(images_subset[0]) + 1, i + 1))
        with timer.stage("incremental_step"):
            use_cull = cull_images and slab is not None
            state, diag = do_update(
                state, i, [torch.stack(sub) for sub in images_subset],
                frame_ids, cur_stereo, use_cull,
            )
            win_acc = accumulated(win_acc, diag)
        win_records.append((i, frame_ids))
        win_culled = win_culled or use_cull
        if on_update is not None:
            stage_pending(i, crop(state[0]))
        num_updates += 1
        if len(win_records) >= check_every:
            with timer.stage("incremental_validate"):
                close_window()
        for sub_list in images_subset:
            sub_list.clear()

    close_window()
    logger.info(
        "incremental (sharded over %d devices, %d camera streams): %d "
        "map updates, final cull slab %s, route_capacity_factor %.1f",
        n_devices, len(streams), num_updates, slab, capacity_factor,
    )
    logger.info(timer.report())
    return crop(state[0]), geom
