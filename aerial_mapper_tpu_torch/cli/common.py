"""Shared CLI plumbing for the demo entry points (twin of
``aerial_mapper_tpu/cli/common.py``).

The reference's demos are gflags binaries composed from ``--flagfile=*.ff``.
The port keeps the JAX package's flag names, defaults and spellings
(``--data_directory``, ``--filename_poses``, ``--center_easting`` ...),
parsed with argparse, with the same ``--flagfile`` indirection and gflags
booleans, so the reference's .ff files translate line for line. The
configs and datasets built here are the port's (``config.py``,
``pipeline/dataset.py``); each CLI passes its ``device`` (``None`` means
CUDA) down to the port's drivers.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import re
import sys
import time
from typing import List, Optional

from aerial_mapper_tpu_torch.config import (
    BlockMatchingConfig,
    DsmConfig,
    GridMapConfig,
    OrthoBackwardGridConfig,
    OrthoFromPclConfig,
    OrthoHomographyConfig,
    PipelineConfig,
    PlaneSweepConfig,
    SgmConfig,
    StereoConfig,
)
from aerial_mapper_tpu_torch.io.poses import PoseFormat
from aerial_mapper_tpu_torch.pipeline.dataset import (
    Dataset,
    load_dataset,
    load_multicam_datasets,
)

logger = logging.getLogger("aerial_mapper_tpu_torch")

_GFLAGS_BOOL = re.compile(r"^--([A-Za-z0-9_]+)=(true|false)$")


def expand_flagfiles(argv: List[str]) -> List[str]:
    """Inline ``--flagfile=path`` arguments (gflags-style).

    Also translates gflags boolean syntax, which argparse boolean flags
    spell differently: exactly ``--flag=true`` becomes ``--flag`` and
    exactly ``--flag=false`` becomes ``--no-flag`` (the
    ``BooleanOptionalAction`` negation) — so the reference's .ff files
    (e.g. ``--alsologtostderr=true``, ``--use_BM=false``) work verbatim.
    Arguments whose value merely *contains* true/false are untouched.
    """
    out: List[str] = []

    def push(arg: str) -> None:
        m = _GFLAGS_BOOL.match(arg)
        if m:
            name, value = m.groups()
            out.append(f"--{name}" if value == "true" else f"--no-{name}")
        else:
            out.append(arg)

    for arg in argv:
        if arg.startswith("--flagfile="):
            with open(arg.split("=", 1)[1]) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        push(line)
        else:
            push(arg)
    return out


def strip_flag_prefix(argv, prefix: str):
    """Remove a reference per-demo flag prefix (e.g. ``backward_grid_``)
    from already-flagfile-expanded argv, including the ``--no-`` forms the
    gflags-bool translation produces (``--backward_grid_x=false`` expands
    to ``--no-backward_grid_x`` BEFORE the strip)."""
    if argv is None:
        argv = sys.argv[1:]
    argv = expand_flagfiles(argv)
    out = []
    for a in argv:
        if a.startswith("--" + prefix):
            out.append("--" + a[len("--" + prefix):])
        elif a.startswith("--no-" + prefix):
            out.append("--no-" + a[len("--no-" + prefix):])
        else:
            out.append(a)
    return out


def add_reference_compat_flags(p: argparse.ArgumentParser):
    """No-op flags present in the reference's .ff files so they parse
    verbatim: visualization/threading toggles whose roles are covered by
    artifact dumps and the drivers here."""
    for name, default in (
        ("show_orthomosaic_opencv", False),  # cv::imshow loop
        ("save_orthomosaic_jpg", True),  # the ortho image path is honored
        ("grid_mode_batch", True),  # batch vs incremental = separate CLIs
        ("use_multi_threads", True),  # parFor -> the card
    ):
        p.add_argument(f"--{name}", action=argparse.BooleanOptionalAction,
                       default=default,
                       help="accepted for reference flagfile compatibility")


def _overviews_arg(value: str):
    """argparse type for --geotiff_overviews: int >= 0 or 'auto' — a typo
    like 'Auto' or '2x' becomes a usage error."""
    if value == "auto":
        return value
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer count of /2 levels or 'auto', got {value!r}"
        )
    if n < 0:
        raise argparse.ArgumentTypeError(
            f"overview count must be >= 0, got {n}"
        )
    return n


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--data_directory", required=True,
                   help="Directory with poses, images, calibration file.")
    p.add_argument("--filename_camera_rig", default="camera_fixed_wing.yaml")
    p.add_argument("--filename_poses", default="opt_poses.txt")
    p.add_argument("--prefix_images", default="image_")
    p.add_argument("--pose_format", default="standard",
                   choices=[f.value for f in PoseFormat])
    p.add_argument("--image_extension", default=".jpg",
                   help="Image file extension; .pgm/.ppm/.pnm (binary "
                        "P5/P6) are read without Pillow, every other "
                        "format needs it.")
    p.add_argument("--load_colored_images", action=argparse.BooleanOptionalAction)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--camera_index", type=int, default=0,
                   help="Rig camera to map with (multi-camera ncamera "
                        "YAMLs): promoted to the primary slot every "
                        "pipeline consumes. The reference demos hardcode "
                        "camera 0 (stereo.cpp:37-40).")
    p.add_argument("--origin", type=float, nargs=3, default=None,
                   metavar=("E", "N", "ALT"),
                   help="Origin subtracted from poses (UTM meters).")
    p.add_argument("--utm_zone", type=int, default=32)
    p.add_argument("--alsologtostderr", action=argparse.BooleanOptionalAction, default=True,
                   help="accepted for reference flagfile compatibility")
    p.add_argument("--v", type=int, default=0,
                   help="verbosity (reference flagfile compatibility)")
    p.add_argument("--report_html", default=None,
                   help="Write a self-contained HTML run report (all map "
                        "layers rendered, stats, timings, config) to this "
                        "path; its PNGs need Pillow. Replaces the "
                        "reference's rviz topics.")
    p.add_argument("--profile_dir", default=None,
                   help="Trace the whole run with torch.profiler (CPU "
                        "and, on a CUDA device, CUDA activity) and write "
                        "it as a Chrome trace (*.pt.trace.json) into this "
                        "directory (view with Perfetto or TensorBoard). "
                        "Replaces the reference's VLOG wall-clock deltas.")
    p.add_argument("--auto_shard", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Shard map rasters (and the incremental fused "
                        "step) over all visible devices, and over every "
                        "rank's devices under a torch.distributed process "
                        "group; --no-auto_shard forces the single-device "
                        "path.")
    p.add_argument("--geotiff_compression", default="none",
                   choices=["none", "deflate"],
                   help="Compression for every GeoTiff this run writes "
                        "(deflate = zlib strips, what GDAL's "
                        "COMPRESS=DEFLATE produces; float DEM tiles "
                        "typically shrink 2-4x).")
    p.add_argument("--geotiff_overviews", default=0, type=_overviews_arg,
                   help="Internal reduced-resolution pyramid pages for "
                        "every GeoTiff this run writes (what gdaladdo "
                        "adds): an integer count of /2 levels, or 'auto' "
                        "to halve until the largest dimension fits 256 px."
                        " Default 0 = single page.")
    p.add_argument("--kernel_family", default="xla",
                   choices=["xla", "pallas"],
                   help="Kernel switch for every stage that has two "
                        "formulations (the config fields keep the JAX "
                        "package's names). 'pallas' runs the hand-written "
                        "CUDA kernels on a CUDA device: the fused BM scan "
                        "(csrc/bm.cu, no left-right check), IDW "
                        "(csrc/idw.cu), the score pass (csrc/score.cu) "
                        "and the SGM scan (csrc/sgm.cu). 'xla' (default) "
                        "runs BM as the cost-volume matcher with the "
                        "left-right check in PyTorch ops; IDW, the "
                        "pinhole score pass and the SGM scan take the "
                        "same CUDA kernels. On a CPU device every kernel "
                        "runs its plain PyTorch version.")
    return p


def add_grid_flags(p: argparse.ArgumentParser):
    p.add_argument("--center_easting", type=float, default=0.0)
    p.add_argument("--center_northing", type=float, default=0.0)
    p.add_argument("--delta_easting", type=float, default=200.0)
    p.add_argument("--delta_northing", type=float, default=200.0)
    p.add_argument("--resolution", type=float, default=1.0)


def add_stereo_flags(p: argparse.ArgumentParser):
    p.add_argument("--dense_pcl_use_every_nth_image", type=int, default=10)
    p.add_argument("--use_BM", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--use_SGM", dest="use_BM", action="store_false")
    # the gflags spelling --use_SGM=false expands to --no-use_SGM, which a
    # plain store_false cannot parse: register it as 'use BM'
    p.add_argument("--no-use_SGM", dest="use_BM", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--num_disparities", type=int, default=80)
    p.add_argument("--images_need_undistortion", action=argparse.BooleanOptionalAction)
    p.add_argument("--densifier", default="stereo",
                   choices=["stereo", "plane_sweep"],
                   help="'stereo' = consecutive-pair virtual stereo (the "
                        "reference's mode); 'plane_sweep' = N-view "
                        "elevation-plane sweep (quality extension, "
                        "stereo/plane_sweep.py).")
    p.add_argument("--ps_z_min", type=float, default=None,
                   help="plane-sweep elevation range lower bound (m). "
                        "Default: derived automatically from a cheap "
                        "full-range BM prepass (robust percentiles of "
                        "triangulated z + margin) so the planes bracket "
                        "the actual terrain.")
    p.add_argument("--ps_z_max", type=float, default=None,
                   help="upper bound (m); default auto like --ps_z_min")
    p.add_argument("--ps_num_planes", type=int, default=48)
    p.add_argument("--ps_num_neighbors", type=int, default=2)
    p.add_argument("--ps_neighbor_spacing", type=int, default=1,
                   help="sequence stride to the neighbor views (wider "
                        "baselines resolve elevation better on "
                        "closely-spaced surveys)")
    p.add_argument("--ps_max_cost", type=float, default=1.0e9,
                   help="reject pixels whose winning photoconsistency "
                        "cost (mean abs diff, gray levels) exceeds this")
    p.add_argument("--stereo_z_min", type=float, default=None,
                   help="drop triangulated points below this world z "
                        "(meters) — kills gross-outlier matches; the "
                        "reference z-filters loaded clouds the same way "
                        "(z > -100, aerial-mapper-io.cc:309-347). "
                        "Default keeps everything (reference parity).")
    p.add_argument("--stereo_z_max", type=float, default=None)
    p.add_argument("--disparity_from_slab",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="Bound the disparity search window to what the "
                        "terrain elevation slab can produce (from "
                        "--stereo_z_min/max when both set, else a BM "
                        "prepass) — the matcher scales ~linearly with "
                        "the disparity count. Opt-in approximation: "
                        "terrain outside the slab cannot be discovered.")


def add_dsm_flags(p: argparse.ArgumentParser):
    p.add_argument("--interpolation_radius", type=float, default=1.0,
                   help="nanoflann-compatible squared-distance radius (m^2)")
    p.add_argument("--adaptive_interpolation", action=argparse.BooleanOptionalAction,
                   default=True)


def parse(p: argparse.ArgumentParser, argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else argv
    args = p.parse_args(expand_flagfiles(argv))
    logging.basicConfig(
        level=logging.DEBUG if args.v and args.v > 0 else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if getattr(args, "geotiff_compression", "none") != "none":
        from aerial_mapper_tpu_torch.io.geotiff import set_default_compression

        set_default_compression(args.geotiff_compression)
    ov = getattr(args, "geotiff_overviews", None)
    if ov is not None:
        # ALWAYS latch (including an explicit 0): in-process callers may
        # parse several CLI runs in one interpreter, and a one-way latch
        # would let an earlier run's pyramid setting leak into a later
        # run that asked for single-page output
        from aerial_mapper_tpu_torch.io.geotiff import set_default_overviews

        set_default_overviews(ov if ov == "auto" else int(ov))
    return args


@contextlib.contextmanager
def profiled(args, dev, name: str):
    """Trace the body with ``torch.profiler`` when ``--profile_dir`` is
    set: CPU activity, and CUDA activity on a CUDA device. The trace is
    written when the body ends (so several in-process runs each write
    their own) as ``<profile_dir>/<name>.<pid>.<ns>.pt.trace.json``. A
    profiler that cannot start logs a warning and the run goes on, as the
    JAX package's ``jax.profiler`` trace does."""
    profile_dir = getattr(args, "profile_dir", None)
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            logger.warning("profiler unavailable: %s: %s",
                           type(e).__name__, e)
            prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(
                profile_dir,
                f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
            prof.export_chrome_trace(path)
            logger.info("profiler trace written to %s", path)


def dataset_from_args(args) -> Dataset:
    return load_dataset(
        args.data_directory,
        args.filename_camera_rig,
        args.filename_poses,
        args.prefix_images,
        pose_format=PoseFormat(args.pose_format),
        color=getattr(args, "load_colored_images", False),
        origin=args.origin,
        extension=args.image_extension,
        max_frames=args.max_frames,
        camera_index=getattr(args, "camera_index", 0),
    )


def add_multicam_flag(p: argparse.ArgumentParser):
    """--all_cameras for the batch mapping demos that can fuse rig streams."""
    p.add_argument(
        "--all_cameras", action=argparse.BooleanOptionalAction, default=False,
        help="Map with EVERY rig camera jointly: one image stream per "
             "camera (a '{cam}' placeholder in --prefix_images locates "
             "them), merged dense cloud, one best-angle ortho pass per "
             "stream. The reference hardcodes camera 0 "
             "(stereo.cpp:37-40); this is the framework extension that "
             "uses the whole ncamera rig. The global observation_index "
             "id mapping follows stream order, which depends on which "
             "stream --camera_index promotes to primary.")


def datasets_from_args(args):
    """Per-camera Dataset list for --all_cameras (None when unset).

    ``--camera_index`` selects the PRIMARY stream (list slot 0), the one
    single-stream fallbacks consume."""
    if not getattr(args, "all_cameras", False):
        return None
    datasets = load_multicam_datasets(
        args.data_directory,
        args.filename_camera_rig,
        args.filename_poses,
        args.prefix_images,
        pose_format=PoseFormat(args.pose_format),
        color=getattr(args, "load_colored_images", False),
        origin=args.origin,
        extension=args.image_extension,
        max_frames=args.max_frames,
    )
    idx = getattr(args, "camera_index", 0)
    if idx:
        if not 0 <= idx < len(datasets):
            raise ValueError(
                f"--camera_index {idx} out of range "
                f"({len(datasets)} rig cameras)"
            )
        datasets = [datasets[idx]] + [
            d for j, d in enumerate(datasets) if j != idx
        ]
    return datasets


def pipeline_config_from_args(args) -> PipelineConfig:
    grid = GridMapConfig(
        center_easting=getattr(args, "center_easting", 0.0),
        center_northing=getattr(args, "center_northing", 0.0),
        delta_easting=getattr(args, "delta_easting", 200.0),
        delta_northing=getattr(args, "delta_northing", 200.0),
        resolution=getattr(args, "resolution", 1.0),
    )
    stereo = StereoConfig(
        use_every_nth_image=getattr(args, "dense_pcl_use_every_nth_image", 1),
        images_need_undistortion=getattr(args, "images_need_undistortion",
                                         False),
        matcher="bm" if getattr(args, "use_BM", True) else "sgm",
        densifier=getattr(args, "densifier", "stereo"),
        z_min=getattr(args, "stereo_z_min", None),
        z_max=getattr(args, "stereo_z_max", None),
        disparity_from_slab=getattr(args, "disparity_from_slab", False),
    )
    plane_sweep = PlaneSweepConfig(
        z_min=getattr(args, "ps_z_min", None),
        z_max=getattr(args, "ps_z_max", None),
        num_planes=getattr(args, "ps_num_planes", 48),
        num_neighbors=getattr(args, "ps_num_neighbors", 2),
        neighbor_spacing=getattr(args, "ps_neighbor_spacing", 1),
        max_cost=getattr(args, "ps_max_cost", 1.0e9),
    )
    kernel = getattr(args, "kernel_family", "xla")
    bm = BlockMatchingConfig(
        num_disparities=getattr(args, "num_disparities", 80),
        kernel=kernel)
    sgm = SgmConfig(num_disparities=getattr(args, "num_disparities", 80),
                    kernel=kernel)
    dsm = DsmConfig(
        interpolation_radius_sq=getattr(args, "interpolation_radius", 1.0),
        adaptive_interpolation=getattr(args, "adaptive_interpolation", True),
        center_easting=grid.center_easting,
        center_northing=grid.center_northing,
        idw_kernel=kernel,
    )
    ortho_backward = OrthoBackwardGridConfig(
        orthomosaic_elevation_m=getattr(
            args, "orthomosaic_elevation_m", 0.0),
        use_digital_elevation_map=getattr(
            args, "use_digital_elevation_map", True),
        colored_ortho=getattr(args, "colored_ortho", False),
        score_kernel=kernel,
    )
    ortho_homography = OrthoHomographyConfig(
        ground_plane_elevation_m=getattr(
            args, "ground_plane_elevation_m", 414.0),
        width_mosaic_pixels=getattr(args, "width_mosaic_pixels", 1000),
        height_mosaic_pixels=getattr(args, "height_mosaic_pixels", 1000),
        resolution=getattr(args, "mosaic_resolution", 1.0),
        origin=tuple(getattr(args, "mosaic_origin", (0.0, 0.0, 0.0))),
    )
    ortho_from_pcl = OrthoFromPclConfig(
        interpolation_radius_sq=getattr(args, "interpolation_radius", 2.0),
        use_adaptive_interpolation=getattr(
            args, "adaptive_interpolation", False),
    )
    return PipelineConfig(
        auto_shard=getattr(args, "auto_shard", True),
        grid=grid, stereo=stereo, plane_sweep=plane_sweep,
        bm=bm, sgm=sgm, dsm=dsm,
        ortho_backward=ortho_backward, ortho_homography=ortho_homography,
        ortho_from_pcl=ortho_from_pcl,
    )


def add_refine_poses_flag(p: argparse.ArgumentParser):
    p.add_argument("--refine_poses", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="Run feature-track bundle adjustment on the loaded "
                        "poses before rasterization (the reference assumes "
                        "pre-optimized PIX4D/COLMAP poses, README.md:5; "
                        "this closes that loop in-framework).")


def maybe_refine_poses(dataset: Dataset, args, device=None) -> Dataset:
    """Apply --refine_poses: BA over feature tracks on ``device`` (None
    means CUDA), returns a dataset with refined body poses. The refinement
    operates on CAMERA poses and converts back through the rig (refined
    camera poses equal refined body poses only for an identity rig)."""
    import dataclasses as _dc

    if not getattr(args, "refine_poses", False):
        return dataset
    import torch

    from aerial_mapper_tpu_torch.config import BundleAdjustmentConfig
    from aerial_mapper_tpu_torch.device import resolve_device
    from aerial_mapper_tpu_torch.features.refine import refine_poses_windowed
    from aerial_mapper_tpu_torch.io.poses import camera_to_body_poses

    dev = resolve_device(device)
    quats_c, trans_c = dataset.camera_poses()
    images = [torch.as_tensor(im, dtype=torch.float32, device=dev)
              for im in dataset.images]
    if images[0].ndim == 3:
        from aerial_mapper_tpu_torch.image.color import rgb_to_gray

        images = [rgb_to_gray(im) for im in images]
    q_ref, t_ref, stats = refine_poses_windowed(
        images, quats_c, trans_c, dataset.rig.camera,
        ba_cfg=BundleAdjustmentConfig(), device=dev,
    )
    logger.info("refine_poses: %s", stats)
    quats_b, trans_b = camera_to_body_poses(dataset.rig, q_ref, t_ref)
    return _dc.replace(dataset, quats_G_B=quats_b, trans_G_B=trans_b)


def maybe_refine_datasets(datasets, args, device=None):
    """--refine_poses for the multicam list: refine on the primary stream,
    share the refined BODY trajectory with every per-camera dataset (the
    rig extrinsics stay fixed: a rig-constrained refinement)."""
    import dataclasses as _dc

    if datasets is None or not getattr(args, "refine_poses", False):
        return datasets
    logger.info(
        "refine_poses (--all_cameras): refining on the PRIMARY stream "
        "(rig camera %d of %d) only; the refined body trajectory is "
        "shared with every stream, rig extrinsics stay fixed (a "
        "rig-constrained approximation: other cameras' observations do "
        "not constrain the trajectory)",
        getattr(args, "camera_index", 0), len(datasets),
    )
    refined0 = maybe_refine_poses(datasets[0], args, device=device)
    return [
        _dc.replace(d, quats_G_B=refined0.quats_G_B,
                    trans_G_B=refined0.trans_G_B)
        for d in datasets
    ]
