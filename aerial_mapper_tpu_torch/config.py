"""Typed configuration for every pipeline stage.

Mirrors the reference's per-module ``Settings`` structs (see
``aerial_mapper_dense_pcl/include/aerial-mapper-dense-pcl/common.h:31-110``,
``aerial_mapper_dsm/include/aerial-mapper-dsm/dsm.h:25-32``,
``aerial_mapper_ortho/include/aerial-mapper-ortho/ortho-backward-grid.h:32-41``,
``.../ortho-forward-homography.h:33-42``, ``.../ortho-from-pcl.h:28-35``,
``aerial_mapper_grid_map/include/.../aerial-mapper-grid-map.h:23-29``)
but as frozen dataclasses so they are hashable.

The PyTorch port keeps its own copy of ``aerial_mapper_tpu/config.py`` so it
imports nothing of the JAX package; the dataclasses are field-for-field the
same. In the port, ``kernel="pallas"`` / ``idw_kernel="pallas"`` /
``score_kernel="pallas"`` select the hand-written CUDA kernel for a CUDA
tensor and its plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GridMapConfig:
    """Geometry of the map raster (reference: grid_map::Settings).

    The grid follows GeoTiff conventions: row 0 is the northern edge, column 0
    the western edge; ``resolution`` is meters per cell.
    """

    center_easting: float = 0.0
    center_northing: float = 0.0
    delta_easting: float = 200.0
    delta_northing: float = 200.0
    resolution: float = 1.0

    @property
    def width(self) -> int:
        return int(round(self.delta_easting / self.resolution))

    @property
    def height(self) -> int:
        return int(round(self.delta_northing / self.resolution))


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Virtual-stereo driver settings (reference: stereo::Settings, common.h:31-35)."""

    use_every_nth_image: int = 1
    images_need_undistortion: bool = False
    # "bm" or "sgm"; the reference defaults to SGBM in code but demos pass BM.
    matcher: str = "bm"
    # "stereo" (consecutive-pair virtual stereo, the reference's mode) or
    # "plane_sweep" (N-view elevation-plane sweep, stereo/plane_sweep.py —
    # opt-in quality extension; configure via PlaneSweepConfig).
    densifier: str = "stereo"
    # Optional world-z bounds on TRIANGULATED points (meters): gross
    # disparity outliers triangulate hundreds of meters off the terrain
    # and dominate the DSM's squared error (measured: bench-scale DSM
    # RMSE 27 m from a handful of outliers vs 0.12 m median). The
    # reference applies exactly this filter to LOADED clouds (z > -100,
    # aerial-mapper-io.cc:309-347) but not to generated ones; None = keep
    # everything (reference parity). Applied identically by the batch,
    # incremental, and fused sharded drivers.
    z_min: Optional[float] = None
    z_max: Optional[float] = None
    # Opt-in: bound the disparity search window to what the terrain's
    # elevation slab can produce (stereo.batched.disparity_range_from_slab)
    # — the slab comes from [z_min, z_max] when both are set, else from a
    # cheap full-range BM prepass (stereo.plane_sweep.auto_z_range). The
    # matcher + cost-volume passes scale ~linearly with the disparity
    # count, so a +-20 m slab at survey scale costs ~1/3 of the 80-
    # disparity reference default. Approximation (documented): terrain
    # OUTSIDE the slab cannot be discovered — default off for parity.
    disparity_from_slab: bool = False


@dataclasses.dataclass(frozen=True)
class SgmConfig:
    """Semi-global matching parameters (reference SGBM defaults, common.h:85-96)."""

    min_disparity: int = 1
    num_disparities: int = 80
    p1: float = 120.0
    p2: float = 250.0
    block_size: int = 9
    # x-Sobel prefilter clip (the reference passes 35 to cv::StereoSGBM,
    # common.h:87 — NOT OpenCV's own 63 default)
    pre_filter_cap: int = 35
    uniqueness_ratio: int = 10
    num_directions: int = 8  # 4 or 8 scan directions (cv full-8 parity)
    # Optional BM-style texture gate (cv::StereoBM's textureThreshold
    # applied to SGM): invalidate pixels whose block-summed |sobel - cap|
    # response is below this. cv::StereoSGBM has no such gate — its
    # aggregation accepts weak-texture matches BM rejects, which is the
    # measured source of SGM's post-z-filter error tail at bench scale
    # (docs/PERFORMANCE.md densifier table). 0 = off (cv parity).
    texture_threshold: float = 0.0
    speckle_window_size: int = 100
    speckle_range: float = 20.0
    # "windowed" (fast support-count approximation) or "cc"
    # (cv::filterSpeckles-parity connected components; ~2 gathers x
    # log2(H*W) iterations costlier — the parity mode).
    speckle_mode: str = "windowed"
    # Left-right consistency (cv::validateDisparity): max allowed index
    # difference between the left winner and the right-view winner at its
    # match column; 0 = exact agreement (the reference default,
    # common.h:91), negative disables.
    disp_12_max_diff: int = 0
    # Both values run the directional scans through the CUDA kernel
    # csrc/sgm.cu on a CUDA tensor and through its plain PyTorch version
    # (stereo/matching.py::sgm_scan_plain) on a CPU tensor, for 4 or 8
    # directions, and the cost and post-filters through csrc/sgm_cost.cu
    # and csrc/sgm_select.cu the same way (block_size <= 15 and
    # num_disparities <= 256 on the card). They differ as their JAX twins
    # do: "pallas" takes the
    # restart arithmetic of the fused scan (sgm_disparity_cuda) and ignores
    # texture_threshold; "xla" takes the lax.scan arithmetic
    # (matching.sgm_disparity) and applies the texture gate.
    kernel: str = "xla"
    # Kept for config parity with the JAX package (its lax.scan unroll
    # factor); it has no effect on the port's results or its kernels.
    scan_unroll: int = 4


@dataclasses.dataclass(frozen=True)
class BlockMatchingConfig:
    """SAD block matching parameters (reference BM defaults, common.h:98-109)."""

    min_disparity: int = 1
    num_disparities: int = 80
    block_size: int = 15
    texture_threshold: float = 20.0
    # cv semantics: invalidate when a cost outside +-1 of the winner is
    # <= minsad + minsad*ratio/100 (integer truncation, equality rejects);
    # NEGATIVE disables the check (0 still rejects exact cost ties)
    uniqueness_ratio: int = 80
    pre_filter_cap: int = 31
    pre_filter_size: int = 9
    speckle_window_size: int = 100
    speckle_range: float = 5.0
    # "windowed" or "cc" — see SgmConfig.speckle_mode.
    speckle_mode: str = "windowed"
    # cv::validateDisparity max index difference (reference: 0,
    # common.h:106); negative disables the LR check.
    disp_12_max_diff: int = 0
    # cv::StereoBM operates on CV_8U images with integer SAD costs
    # (prefilter_xsobel writes uint8, SADs accumulate in int); True
    # quantizes the (bilinear, float) rectified images the same way and
    # runs the whole [D, H, W] cost volume in int16 — half the HBM bytes
    # of float32. False keeps the earlier float cost volume.
    integer_costs: bool = True
    # "xla": the cost-volume matcher in PyTorch ops
    # (matching.block_matching_disparity, with the left-right check).
    # "pallas": the fused running-state scan, the CUDA kernel csrc/bm.cu on
    # a CUDA tensor and its plain PyTorch version on a CPU tensor
    # (stereo/cuda_bm.py) — the cost volume is never stored. Identical
    # border masking, WTA, sub-pixel, texture, and speckle semantics;
    # deviations in the acceptance set only: a conservative running
    # uniqueness runner-up, and NO left-right check (disp_12_max_diff is
    # ignored) — exact "xla" parity under uniqueness_ratio<0 (disabled) +
    # disp_12_max_diff<0.
    kernel: str = "xla"


@dataclasses.dataclass(frozen=True)
class PlaneSweepConfig:
    """Plane-sweep multi-view densifier (capability extension; the
    reference densifies only consecutive rectified pairs,
    stereo.cpp:149-193). Sweeps ``num_planes`` world-ELEVATION planes in
    [z_min, z_max] against ``num_neighbors`` views per reference frame —
    see stereo/plane_sweep.py. An opt-in quality mode: ~M x K x H x W
    gathers per reference view, far more work than pair block matching.

    ``z_min``/``z_max`` = None (default) derives the missing bound
    automatically from a cheap full-range BM prepass on a few pairs
    (robust percentiles of the triangulated z, widened by a margin —
    ``stereo.plane_sweep.auto_z_range``); planes that miss the terrain
    would otherwise silently degrade elevations (VERDICT r4 #4). Hand-set
    both bounds to skip the prepass."""

    z_min: Optional[float] = None
    z_max: Optional[float] = None
    num_planes: int = 48
    num_neighbors: int = 2
    # sequence stride between a reference and its neighbor views:
    # elevation sensitivity is ~ fx * baseline / depth^2 px per meter, so
    # closely-spaced survey frames need spacing > 1 for the sweep to
    # resolve height (neighbors picked at ri +- spacing, +- 2*spacing, ...)
    neighbor_spacing: int = 1
    block_size: int = 7
    # minimum views that must see the point at the winning plane
    min_views: int = 1
    # reject pixels whose winning mean-abs-diff cost exceeds this (gray
    # levels); 1e9 disables
    max_cost: float = 1.0e9
    # cv-style uniqueness on the plane axis (%); 0 disables
    uniqueness_ratio: int = 0
    # reject pixels whose winner is the FIRST or LAST plane: no parabolic
    # refinement is possible there and such winners are usually sweep-range
    # clipping artifacts (set the range generously instead)
    reject_boundary_planes: bool = True
    scan_unroll: int = 2


@dataclasses.dataclass(frozen=True)
class DsmConfig:
    """DSM IDW settings (reference: dsm::Settings, dsm.h:25-32).

    NOTE on units: the reference feeds ``interpolation_radius`` directly to a
    nanoflann ``RadiusResultSet`` whose L2 adaptor returns *squared*
    distances, so the parameter is effectively in m^2 and the IDW weights are
    1/d^2 (SURVEY.md "Parity with reference quirks"). We keep those semantics:
    ``interpolation_radius_sq`` is compared against squared cell-to-point
    distances and the adaptive growth caps at ``max_radius_sq`` = 7.0 m^2.
    """

    interpolation_radius_sq: float = 1.0
    adaptive_interpolation: bool = True
    adaptive_growth_factor: float = 1.1
    max_radius_sq: float = 7.0
    center_easting: float = 0.0
    center_northing: float = 0.0
    # Max points binned per source cell for the dense neighborhood gather.
    bin_capacity: int = 8
    # "xla" or "pallas": the same windowed IDW in the port — the CUDA
    # kernel csrc/idw.cu on a CUDA tensor, its plain PyTorch version
    # (dsm/idw.py::binned_idw) on a CPU tensor.
    idw_kernel: str = "xla"


@dataclasses.dataclass(frozen=True)
class OrthoBackwardGridConfig:
    """Backward-grid ortho settings (reference: ortho::Settings, ortho-backward-grid.h:32-41)."""

    orthomosaic_elevation_m: float = 0.0
    use_digital_elevation_map: bool = True
    colored_ortho: bool = False
    # Cells per score-pass chunk: bounds the [num_images x chunk] tensors.
    # Default covers a 512x512 map in one pass; memory ~ N * chunk * 24 B.
    cell_chunk: int = 262144
    # "xla" or "pallas": with a pinhole camera both run the best-angle
    # score pass as the CUDA kernel csrc/score.cu on a CUDA tensor and as
    # its plain PyTorch version (ortho/backward_grid.py::_score_pass) on a
    # CPU tensor. With a distorted camera "xla" runs the general path in
    # PyTorch (backward_grid.py::_score_pass_general, cell_chunk cells at a
    # time) and "pallas" raises ValueError, as in the JAX package.
    score_kernel: str = "xla"


@dataclasses.dataclass(frozen=True)
class OrthoHomographyConfig:
    """Forward-homography mosaic settings (reference: ortho::Settings,
    ortho-forward-homography.h:33-42). The reference hardcodes 1 m/px; we
    expose ``resolution``."""

    ground_plane_elevation_m: float = 414.0
    width_mosaic_pixels: int = 1000
    height_mosaic_pixels: int = 1000
    resolution: float = 1.0
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    batch: bool = True
    image_chunk: int = 8
    # Per-image accumulation window (mosaic pixels). A homography maps the
    # image rectangle to a convex quad (lines to lines), so its footprint's
    # bounding box is spanned by the 4 warped corners of the half-pixel-
    # expanded source rectangle ([-0.5, W-0.5]: everything INTER_NEAREST
    # accepts); warping only a [window_rows, window_cols] slab around it
    # instead of the full mosaic cuts the per-image gather from Hm*Wm to
    # the footprint size. 0 = full mosaic (always exact). With auto_window
    # the batch driver sizes the window from the host-side pose set and
    # uses the full path whenever any footprint is unbounded (corner
    # at/behind the ground-plane horizon) or larger than the mosaic. A
    # HAND-SET window smaller than some image's footprint drops that
    # image's whole contribution (the runtime fit-check refuses to clip
    # silently) — prefer auto_window. Off by default here, unlike the JAX
    # package: one image per loop step is host-bound on the GPU, and the
    # window's extra launches per image made it 1.5-2x as slow as the full
    # warp on 384x768 to 2000x2000 mosaics (chip_smoke.py phase 7d);
    # both give the same mosaic bit for bit.
    window_rows: int = 0
    window_cols: int = 0
    auto_window: bool = False


@dataclasses.dataclass(frozen=True)
class OrthoFromPclConfig:
    """Ortho-from-points settings (reference: ortho::Settings, ortho-from-pcl.h:28-35).

    Same squared-distance-unit quirk as DsmConfig; adaptive growth multiplies
    the radius by 10 per step (ortho-from-pcl.cc:63-71) and is UNCAPPED in
    the reference. ``max_radius_sq=None`` (default) reproduces that: the
    windowed kernel handles the near field and an exact global brute-force
    pass fills any remaining sparse cells (dsm/idw.py idw_unbounded_brute).
    Set a float to cap the growth instead (bounded cost on huge maps).
    """

    interpolation_radius_sq: float = 2.0
    use_adaptive_interpolation: bool = False
    adaptive_growth_factor: float = 10.0
    max_radius_sq: Optional[float] = None
    bin_capacity: int = 8


@dataclasses.dataclass(frozen=True)
class BundleAdjustmentConfig:
    """Windowed bundle adjustment (north-star extension; not in reference).

    ``position_prior_sigma_m``: soft prior tying camera positions to their
    initial (georeferenced PIX4D/COLMAP) values. Besides reflecting the
    GNSS-anchored use case, it pins the similarity-scale gauge that fixing
    a single camera leaves free. <= 0 disables.
    """

    max_iterations: int = 10
    # PCG iterations on the reduced camera system per LM step
    # (block-Jacobi preconditioned; 40 suffices to ~machine tolerance for
    # hundreds of cameras).
    cg_iterations: int = 40
    damping_init: float = 1e-4
    damping_factor: float = 10.0
    huber_delta: float = 2.0
    fix_first_pose: bool = True
    position_prior_sigma_m: float = 3.0
    # Redescending gate: observations with residual norm above this get
    # zero IRLS weight and a capped cost (gross outliers exert no force).
    outlier_threshold_px: float = 20.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline composition.

    ``auto_shard``: when ``parallel/mesh.py::default_devices`` holds more
    than one device, the batch drivers shard over a ``tiles`` mesh of them
    (parallel/sharded.py): the stereo by pair or reference view, the DSM
    and backward-grid ortho by map row band, the homography by image; the
    maps equal the single-device ones (the homography to float rounding).
    The incremental driver runs one fused sharded step per update over a
    (pairs=1, tiles=n) mesh, its map equal to the single-device one
    (``pipeline/incremental.py``). Under a ``torch.distributed`` group the
    mesh spans every rank's devices (``parallel/mesh.py::mesh_devices``):
    every rank returns the whole result, and the batch drivers write their
    files on rank 0 only.
    """

    auto_shard: bool = True
    grid: GridMapConfig = GridMapConfig()
    stereo: StereoConfig = StereoConfig()
    plane_sweep: PlaneSweepConfig = PlaneSweepConfig()
    bm: BlockMatchingConfig = BlockMatchingConfig()
    sgm: SgmConfig = SgmConfig()
    dsm: DsmConfig = DsmConfig()
    ortho_backward: OrthoBackwardGridConfig = OrthoBackwardGridConfig()
    ortho_homography: OrthoHomographyConfig = OrthoHomographyConfig()
    ortho_from_pcl: OrthoFromPclConfig = OrthoFromPclConfig()
    ba: BundleAdjustmentConfig = BundleAdjustmentConfig()
