#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--sgm-chunk N|none]

Phases (any failed check raises, and the script exits non-zero without its
result line):

1. Device: the card's name and ``nvidia-smi`` name / power limit.
2. Build: ``nvcc`` compiles ``aerial_mapper_tpu_torch/csrc/*.cu`` (one
   process per source, in parallel) into ``aerial_mapper_tpu_torch/_build/``.
3. Each CUDA kernel against its plain PyTorch version on the card, at the
   bench shapes of the fused mapping step (35 pairs of 752x480 at 80
   disparities; the bench cloud's binned arrays; 400x400 cells x 249
   cameras), with times from CUDA events (median after a warm-up) and the
   least time the card could take for the same work; each kernel's
   device time alone (``device_ms``, torch.profiler) sits beside the
   events' time of one wrapper call (``ms``). 3a: both BM entries bit-equal
   on all 5 maps: the integer kernel on the bench pairs, on a worst-case
   pair (left 2 * cap, right 0) and on a ragged batch (H, W not multiples of
   its tile, W < D + r) at blocks 1, 5, 9, 15, 21 and 127; the float entry
   (the ring kernel up to block 55, the wide one above) on the bench pairs
   prefiltered with ``integer_costs=False`` at blocks 15 and 25 and on
   ragged non-integer batches at blocks 1, 5, 15, 23, 25, 45 and 89, and
   ``ValueError`` before any launch at the first block past its
   shared-memory limit (91 at 80 disparities); the integer entry timed on
   the integer-valued bench input, the float entry at blocks 15 and 25 on
   the float-prefiltered one, with both the bound of the integer entry's
   operation count and the float entry's order-keeping bound (4r + 9
   operations per pixel and disparity). 3b: IDW hit and values bit-equal on
   the bench cloud, adaptive (the timed case), without the ladder and with a
   window of more than 128 offsets. 3c: the score pass bit-equal on all 5
   outputs on an adversarial input (UTM-sized coordinates, cells on the
   image edges, NaN and infinite elevations, cameras behind the cells,
   duplicate cameras past the first 256), at the survey shape (2000x2000
   cells at 0.5 m x 825 cameras, the plain version chunked over cells) and
   at the bench shape, with the cull's kept share of pairs and the visible
   pairs that its bound counts. 3d: the SGM scan on the real BT cost of the
   SGM step's first chunk of bench pairs (the launch shape of phase 5), all
   8 passes, bit-equal in both restart forms, then timed over all of the
   step's chunks (35 pairs). 3e: SGM's cost kernel (``csrc/sgm_cost.cu``)
   bit-equal to its plain version on the step's 35 bench pairs at its
   configuration (block 9, ``min_disparity`` 1) and at ``min_disparity`` 0
   with blocks 1 and 15; the post-filter kernels (``csrc/sgm_select.cu``:
   WTA, uniqueness at the configuration's ratio and off, the left-right
   check at ``max_diff`` 0 and 1) bit-equal on the step's aggregated
   volume and on crafted volumes (integer costs full of ties, all-1e9
   image columns, rows and right-view columns, D of 13, 80 and 100); the
   edges of the redesigned cost and LR kernels (``sgm_edge_phase``: the
   cost at 20 tiling edge shapes and on images outside its division's
   untested range, windows 2 to 15; ``tools/sgm_div_check.py`` over all
   2^32 inputs; the LR check on odd and small D, -0 beside +0, and a
   volume that is not 16-byte aligned); each check's launch counted; each
   kernel timed at the step's shape, with its share of its bound beside
   the card's name and power limit.
4. The fused mapping step end to end at bench scale (the workload of
   ``bench.py``, built by ``bench_torch.py`` without its pose jitter:
   249 synthetic 752x480 images, a 400x400-cell map at 0.5 m, 35
   pairs), with every launch counter set to 0 just before and read just
   after; the DSM and ortho are scored against the synthetic scene's
   analytic height and texture. 4f: the same step on the float
   BM path (``integer_costs=False``), counted and scored the same way.
   4f(ii): the step at ``block_size=25`` with ``integer_costs`` left on,
   which the integer guard sends to the float entry: 1 float BM, 0
   integer BM, 1 IDW and 1 score launch per step, its bars printed (a
   miss is reported, not raised).
5. The same step with the SGM matcher (``SgmConfig(num_disparities=80,
   kernel="pallas")``, 8 directions, ``--sgm-chunk`` pairs per pass: by
   default all 35 at once), counters set to 0 just before and read just
   after (8 scan launches and one of each of SGM's cost, WTA, uniqueness
   and left-right kernels per pass), scored the same way.
6. The incremental driver (``pipeline/incremental.py::run_incremental``)
   over the same 249 frames as an in-memory ``Dataset`` (identity
   extrinsic, body poses = camera poses), an update every 7th frame (35
   updates, 34 of them one stereo pair each, each scoring the map against
   that update's 7 cameras), counters set to 0 before and read after each
   run: 34 BM, 34 IDW and 35 score launches, no SGM and no float BM. 6a: 3
   streaming runs (median, min, max) and one prestaged run, scored the
   same way, with the per-update stage times of the port's StageTimer, a
   profile of each mode and the peak memory. 6b: frames [0, 126), then the
   full stream resumed at frame 126 from those layers, bit-equal to the
   uninterrupted map. 6c: the slab-bounded disparity search under a
   declared envelope around the scene's heights (its window printed),
   counted and scored the same way. 6d: each kernel bit-equal to its plain
   version on the operands of two updates (at frames 118 and 125, a pair
   along a flight line and the pair across the turn): BM on the pair at
   6a's window [1, 81) and at 6c's, IDW on its binned cloud, the score pass
   on its 7 cameras over the 400x400 map its DSM step left.
7. The five batch drivers (``pipeline/batch.py``) on the same stream as an
   in-memory ``Dataset``, every 7th frame paired (frames 6, 13, ..., 244:
   34 pairs, one per matcher pass), every launch counter set to 0 before
   and read after each run; each driver runs once writing its files, then
   3 times timed (median; host clock ending in a synchronize). 7a
   ``run_ortho_backward_grid`` (BM): 34 BM, 1 IDW and 1 score launches,
   phase 4's bars, the GeoTiff read back equal to the ortho, the npz
   layers to the map, the JPEG and HTML report written where Pillow is
   installed. 7b ``run_dsm`` with SGM: 272 SGM and 1 IDW launches, the DSM
   bars; then the SGM kernel at the drivers' launch shape [1, 480, 752,
   80], on the BT cost of two of its pairs, all 8 passes bit-equal in both
   restart forms, each launch counted. 7c ``run_dense_pcl``: 34 BM
   launches, the npz cloud read back equal. 7d
   ``run_ortho_forward_homography`` on a 384x768 mosaic at 0.5 m over the
   scene: the auto-windowed mosaic bit-equal to the full-mosaic warp, both
   timed; the same pair of runs at the config's default 1000x1000 mosaic
   and at 2000x2000. 7e ``run_ortho_from_pcl`` at the defaults and
   adaptive unbounded (one IDW launch each, the unbounded one through the
   kernel's instantiation for more than 128 offsets; one timed run, with
   the cells its brute pass fills and the brute pass timed alone), held to
   the ortho bars; then on a sparse cloud, every cell hit, against the
   same call on the CPU.

8. The plane-sweep densifier and the distorted-camera path, every run
   counted the same way, each driver once and then 3 times timed. 8a
   ``run_ortho_backward_grid`` with ``densifier="plane_sweep"`` on the
   bench stream (35 reference views, 2 neighbours 7 frames away, 48
   planes, the z range from the BM prepass): 3 BM, 1 IDW and 1 score
   launches, phase 4's bars, the auto range and pile-up fractions, a
   profile of the first 50 frames (7 reference views) with the launches
   per reference view. 8b the same poses
   rendered through a radial-tangential lens (the general score pass on
   8a's map and one frame's undistortion first timed alone): (i) the
   backward-grid ortho with undistortion and the general score path (34 BM, 1 IDW, no score
   launch; ``score_kernel="pallas"`` raises ``ValueError``), (ii)
   ``run_incremental`` with undistortion (34 BM, 34 IDW, no score launch,
   runs bit-equal), (iii) the homography on 7d's mosaic with every image
   undistorted, against the pinhole stream's mosaic, (iv) ``run_dsm`` with
   the plane sweep through the lens (1 IDW). 8c: BM bit-equal on an
   undistorted, rectified lens pair (118, 125), IDW on 8a's binned cloud
   and the score pass on 8a's map and cameras.

9. The demo CLIs (``aerial_mapper_tpu_torch/cli``) as a user runs them.
   9a: the bench stream written as a dataset on disk by the port's own
   writers (249 PGM frames, ``opt_poses.txt``, the rig YAML), read back
   equal. 9b: the six mapping CLIs in process through ``main(argv)`` with
   ``device`` left at None and ``yaml`` and ``PIL`` blocked, each run
   counted: the backward grid under ``--kernel_family pallas`` (34 BM, 1
   IDW, 1 score launches), ``xla`` (0, 1, 1) and a flagfile with the
   reference's ``backward_grid_`` prefix and gflags booleans (bit-equal to
   the ``pallas`` run); ``main_dsm`` with BM (34 BM, 1 IDW) and SGM (272
   SGM, 1 IDW); the incremental CLI (34 BM, 34 IDW, 35 score); the
   homography on 7d's 384x768 mosaic (none); ``main_dense_pcl`` on the
   first 50 frames (6 BM) and ``main_ortho_from_pcl`` on its text cloud
   (1 IDW). Each run's files, read back, equal the port driver called in
   process on ``cli.common``'s dataset and config for the same argv, and
   its maps meet phase 4's bars. Where Pillow is installed, the HTML
   report and the live preview run after that. 9c: ``python -m
   aerial_mapper_tpu_torch.cli.main_dsm`` with ``--profile_dir`` exits 0
   and writes 9b's GeoTiff and a non-empty trace.

10. Feature-track bundle adjustment (``ba/``, ``features/``) and
    ``--refine_poses``; no kernel of its own, so the four kernels' counts
    show where the refined poses feed the mappers. 10a ``bundle_adjust``
    on ``bench.py::worker_ba``'s problem (the 249 bench cameras, 3000
    landmarks on the scene, ~130 k observations; 0.5 px, 0.5 m pose and
    0.5 m landmark noise; 10 LM steps): a warm run and 3 timed, two solves
    bit-equal, the cost falling, the aligned position error at least
    halved, a profile of one solve (kernels per solve, busy share) and the
    segment sums' route against ``index_add_``. Phase 9's dataset is
    written again with a pose file carrying 0.5 m of noise on frames
    1..248. 10b ``refine_poses_windowed`` on it: two runs bit-equal, no
    kernel launched, the median 15-frame aligned ATE at least halved, one
    window profiled. 10c ``main_refine_poses`` (10b's check on its file),
    ``main_dsm`` with the true, the noisy and (``--refine_poses``) the
    refined poses, and ``main_ortho_backward_grid --refine_poses``, each
    counted (34 BM, 1 IDW, and 1 score for the ortho): the refining CLIs'
    maps equal the drivers in process on 10b's poses, their median |DSM
    error| at most half the noisy one, DSM and ortho coverage above 0.5.
11. The one-process mesh (``parallel/``) on logical shards of the card
    (``parallel/mesh.py::default_devices`` patched to repeat ``cuda:0``;
    one card runs the shards one after another, so its times are the cost
    of sharding on one card, not a multi-GPU scaling figure). 11a
    ``sharded_map_step`` over a (pairs, tiles) = (2, 4) mesh on phase 4's
    operands (35 pairs padded to 40 ring slots, 4 bands of 100 rows):
    (i) replicated images at route_capacity_factor 4.0, bit-equal to the
    one-device composition, 40 BM / 8 IDW / 8 score launches per step,
    timed against phase 4's step; (ii) slab-culled images at factor 2.0:
    overflow, routed points per tile, images per band, ``diag.check`` and
    bit-equal where it passes. 11b: BM, IDW and score bit-equal to their
    plain versions on shard 0's operands of 11a(i). 11c: the backward grid
    (BM), ``run_dsm`` (SGM), ``run_dense_pcl`` (pairs; the plane sweep on
    the first 50 frames) and the homography on a 4-shard tiles mesh, each
    equal to its ``auto_shard=False`` run (bit for bit; the homography at
    atol 5e-3). 11d ``sharded_bundle_adjust`` over an (obs,) mesh of 4 on
    10a's problem padded with valid=False: within 5e-3 m / 1e-4 of
    ``bundle_adjust``, two runs bit-equal.
12. The sharded incremental driver: ``run_incremental`` with
    ``auto_shard`` over 8 logical shards of the card, on phase 6's stream
    and config (a (pairs, tiles) = (1, 8) mesh: each update one fused
    ``sharded_map_step``, the pair padded to 8 ring slots, 8 bands of 50
    rows, the images culled per band against the tracked slab, one host
    read per window of 8 updates). Each run counted and held to the
    driver's calls (8 BM, 8 IDW and 8 score launches per fused step, 8
    score per ortho-only pass). 12a the defaults: a warm run (band sizes
    of the cull, synchronizes counted under torch's sync debug mode, peak
    memory), 2 timed runs, each map bit-equal to phase 6's one-device map;
    12b a forced slab violation (``slab_margin_m=-0.5``) and 12c a forced
    overflow (``route_capacity_factor=0.2``), each replayed and bit-equal;
    12d the deferred ``on_update`` payloads on the first 70 frames, host
    numpy and bit-equal to the one-device payloads; 12e BM, IDW and score
    bit-equal to their plain versions on shard 0's operands of a culled
    update; 12f the native image loader (``io/native_loader.py``): whether
    it builds, and where it does, ``backend="native"`` equal to ``"pil"``
    on the bench frames as PGM, both timed.
13. The mesh across processes (``parallel/distributed.py``): the parent
    writes phase 4's frames and phase 6's map to a temporary ``.npz`` and
    spawns 2 worker processes of this script (``--dist-worker``, a Gloo
    group with a ``file://`` rendezvous), each with 4 logical shards of
    ``cuda:0``; every launch counter is set to 0 just before each run and
    read just after, per rank. 13a ``sharded_dsm_update`` on an (8,)
    tiles mesh over phase 4's cloud; 13b ``sharded_map_step`` over phase
    4's operands on (pairs, tiles) = (1, 8) (tiles cross the processes)
    and (2, 4) (pairs cross them), each bit-equal to the one-device DSM
    and composition; 13c ``run_incremental`` with ``auto_shard`` over
    phase 6's stream on the driver's (1, 8) mesh: a warm run and 2 timed,
    every rank's map bit-equal to phase 6's, with per rank the wall time,
    windows, replays, window reads, launches per kernel, bytes through the
    group and peak memory. 13d: 13b's (1, 8) step in this process inside
    a one-rank NCCL group (the device-tensor path of the collectives),
    bit-equal too.
14. The batch drivers across processes (``pipeline/batch.py``'s
    ``auto_shard`` under a group): the parent runs 7a's backward grid on
    one device writing its files, writes the frames and 11c's sharded
    results to a temporary ``.npz`` and spawns 2 workers of this script
    (``--dist-worker R --dist-phase 14``, Gloo), each with 2 logical shards
    of ``cuda:0``, so the drivers' tiles mesh is 11c's 4 shards across the
    processes. 14a: each worker runs 11c's five drivers (the sweep on the
    first 50 frames), a warm run and 2 timed, every launch counter set to
    0 just before each run and read just after (per rank: the backward
    grid 18 BM / 2 IDW / 2 score, the SGM DSM 144 SGM / 2 IDW, the dense
    cloud 18 BM, the sweep 3 BM, the homography none), every result on
    every rank bit-equal to 11c's sharded one, with per rank the wall
    time, bytes and seconds through the group and peak memory; rank 0
    alone writes 7a's files, equal to the one-device run's. 14b: the
    backward grid in this process inside a one-rank NCCL group over 4
    logical shards, bit-equal to 11c.
15. The card's two rasters against the C++ reference loops
    (``native/reference_baseline.cc`` through ``aerial_mapper_tpu_torch/
    native.py``, built in phase 2 with ``make -C native
    libambaseline.so``; without it the run fails): an oracle written
    independently of the kernels and of their plain versions. 15a: the
    backward grid (the score kernel) at the bench with the analytic
    elevation against ``backward_grid_cpu``: agreement within 2 gray on
    >= 99.9 % of the cells both texture, <= 0.1 % textured by one side
    only. 15b: 70 uniform points per cell (seed 7, z the scene's height
    plus N(0, 0.15 m)) through the binned IDW (the IDW kernel, K = 8)
    against ``dsm_idw_cpu``'s all-neighbours loop: hit mismatch <= 1e-3,
    RMSE < 0.06 m and max < 0.5 m over the cells both hit. Both passes run
    once counted (1 score, 1 IDW launch); the card's times (CUDA events)
    and the loops' host seconds and threads are data.
16. Colored frames and a two-camera rig (``colored_rig_phase``): the
    bench stream rendered in RGB (uint8 [249, 480, 752, 3]) and a second
    camera pitched 25 degrees north at the same poses; every run counted.
    16a ``run_incremental`` on the RGB frames with ``colored_ortho`` and on
    their gray twin (``rgb_to_gray`` of them on the card): the non-color
    layers bit-equal, the BT.601 gray of the unpacked colored ortho equal
    to the gray ortho on every textured cell, the RGB within phase 4's
    ortho bars of the scene's ``texture_rgb``, and two controls (blue
    dropped; the packed layer through float arithmetic) failing both the
    luma and the int32-bits check. 16b the same pair of
    ``run_ortho_backward_grid`` jobs, the RGB GeoTiff and image read back
    equal to ``_ortho_image``, NaN cells white. 16c the rig on disk (PPM
    frames per camera, the rig YAML, the poses) and the map 140 rows
    taller to the north: the fused job and stream on gray frames held to
    phase 4's bars, a DSM 1.3 x camera 0's alone, global ids in [0, 498)
    from both cameras; the same runs on RGB frames; BM, IDW and score
    bit-equal to their plain versions on the colored stream's update of
    frame 118 (the 540x400 map). 16d the rig stream, the colored rig job and
    the colored rig stream (with ``on_update`` payloads) on 8 logical
    shards, bit-equal to their one-device runs; IDW and score bit-equal to
    their plain versions on every band of the colored stream's middle
    step.
    16e the two backward-grid CLIs with ``--load_colored_images
    --colored_ortho --all_cameras`` and ``yaml`` and ``PIL`` blocked,
    their layers bit-equal to 16c's colored runs.

The lines before the last are the ``nvidia-smi`` line, the ``{"e2e": ...}``,
``{"e2e_bm_float": ...}``, ``{"e2e_sgm": ...}``, ``{"e2e_incremental":
...}``, ``{"e2e_batch": ...}``, ``{"e2e_slice7": ...}``, ``{"e2e_cli":
...}``, ``{"e2e_refine": ...}``, ``{"e2e_shard": ...}`` and
``{"e2e_stream_shard": ...}``, ``{"e2e_dist": ...}``,
``{"e2e_dist_batch": ...}``, ``{"e2e_native": ...}`` and
``{"e2e_colored_rig": ...}`` objects and one
JSON object ``{"kernels":
[...]}`` (each kernel with its launches in one incremental run, in one run
of each batch driver, in each run of phase 8, in each CLI run of 9b, in
each run of phase 10, in each run of phase 11 beside those of its step
in each run of phase 12, per rank in each run of phase 13, per rank in
each driver of phase 14, in phase 15's two passes and in each run of
phase 16); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA it exits 2 and prints no result.
"""

import argparse
import json
import logging
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

import bench_torch
from bench_torch import (
    BA_LANDMARKS,
    ate_aligned,
    bit_equal_maps,
    count_syncs,
)

NUM_IMAGES = 249
IMG_W, IMG_H = 752, 480
MAP_CELLS = 400
RESOLUTION = 0.5
NUM_DISP = 80
USE_EVERY_NTH = 7
# the pairs of phase 7b's SGM check end at these frames: (111, 118) along
# the first flight line, (118, 125) across the turn to the second
SGM_CHECK_FRAMES = (118, 125)
# phase 8c's BM check: the pair (118, 125) of the lens stream, undistorted
LENS_CHECK_PAIR = (118, 125)

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores. Every kernel here is float32 / integer work on
# the CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations per unit of work, the least a kernel of each function needs:
# BM per (pixel, disparity): AD (sub, abs), a sliding (2r+1)^2 window sum
# (2 adds in, 2 out), and the state update (3 compares, 3 selects).
OPS_BM = 12
# The float BM entry's order-keeping count per (pixel, disparity): its
# window sums must round as the plain version's in-order folds do (a
# sliding sum rounds differently), so 2r adds down the column and 2r along
# the row; with the AD (2), the border mask (1) and the state (6): 4r + 9.
OPS_BM_FLOAT_FIXED = 9
OPS_BM_FLOAT_PER_R = 4
# IDW per visit of an occupied slot from a window offset: pass 1 (every
# visit) offset add x2, d^2 (2 mul, add), min; pass 2 (only the visits from
# offsets with a slot inside the cell's radius) the same d^2, radius
# compare, 1/d^2, weighted num/den accumulation (mul, 2 adds).
OPS_IDW_PASS1 = 6
OPS_IDW_PASS2 = 10
OPS_IDW_LADDER = 20  # per cell: log, ceil, 2 pow, compares
# score per visible (cell, camera) pair: 3 x (3 mul + 3 add/sub), 2 div +
# 2 mul-add for (u, v), 6 visibility compares, q (3 mul, 2 add, max, div),
# select, compare. Charged only to the visible pairs (the sum of the plain
# version's n_vis): an invisible pair can be rejected by geometry, a whole
# tile of cells at a time, without its projection.
OPS_SCORE = 40
# SGM per (position, disparity, pass): min into m, two +P1, +P2, three
# mins for best, c + best - m (2), store select
OPS_SGM = 10
# SGM's cost per (pixel, disparity): BT (4 subtractions, 4 max, 1 min), the
# division and the border select, and the window's 2 (k - 1) adds, which
# must keep the plain version's order (a sliding sum rounds otherwise)
OPS_SGM_COST_FIXED = 11
OPS_SGM_COST_PER_K = 2
# the post-filters per (pixel, disparity) read: WTA a compare and a select;
# uniqueness the |d - best| test, a select and a min; the LR check's column
# minima a bound test and a min
OPS_SGM_WTA = 2
OPS_SGM_UNIQUENESS = 3
OPS_SGM_LR = 2
# the survey shape of phase 3c: a 1 km x 1 km map at 0.5 m, 25 lines of 33
# images at 80 % forward and 60 % side overlap with the bench camera
SURVEY_CELLS = 2000
SURVEY_LINES, SURVEY_PER_LINE = 25, 33
SURVEY_PLAIN_CHUNK = 32768  # cells per call of the plain version
# phase 8a profiles the sweep over the first PROFILE_FRAMES frames
PROFILE_FRAMES = 50


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, kernel: str, reps: int):
    """Mean device time per call of ``fn`` spent in the CUDA kernels whose
    name contains ``kernel`` (torch.profiler over ``reps`` calls after a
    warm-up): the kernel alone, without the wrapper's host time that a
    single call's CUDA events also hold. None if nothing was recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if kernel in e.key)
    return us / 1e3 / reps if us > 0 else None


def share(bound_ms: float, ms: float) -> float:
    """The share of its bound a kernel reached, over the events' time of one
    call: the wrapper's host time included, so a floor on the share. (Late
    in a whole run, torch.profiler has recorded ~3/5 of the launches that
    ``device_ms`` times, giving device times below the bound.)"""
    return bound_ms / ms


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def idw_visits(binned, ext, dsm_cfg):
    """The slot visits that the adaptive IDW of ``binned`` on ``ext`` needs,
    from this data: ``(pass 1, pass 2)``. Pass 1 visits every occupied slot
    (``min(count, K)`` per cell) from every window offset; pass 2 only those
    from offsets with a slot strictly inside the cell's radius, as the plain
    version's ladder gives it."""
    from aerial_mapper_tpu_torch.dsm.idw import (
        _circular_offsets,
        _f32,
        _window_halfwidth,
        effective_radius_sq,
    )

    k, h, w = binned.de.shape
    hw = _window_halfwidth(dsm_cfg.max_radius_sq, ext.resolution)
    offsets = _circular_offsets(hw, ext.resolution, dsm_cfg.max_radius_sq)
    res = _f32(ext.resolution)
    pad = (hw, hw, hw, hw)
    de_p = torch.nn.functional.pad(binned.de, pad, value=1e9)
    dn_p = torch.nn.functional.pad(binned.dn, pad, value=1e9)
    n_p = torch.nn.functional.pad(binned.count.clamp(max=k), pad, value=0)

    def at(oi, oj):  # per cell: the offset's slot minimum and slot count
        de = de_p[:, oi:oi + h, oj:oj + w] + _f32(_f32(oj - hw) * res)
        dn = dn_p[:, oi:oi + h, oj:oj + w] - _f32(_f32(oi - hw) * res)
        return (de * de + dn * dn).amin(dim=0), n_p[oi:oi + h, oj:oj + w]

    d2min = torch.full((h, w), 1e9, device=binned.de.device)
    visits1 = 0
    for oi, oj in offsets:
        m, n = at(oi, oj)
        d2min = torch.minimum(d2min, m)
        visits1 += int(n.sum().item())
    r_eff = effective_radius_sq(d2min, dsm_cfg.interpolation_radius_sq,
                                dsm_cfg.adaptive_growth_factor,
                                dsm_cfg.max_radius_sq)
    visits2 = 0
    for oi, oj in offsets:
        m, n = at(oi, oj)
        visits2 += int(torch.where(m < r_eff, n, 0).sum().item())
    return float(visits1), float(visits2)


def bench_camera_scene():
    """The bench camera and scene (``bench_torch.py``) at this script's
    frame size."""
    return bench_torch.bench_camera_scene(IMG_W, IMG_H)


def bench_poses():
    """The bench survey (``bench_torch.py``) at this script's frame count,
    without the benchmark's pose jitter."""
    return bench_torch.bench_poses(NUM_IMAGES, jitter=0.0)


def survey_poses():
    """The survey shape's poses: 25 lines of 33 images 31 m apart, 40 m
    between lines (80 % forward, 60 % side overlap of the bench camera's
    157 m x 100 m footprint), jitter 0.5 m and ~0.01 rad."""
    from aerial_mapper_tpu_torch.synth.scene import make_survey_poses

    return make_survey_poses(
        SURVEY_LINES * SURVEY_PER_LINE, altitude=514.0, spacing=31.0,
        num_lines=SURVEY_LINES, line_spacing=40.0, start_easting=-496.0,
        start_northing=-480.0, jitter=0.5)


def bench_dataset(cam, host_images, n=NUM_IMAGES):
    """The first ``n`` frames of the bench stream as an in-memory
    ``Dataset`` (``bench_torch.py``)."""
    return bench_torch.bench_dataset(cam, host_images, *bench_poses(), n)


def score_input(scene, Rs, ts, cells_per_side, dev):
    """The score pass's operands as ``backward_grid_update`` builds them:
    the cell centres of a square map at RESOLUTION with the scene's height,
    the camera bank of the poses (through quaternions), and the grid
    shape."""
    from aerial_mapper_tpu_torch.geo.se3 import (
        matrix_to_quat,
        quat_conjugate,
        quat_to_matrix,
    )
    from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry, cell_centers
    from aerial_mapper_tpu_torch.ortho.backward_grid import camera_bank

    geom = MapGeometry(0.0, 0.0, RESOLUTION, cells_per_side, cells_per_side)
    ce, cn = cell_centers(geom, device=dev)
    cells = torch.stack([ce.reshape(-1), cn.reshape(-1),
                         scene.height(ce, cn).reshape(-1)],
                        dim=-1).contiguous()
    quats = matrix_to_quat(torch.as_tensor(Rs, dtype=torch.float32,
                                           device=dev))
    bank = camera_bank(quat_to_matrix(quat_conjugate(quats)),
                       torch.as_tensor(ts, dtype=torch.float32, device=dev))
    return cells, bank, (cells_per_side, cells_per_side)


def adversarial_score_input(cam, dev):
    """An input made to break a wrong cull: UTM-sized coordinates (easting
    5e5 m, northing 5e6 m); 16 x 16 clusters of cells that project onto the
    four image edges of two cameras, a few float32 steps either side; NaN
    and +-inf elevations; 250 cameras below the ground (every cell behind
    them); and duplicates of the 14 survey cameras at indices 264-277, in
    the second chunk of 256 cameras, so ties must go to the lower index.
    The grid shape is not a multiple of the tile."""
    from aerial_mapper_tpu_torch.ortho.backward_grid import camera_bank
    from aerial_mapper_tpu_torch.synth.scene import make_survey_poses

    e0, n0, ground = 500000.0, 5000000.0, 414.0
    Rs, ts = make_survey_poses(14, altitude=514.0, spacing=30.0, num_lines=2,
                               line_spacing=40.0, start_easting=e0 - 100.0,
                               start_northing=n0 - 20.0, jitter=0.5, seed=3)
    rng = np.random.default_rng(4)
    t_below = np.concatenate([
        rng.uniform([e0 - 150, n0 - 60], [e0 + 150, n0 + 80], (250, 2)),
        np.full((250, 1), 300.0)], axis=1)
    Rs = np.concatenate([Rs, np.repeat(Rs[:1], 250, 0), Rs])
    ts = np.concatenate([ts, t_below, ts])

    def cluster(R, t, u, v, along):
        d = R @ np.array([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, 1.0])
        p = (t + (ground - t[2]) / d[2] * d).astype(np.float32)
        out = np.repeat(p[None, None], 16, 0).repeat(16, 1)
        for a in range(16):  # -8..7 float32 steps along one axis
            x = p[along]
            for _ in range(abs(a - 8)):
                x = np.nextafter(x, np.float32(np.inf if a > 8 else -np.inf))
            out[:, a, along] = x
        return out

    clusters = [cluster(Rs[j], ts[j], u, v, along) for j in (2, 9)
                for u, v, along in ((0.0, IMG_H / 2, 0), (IMG_W, IMG_H / 2, 0),
                                    (IMG_W / 2, 0.0, 1), (IMG_W / 2, IMG_H, 1))]
    gh, gw = 53, 16 * len(clusters) + 9
    jj, ii = np.meshgrid(np.arange(gw), np.arange(gh))
    grid = np.stack([e0 - 120.0 + 2.0 * jj, n0 + 60.0 - 2.0 * ii,
                     ground + 6.0 * rng.random((gh, gw))], -1)
    grid = grid.astype(np.float32)
    for k, c in enumerate(clusters):
        grid[:16, 16 * k:16 * k + 16] = c
    grid[16:32, 32:48, 2] = np.nan  # a tile the DSM has not reached
    grid[50:, :, 2] = np.nan  # NaN rows in the ragged last tile row
    grid[20, 70, 2] = np.inf
    grid[40, 100, 2] = -np.inf
    R_cw = torch.as_tensor(np.transpose(Rs, (0, 2, 1)).copy(),
                           dtype=torch.float32, device=dev)
    bank = camera_bank(R_cw, torch.as_tensor(ts, dtype=torch.float32,
                                             device=dev))
    cells = torch.as_tensor(grid.reshape(-1, 3), device=dev)
    return cells, bank, (gh, gw)


def score_plain(cells, bank, cam, chunk=SURVEY_PLAIN_CHUNK):
    """The plain score pass over chunks of cells (each row is independent,
    so the chunks change no bit)."""
    from aerial_mapper_tpu_torch.ortho.backward_grid import _score_pass

    outs = [_score_pass(cells[i:i + chunk], bank, cam)
            for i in range(0, cells.shape[0], chunk)]
    return tuple(torch.cat(o) for o in zip(*outs))


def score_check(tag, cells, bank, grid_shape, cam, reps=0):
    """score_pass_cuda against the plain version (chunked over cells) on all
    5 outputs, bit for bit; the cull's kept share of pairs (the plain
    predicate), the visible pairs and the bound they give; with ``reps``
    the kernel's time too: CUDA events around one call (``ms``) and the
    kernel alone (``device_ms``, torch.profiler)."""
    from aerial_mapper_tpu_torch.ortho.cuda_score import (
        cell_tiles,
        score_pass_cuda,
        tile_camera_mask_plain,
    )

    def call():
        return score_pass_cuda(cells, bank, cam, grid_shape=grid_shape)

    n0 = score_pass_cuda.launches
    sk = call()
    check(score_pass_cuda.launches == n0 + 1,
          f"score {tag}: the launch count did not move")
    box = {}
    plain_ms = cuda_ms(lambda: box.update(r=score_plain(cells, bank, cam)),
                       reps=1, warmup=0)
    sp = box["r"]
    err = 0.0
    for name, a, b in zip(("best", "best_q", "u", "v", "n_vis"), sk, sp):
        check(torch.equal(a, b), f"score {tag}: {name} differs from the "
              f"plain version on {(a != b).sum().item()} cells")
        d = (a.double() - b.double()).abs()
        err = max(err, torch.where(a == b, 0.0, d).max().item())
    t_cells, n_cams = cells.shape[0], bank.shape[0]
    mask = tile_camera_mask_plain(cells, bank, cam, grid_shape)
    per_tile = torch.bincount(cell_tiles(t_cells, grid_shape),
                              minlength=mask.shape[0]).to(mask.device)
    kept = float((mask.sum(1).double() * per_tile).sum().item())
    visible = float(sp[4].double().sum().item())
    seen = float((sp[0] < n_cams).double().mean().item())
    bnd, by = bound(t_cells * (12 + 20) + n_cams * 48.0, visible * OPS_SCORE)
    fig = dict(cells=t_cells, cameras=n_cams,
               kept_share=kept / (t_cells * n_cams),
               visible_share=visible / (t_cells * n_cams),
               mean_n_vis=visible / t_cells, seen_share=seen,
               plain_ms=plain_ms, bound_ms=bnd, bound_by=by, max_abs_err=err)
    del sk, sp, mask
    if reps:
        fig["ms"] = cuda_ms(call, reps=reps)
        fig["device_ms"] = device_ms(call, "score_kernel", reps=reps)
    timed = (f"kernel {fig['ms']:.4f} ms (device {fig['device_ms']}), "
             if reps else "")
    print(f"[{tag}] {t_cells} cells x {n_cams} cameras, grid "
          f"{grid_shape}: all 5 outputs bit-equal; cull keeps "
          f"{fig['kept_share']:.4f} of the pairs, {fig['visible_share']:.4f} "
          f"visible (mean n_vis {fig['mean_n_vis']:.3f}, seen {seen:.4f}); "
          f"{timed}plain {plain_ms:.3f} ms (chunks of {SURVEY_PLAIN_CHUNK} "
          f"cells), bound {bnd:.4f} ms ({by})", flush=True)
    return fig


def _fits(float_entry, block):
    """Whether a float BM kernel takes ``block`` at NUM_DISP disparities."""
    try:
        float_entry(block, NUM_DISP)
    except ValueError:
        return False
    return True


def bm_check(tag, lf, rf, num_disp, min_disp, block, integer_costs):
    """One bm_scan entry against bm_scan_plain on all 5 maps, bit for bit,
    its launch counted; max |err|."""
    from aerial_mapper_tpu_torch.stereo.cuda_bm import (
        bm_scan,
        bm_scan_plain,
        float_entry,
    )

    args = (lf, rf, num_disp, min_disp, block)
    counter = "launches" if integer_costs else "float_launches"
    n0 = getattr(bm_scan, counter)
    k_out = bm_scan(*args, integer_costs=integer_costs)
    check(getattr(bm_scan, counter) == n0 + 1,
          f"bm {tag}: the {counter[:-1]} count did not move")
    p_out = bm_scan_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("best", "bestd", "cm", "cp", "runner"),
                          k_out, p_out):
        check(torch.equal(a, b), f"bm {tag} {name} differs from the "
              f"plain version on {(a != b).sum().item()} pixels")
        err = max(err, (a.double() - b.double()).abs().max().item())
    entry = "" if integer_costs else f" ({float_entry(block, num_disp)})"
    print(f"[{tag}] {tuple(lf.shape)} disparities [{min_disp}, "
          f"{min_disp + num_disp}) block {block}{entry}: bit-equal on all 5 "
          f"maps", flush=True)
    return err


def idw_check(tag, binned, ext, dsm_cfg, adaptive, max_radius_sq):
    """binned_idw_cuda against binned_idw, bit for bit, its launch
    counted; max |err|."""
    from aerial_mapper_tpu_torch.dsm.cuda_idw import binned_idw_cuda
    from aerial_mapper_tpu_torch.dsm.idw import binned_idw

    args = (binned, ext, dsm_cfg.interpolation_radius_sq, adaptive,
            dsm_cfg.adaptive_growth_factor, max_radius_sq)
    n0 = binned_idw_cuda.launches
    vk, hk = binned_idw_cuda(*args)
    check(binned_idw_cuda.launches == n0 + 1,
          f"idw {tag}: the launch count did not move")
    vp, hp = binned_idw(*args)
    torch.cuda.synchronize()
    check(torch.equal(hk, hp), f"idw {tag}: hit differs on "
          f"{(hk != hp).sum().item()} cells")
    check(torch.equal(vk, vp), f"idw {tag}: values differ from the "
          f"plain version on {(vk != vp).sum().item()} cells")
    print(f"[{tag}] K={binned.de.shape[0]} {ext.height}x{ext.width}, "
          f"{int(torch.clamp(binned.count, max=binned.de.shape[0]).sum())} "
          "occupied slots: hit equal, values bit-equal", flush=True)
    return (vk - vp).abs().max().item()


def sgm_check(tag, cost, sgm_cfg):
    """sgm_scan against sgm_scan_plain on ``cost`` [B, H, W, D], all 8
    passes, bit for bit, both restart forms on the diagonal passes (4..7),
    each launch counted; (max |err|, pass/form cases compared)."""
    from aerial_mapper_tpu_torch.stereo.cuda_sgm import (
        NUM_PASSES,
        sgm_scan,
        sgm_scan_plain,
    )

    err, compared = 0.0, 0
    for pass_id in range(NUM_PASSES):
        # the restart forms differ on the diagonals (passes 4..7) only
        for pallas_form in ((True, False) if pass_id >= 4 else (True,)):
            args = (cost, sgm_cfg.p1, sgm_cfg.p2, pass_id, pallas_form)
            n0 = sgm_scan.launches
            a = sgm_scan(*args)
            check(sgm_scan.launches == n0 + 1,
                  f"sgm {tag}: the launch count did not move")
            b = sgm_scan_plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"sgm {tag} pass {pass_id} "
                  f"(pallas_form={pallas_form}) differs from the plain "
                  f"version on {(a != b).sum().item()} values")
            err = max(err, (a - b).abs().max().item())
            compared += 1
            del a, b
    print(f"[{tag}] {tuple(cost.shape)}: all {NUM_PASSES} passes bit-equal "
          f"in {compared} pass/form cases", flush=True)
    return err, compared


def sgm_cost_check(tag, lf, rf, num_disp, min_disp, block, bits=False):
    """sgm_cost_volume against its plain version on the x-Sobel images
    ``lf``, ``rf`` [B, H, W], bit for bit, the launch counted; max |err|.
    With ``bits``, the float32 bit patterns are compared (-0 apart from +0;
    infinities of any sign)."""
    from aerial_mapper_tpu_torch.stereo.matching import (
        sgm_cost_volume,
        sgm_cost_volume_plain,
    )

    n0 = sgm_cost_volume.launches
    a = sgm_cost_volume(lf, rf, num_disp, min_disp, block)
    check(sgm_cost_volume.launches == n0 + 1,
          f"sgm_cost_volume {tag}: the launch count did not move")
    b = sgm_cost_volume_plain(lf, rf, num_disp, min_disp, block)
    torch.cuda.synchronize()
    same = (torch.equal(a.view(torch.int32), b.view(torch.int32)) if bits
            else torch.equal(a, b))
    check(same, f"sgm_cost_volume {tag} (block {block}, "
          f"min_disp {min_disp}) differs from the plain version on "
          f"{(a.view(torch.int32) != b.view(torch.int32)).sum().item()} "
          f"values")
    err = 0.0 if bits else (a - b).abs().max().item()
    print(f"[{tag}] {tuple(a.shape)} block {block} min_disp {min_disp}: "
          f"bit-equal", flush=True)
    return err


def sgm_select_check(tag, agg, min_disp, ratios, max_diffs):
    """SGM's post-filter kernels against their plain versions on the
    aggregated volume ``agg`` [B, H, W, D], bit for bit, each launch
    counted: WTA, uniqueness at each of ``ratios``, the LR check at each of
    ``max_diffs``; (max |err| by kernel, cases compared)."""
    from aerial_mapper_tpu_torch.stereo.matching import (
        sgm_lr_check,
        sgm_lr_check_plain,
        sgm_uniqueness,
        sgm_uniqueness_plain,
        sgm_wta,
        sgm_wta_plain,
    )

    def counted(fn, *args):
        n0 = fn.launches
        out = fn(*args)
        check(fn.launches == n0 + 1,
              f"{fn.__name__} {tag}: the launch count did not move")
        return out

    got = counted(sgm_wta, agg, min_disp)
    want = sgm_wta_plain(agg, min_disp)
    torch.cuda.synchronize()
    for name, a, b in zip(("disp", "c0", "best"), got, want):
        check(torch.equal(a, b), f"sgm_wta {tag}: {name} differs from the "
              f"plain version on {(a != b).sum().item()} pixels")
    errs = {"sgm_wta": max((got[0] - want[0]).abs().max().item(),
                           (got[1] - want[1]).abs().max().item())}
    _disp, c0, best = want
    cases = 1
    for ratio in ratios:
        a = counted(sgm_uniqueness, agg, best, c0, ratio)
        b = sgm_uniqueness_plain(agg, best, c0, ratio)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"sgm_uniqueness {tag} ratio {ratio} "
              f"differs on {(a != b).sum().item()} pixels")
        cases += 1
    for max_diff in max_diffs:
        a = counted(sgm_lr_check, agg, best, min_disp, max_diff)
        b = sgm_lr_check_plain(agg, best, min_disp, max_diff)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"sgm_lr_check {tag} max_diff {max_diff} "
              f"differs on {(a != b).sum().item()} pixels "
              f"({a.float().mean().item():.4f} against "
              f"{b.float().mean().item():.4f} passing)")
        cases += 1
    errs["sgm_uniqueness"] = errs["sgm_lr_check"] = 0.0
    print(f"[{tag}] {tuple(agg.shape)} min_disp {min_disp}: WTA, "
          f"uniqueness at {ratios} and the LR check at max_diff {max_diffs} "
          f"bit-equal ({cases} cases)", flush=True)
    return errs, cases


def crafted_sgm_volume(shape, min_disp, dev, seed):
    """A [B, H, W, D] volume of integer costs 0..12 (ties everywhere) with
    1e9 on a whole image column, a whole row of the first pair, d = 0 of
    the last pair and the right-view column x = 9 (cost[v, 9 + min_disp +
    d, d] for every d): the sentinel ties the LR check's minima with its
    padding."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    vol = torch.randint(0, 13, shape, generator=gen, device=dev).float()
    _b, _h, w, d = shape
    vol[:, :, 5, :] = 1e9
    vol[0, 3] = 1e9
    vol[-1, ..., 0] = 1e9
    for dd in range(d):
        if 9 + min_disp + dd < w:
            vol[:, :, 9 + min_disp + dd, dd] = 1e9
    return vol


# SGM cost edge shapes (pairs, H, W, D, min_disp, block): one strip with
# odd D (segments neither aligned nor a multiple of 4 floats), ragged last
# strips, more rows than a block walks, D cut into chunks (K = 15 and
# D > 92, K = 4 or 7 and D > 256), the step's D and window on ragged strips,
# small D at even windows
SGM_COST_EDGES = ((2, 11, 37, 7, 0, 1), (1, 9, 70, 13, 3, 2),
                  (2, 13, 150, 40, 0, 9), (1, 200, 10, 5, 3, 9),
                  (1, 7, 41, 80, 3, 9), (1, 6, 9, 120, 0, 15),
                  (1, 17, 23, 33, 3, 15), (1, 5, 80, 16, 0, 15),
                  (3, 200, 301, 257, 1, 9), (2, 97, 755, 80, 1, 9),
                  (1, 31, 64, 3, 0, 6), (1, 31, 64, 12, 0, 10),
                  (1, 31, 64, 12, 2, 14), (2, 40, 100, 256, 2, 4),
                  (1, 20, 90, 300, 1, 7), (1, 15, 50, 1, 0, 5),
                  (1, 200, 33, 81, 1, 11), (1, 12, 130, 64, 5, 13),
                  (1, 9, 17, 17, 0, 3), (1, 9, 17, 17, 0, 8))


def sgm_edge_phase(dev):
    """Phase 3e's edges: the cost kernel bit-equal to its plain version on
    every shape of ``SGM_COST_EDGES`` (x-Sobel images of noise) and, at
    windows 2, 6, 9, 10 and 15, on images outside the range where its
    division needs no test (subnormal and tiny, near 2^118, signed with -0);
    ``tools/sgm_div_check.py`` (its division against ``__fdiv_rn`` on all
    2^32 inputs); the LR kernel bit-equal on crafted volumes of odd and
    small D and on a volume that is not 16-byte aligned. Returns the cases
    compared."""
    from aerial_mapper_tpu_torch.stereo.matching import _xsobel_prefilter

    gen = torch.Generator(device=dev).manual_seed(26)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    cases = 0
    for b, h, w, d, md, k in SGM_COST_EDGES:
        left = rand(b, h, w) * 255
        right = torch.roll(left, -5, dims=-1) + rand(b, h, w) * 4
        sgm_cost_check(f"3e sgm_cost_volume edge {(b, h, w, d)}",
                       _xsobel_prefilter(left, 35.0),
                       _xsobel_prefilter(right, 35.0), d, md, k)
        cases += 1
    for kind in ("tiny", "huge", "signed"):
        for k in (2, 6, 9, 10, 15):
            a, b = rand(2, 23, 67), rand(2, 23, 67)
            if kind == "tiny":
                a = a * 2.0 ** -130
                b = torch.where(b < 0.5, b * 2.0 ** -140, b * 2.0 ** -90)
            elif kind == "huge":
                a, b = a * 2.0 ** 118, b * 2.0 ** 117
            else:
                a = torch.where(a < 0.3, torch.full_like(a, -0.0), a - 0.5)
                b = torch.where(b < 0.3, torch.zeros_like(b), 0.5 - b)
            for d, md in ((16, 0), (13, 2)):
                sgm_cost_check(f"3e sgm_cost_volume {kind} images", a, b, d,
                               md, k, bits=True)
                cases += 1
    div = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "sgm_div_check.py")],
        capture_output=True, text=True, timeout=300)
    check(div.returncode == 0, "sgm_cost's division differs from __fdiv_rn: "
          f"{div.stdout[-2000:]} {div.stderr[-2000:]}")
    print(f"[3e sgm_cost division] div_run and div_k2 equal to __fdiv_rn "
          f"on all 2^32 inputs at K = 2..15", flush=True)
    lr_vols = (((2, 9, 23, 7), 3), ((1, 5, 33, 6), 1), ((2, 13, 40, 20), 0))
    for i, (shape, md) in enumerate(lr_vols):
        vol = crafted_sgm_volume(shape, md, dev, seed=10 + i)
        if i == 2:  # -0 beside +0 in the column minima
            vol = torch.where(vol == 0, torch.full_like(vol, -0.0), vol)
            vol[:, ::2] = torch.where(vol[:, ::2] == 0, 0.0, vol[:, ::2])
        cases += sgm_select_check(f"3e sgm post-filters, edge {shape}", vol,
                                  md, (10,), (0, 1, 2))[1]
    # not 16-byte aligned: the LR kernel's scalar pass
    vol = crafted_sgm_volume((2, 17, 90, 40), 1, dev, seed=20)
    view = torch.empty(vol.numel() + 1, device=dev)[1:].view(vol.shape)
    view.copy_(vol)
    cases += sgm_select_check("3e sgm post-filters, unaligned", view, 1,
                              (10,), (0, 1, 2))[1]
    print(f"[3e sgm edges] cost and LR kernels bit-equal in {cases} edge "
          f"cases", flush=True)
    return cases


def sgm_match_phase(lf, rf, sgm_cfg, dev, smi):
    """Phase 3e: SGM's cost kernel bit-equal to its plain version on the
    x-Sobel images ``lf``, ``rf`` [B, H, W] at ``sgm_cfg``'s block and
    ``min_disparity`` and at ``min_disparity`` 0 with blocks 1 and 15; the
    post-filter kernels bit-equal on the aggregated volume of that cost and
    on crafted volumes; the edges of ``sgm_edge_phase``; each kernel timed
    on the aggregated volume, with its bound and the share of it reached,
    beside ``smi`` (the card's name and power limit). Returns the four
    kernels' entries of the ``kernels`` line."""
    from aerial_mapper_tpu_torch.stereo.matching import (
        aggregate_passes,
        sgm_cost_volume,
        sgm_cost_volume_plain,
        sgm_lr_check,
        sgm_lr_check_plain,
        sgm_uniqueness,
        sgm_uniqueness_plain,
        sgm_wta,
        sgm_wta_plain,
    )

    kernels = []
    nd, md, blk = (sgm_cfg.num_disparities, sgm_cfg.min_disparity,
                   sgm_cfg.block_size)
    cost_err = max(
        sgm_cost_check("3e sgm_cost_volume", lf, rf, nd, md, blk),
        sgm_cost_check("3e sgm_cost_volume", lf, rf, nd, 0, 1),
        sgm_cost_check("3e sgm_cost_volume", lf, rf, nd, 0, 15))
    edge_cases = sgm_edge_phase(dev)
    cost_args = (lf, rf, nd, md, blk)
    cost_ms = cuda_ms(lambda: sgm_cost_volume(*cost_args), reps=10)
    cost_dev_ms = device_ms(lambda: sgm_cost_volume(*cost_args),
                            "sgm_cost_kernel", reps=5)
    cost_plain_ms = cuda_ms(lambda: sgm_cost_volume_plain(*cost_args),
                            reps=2)
    # the step's aggregated volume, as _sgm_disparity reads it
    agg = aggregate_passes(sgm_cost_volume(*cost_args), sgm_cfg.p1,
                           sgm_cfg.p2, sgm_cfg.num_directions, True)
    vb, vh, vw, vd = agg.shape
    pixels, vals = float(vb * vh * vw), float(vb * vh * vw * vd)
    sel_errs, sel_cases = sgm_select_check(
        "3e sgm post-filters, step volume", agg, md,
        (sgm_cfg.uniqueness_ratio, -1), (sgm_cfg.disp_12_max_diff, 1))
    crafted = (((3, 37, 61, nd), md), ((2, 19, 45, 13), 0),
               ((2, 11, 300, 100), 3))
    for i, (shape, m) in enumerate(crafted):
        errs, cases = sgm_select_check(
            f"3e sgm post-filters, crafted {shape}",
            crafted_sgm_volume(shape, m, dev, seed=i), m, (10, 0, -1),
            (0, 1, 2))
        sel_cases += cases
        for name, e in errs.items():
            sel_errs[name] = max(sel_errs[name], e)
    cost_bound, cost_by = bound(
        4.0 * vals + 2 * 4.0 * pixels,
        vals * (OPS_SGM_COST_FIXED + OPS_SGM_COST_PER_K * (blk - 1)))
    kernels.append(dict(
        name="sgm_cost_volume", route="cuda",
        source="aerial_mapper_tpu_torch/csrc/sgm_cost.cu",
        replaces="none: XLA ops, aerial_mapper_tpu/stereo/matching.py:156 "
                 "(_bt_cost, _box_filter, _border_mask)",
        max_abs_err=cost_err, ms=cost_ms, device_ms=cost_dev_ms,
        plain_ms=cost_plain_ms, bound_ms=cost_bound, bound_by=cost_by,
        library_ms=None,
    ))
    print(f"[3e sgm_cost_volume] {vb}x{vh}x{vw} D={vd} block {blk}: kernel "
          f"{cost_ms:.3f} ms (device {cost_dev_ms}), plain "
          f"{cost_plain_ms:.3f} ms, bound {cost_bound:.3f} ms ({cost_by}), "
          f"share {share(cost_bound, cost_ms):.3f}; "
          f"{edge_cases} edge cases bit-equal; {smi}", flush=True)
    _d, c0, best = sgm_wta(agg, md)
    # the entries of the volume the LR kernel reads: cost[v, x + md + d, d]
    # for x >= 0, i.e. the columns w >= md + d of each plane d
    lr_vals = float(vb * vh * sum(max(vw - md - d, 0) for d in range(vd)))
    # wrapper, plain version, arguments, kernel, its XLA twin (line of
    # aerial_mapper_tpu/stereo/matching.py), bytes, operations
    posts = (
        (sgm_wta, sgm_wta_plain, (agg, md), "sgm_wta_kernel",
         "201 (_wta_subpixel)", 4.0 * vals + 16.0 * pixels,
         vals * OPS_SGM_WTA),
        (sgm_uniqueness, sgm_uniqueness_plain,
         (agg, best, c0, sgm_cfg.uniqueness_ratio), "sgm_uniqueness_kernel",
         "253 (_uniqueness_mask)", 4.0 * vals + 13.0 * pixels,
         vals * OPS_SGM_UNIQUENESS),
        (sgm_lr_check, sgm_lr_check_plain,
         (agg, best, md, sgm_cfg.disp_12_max_diff), "sgm_lr_kernel",
         "282 (_lr_consistency_mask)", 4.0 * lr_vals + 9.0 * pixels,
         lr_vals * OPS_SGM_LR),
    )
    for fn, plain, args, kernel, twin, nbytes, ops in posts:
        k_ms = cuda_ms(lambda: fn(*args), reps=10)
        k_dev = device_ms(lambda: fn(*args), kernel, reps=5)
        p_ms = cuda_ms(lambda: plain(*args), reps=2)
        b_ms, b_by = bound(nbytes, ops)
        kernels.append(dict(
            name=fn.__name__, route="cuda",
            source="aerial_mapper_tpu_torch/csrc/sgm_select.cu",
            replaces="none: XLA ops, aerial_mapper_tpu/stereo/matching.py:"
                     + twin,
            max_abs_err=sel_errs[fn.__name__], ms=k_ms, device_ms=k_dev,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
        print(f"[3e {fn.__name__}] {vb}x{vh}x{vw} D={vd}: kernel "
              f"{k_ms:.3f} ms (device {k_dev}), plain {p_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}), share "
              f"{share(b_ms, k_ms):.3f}; bit-equal in {sel_cases} "
              f"cases over {1 + len(crafted)} volumes; {smi}", flush=True)
    return kernels


def map_bars(tag, out, truth_h, truth_t, missed=None):
    """The DSM and ortho bars on a final map (coverage > 0.5 of both,
    median |elevation - height| < 0.5 m, median |ortho - texture| < 5
    gray), every layer MAP_CELLS square; returns the four figures. With a
    ``missed`` list, a missed bar is appended to it instead of raised."""
    for name, t in out.items():
        check(t.shape == (MAP_CELLS, MAP_CELLS), f"{tag}: layer {name} shape")
    return {**dsm_bars(tag, out["elevation"], truth_h, missed),
            **ortho_bars(tag, out["ortho"],
                         torch.isfinite(out["observation_index"]), truth_t,
                         missed)}


def bar(cond, msg: str, missed=None) -> None:
    """``check``, or with a ``missed`` list, record a miss and go on."""
    if missed is None:
        check(cond, msg)
    elif not cond:
        missed.append(msg)
        print(f"bar missed: {msg}", flush=True)


def dsm_bars(tag, elevation, truth_h, missed=None):
    """Coverage > 0.5 and median |elevation - height| < 0.5 m."""
    hit = torch.isfinite(elevation)
    coverage = hit.float().mean().item()
    bar(coverage > 0.5, f"{tag}: DSM coverage {coverage}", missed)
    dsm_med = (elevation[hit] - truth_h[hit]).abs().median().item()
    bar(dsm_med < 0.5, f"{tag}: median |elevation - height| {dsm_med} m",
        missed)
    return dict(dsm_coverage=coverage, dsm_median_abs_err_m=dsm_med)


def ortho_bars(tag, ortho, textured, truth_t, missed=None):
    """Over the ``textured`` cells: coverage > 0.5 and median |ortho -
    texture| < 5 gray."""
    ortho_cov = textured.float().mean().item()
    bar(ortho_cov > 0.5, f"{tag}: ortho coverage {ortho_cov}", missed)
    ortho_med = (ortho[textured] - truth_t[textured]).abs().median().item()
    bar(ortho_med < 5.0, f"{tag}: median |ortho - texture| {ortho_med}",
        missed)
    return dict(ortho_coverage=ortho_cov, ortho_median_abs_err_gray=ortho_med)


def packed_bits(layer):
    """A packed-RGB layer's bits as int32. Its values are float32
    denormals and tiny normals: a float comparison (``allclose``,
    ``assert_close``) passes on them whatever the colors, and float
    arithmetic rounds or flushes them."""
    return layer.contiguous().view(torch.int32)


def packed_equal(a, b) -> bool:
    """Two packed-RGB layers hold the same bits on every cell."""
    return torch.equal(packed_bits(a), packed_bits(b))


def luma_mismatch(colored_ortho, gray_ortho, textured):
    """Phase 16's luma check: (cells of ``textured`` where the BT.601 gray
    of the colored ortho's unpacked 8-bit RGB differs from the gray run's
    ortho, textured cells). A frame's gray twin is ``rgb_to_gray`` of its
    integer RGB, so on a sound pair of maps the count is 0."""
    from aerial_mapper_tpu_torch.image.color import (
        rgb_to_gray,
        unpack_float_to_rgb,
    )

    rgb = torch.round(unpack_float_to_rgb(colored_ortho[textured]) * 255.0)
    differs = rgb_to_gray(rgb) != gray_ortho[textured]
    return int(differs.sum().item()), int(textured.sum().item())


def drop_blue(packed):
    """Phase 16's first control: every packed color with blue set to 0."""
    return (packed_bits(packed) & ~0xFF).view(torch.float32)


def halve_and_double(packed):
    """Phase 16's second control: the packed layer through float
    arithmetic, x * 0.5 * 2.0. Halving a denormal rounds its last bit
    away (a card that flushes denormals zeroes it), so about half of the
    colors come back with another blue."""
    return packed * 0.5 * 2.0


PACKED_CONTROLS = {"drop_blue": drop_blue,
                   "halve_and_double": halve_and_double}


def profile_top(fn):
    """Run ``fn`` under torch.profiler: (device ms, [(ms, name, count)]
    sorted by time over the kernels and copies on the card, the same over
    the host's operators and runtime calls by their self CPU time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    top, host = bench_torch.profiled_ops(prof)
    return sum(t for t, _k, _c in top), top, host


class _LogCapture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def run_logged(fn):
    """``fn()`` with the port's INFO log records captured: (result,
    records)."""
    lg = logging.getLogger("aerial_mapper_tpu_torch")
    cap, old = _LogCapture(), lg.level
    lg.addHandler(cap)
    lg.setLevel(logging.INFO)
    try:
        return fn(), cap.records
    finally:
        lg.removeHandler(cap)
        lg.setLevel(old)


def incremental_phase(w, bm_cfg, dsm_cfg, ortho_cfg, counters, truth_h,
                      truth_t, dev):
    """Phase 6: ``run_incremental`` over the bench stream (249 frames of
    752x480, an update every 7th frame: 35 updates, 34 of them stereo) on
    the 400x400 map at 0.5 m. 6a: a warm-up on a 15-frame prefix, 3 timed
    streaming runs and one prestaged run, each with every launch counter set
    to 0 just before and read just after (34 BM, 34 IDW, 35 score, no SGM
    and no float BM per run), the map held to phase 4's bars, the per-update
    stage times of the port's StageTimer, one profiled run of each mode and
    the peak memory. 6b: frames [0, 126), then the full stream resumed at
    frame 126 from those layers, bit-equal to the uninterrupted run. 6c: the
    slab-bounded search under a declared envelope around the scene's
    heights, counted and held to the same bars. 6d: each kernel against its
    plain version, bit for bit, on the operands of the head run's last two
    updates. Returns (e2e_incremental, launches per run, max |err| of 6d by
    kernel, the streaming map that phase 12 is held to)."""
    from aerial_mapper_tpu_torch.config import PipelineConfig, StereoConfig
    from aerial_mapper_tpu_torch.dsm.idw import bin_with_halo
    from aerial_mapper_tpu_torch.io.poses import _rot_matrix_np
    from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry
    from aerial_mapper_tpu_torch.ortho.backward_grid import score_operands
    from aerial_mapper_tpu_torch.pipeline.incremental import (
        _maybe_bound_disparity_incremental,
        _stereo_image_from,
        _to_device,
        run_incremental,
    )
    from aerial_mapper_tpu_torch.stereo.batched import (
        prepare_pair_operands,
        process_pairs_batched,
    )
    from aerial_mapper_tpu_torch.stereo.cuda_bm import bm_scan, prefilter_pair
    from aerial_mapper_tpu_torch.stereo.rectify import _rectify_image
    from aerial_mapper_tpu_torch.utils.timing import STAGE_LOG

    cam = w["cam"]
    host_images = w["images"].cpu().numpy()  # the 8-bit frames as float32

    def dataset(n=NUM_IMAGES):
        return bench_dataset(cam, host_images, n)

    full = dataset()
    cfg = stream_config(bm_cfg, dsm_cfg, ortho_cfg)
    n_updates = len(range(USE_EVERY_NTH - 1, NUM_IMAGES, USE_EVERY_NTH))
    want = dict(bm_scan=n_updates - 1, binned_idw_cuda=n_updates - 1,
                score_pass_cuda=n_updates, sgm_scan=0, bm_scan_float=0)

    def counted(tag, fn):
        """fn() with every counter set to 0 just before and read just
        after; the counts must be the path's."""
        for f in counters:
            f.launches = 0
        bm_scan.float_launches = 0
        out = fn()
        launches = {f.__name__: f.launches for f in counters}
        launches["bm_scan_float"] = bm_scan.float_launches
        check(launches == want, f"{tag}: launches {launches}, want {want}")
        return out, launches

    def run(ds=full, run_cfg=cfg, **kw):
        return run_incremental(ds, run_cfg, update_every_nth=USE_EVERY_NTH,
                               device=dev, **kw)[0]

    def timed(tag, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (out, records), launches = counted(tag, lambda: run_logged(
            lambda: run(**kw)))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, records, launches

    # ---- 6a. streaming and prestaged runs ----
    t0 = time.perf_counter()
    run(dataset(15))
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    stream_s, stage = [], {}
    for k in range(3):
        out, dt, records, launches = timed(f"6a streaming run {k}")
        stream_s.append(dt)
        if k == 0:
            first, bars = out, map_bars("6a streaming", out, truth_h, truth_t)
            for r in records:  # the StageTimer's resolved stages
                if r.msg == STAGE_LOG:
                    stage.setdefault(r.args[0], []).append(r.args[1] * 1e3)
        else:
            check(bit_equal_maps(out, first),
                  f"6a: streaming run {k} differs from run 0")
    peak_gib = {"streaming": torch.cuda.max_memory_allocated() / 2 ** 30}
    torch.cuda.reset_peak_memory_stats()
    pre, pre_s, _r, _l = timed("6a prestaged", prestage_images=True)
    peak_gib["prestaged"] = torch.cuda.max_memory_allocated() / 2 ** 30
    map_bars("6a prestaged", pre, truth_h, truth_t)
    check(bit_equal_maps(pre, first), "6a: prestaged differs from streaming")
    check(len(stage.get("incremental_dsm", ())) == n_updates - 1
          and len(stage.get("incremental_ortho", ())) == n_updates,
          f"6a: stage samples {[(k, len(v)) for k, v in stage.items()]}")
    stage_ms = {name: dict(per_update_median_ms=float(np.median(v)),
                           per_update_mean_ms=float(np.mean(v)),
                           min_ms=float(np.min(v)), max_ms=float(np.max(v)),
                           updates=len(v))
                for name, v in stage.items()}
    stream_med = float(np.median(stream_s))
    prof = {}
    for mode, kw, wall in (("streaming", {}, stream_med),
                           ("prestaged", dict(prestage_images=True), pre_s)):
        dev_ms, top, host = profile_top(lambda: run(**kw))
        # kernel and copy time of the profiled run over the unprofiled
        # run's wall time (one stream: nothing overlaps); the host's
        # operators and runtime calls by self CPU time, as the profiler
        # (which slows them) saw them
        prof[mode] = dict(device_ms=dev_ms if top else None,
                          device_busy_share=(dev_ms / (wall * 1e3)
                                             if top else None),
                          kernels=sum(c for _t, _k, c in top),
                          top=[dict(ms=t, name=k[:80], count=c)
                               for t, k, c in top[:10]],
                          host_ms=sum(t for t, _k, _c in host),
                          host_top=[dict(ms=t, name=k[:80], count=c)
                                    for t, k, c in host[:10]])
    print(f"[6a incremental] {n_updates} updates ({n_updates - 1} stereo) "
          f"over {NUM_IMAGES} frames: streaming median {stream_med:.4f} s "
          f"(min {min(stream_s):.4f}, max {max(stream_s):.4f}; warm-up "
          f"{warmup_s:.3f} s on 15 frames), prestaged {pre_s:.4f} s; per "
          f"update (StageTimer, CUDA events) "
          + ", ".join(f"{k} median {v['per_update_median_ms']:.3f} ms"
                      for k, v in sorted(stage_ms.items()))
          + f"; DSM coverage {bars['dsm_coverage']:.4f}, median |err| "
          f"{bars['dsm_median_abs_err_m']:.4f} m; ortho coverage "
          f"{bars['ortho_coverage']:.4f}, median |err| "
          f"{bars['ortho_median_abs_err_gray']:.3f} gray; peak "
          f"{peak_gib['streaming']:.3f} GiB streaming, "
          f"{peak_gib['prestaged']:.3f} GiB prestaged ({base_gib:.3f} GiB "
          f"held before); launches "
          f"per run {launches}; streaming and prestaged maps bit-equal",
          flush=True)
    for mode, p in prof.items():
        if p["device_ms"] is None:
            print(f"[6a profile {mode}] torch.profiler recorded no device "
                  "time: busy share not measured")
            continue
        print(f"[6a profile {mode}] {p['kernels']} kernels and copies, "
              f"{p['device_ms']:.2f} ms of the {mode} run (busy share "
              f"{p['device_busy_share']:.3f}):")
        for t in p["top"]:
            print(f"    {t['ms']:9.3f} ms  x{t['count']:<5d} {t['name']}")
        print(f"[6a profile {mode}] host: {p['host_ms']:.2f} ms of self CPU "
              "time in operators and runtime calls (profiled):")
        for t in p["host_top"]:
            print(f"    {t['ms']:9.3f} ms  x{t['count']:<5d} {t['name']}")

    # ---- 6b. resume at an update boundary: bit-equal ----
    resume_at = USE_EVERY_NTH * ((n_updates + 1) // 2)  # frame 126
    # the head run's last two updates (frames 118 and 125), for 6d: the
    # map each left, by its frame
    held = {}

    def keep(i, layers, _geom):
        if i == resume_at - 1 - USE_EVERY_NTH:
            held[i] = {k: v.clone() for k, v in layers.items()}

    def head_then_tail():
        head = held[resume_at - 1] = run(dataset(resume_at), on_update=keep)
        return run(initial_layers=head, start_frame=resume_at)

    tail, _ = counted("6b resume", head_then_tail)
    check(bit_equal_maps(tail, first),
          "6b: the resumed map differs from the uninterrupted run")
    del tail
    print(f"[6b resume] frames [0, {resume_at}) then resumed at frame "
          f"{resume_at}: every layer bit-equal to the uninterrupted run",
          flush=True)

    # ---- 6c. slab-bounded search under a declared envelope ----
    z_lo = float(np.floor(truth_h.min().item() - 4.0))
    z_hi = float(np.ceil(truth_h.max().item() + 4.0))
    slab_cfg = PipelineConfig(
        grid=cfg.grid, bm=bm_cfg, dsm=dsm_cfg, ortho_backward=ortho_cfg,
        stereo=StereoConfig(use_every_nth_image=1, disparity_from_slab=True,
                            z_min=z_lo, z_max=z_hi))
    # the window the driver derives from the envelope, by its own helper
    bounded = _maybe_bound_disparity_incremental(slab_cfg, [full],
                                                 USE_EVERY_NTH).bm
    lo, hi = bounded.min_disparity, bounded.min_disparity + \
        bounded.num_disparities
    check(lo > 0 and hi - lo != NUM_DISP,
          f"6c: window [{lo}, {hi}) does not exercise min_disparity > 0 "
          "with another count")
    slab, slab_s, _r, _l = timed("6c slab", run_cfg=slab_cfg)
    slab_bars = map_bars("6c slab", slab, truth_h, truth_t)
    print(f"[6c slab] envelope [{z_lo}, {z_hi}] m -> disparities [{lo}, "
          f"{hi}) ({hi - lo} vs {NUM_DISP} full): run {slab_s:.4f} s; DSM "
          f"coverage {slab_bars['dsm_coverage']:.4f}, median |err| "
          f"{slab_bars['dsm_median_abs_err_m']:.4f} m; ortho coverage "
          f"{slab_bars['ortho_coverage']:.4f}, median |err| "
          f"{slab_bars['ortho_median_abs_err_gray']:.3f} gray", flush=True)
    del slab

    # ---- 6d. each kernel on one update's operands: bit-equal ----
    # two updates of the 6b head run: frame 118 against 111 (a pair along
    # the first flight line) and 125 against 118 (the pair across the turn
    # to the second line, few valid points). For each, BM on its pair at
    # 6a's window and at 6c's, IDW on its cloud, and the score pass on its
    # 7 cameras over the map that update's DSM step left.
    geom = MapGeometry.from_config(cfg.grid)
    quats_c, trans_c = full.camera_poses()
    Rs_c = np.stack([_rot_matrix_np(q) for q in quats_c])
    windows = ((bm_cfg.min_disparity, bm_cfg.num_disparities),
               (lo, hi - lo))
    errs = dict(bm_scan=0.0, binned_idw_cuda=0.0, score_pass_cuda=0.0)
    kernel_checks = []
    for i_u in sorted(held):
        prev_u = i_u - USE_EVERY_NTH
        tag = f"6d update {i_u} (pair {prev_u}, {i_u})"
        u_ops = prepare_pair_operands(
            cam.K, Rs_c[[prev_u, i_u]], trans_c[[prev_u, i_u]],
            [_stereo_image_from(_to_device(host_images[k], dev), full, cfg)
             for k in (prev_u, i_u)], device=dev)
        lf, rf = prefilter_pair(_rectify_image(u_ops.image1, u_ops.T1_inv),
                                _rectify_image(u_ops.image2, u_ops.T2_inv),
                                bm_cfg)
        for d_lo, d_num in windows:
            errs["bm_scan"] = max(errs["bm_scan"], bm_check(
                f"{tag} bm_scan", lf, rf, d_num, d_lo, bm_cfg.block_size,
                True))
        pts, _i, valid = process_pairs_batched(u_ops, cam, bm_cfg,
                                               device=dev, batch_chunk=1)
        p = pts.reshape(-1, 3)
        binned, ext, _halo = bin_with_halo(
            p[:, :2], p[:, 2], valid.reshape(-1), geom, dsm_cfg.bin_capacity,
            dsm_cfg.max_radius_sq if dsm_cfg.adaptive_interpolation
            else dsm_cfg.interpolation_radius_sq)
        errs["binned_idw_cuda"] = max(errs["binned_idw_cuda"], idw_check(
            f"{tag} binned_idw", binned, ext, dsm_cfg,
            dsm_cfg.adaptive_interpolation, dsm_cfg.max_radius_sq))
        sub = slice(prev_u + 1, i_u + 1)
        cells, bank = score_operands(
            held[i_u], _to_device(quats_c[sub], dev),
            _to_device(trans_c[sub], dev), geom, ortho_cfg)
        su = score_check(f"{tag} score_pass", cells, bank,
                         (geom.height, geom.width), cam)
        errs["score_pass_cuda"] = max(errs["score_pass_cuda"],
                                      su["max_abs_err"])
        kernel_checks.append(dict(
            update_frame=i_u, pair=[prev_u, i_u],
            bm_windows=[[d_lo, d_lo + d_num] for d_lo, d_num in windows],
            valid_points=int(valid.sum().item()),
            occupied_slots=int(torch.clamp(
                binned.count, max=dsm_cfg.bin_capacity).sum().item()),
            score={k: su[k] for k in ("cells", "cameras", "kept_share",
                                      "visible_share", "mean_n_vis")},
            bit_equal=True))
        del u_ops, lf, rf, pts, valid, p, binned, cells, bank
    del held
    check(len(kernel_checks) == 2, "6d: the head run did not keep both "
          "updates' maps")
    e2e = dict(
        updates=n_updates, stereo_updates=n_updates - 1,
        streaming_s=stream_s, streaming_median_s=stream_med,
        streaming_min_s=min(stream_s), streaming_max_s=max(stream_s),
        prestaged_s=pre_s, warmup_s=warmup_s, stage_ms=stage_ms,
        profile=prof, peak_mem_gib=peak_gib, held_before_gib=base_gib,
        launches=launches, resume_bit_equal=True,
        slab=dict(z_min=z_lo, z_max=z_hi, min_disparity=lo,
                  num_disparities=hi - lo, run_s=slab_s, **slab_bars),
        kernel_checks=kernel_checks, **bars,
    )
    return e2e, launches, errs, first


class DriverRuns:
    """Counted and timed runs of the port's drivers (phases 7 and 8): every
    launch counter is set to 0 just before each run and read just after,
    and must show the path's counts; ``launches`` keeps them by tag.
    ``expect`` is the counts, or a function that gives them after the run.
    ``sync`` waits for the work a timed run started (by default the
    current card's); with ``counting`` off (the plain versions on the CPU
    count nothing) ``want`` expects no launch."""

    def __init__(self, counters, sync=None, counting=True):
        self.counters, self.counting = counters, counting
        self.sync = sync or (lambda: torch.cuda.synchronize())
        self.launches = {}
        self.none = dict.fromkeys(
            [f.__name__ for f in counters] + ["bm_scan_float"], 0)

    def want(self, **n):
        return {**self.none, **n} if self.counting else dict(self.none)

    def counted(self, tag, fn, expect):
        from aerial_mapper_tpu_torch.stereo.cuda_bm import bm_scan

        for f in self.counters:
            f.launches = 0
        bm_scan.float_launches = 0
        out = fn()
        got = {f.__name__: f.launches for f in self.counters}
        got["bm_scan_float"] = bm_scan.float_launches
        if callable(expect):
            expect = expect()
        check(got == expect, f"{tag}: launches {got}, want {expect}")
        self.launches[tag] = got
        return out

    def timed(self, tag, fn, expect):
        self.sync()
        t0 = time.perf_counter()
        out = self.counted(tag, fn, expect)
        self.sync()
        return out, time.perf_counter() - t0

    def run(self, tag, fn, expect):
        """``timed``: (result, record of its seconds and launches)."""
        out, dt = self.timed(tag, fn, expect)
        return out, dict(wall_s=dt, launches=self.launches[tag])

    def drive(self, tag, fn, expect, reps=3, **outputs):
        """One counted run writing ``outputs`` (the warm-up), then ``reps``
        counted runs timed (with reps=0 the first run's time stands);
        (result of the first run, record with the first run's stage
        times). The first run's other log messages go to ``last_log``."""
        from aerial_mapper_tpu_torch.utils.timing import STAGE_LOG

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (first, first_s), records = run_logged(
            lambda: self.timed(tag, lambda: fn(**outputs), expect))
        stages = {r.args[0]: r.args[1] * 1e3 for r in records
                  if r.msg == STAGE_LOG}
        times = [self.timed(tag, fn, expect)[1] for _ in range(reps)]
        rec = dict(median_s=float(np.median(times or [first_s])),
                   runs_s=times, first_s=first_s,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   stage_ms_first_run=stages,
                   launches=self.launches[tag])
        self.last_log = [r.getMessage() for r in records
                         if r.msg != STAGE_LOG]
        return first, rec


def batch_config(w, bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg):
    """The batch drivers' ``PipelineConfig`` of phases 7 and 11c: the
    400x400 map at 0.5 m, every 7th frame paired, the homography on a
    768x384 mosaic with the auto window."""
    from aerial_mapper_tpu_torch.config import (
        GridMapConfig,
        OrthoFromPclConfig,
        OrthoHomographyConfig,
        PipelineConfig,
        StereoConfig,
    )

    extent = MAP_CELLS * RESOLUTION
    # the mosaic of 7d: the scene's flight lines and footprints (easting
    # +-178 m, northing +-80 m) at 0.5 m around its centre
    hcfg = OrthoHomographyConfig(
        ground_plane_elevation_m=w["scene"].base_elevation,
        width_mosaic_pixels=768, height_mosaic_pixels=384,
        resolution=RESOLUTION, origin=(0.0, 0.0, 0.0), auto_window=True)
    return PipelineConfig(
        grid=GridMapConfig(delta_easting=extent, delta_northing=extent,
                           resolution=RESOLUTION),
        stereo=StereoConfig(use_every_nth_image=USE_EVERY_NTH),
        bm=bm_cfg, sgm=sgm_cfg, dsm=dsm_cfg, ortho_backward=ortho_cfg,
        ortho_homography=hcfg, ortho_from_pcl=OrthoFromPclConfig())


def backward_grid_files(directory):
    """7a's output paths of ``run_ortho_backward_grid`` under
    ``directory``: the GeoTiff and the npz layers, and where Pillow is
    installed the JPEG and the HTML report (its PNGs need Pillow)."""
    import importlib.util

    names = dict(output_geotiff="ortho.tif", output_layers_npz="layers.npz")
    if importlib.util.find_spec("PIL") is not None:
        names.update(output_jpg="ortho.jpg", output_report_html="report.html")
    return {k: os.path.join(directory, v) for k, v in names.items()}


def batch_phase(w, bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg, counters, truth_h,
                truth_t, dev):
    """Phase 7: the five batch drivers of ``pipeline/batch.py`` on the
    bench stream (249 frames of 752x480 as an in-memory ``Dataset``, every
    7th frame paired: 34 pairs, one per BM pass) and the 400x400 map at
    0.5 m. Each driver runs once with its outputs written (the warm-up),
    then 3 times timed (host clock ending in a synchronize; the median),
    every run with each launch counter set to 0 just before and read just
    after. 7a ``run_ortho_backward_grid`` (BM) held to phase 4's bars, its
    GeoTiff read back equal to the ortho and its npz layers to the map;
    7b ``run_dsm`` with SGM held to the DSM bars, and the SGM kernel
    bit-equal to its plain version on two of its pairs' costs at its
    one-pair launch shape; 7c ``run_dense_pcl``, its npz cloud loaded back
    equal; 7d ``run_ortho_forward_homography`` on an auto-windowed mosaic
    over the scene, bit-equal to the full-mosaic warp, and both paths timed
    at 1000x1000 and 2000x2000; 7e ``run_ortho_from_pcl`` at the defaults
    and adaptive unbounded, held to the ortho bars, the brute pass timed
    alone, then on a sparse cloud whose cells the brute pass fills, against
    the same call on the CPU. Returns (e2e_batch, launches by driver, max
    |err| of 7b's SGM check by kernel)."""
    import dataclasses
    import importlib.util
    import tempfile

    from aerial_mapper_tpu_torch.config import OrthoFromPclConfig
    from aerial_mapper_tpu_torch.dsm.idw import (
        _circular_offsets,
        _window_halfwidth,
        idw_to_grid,
        idw_unbounded_brute,
        ortho_from_points,
    )
    from aerial_mapper_tpu_torch.io.artifacts import (
        load_layers,
        load_points,
        to_host,
    )
    from aerial_mapper_tpu_torch.io.geotiff import read_geotiff
    from aerial_mapper_tpu_torch.mapgrid.grid import (
        MapGeometry,
        cell_centers,
        create_map_state,
    )
    from aerial_mapper_tpu_torch.io.poses import _rot_matrix_np
    from aerial_mapper_tpu_torch.ortho.homography import auto_window
    from aerial_mapper_tpu_torch.pipeline import batch
    from aerial_mapper_tpu_torch.pipeline.incremental import (
        _stereo_image_from,
        _to_device,
    )
    from aerial_mapper_tpu_torch.stereo.batched import prepare_pair_operands
    from aerial_mapper_tpu_torch.stereo.matching import _sgm_cost
    from aerial_mapper_tpu_torch.stereo.rectify import _rectify_image

    cam, scene = w["cam"], w["scene"]
    ds = bench_dataset(cam, w["images"].cpu().numpy())
    cfg = batch_config(w, bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg)
    hcfg = cfg.ortho_homography
    sgm_run_cfg = dataclasses.replace(
        cfg, stereo=dataclasses.replace(cfg.stereo, matcher="sgm"))
    # the drivers pair frames n-1, 2n-1, ... (the reference's skip
    # counter): 35 frames, 34 pairs
    pairs = len(range(USE_EVERY_NTH - 1, NUM_IMAGES, USE_EVERY_NTH)) - 1
    runs = DriverRuns(counters)
    want, drive = runs.want, runs.drive

    e2e = {}
    have_pil = importlib.util.find_spec("PIL") is not None
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 7a. run_ortho_backward_grid (BM) ----
        files = backward_grid_files(tmp)
        out, rec = drive(
            "run_ortho_backward_grid",
            lambda **o: batch.run_ortho_backward_grid(ds, cfg, device=dev,
                                                      **o)[0],
            want(bm_scan=pairs, binned_idw_cuda=1, score_pass_cuda=1),
            **files)
        rec.update(map_bars("7a", out, truth_h, truth_t))
        arr, _geo, _zone = read_geotiff(files["output_geotiff"])
        check(np.array_equal(arr, np.clip(to_host(out["ortho"]), 0, 255)
                             .astype(np.uint8)),
              "7a: the GeoTiff read back differs from the ortho layer")
        saved, _g = load_layers(files["output_layers_npz"])
        check(bit_equal_maps({k: torch.as_tensor(v, device=dev)
                              for k, v in saved.items()}, out),
              "7a: the npz layers differ from the map")
        rec["files"] = {k: os.path.getsize(v) for k, v in files.items()}
        rec["jpeg_and_report"] = ("written" if have_pil else
                                  "not written: no Pillow on this machine")
        e2e["run_ortho_backward_grid"] = rec
        del out, saved
        print(f"[7a run_ortho_backward_grid] {pairs} pairs: median "
              f"{rec['median_s']:.4f} s of 3 {rec['runs_s']}; "
              f"stages {rec['stage_ms_first_run']}; DSM coverage "
              f"{rec['dsm_coverage']:.4f}, median |err| "
              f"{rec['dsm_median_abs_err_m']:.4f} m; ortho coverage "
              f"{rec['ortho_coverage']:.4f}, median |err| "
              f"{rec['ortho_median_abs_err_gray']:.3f} gray; peak "
              f"{rec['peak_mem_gib']:.3f} GiB; GeoTiff and npz read back "
              f"equal; JPEG and report {rec['jpeg_and_report']}; launches "
              f"{rec['launches']}", flush=True)

        # ---- 7b. run_dsm with SGM ----
        out, rec = drive(
            "run_dsm_sgm",
            lambda **o: batch.run_dsm(ds, sgm_run_cfg, device=dev, **o)[0],
            want(sgm_scan=8 * pairs, binned_idw_cuda=1))
        rec.update(dsm_bars("7b", out["elevation"], truth_h))
        e2e["run_dsm_sgm"] = rec
        del out
        print(f"[7b run_dsm sgm] {pairs} pairs, one per pass: median "
              f"{rec['median_s']:.4f} s of 3; DSM coverage "
              f"{rec['dsm_coverage']:.4f}, median |err| "
              f"{rec['dsm_median_abs_err_m']:.4f} m; peak "
              f"{rec['peak_mem_gib']:.3f} GiB; launches {rec['launches']}",
              flush=True)
        # the SGM kernel at the drivers' launch shape [1, H, W, D], held to
        # its plain version on the BT cost of two of 7b's pairs
        quats_c, trans_c = ds.camera_poses()
        Rs_c = np.stack([_rot_matrix_np(q) for q in quats_c])
        sgm_errs, sgm_pairs = {}, []
        for i_u in SGM_CHECK_FRAMES:
            prev_u = i_u - USE_EVERY_NTH
            u_ops = prepare_pair_operands(
                cam.K, Rs_c[[prev_u, i_u]], trans_c[[prev_u, i_u]],
                [_stereo_image_from(_to_device(ds.images[k], dev), ds, cfg)
                 for k in (prev_u, i_u)], device=dev)
            cost = _sgm_cost(_rectify_image(u_ops.image1, u_ops.T1_inv),
                             _rectify_image(u_ops.image2, u_ops.T2_inv),
                             sgm_cfg)[1]
            err, cases = sgm_check(f"7b sgm_scan pair ({prev_u}, {i_u})",
                                   cost, sgm_cfg)
            sgm_errs["sgm_scan"] = max(sgm_errs.get("sgm_scan", 0.0), err)
            sgm_pairs.append(dict(pair=[prev_u, i_u],
                                  shape=list(cost.shape), cases=cases,
                                  bit_equal=True))
            del u_ops, cost
        rec["sgm_kernel_checks"] = sgm_pairs

        # ---- 7c. run_dense_pcl ----
        npz = os.path.join(tmp, "cloud.npz")
        t0 = time.perf_counter()
        cloud, rec = drive(
            "run_dense_pcl",
            lambda **o: batch.run_dense_pcl(ds, cfg, device=dev, **o),
            want(bm_scan=pairs), output_cloud_npz=npz)
        pts, intens, valid = cloud
        p, i, v = load_points(npz)
        check(np.array_equal(p, to_host(pts))
              and np.array_equal(i, to_host(intens))
              and np.array_equal(v, to_host(valid)),
              "7c: the npz cloud read back differs")
        rec.update(points=int(pts.shape[0]), valid=int(valid.sum()),
                   npz_bytes=os.path.getsize(npz),
                   phase_s=time.perf_counter() - t0)
        e2e["run_dense_pcl"] = rec
        del p, i, v
        print(f"[7c run_dense_pcl] {rec['valid']} valid of {rec['points']} "
              f"points: median {rec['median_s']:.4f} s of 3; npz "
              f"{rec['npz_bytes']} bytes read back equal; peak "
              f"{rec['peak_mem_gib']:.3f} GiB", flush=True)

    # ---- 7d. run_ortho_forward_homography: windowed == full ----
    win = auto_window(hcfg, cam, quats_c, trans_c)
    check(win is not None and win[0] < hcfg.height_mosaic_pixels,
          f"7d: auto_window gave {win}: the windowed path would not run")
    full_cfg = dataclasses.replace(cfg, ortho_homography=dataclasses.replace(
        hcfg, auto_window=False))
    mosaic, rec = drive(
        "run_ortho_forward_homography",
        lambda **o: batch.run_ortho_forward_homography(ds, cfg, device=dev),
        want())
    full, rec_full = drive(
        "run_ortho_forward_homography_full",
        lambda **o: batch.run_ortho_forward_homography(ds, full_cfg,
                                                       device=dev),
        want())
    check(torch.equal(mosaic, full),
          f"7d: the windowed mosaic differs from the full warp on "
          f"{(mosaic != full).sum().item()} pixels")
    observed = mosaic > 0
    coverage = observed.float().mean().item()
    check(coverage > 0.5, f"7d: mosaic coverage {coverage}")
    hm, wm = hcfg.height_mosaic_pixels, hcfg.width_mosaic_pixels
    geom_m = MapGeometry(0.0, 0.0, RESOLUTION, hm, wm)
    tex = scene.texture(*cell_centers(geom_m, device=dev))
    rec.update(window=list(win), mosaic=[hm, wm], coverage=coverage,
               full_median_s=rec_full["median_s"],
               full_runs_s=rec_full["runs_s"],
               full_peak_mem_gib=rec_full["peak_mem_gib"],
               bit_equal_to_full=True,
               # the plane at the base elevation on a relief scene: parallax
               # moves texels, so this is printed and not held to a bar
               median_abs_err_vs_texture_gray=(
                   mosaic[observed] - tex[observed]).abs().median().item())
    e2e["run_ortho_forward_homography"] = rec
    del mosaic, full, tex
    print(f"[7d run_ortho_forward_homography] {hm}x{wm} mosaic at "
          f"{RESOLUTION} m, auto window {win[0]}x{win[1]}: windowed median "
          f"{rec['median_s']:.4f} s, full {rec['full_median_s']:.4f} s; "
          f"bit-equal; coverage {coverage:.4f}; median |mosaic - texture| "
          f"{rec['median_abs_err_vs_texture_gray']:.3f} gray (flat-plane "
          f"parallax, no bar); peak {rec['peak_mem_gib']:.3f} / "
          f"{rec['full_peak_mem_gib']:.3f} GiB", flush=True)
    # the same windowed and full runs at the config's default mosaic
    # (1000x1000) and at a survey-sized one (2000x2000: 1 km at 0.5 m)
    sizes = {}
    for side in (1000, 2000):
        scfg = dataclasses.replace(hcfg, width_mosaic_pixels=side,
                                   height_mosaic_pixels=side)
        s_win = auto_window(scfg, cam, quats_c, trans_c)
        check(s_win is not None, f"7d {side}: auto_window gave None")
        got, fig = {}, dict(window=list(s_win), bit_equal_to_full=True)
        for mode, auto in (("windowed", True), ("full", False)):
            run_cfg = dataclasses.replace(
                cfg, ortho_homography=dataclasses.replace(
                    scfg, auto_window=auto))
            got[mode], r = drive(
                f"run_ortho_forward_homography_{side}_{mode}",
                lambda **o: batch.run_ortho_forward_homography(
                    ds, run_cfg, device=dev), want())
            fig.update({f"{mode}_median_s": r["median_s"],
                        f"{mode}_runs_s": r["runs_s"],
                        f"{mode}_peak_mem_gib": r["peak_mem_gib"]})
        check(torch.equal(got["windowed"], got["full"]),
              f"7d {side}: the windowed mosaic differs from the full warp "
              f"on {(got['windowed'] != got['full']).sum().item()} pixels")
        sizes[f"{side}x{side}"] = fig
        del got
        print(f"[7d {side}x{side}] auto window {s_win[0]}x{s_win[1]}: "
              f"windowed median {fig['windowed_median_s']:.4f} s "
              f"{fig['windowed_runs_s']}, full "
              f"{fig['full_median_s']:.4f} s {fig['full_runs_s']}; "
              f"bit-equal", flush=True)
    rec["sizes"] = sizes

    # ---- 7e. run_ortho_from_pcl ----
    geom = MapGeometry(0.0, 0.0, RESOLUTION, MAP_CELLS, MAP_CELLS)
    unb_cfg = dataclasses.replace(cfg, ortho_from_pcl=OrthoFromPclConfig(
        use_adaptive_interpolation=True))
    opc = unb_cfg.ortho_from_pcl
    cap = max(opc.interpolation_radius_sq * opc.adaptive_growth_factor,
              (12.0 * RESOLUTION) ** 2)  # ortho_from_points' working cap
    n_off = len(_circular_offsets(_window_halfwidth(cap, RESOLUTION),
                                  RESOLUTION, cap))
    check(n_off > 128, f"7e: the working cap's window has {n_off} offsets")
    # unbounded: cells beyond the working cap from every point (the map's
    # strips outside the footprints) go to the brute pass, O(cells x
    # points) over the whole cloud: one timed run
    for tag, run_cfg, reps in (("run_ortho_from_pcl", cfg, 3),
                               ("run_ortho_from_pcl_unbounded", unb_cfg, 0)):
        out, rec = drive(
            tag, lambda **o: batch.run_ortho_from_pcl(ds, run_cfg,
                                                      device=dev)[0],
            want(bm_scan=pairs, binned_idw_cuda=1), reps=reps)
        hit = out["ortho"] != 255.0
        rec.update(ortho_bars(f"7e {tag}", out["ortho"], hit, truth_t))
        e2e[tag] = rec
        print(f"[7e {tag}] median {rec['median_s']:.4f} s of {reps or 1}; "
              f"ortho "
              f"coverage {rec['ortho_coverage']:.4f}, median |err| "
              f"{rec['ortho_median_abs_err_gray']:.3f} gray; peak "
              f"{rec['peak_mem_gib']:.3f} GiB", flush=True)
    # the unbounded run's brute pass: the cells its windowed pass (the
    # working cap, a window of n_off offsets) leaves unhit, on 7c's cloud
    pts, intens, valid = cloud
    _v, near_hit = idw_to_grid(pts[:, :2], intens, valid, geom,
                               opc.bin_capacity,
                               radius_sq=opc.interpolation_radius_sq,
                               adaptive=True,
                               growth=opc.adaptive_growth_factor,
                               max_radius_sq=cap)
    brute_cells = int((~near_hit).sum())
    # the brute pass alone on those cells (CUDA events, one run: seconds)
    brute_bench_ms = cuda_ms(lambda: idw_unbounded_brute(
        pts[:, :2], intens, valid, geom,
        radius_sq=opc.interpolation_radius_sq,
        growth=opc.adaptive_growth_factor, cells=~near_hit),
        reps=1, warmup=0)
    e2e["run_ortho_from_pcl_unbounded"].update(
        window_offsets=n_off, brute_cells=brute_cells,
        brute_ms=brute_bench_ms)
    # a sparse cloud (every 40,000th valid point) leaves most cells to the
    # brute pass: the driver on the card against the same call on the CPU
    keep = torch.nonzero(valid).reshape(-1)[::40000]
    sparse = (to_host(pts[keep]).astype(np.float64),
              to_host(intens[keep]).astype(np.float64))
    out, rec = drive(
        "run_ortho_from_pcl_sparse",
        lambda **o: batch.run_ortho_from_pcl(None, unb_cfg,
                                             point_cloud=sparse,
                                             device=dev)[0],
        want(binned_idw_cuda=1))
    ref = ortho_from_points(
        create_map_state(geom, device="cpu"),
        torch.as_tensor(sparse[0], dtype=torch.float32),
        torch.as_tensor(sparse[1], dtype=torch.float32),
        torch.ones(len(keep), dtype=torch.bool), geom, opc)["ortho"]
    got = out["ortho"].cpu()
    check(bool((got != 255.0).all()), "7e sparse: unhit cells remain")
    err = ((got - ref).abs() / ref.abs().clamp(min=1e-6)).max().item()
    check(torch.equal(got != 255.0, ref != 255.0) and err < 1e-5,
          f"7e sparse: the card's ortho differs from the CPU's (max rel "
          f"err {err})")
    sp_pts = torch.as_tensor(sparse[0], dtype=torch.float32, device=dev)
    sp_in = torch.as_tensor(sparse[1], dtype=torch.float32, device=dev)
    sp_valid = torch.ones(len(keep), dtype=torch.bool, device=dev)
    _v, sp_hit = idw_to_grid(sp_pts[:, :2], sp_in, sp_valid, geom,
                             opc.bin_capacity,
                             radius_sq=opc.interpolation_radius_sq,
                             adaptive=True,
                             growth=opc.adaptive_growth_factor,
                             max_radius_sq=cap)
    sp_cells = int((~sp_hit).sum())
    brute_ms = cuda_ms(lambda: idw_unbounded_brute(
        sp_pts[:, :2], sp_in, sp_valid, geom,
        radius_sq=opc.interpolation_radius_sq,
        growth=opc.adaptive_growth_factor, cells=~sp_hit), reps=3)
    rec.update(points=len(keep), brute_cells=sp_cells, brute_ms=brute_ms,
               max_rel_err_vs_cpu=err)
    e2e["run_ortho_from_pcl_sparse"] = rec
    print(f"[7e unbounded] the working cap's window has {n_off} offsets "
          f"(the IDW kernel's second instantiation); {brute_cells} of "
          f"{MAP_CELLS ** 2} cells reach the brute pass on the bench cloud "
          f"({brute_bench_ms:.1f} ms); "
          f"sparse cloud of {len(keep)} points: {sp_cells} cells to the "
          f"brute pass ({brute_ms:.3f} ms), every cell hit, median "
          f"{rec['median_s']:.4f} s, max rel err vs the CPU {err:.2e}",
          flush=True)
    del cloud, pts, intens, valid, out
    return e2e, runs.launches, sgm_errs


def slice7_phase(w, bm_cfg, dsm_cfg, ortho_cfg, counters, truth_h, truth_t,
                 dev):
    """Phase 8: the plane-sweep densifier and the distorted-camera path at
    full width. Every run goes through ``DriverRuns`` (each launch counter
    set to 0 just before and read just after); each driver runs once, then
    3 times timed (median; host clock ending in a synchronize).

    8a: ``run_ortho_backward_grid`` with ``densifier="plane_sweep"`` on the
    pinhole bench stream, every 7th frame a reference view (35), 2
    neighbours 7 frames away, 48 planes, both z bounds unset (the BM
    prepass: 3 BM launches), then 1 IDW and 1 score launch; phase 4's bars,
    the auto range and the boundary pile-up fractions, the stage times, the
    peak memory and one profiled run (kernel launches per reference view).
    8b: the same 249 poses rendered through a radial-tangential lens; the
    general score pass on 8a's map and one frame's undistortion are first
    timed alone (CUDA events). (i)
    ``run_ortho_backward_grid`` (BM) with ``images_need_undistortion`` and
    ``score_kernel="xla"``: 34 BM, 1 IDW and no score launch (the lens
    takes the general path); the same call with ``"pallas"`` raises
    ``ValueError``. (ii) ``run_incremental`` streaming with undistortion:
    34 BM, 34 IDW, no score launch, every run bit-equal. (iii)
    ``run_ortho_forward_homography`` on 7d's 384x768 mosaic, every image
    undistorted first, held to the ortho bars against the pinhole stream's
    mosaic. (iv) ``run_dsm`` with the plane sweep through the lens model
    (no undistortion, z in [399, 429]): 1 IDW launch. 8c: BM bit-equal to
    its plain version on one undistorted, rectified pair of the lens stream
    (frames 118, 125), IDW on 8a's binned cloud, the score pass on 8a's map
    and cameras. Returns (e2e_slice7, launches by run, max |err| of 8c by
    kernel)."""
    import dataclasses

    from aerial_mapper_tpu_torch.config import (
        GridMapConfig,
        OrthoHomographyConfig,
        PipelineConfig,
        PlaneSweepConfig,
        StereoConfig,
    )
    from aerial_mapper_tpu_torch.dsm.idw import bin_with_halo
    from aerial_mapper_tpu_torch.io.poses import _rot_matrix_np
    from aerial_mapper_tpu_torch.mapgrid.grid import (
        MapGeometry,
        cell_centers,
    )
    from aerial_mapper_tpu_torch.camera.undistort import (
        build_undistort_map,
        undistort_image,
    )
    from aerial_mapper_tpu_torch.ortho.backward_grid import (
        _score_pass_general,
        score_operands,
    )
    from aerial_mapper_tpu_torch.pipeline import batch
    from aerial_mapper_tpu_torch.pipeline.incremental import (
        _stereo_image_from,
        _to_device,
        run_incremental,
    )
    from aerial_mapper_tpu_torch.stereo.batched import prepare_pair_operands
    from aerial_mapper_tpu_torch.stereo.cuda_bm import prefilter_pair
    from aerial_mapper_tpu_torch.stereo.plane_sweep import (
        auto_z_range,
        warn_boundary_pileup,
    )
    from aerial_mapper_tpu_torch.stereo.rectify import _rectify_image
    from aerial_mapper_tpu_torch.synth.scene import render_image

    cam, scene = w["cam"], w["scene"]
    ds = bench_dataset(cam, w["images"].cpu().numpy())
    extent = MAP_CELLS * RESOLUTION
    geom = MapGeometry(0.0, 0.0, RESOLUTION, MAP_CELLS, MAP_CELLS)
    base = PipelineConfig(
        grid=GridMapConfig(delta_easting=extent, delta_northing=extent,
                           resolution=RESOLUTION),
        stereo=StereoConfig(use_every_nth_image=USE_EVERY_NTH),
        bm=bm_cfg, dsm=dsm_cfg, ortho_backward=ortho_cfg)
    # the sweep: neighbours 7 frames (11 m) away, the stereo pairs'
    # baseline; closely spaced frames need a spacing above 1
    sweep = PlaneSweepConfig(neighbor_spacing=USE_EVERY_NTH)
    ps_cfg = dataclasses.replace(
        base, plane_sweep=sweep, stereo=dataclasses.replace(
            base.stereo, densifier="plane_sweep"))
    refs = len(range(USE_EVERY_NTH - 1, NUM_IMAGES, USE_EVERY_NTH))
    pairs = refs - 1
    runs = DriverRuns(counters)
    want, drive = runs.want, runs.drive
    e2e, errs = {}, {}
    t_phase = time.perf_counter()

    # ---- 8a. the plane sweep at full width (pinhole bench stream) ----
    out, rec = drive(
        "8a plane_sweep run_ortho_backward_grid",
        lambda **o: batch.run_ortho_backward_grid(ds, ps_cfg, device=dev)[0],
        want(bm_scan=3, binned_idw_cuda=1, score_pass_cuda=1))
    rec.update(map_bars("8a", out, truth_h, truth_t))
    # the auto range the driver logged, and the same prepass by hand
    quats_c, trans_c = ds.camera_poses()
    Rs_c = np.stack([_rot_matrix_np(q) for q in quats_c])
    stereo_images = [_stereo_image_from(_to_device(im, dev), ds, ps_cfg)
                     for im in ds.images]
    z_lo, z_hi = runs.counted(
        "8a auto_z_range", lambda: auto_z_range(
            stereo_images, Rs_c, trans_c, cam, bm_cfg=bm_cfg, device=dev),
        want(bm_scan=3))
    logged = [m for m in runs.last_log if "auto z range" in m]
    check(len(logged) == 1 and f"[{z_lo:.1f}, {z_hi:.1f}]" in logged[0],
          f"8a: the driver's auto range {logged} is not [{z_lo}, {z_hi}]")
    check(z_lo < truth_h.min().item() and z_hi > truth_h.max().item(),
          f"8a: auto range [{z_lo}, {z_hi}] does not bracket the terrain")
    resolved = dataclasses.replace(sweep, z_min=z_lo, z_max=z_hi)
    cloud = runs.counted(
        "8a plane_sweep run_dense_pcl",
        lambda: batch.run_dense_pcl(ds, ps_cfg, device=dev),
        want(bm_scan=3))
    pts, _intens, valid = cloud
    pile = warn_boundary_pileup(pts, valid, resolved)
    # the profile's depth is cut to the first PROFILE_FRAMES frames (7
    # reference views): the trace of the whole run (~270 k launches) took
    # 185-209 s to record and read, the longest step of the script; the
    # busy share is over this shorter run's own unprofiled time
    n_p = PROFILE_FRAMES
    ds_p = dataclasses.replace(ds, quats_G_B=ds.quats_G_B[:n_p],
                               trans_G_B=ds.trans_G_B[:n_p],
                               images=ds.images[:n_p])
    refs_p = len(range(USE_EVERY_NTH - 1, n_p, USE_EVERY_NTH))
    _o, short_s = runs.timed(
        "8a plane_sweep profiled frames",
        lambda: batch.run_ortho_backward_grid(ds_p, ps_cfg, device=dev),
        want(bm_scan=3, binned_idw_cuda=1, score_pass_cuda=1))
    t0 = time.perf_counter()
    dev_ms, top, host = profile_top(
        lambda: batch.run_ortho_backward_grid(ds_p, ps_cfg, device=dev))
    profile_s = time.perf_counter() - t0
    n_kernels = sum(c for _t, _k, c in top)
    launch_calls = sum(c for _t, k, c in host if k == "cudaLaunchKernel")
    rec.update(
        reference_views=refs, auto_z_range=[z_lo, z_hi],
        planes=sweep.num_planes, neighbors=sweep.num_neighbors,
        neighbor_spacing=sweep.neighbor_spacing,
        pileup_fractions=list(pile), cloud_points=int(pts.shape[0]),
        cloud_valid=int(valid.sum().item()),
        profile=dict(frames=n_p, reference_views=refs_p, run_s=short_s,
                     device_ms=dev_ms if top else None,
                     device_busy_share=(dev_ms / (short_s * 1e3)
                                        if top else None),
                     kernels_and_copies=n_kernels,
                     per_reference_view=n_kernels / refs_p,
                     cuda_launch_kernel_calls=launch_calls,
                     profiled_run_s=profile_s,
                     top=[dict(ms=t, name=k[:80], count=c)
                          for t, k, c in top[:10]],
                     host_top=[dict(ms=t, name=k[:80], count=c)
                               for t, k, c in host[:8]]))
    rec["reduced"] = (f"the profile over the first {n_p} frames "
                      f"({refs_p} reference views)")
    e2e["8a_plane_sweep"] = rec
    print(f"[8a plane sweep] {refs} reference views x {sweep.num_planes} "
          f"planes x {sweep.num_neighbors} neighbours (spacing "
          f"{sweep.neighbor_spacing}); auto z range [{z_lo:.3f}, "
          f"{z_hi:.3f}] m, pile-up {pile[0]:.4f} / {pile[1]:.4f}: first "
          f"{rec['first_s']:.3f} s, median {rec['median_s']:.4f} s of 3 "
          f"{rec['runs_s']}; stages {rec['stage_ms_first_run']}; DSM "
          f"coverage {rec['dsm_coverage']:.4f}, median |err| "
          f"{rec['dsm_median_abs_err_m']:.4f} m; ortho coverage "
          f"{rec['ortho_coverage']:.4f}, median |err| "
          f"{rec['ortho_median_abs_err_gray']:.3f} gray; cloud "
          f"{rec['cloud_valid']} valid of {rec['cloud_points']}; peak "
          f"{rec['peak_mem_gib']:.3f} GiB; launches {rec['launches']}",
          flush=True)
    if top:
        print(f"[8a profile] the first {n_p} frames ({refs_p} reference "
              f"views, {short_s:.3f} s unprofiled): {n_kernels} kernels and "
              f"copies ({n_kernels / refs_p:.0f} per reference view, "
              f"{launch_calls} cudaLaunchKernel calls), {dev_ms:.2f} ms on "
              f"the card (busy share "
              f"{rec['profile']['device_busy_share']:.3f}):")
        for t, k, c in top[:10]:
            print(f"    {t:9.3f} ms  x{c:<6d} {k[:90]}")
        print("[8a profile] host (self CPU, profiled):")
        for t, k, c in host[:8]:
            print(f"    {t:9.3f} ms  x{c:<6d} {k[:90]}")
    else:
        print("[8a profile] torch.profiler recorded no device time: busy "
              "share not measured")

    # ---- 8c (first part). IDW on 8a's binned cloud, the score pass on
    # 8a's map and its 249 cameras: bit-equal ----
    p = pts.reshape(-1, 3)
    rec_points = int(valid.sum().item())
    binned, ext, _halo = bin_with_halo(
        p[:, :2], p[:, 2], valid.reshape(-1), geom, dsm_cfg.bin_capacity,
        dsm_cfg.max_radius_sq if dsm_cfg.adaptive_interpolation
        else dsm_cfg.interpolation_radius_sq)
    errs["binned_idw_cuda"] = idw_check(
        "8c binned_idw, 8a cloud", binned, ext, dsm_cfg,
        dsm_cfg.adaptive_interpolation, dsm_cfg.max_radius_sq)
    idw_slots = int(torch.clamp(binned.count,
                                max=dsm_cfg.bin_capacity).sum().item())
    cells, bank = score_operands(out, _to_device(quats_c, dev),
                                 _to_device(trans_c, dev), geom, ortho_cfg)
    sc = score_check("8c score_pass, 8a map", cells, bank,
                     (geom.height, geom.width), cam)
    errs["score_pass_cuda"] = sc["max_abs_err"]
    del out, cloud, pts, valid, p, binned, stereo_images

    # ---- 8b. the distorted stream ----
    lens = cam._replace(dist_kind="radial-tangential",
                        dist_params=(-0.2, 0.05, 1e-4, -1e-4))
    # the lens path's two new layers alone (CUDA events): the general
    # score pass on 8a's map and cameras, and one frame's undistortion
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    R_cw = bank[:, :9].reshape(-1, 3, 3)
    t_all = _to_device(trans_c, dev)
    general_ms = cuda_ms(lambda: _score_pass_general(
        cells, R_cw, t_all, lens, ortho_cfg.cell_chunk), reps=5)
    general_gib = torch.cuda.max_memory_allocated() / 2 ** 30 - held_gib
    frame = _to_device(ds.images[0], dev)
    t0 = time.perf_counter()
    build_undistort_map(lens, dev)
    torch.cuda.synchronize()
    map_ms = (time.perf_counter() - t0) * 1e3
    undistort_ms = cuda_ms(lambda: undistort_image(lens, frame), reps=20)
    layers = dict(general_score_ms=general_ms,
                  general_score_peak_gib_above_held=general_gib,
                  general_score_shape=[cells.shape[0], R_cw.shape[0]],
                  undistort_map_first_build_ms=map_ms,
                  undistort_frame_ms=undistort_ms)
    print(f"[8b layers] general score pass, lens, {cells.shape[0]} cells x "
          f"{R_cw.shape[0]} cameras: {general_ms:.3f} ms, "
          f"{general_gib:.3f} GiB above the {held_gib:.3f} held; "
          f"undistortion of one {IMG_W}x{IMG_H} frame {undistort_ms:.4f} ms "
          f"(map built in {map_ms:.2f} ms)", flush=True)
    del cells, bank, R_cw, t_all, frame
    Rs, ts = bench_poses()
    t0 = time.perf_counter()
    lens_frames = torch.stack([render_image(scene, lens, R, t,
                                            apply_distortion=True,
                                            device=dev)
                               for R, t in zip(Rs, ts)])
    lens_frames = torch.clamp(torch.round(lens_frames), 0.0, 255.0)
    lds = bench_dataset(lens, lens_frames.cpu().numpy())
    check(not torch.equal(lens_frames, w["images"]),
          "8b: the lens changed no pixel")
    del lens_frames
    render_s = time.perf_counter() - t0
    und = dataclasses.replace(base, stereo=dataclasses.replace(
        base.stereo, images_need_undistortion=True))
    xla_score = dataclasses.replace(ortho_cfg, score_kernel="xla")
    und_xla = dataclasses.replace(und, ortho_backward=xla_score)

    # (i) the backward-grid ortho on undistorted stereo, the general score
    out, rec = drive(
        "8b(i) run_ortho_backward_grid lens",
        lambda **o: batch.run_ortho_backward_grid(lds, und_xla,
                                                  device=dev)[0],
        want(bm_scan=pairs, binned_idw_cuda=1))
    rec.update(map_bars("8b(i)", out, truth_h, truth_t))
    try:
        batch.run_ortho_backward_grid(lds, und, device=dev)
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None and "pinhole" in raised,
          "8b(i): score_kernel='pallas' with a lens did not raise "
          "ValueError")
    rec["pallas_score_raises"] = raised
    e2e["8b_i_backward_grid"] = rec
    del out
    print(f"[8b(i) run_ortho_backward_grid, lens] {pairs} undistorted "
          f"pairs, general score path: median {rec['median_s']:.4f} s of 3 "
          f"{rec['runs_s']} (first {rec['first_s']:.3f} s; lens render "
          f"{render_s:.2f} s); stages {rec['stage_ms_first_run']}; DSM "
          f"coverage {rec['dsm_coverage']:.4f}, median |err| "
          f"{rec['dsm_median_abs_err_m']:.4f} m; ortho coverage "
          f"{rec['ortho_coverage']:.4f}, median |err| "
          f"{rec['ortho_median_abs_err_gray']:.3f} gray; peak "
          f"{rec['peak_mem_gib']:.3f} GiB; launches {rec['launches']}; "
          f"score_kernel='pallas' raises ValueError", flush=True)

    # (ii) the incremental driver, streaming, undistorting each update
    inc_cfg = dataclasses.replace(und_xla, stereo=dataclasses.replace(
        und_xla.stereo, use_every_nth_image=1))
    first, rec = drive(
        "8b(ii) run_incremental lens",
        lambda **o: run_incremental(lds, inc_cfg,
                                    update_every_nth=USE_EVERY_NTH,
                                    device=dev)[0],
        want(bm_scan=pairs, binned_idw_cuda=pairs))
    rec.update(map_bars("8b(ii)", first, truth_h, truth_t))
    again = runs.counted(
        "8b(ii) run_incremental lens, again",
        lambda: run_incremental(lds, inc_cfg,
                                update_every_nth=USE_EVERY_NTH,
                                device=dev)[0],
        want(bm_scan=pairs, binned_idw_cuda=pairs))
    check(bit_equal_maps(again, first), "8b(ii): two runs differ")
    rec["runs_bit_equal"] = True
    e2e["8b_ii_incremental"] = rec
    del first, again
    print(f"[8b(ii) run_incremental, lens] {refs} updates, streaming: "
          f"median {rec['median_s']:.4f} s of 3 {rec['runs_s']} (first "
          f"{rec['first_s']:.3f} s); DSM coverage {rec['dsm_coverage']:.4f}"
          f", median |err| {rec['dsm_median_abs_err_m']:.4f} m; ortho "
          f"coverage {rec['ortho_coverage']:.4f}, median |err| "
          f"{rec['ortho_median_abs_err_gray']:.3f} gray; two runs "
          f"bit-equal; peak {rec['peak_mem_gib']:.3f} GiB; launches "
          f"{rec['launches']}", flush=True)

    # (iii) the homography mosaic, every image undistorted first
    hcfg = OrthoHomographyConfig(
        ground_plane_elevation_m=scene.base_elevation,
        width_mosaic_pixels=768, height_mosaic_pixels=384,
        resolution=RESOLUTION, origin=(0.0, 0.0, 0.0))
    h_cfg = dataclasses.replace(base, ortho_homography=hcfg)
    mosaic, rec = drive(
        "8b(iii) run_ortho_forward_homography lens",
        lambda **o: batch.run_ortho_forward_homography(lds, h_cfg,
                                                       device=dev),
        want())
    pin = runs.counted(
        "8b(iii) run_ortho_forward_homography pinhole",
        lambda: batch.run_ortho_forward_homography(ds, h_cfg, device=dev),
        want())
    # against the pinhole stream's mosaic: the flat plane's parallax
    # keeps both off the analytic texture alike (phase 7d prints it)
    rec.update(ortho_bars("8b(iii)", mosaic, (mosaic > 0) & (pin > 0),
                          pin))
    tex = scene.texture(*cell_centers(
        MapGeometry(0.0, 0.0, RESOLUTION, 384, 768), device=dev))
    seen = mosaic > 0
    rec["median_abs_err_vs_texture_gray"] = \
        (mosaic[seen] - tex[seen]).abs().median().item()
    e2e["8b_iii_homography"] = rec
    del mosaic, pin, tex
    print(f"[8b(iii) run_ortho_forward_homography, lens] 384x768 mosaic, "
          f"each image undistorted: median {rec['median_s']:.4f} s of 3 "
          f"{rec['runs_s']}; vs the pinhole mosaic coverage "
          f"{rec['ortho_coverage']:.4f}, median |err| "
          f"{rec['ortho_median_abs_err_gray']:.3f} gray (vs the texture "
          f"{rec['median_abs_err_vs_texture_gray']:.3f}, no bar)",
          flush=True)

    # (iv) the plane sweep through the lens model, no undistortion
    lens_ps = dataclasses.replace(ps_cfg, plane_sweep=dataclasses.replace(
        sweep, z_min=399.0, z_max=429.0))
    out, rec = drive(
        "8b(iv) plane_sweep run_dsm lens",
        lambda **o: batch.run_dsm(lds, lens_ps, device=dev)[0],
        want(binned_idw_cuda=1))
    rec.update(dsm_bars("8b(iv)", out["elevation"], truth_h))
    e2e["8b_iv_plane_sweep_lens"] = rec
    del out
    print(f"[8b(iv) plane sweep through the lens] z [399, 429]: median "
          f"{rec['median_s']:.4f} s of 3 {rec['runs_s']} (first "
          f"{rec['first_s']:.3f} s); DSM coverage {rec['dsm_coverage']:.4f}"
          f", median |err| {rec['dsm_median_abs_err_m']:.4f} m; peak "
          f"{rec['peak_mem_gib']:.3f} GiB; launches {rec['launches']}",
          flush=True)

    # ---- 8c (second part). BM on one undistorted, rectified pair ----
    a, b = LENS_CHECK_PAIR
    u_ops = prepare_pair_operands(
        lens.K, Rs_c[[a, b]], trans_c[[a, b]],
        [_stereo_image_from(_to_device(lds.images[k], dev), lds, und)
         for k in (a, b)], device=dev)
    lf, rf = prefilter_pair(_rectify_image(u_ops.image1, u_ops.T1_inv),
                            _rectify_image(u_ops.image2, u_ops.T2_inv),
                            bm_cfg)
    errs["bm_scan"] = bm_check(f"8c bm_scan, undistorted pair ({a}, {b})",
                               lf, rf, bm_cfg.num_disparities,
                               bm_cfg.min_disparity, bm_cfg.block_size,
                               True)
    e2e["layers"] = layers
    e2e["phase_s"] = time.perf_counter() - t_phase
    print(f"[8 done] phase 8 took {e2e['phase_s']:.1f} s (the profiled 8a "
          f"run {profile_s:.1f} s)", flush=True)
    e2e["kernel_checks"] = dict(
        bm_pair=[a, b], idw_points=rec_points, idw_occupied_slots=idw_slots,
        score={k: sc[k] for k in ("cells", "cameras", "kept_share",
                                  "visible_share", "mean_n_vis")},
        bit_equal=True)
    return e2e, runs.launches, errs


# the flagfile of 9b's third backward-grid run: the reference's
# backward_grid_ prefix and gflags booleans (tests/data/flags/ holds the
# layouts the CPU tests read)
CLI_FLAGFILE = """--alsologtostderr=true
--v=0
--backward_grid_data_directory={data}
--backward_grid_image_extension=.pgm
--backward_grid_center_easting=0.0
--backward_grid_center_northing=0.0
--backward_grid_delta_easting={extent}
--backward_grid_delta_northing={extent}
--backward_grid_resolution={resolution}
--backward_grid_interpolation_radius=2.0
--backward_grid_adaptive_interpolation=true
--backward_grid_use_digital_elevation_map=true
--backward_grid_show_orthomosaic_opencv=false
--backward_grid_use_multi_threads=false
--backward_grid_kernel_family=pallas
--dense_pcl_use_every_nth_image={every_nth}
--num_disparities={num_disp}
--use_BM=true
--backward_grid_orthomosaic_jpg_filename={out}/ff_ortho.pgm
--backward_grid_output_geotiff={out}/ff_ortho.tif
--backward_grid_output_layers_npz={out}/ff_layers.npz
"""
# 9b's cut of the dense-cloud pair: the first CLI_MAX_FRAMES frames (6
# pairs), and a from-points map over their footprints (easting -90..10,
# northing -80..20)
CLI_MAX_FRAMES = 50
CLI_PCL_GRID = ["--center_easting", "-40", "--center_northing", "-30",
                "--delta_easting", "100", "--delta_northing", "100",
                "--resolution", "0.5"]


class _ModulesBlocked:
    """``import`` of each named module raises ImportError inside the
    block, as on a machine without it; the modules are restored after."""

    def __init__(self, *names):
        self.names, self.saved = names, {}

    def __enter__(self):
        for n in self.names:
            self.saved[n] = sys.modules.get(n)
            sys.modules[n] = None
        return self

    def __exit__(self, *exc):
        for n, m in self.saved.items():
            if m is None:
                del sys.modules[n]
            else:
                sys.modules[n] = m
        return False


def cli_phase(w, counters, truth_h, truth_t, dev):
    """Phase 9: the demo CLIs (``aerial_mapper_tpu_torch/cli``) on the
    card, as a user runs them. 9a writes the bench stream as a dataset on
    disk with the port's own writers (249 PGM frames, ``opt_poses.txt``,
    the rig YAML) and reads the rig back equal. 9b runs the six mapping
    CLIs in process through ``main(argv)`` with ``device`` left at None,
    with ``yaml`` and ``PIL`` blocked, each counted (every launch counter
    set to 0 just before and read just after); each run's files, read
    back, equal the port driver called in process on
    ``common.dataset_from_args`` / ``common.pipeline_config_from_args`` of
    the same argv, and its maps meet phase 4's bars. Where Pillow is
    installed, the HTML report and the live preview run after that. 9c
    runs ``python -m aerial_mapper_tpu_torch.cli.main_dsm`` with
    ``--profile_dir``: exit 0, a GeoTiff equal to 9b's and a non-empty
    trace. Returns (e2e_cli, launches by run)."""
    import importlib.util
    import shutil
    import tempfile

    from aerial_mapper_tpu_torch.camera.rig import (
        load_camera_rig,
        save_camera_rig,
    )
    from aerial_mapper_tpu_torch.cli import (
        common,
        main_dense_pcl,
        main_dsm,
        main_ortho_backward_grid,
        main_ortho_backward_grid_incremental,
        main_ortho_forward_homography,
        main_ortho_from_pcl,
    )
    from aerial_mapper_tpu_torch.io.artifacts import (
        load_layers,
        load_points,
        to_host,
    )
    from aerial_mapper_tpu_torch.io.geotiff import read_geotiff
    from aerial_mapper_tpu_torch.io.images import (
        load_images_by_names,
        save_image,
    )
    from aerial_mapper_tpu_torch.io.pointcloud import load_point_cloud_txt
    from aerial_mapper_tpu_torch.io.poses import save_poses_standard
    from aerial_mapper_tpu_torch.mapgrid.grid import (
        MapGeometry,
        cell_centers,
    )
    from aerial_mapper_tpu_torch.pipeline import batch
    from aerial_mapper_tpu_torch.pipeline.dataset import load_dataset
    from aerial_mapper_tpu_torch.pipeline.incremental import run_incremental

    cam, scene = w["cam"], w["scene"]
    ds = bench_dataset(cam, w["images"].cpu().numpy())
    pairs = len(range(USE_EVERY_NTH - 1, NUM_IMAGES, USE_EVERY_NTH)) - 1
    pcl_pairs = len(range(USE_EVERY_NTH - 1, CLI_MAX_FRAMES,
                          USE_EVERY_NTH)) - 1
    runs = DriverRuns(counters)
    want = runs.want
    have_pil = importlib.util.find_spec("PIL") is not None
    e2e = dict(reduced=[
        f"main_dense_pcl and main_ortho_from_pcl: --max_frames "
        f"{CLI_MAX_FRAMES} ({pcl_pairs} pairs: the full stream's ~11 M "
        "points as text would take ~50 s to write), the from-points map "
        "cut to 200x200 cells at 0.5 m over those frames' footprints"])
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        os.makedirs(data)
        os.makedirs(out)

        # ---- 9a. the dataset on disk, written by the port ----
        t0 = time.perf_counter()
        for i, im in enumerate(ds.images):
            save_image(os.path.join(data, f"image_{i}.pgm"), im)
        images_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_poses_standard(os.path.join(data, "opt_poses.txt"),
                            ds.quats_G_B, ds.trans_G_B)
        poses_s = time.perf_counter() - t0
        rig_path = os.path.join(data, "camera_fixed_wing.yaml")
        t0 = time.perf_counter()
        save_camera_rig(ds.rig, rig_path)
        back = load_camera_rig(rig_path)
        rig_s = time.perf_counter() - t0
        check(tuple(back.cameras) == tuple(ds.rig.cameras)
              and np.array_equal(back.T_C_B_quats, ds.rig.T_C_B_quats)
              and np.array_equal(back.T_C_B_trans, ds.rig.T_C_B_trans),
              f"9a: the rig read back differs: {back}")
        # the whole dataset read back: the frames exact, the poses to the
        # Standard format's 9 and 12 decimals
        t0 = time.perf_counter()
        disk = load_dataset(data, "camera_fixed_wing.yaml", "opt_poses.txt",
                            "image_", extension=".pgm")
        load_s = time.perf_counter() - t0
        check(len(disk.images) == len(ds.images) and all(
            np.array_equal(a, b) for a, b in zip(disk.images, ds.images)),
            "9a: the PGM frames read back differ")
        pose_err = max(np.abs(disk.trans_G_B - ds.trans_G_B).max(),
                       np.abs(disk.quats_G_B - ds.quats_G_B).max())
        check(pose_err < 1e-8, f"9a: the poses read back differ by "
                               f"{pose_err}")
        e2e["dataset"] = dict(
            frames=len(ds.images), images_s=images_s, poses_s=poses_s,
            rig_write_read_s=rig_s, load_s=load_s, pose_max_abs_err=pose_err,
            bytes=sum(os.path.getsize(os.path.join(data, f))
                      for f in os.listdir(data)))
        print(f"[9a dataset] {len(ds.images)} PGM frames in {images_s:.2f} "
              f"s, poses {poses_s:.3f} s, rig written and read back equal "
              f"in {rig_s:.4f} s; {e2e['dataset']['bytes']} bytes; read "
              f"back in {load_s:.2f} s, frames equal, poses within "
              f"{pose_err:.1e}", flush=True)

        # each CLI takes the flags its parser has: the dataset, the map,
        # the stereo pairing and the DSM's IDW radius (phase 4's)
        data_flags = ["--data_directory", data, "--image_extension", ".pgm"]
        stereo_flags = ["--num_disparities", str(NUM_DISP),
                        "--dense_pcl_use_every_nth_image",
                        str(USE_EVERY_NTH)]
        base = data_flags + stereo_flags + [
            "--center_easting", "0", "--center_northing", "0",
            "--delta_easting", str(MAP_CELLS * RESOLUTION),
            "--delta_northing", str(MAP_CELLS * RESOLUTION),
            "--resolution", str(RESOLUTION), "--interpolation_radius", "2"]

        def path(name):
            return os.path.join(out, name)

        def own_paths(tag, mod, argv):
            """Fail if ``argv`` leaves one of the CLI's fixed ``/tmp``
            defaults in place: every file a run writes lies under
            ``out``."""
            got = vars(mod.parse_args(argv))
            dflt = vars(mod.parse_args(["--data_directory", "."]))
            fixed = sorted(k for k, v in got.items()
                           if isinstance(v, str) and v.startswith("/tmp/")
                           and v == dflt.get(k))
            check(not fixed, f"9 {tag}: the argv keeps the default path "
                  f"of {fixed}")

        def cli(tag, mod, argv, expect, driver):
            """One counted CLI run (``device`` None), then ``driver(args,
            source, cfg)`` in process on the same argv, the source being
            ``common.dataset_from_args`` or the text cloud the argv names:
            (its result, record). The load time is the source's."""
            own_paths(tag, mod, argv)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runs.counted(tag, lambda: mod.main(argv), expect)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            args = mod.parse_args(argv)
            t0 = time.perf_counter()
            cloud_file = getattr(args, "point_cloud_filename", "")
            src = (load_point_cloud_txt(cloud_file) if cloud_file
                   else common.dataset_from_args(args))
            load_s = time.perf_counter() - t0
            ref = driver(args, src, common.pipeline_config_from_args(args))
            rec = dict(run_s=run_s, load_s=load_s, peak_mem_gib=peak,
                       launches=runs.launches[tag])
            e2e[tag] = rec
            return ref, rec

        def same_map(tag, npz, ref):
            saved, _g = load_layers(npz)
            check(bit_equal_maps({k: torch.as_tensor(v, device=dev)
                                  for k, v in saved.items()}, ref),
                  f"{tag}: the npz layers differ from the in-process "
                  "driver's map")

        def same_image(tag, name, layer):
            img8 = np.clip(to_host(layer), 0, 255).astype(np.uint8)
            if name.endswith(".tif"):
                got = read_geotiff(path(name))[0]
            else:
                got = load_images_by_names(out, [name])[0]
            check(np.array_equal(got, img8),
                  f"{tag}: {name} differs from the in-process layer")

        def printed(tag, rec, extra=""):
            print(f"[9b {tag}] run {rec['run_s']:.3f} s (load "
                  f"{rec['load_s']:.3f} s in process); peak "
                  f"{rec['peak_mem_gib']:.3f} GiB; launches "
                  f"{rec['launches']}{extra}", flush=True)

        def ortho_driver(args, dsx, cfg):
            return batch.run_ortho_backward_grid(dsx, cfg, device=dev)[0]

        # ---- 9b. the six mapping CLIs, with neither yaml nor PIL ----
        with _ModulesBlocked("yaml", "PIL"):
            for tag, family in (("backward_grid_pallas", "pallas"),
                                ("backward_grid_xla", "xla")):
                ref, rec = cli(
                    tag, main_ortho_backward_grid,
                    base + ["--kernel_family", family,
                            "--output_geotiff", path(f"{tag}.tif"),
                            "--orthomosaic_jpg_filename", path(f"{tag}.pgm"),
                            "--output_layers_npz", path(f"{tag}.npz")],
                    want(bm_scan=pairs if family == "pallas" else 0,
                         binned_idw_cuda=1, score_pass_cuda=1),
                    ortho_driver)
                same_map(tag, path(f"{tag}.npz"), ref)
                same_image(tag, f"{tag}.tif", ref["ortho"])
                same_image(tag, f"{tag}.pgm", ref["ortho"])
                rec.update(map_bars(f"9b {tag}", ref, truth_h, truth_t))
                printed(tag, rec, f"; DSM {rec['dsm_coverage']:.4f} at "
                        f"{rec['dsm_median_abs_err_m']:.4f} m, ortho "
                        f"{rec['ortho_coverage']:.4f} at "
                        f"{rec['ortho_median_abs_err_gray']:.3f} gray; "
                        "files equal the in-process map")
                del ref

            ff = path("backward_grid.ff")
            with open(ff, "w") as f:
                f.write(CLI_FLAGFILE.format(
                    data=data, out=out, extent=MAP_CELLS * RESOLUTION,
                    resolution=RESOLUTION, every_nth=USE_EVERY_NTH,
                    num_disp=NUM_DISP))
            tag = "backward_grid_flagfile"
            ref, rec = cli(tag, main_ortho_backward_grid, [f"--flagfile={ff}"],
                           want(bm_scan=pairs, binned_idw_cuda=1,
                                score_pass_cuda=1), ortho_driver)
            same_map(tag, path("ff_layers.npz"), ref)
            same_map(tag, path("backward_grid_pallas.npz"), ref)
            same_image(tag, "ff_ortho.tif", ref["ortho"])
            same_image(tag, "ff_ortho.pgm", ref["ortho"])
            printed(tag, rec, "; bit-equal to backward_grid_pallas")
            del ref

            def dsm_driver(args, dsx, cfg):
                return batch.run_dsm(dsx, cfg, device=dev)[0]

            for tag, extra, expect in (
                    ("dsm_bm", [], want(bm_scan=pairs, binned_idw_cuda=1)),
                    ("dsm_sgm", ["--use_BM=false"],
                     want(sgm_scan=8 * pairs, binned_idw_cuda=1))):
                ref, rec = cli(
                    tag, main_dsm,
                    base + ["--kernel_family", "pallas", *extra,
                            "--output_geotiff", path(f"{tag}.tif"),
                            "--output_layers_npz", path(f"{tag}.npz")],
                    expect, dsm_driver)
                same_map(tag, path(f"{tag}.npz"), ref)
                arr = torch.as_tensor(read_geotiff(path(f"{tag}.tif"))[0],
                                      device=dev)
                check(bit_equal_maps({"e": arr}, {"e": ref["elevation"]}),
                      f"{tag}: the GeoTiff differs from the elevation")
                rec.update(dsm_bars(f"9b {tag}", ref["elevation"], truth_h))
                printed(tag, rec, f"; DSM {rec['dsm_coverage']:.4f} at "
                        f"{rec['dsm_median_abs_err_m']:.4f} m")
                del ref, arr

            tag = "incremental"
            ref, rec = cli(
                tag, main_ortho_backward_grid_incremental,
                base + ["--kernel_family", "pallas", "--update_every_nth",
                        str(USE_EVERY_NTH), "--orthomosaic_jpg_filename",
                        path("incremental.pgm"), "--output_layers_npz",
                        path("incremental.npz"), "--preview_dir",
                        path("no_preview")],
                want(bm_scan=pairs, binned_idw_cuda=pairs,
                     score_pass_cuda=pairs + 1),
                lambda args, dsx, cfg: run_incremental(
                    dsx, cfg, update_every_nth=args.update_every_nth,
                    device=dev)[0])
            same_map(tag, path("incremental.npz"), ref)
            same_image(tag, "incremental.pgm", ref["ortho"])
            rec.update(map_bars(f"9b {tag}", ref, truth_h, truth_t))
            printed(tag, rec, f"; DSM {rec['dsm_coverage']:.4f} at "
                    f"{rec['dsm_median_abs_err_m']:.4f} m, ortho "
                    f"{rec['ortho_coverage']:.4f} at "
                    f"{rec['ortho_median_abs_err_gray']:.3f} gray")
            del ref

            tag = "homography"
            hm, wm = 384, 768
            mosaic, rec = cli(
                tag, main_ortho_forward_homography,
                data_flags + ["--ground_plane_elevation_m",
                        str(scene.base_elevation), "--width_mosaic_pixels",
                        str(wm), "--height_mosaic_pixels", str(hm),
                        "--mosaic_resolution", str(RESOLUTION),
                        "--mosaic_origin", "0", "0", "0",
                        "--filename_mosaic_output", path("mosaic.pgm"),
                        "--output_geotiff", path("mosaic.tif")],
                want(),
                lambda args, dsx, cfg: batch.run_ortho_forward_homography(
                    dsx, cfg, device=dev))
            same_image(tag, "mosaic.pgm", mosaic)
            same_image(tag, "mosaic.tif", mosaic)
            observed = mosaic > 0
            coverage = observed.float().mean().item()
            check(coverage > 0.5, f"9b {tag}: mosaic coverage {coverage}")
            tex = scene.texture(*cell_centers(
                MapGeometry(0.0, 0.0, RESOLUTION, hm, wm), device=dev))
            rec.update(mosaic=[hm, wm], coverage=coverage,
                       median_abs_err_vs_texture_gray=(
                           mosaic[observed] - tex[observed]).abs()
                       .median().item())
            printed(tag, rec, f"; {hm}x{wm} mosaic, coverage "
                    f"{coverage:.4f}, median |mosaic - texture| "
                    f"{rec['median_abs_err_vs_texture_gray']:.3f} gray "
                    "(flat-plane parallax, no bar)")
            del mosaic, tex

            tag = "dense_pcl"
            cloud_txt = path("cloud.txt")
            (pts, intens, valid), rec = cli(
                tag, main_dense_pcl,
                data_flags + stereo_flags + [
                    "--kernel_family", "pallas", "--max_frames",
                    str(CLI_MAX_FRAMES), "--output_cloud_txt", cloud_txt,
                    "--output_cloud_npz", path("cloud.npz")],
                want(bm_scan=pcl_pairs),
                lambda args, dsx, cfg: batch.run_dense_pcl(dsx, cfg,
                                                           device=dev))
            p, i, v = load_points(path("cloud.npz"))
            check(np.array_equal(p, to_host(pts))
                  and np.array_equal(i, to_host(intens))
                  and np.array_equal(v, to_host(valid)),
                  f"9b {tag}: the npz cloud differs from the in-process "
                  "cloud")
            t0 = time.perf_counter()
            txt_pts, txt_int = load_point_cloud_txt(cloud_txt)
            txt_s = time.perf_counter() - t0
            # the text holds the valid points to 6 decimals; the loader
            # drops z <= -100 (the reference's filter)
            kept = v & (p[:, 2] > -100.0)
            check(txt_pts.shape[0] == int(kept.sum())
                  and np.abs(txt_pts - p[kept]).max() <= 1e-6
                  and np.array_equal(txt_int, np.round(i[kept])),
                  f"9b {tag}: the text cloud differs from its valid points")
            rec.update(points=int(v.size), valid=int(v.sum()),
                       txt_bytes=os.path.getsize(cloud_txt),
                       txt_read_s=txt_s)
            printed(tag, rec, f"; {rec['valid']} valid of {rec['points']} "
                    f"points; npz equal, text equal to 6 decimals "
                    f"({rec['txt_bytes']} bytes, read in {txt_s:.2f} s)")
            del pts, intens, valid, p, i, v, txt_pts, txt_int

            tag = "ortho_from_pcl"
            layers, rec = cli(
                tag, main_ortho_from_pcl,
                data_flags + stereo_flags + ["--kernel_family", "pallas"]
                + CLI_PCL_GRID
                + ["--point_cloud_filename", cloud_txt,
                   "--orthomosaic_jpg_filename", path("pcl.pgm"),
                   "--output_geotiff", path("pcl.tif")],
                want(binned_idw_cuda=1),
                lambda args, cloud, cfg: batch.run_ortho_from_pcl(
                    None, cfg, point_cloud=cloud, device=dev)[0])
            same_image(tag, "pcl.tif", layers["ortho"])
            same_image(tag, "pcl.pgm", layers["ortho"])
            geom_p = MapGeometry(-40.0, -30.0, RESOLUTION, 200, 200)
            tex_p = scene.texture(*cell_centers(geom_p, device=dev))
            ortho = layers["ortho"]
            rec.update(ortho_bars(f"9b {tag}", ortho, ortho != 255.0,
                                  tex_p))
            printed(tag, rec, f"; ortho {rec['ortho_coverage']:.4f} at "
                    f"{rec['ortho_median_abs_err_gray']:.3f} gray on "
                    "200x200 cells")
            del layers, ortho, tex_p

        # the report's and the preview's PNGs need Pillow
        if have_pil:
            tag = "backward_grid_report"
            ref, rec = cli(
                tag, main_ortho_backward_grid,
                base + ["--kernel_family", "pallas", "--output_geotiff",
                        path("r.tif"), "--orthomosaic_jpg_filename",
                        path("r.pgm"), "--report_html", path("r.html")],
                want(bm_scan=pairs, binned_idw_cuda=1, score_pass_cuda=1),
                ortho_driver)
            check(os.path.getsize(path("r.html")) > 0, "9b: no report")
            same_image(tag, "r.pgm", ref["ortho"])
            printed(tag, rec, "; report written")
            tag = "incremental_preview"
            pv = path("preview")
            ref, rec = cli(
                tag, main_ortho_backward_grid_incremental,
                base + ["--kernel_family", "pallas", "--update_every_nth",
                        str(USE_EVERY_NTH), "--orthomosaic_jpg_filename",
                        path("pv.pgm"), "--preview_every_updates", "5",
                        "--preview_dir", pv],
                want(bm_scan=pairs, binned_idw_cuda=pairs,
                     score_pass_cuda=pairs + 1),
                lambda args, dsx, cfg: run_incremental(
                    dsx, cfg, update_every_nth=args.update_every_nth,
                    device=dev)[0])
            same_image(tag, "pv.pgm", ref["ortho"])
            check(all(os.path.exists(os.path.join(pv, f)) for f in (
                "ortho_live.png", "elevation_live.png", "cloud_live.png")),
                f"9b {tag}: preview files missing: {os.listdir(pv)}")
            printed(tag, rec, "; preview PNGs written")
            del ref
            e2e["report_and_preview"] = "ran (Pillow installed)"
        else:
            e2e["report_and_preview"] = "not run: no Pillow on this machine"

        # ---- 9c. one CLI as a subprocess, profiled ----
        prof = os.path.join(tmp, "prof")
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here)
        argv = base + ["--kernel_family", "pallas", "--output_geotiff",
                       path("sub.tif"), "--profile_dir", prof]
        own_paths("9c", main_dsm, argv)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "aerial_mapper_tpu_torch.cli.main_dsm",
             *argv], cwd=here, env=env, capture_output=True, text=True,
            timeout=600)
        sub_s = time.perf_counter() - t0
        check(r.returncode == 0,
              f"9c: main_dsm exited {r.returncode}: {r.stderr[-3000:]}")
        a = read_geotiff(path("sub.tif"))[0]
        b = read_geotiff(path("dsm_bm.tif"))[0]
        check(np.array_equal(np.isnan(a), np.isnan(b))
              and np.array_equal(np.nan_to_num(a), np.nan_to_num(b)),
              "9c: the subprocess's GeoTiff differs from 9b's dsm_bm")
        traces = os.listdir(prof) if os.path.isdir(prof) else []
        check(len(traces) == 1 and os.path.getsize(
            os.path.join(prof, traces[0])) > 0,
            f"9c: expected one non-empty trace in {prof}: {traces}")
        e2e["subprocess_main_dsm"] = dict(
            wall_s=sub_s, trace=traces[0],
            trace_bytes=os.path.getsize(os.path.join(prof, traces[0])),
            geotiff_equal_to_9b=True)
        print(f"[9c python -m ...main_dsm] exit 0 in {sub_s:.2f} s (CUDA "
              f"start-up and the cached kernel library included); GeoTiff "
              f"equal to 9b's; trace {traces[0]} "
              f"({e2e['subprocess_main_dsm']['trace_bytes']} bytes)",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    e2e["phase_s"] = time.perf_counter() - t_phase
    print(f"[9 done] phase 9 took {e2e['phase_s']:.1f} s; report and "
          f"preview: {e2e['report_and_preview']}", flush=True)
    return e2e, runs.launches


# phase 10b/10c's pose noise (10a's problem is bench_torch.py::ba_problem)
POSE_NOISE_M = 0.5
POSE_NOISE_SEED = 42
# the span of phase 10's local trajectory error: the stride of the
# windowed refinement (windows of 20 frames overlapping by 5)
LOCAL_SPAN = 15


def ate(est, true):
    """RMS position error (m), unaligned."""
    return float(np.sqrt(np.mean(np.sum((np.asarray(est, np.float64)
                                         - true) ** 2, axis=1))))


def local_ate(est, true, span=LOCAL_SPAN):
    """:func:`ate_aligned` over each run of ``span`` frames (the last one
    kept if it holds 5 or more): the error of the trajectory's local shape,
    what a stereo pair's geometry needs, without the drift between spans."""
    n = len(true)
    return [ate_aligned(est[s:s + span], true[s:s + span])
            for s in range(0, n, span) if min(s + span, n) - s >= 5]


def noisy_trans(trans):
    """``trans`` with N(0, 0.5 m) on every frame but the first (the gauge
    anchor), as ``tests/test_cli.py``'s refine test perturbs its poses."""
    out = np.array(trans, np.float64)
    out[1:] += np.random.default_rng(POSE_NOISE_SEED).normal(
        scale=POSE_NOISE_M, size=(len(out) - 1, 3))
    return out


def refine_phase(w, counters, truth_h, truth_t, dev):
    """Phase 10: feature-track bundle adjustment on the card. 10a
    ``bundle_adjust`` on ``bench.py::worker_ba``'s problem (249 cameras,
    3000 landmarks, ~130 k observations, 10 LM steps): a warm run, 3 timed
    (host clock to a synchronize), two solves bit-equal, the cost falling,
    the aligned position error at least halved, one solve profiled
    (kernels per solve, busy share), the segment sums' route timed against
    ``index_add_``. Phase 9's PGM dataset is written again with a pose file
    carrying 0.5 m of noise on frames 1..248. 10b
    ``refine_poses_windowed`` on it as ``--refine_poses`` reads it: two runs
    bit-equal, no kernel launched, the median over 15-frame spans of the
    aligned ATE at least halved (the windows drift apart: the whole
    trajectory's ATE is printed), one 20-frame window profiled (its host
    reads). 10c ``main_refine_poses`` (its file read back, 10b's check);
    ``main_dsm`` with the true and the noisy poses, and with
    ``--refine_poses``, and ``main_ortho_backward_grid --refine_poses``,
    each counted (34 BM, 1 IDW and, for the ortho, 1 score launches): the
    refining CLIs' maps equal the drivers run in process on 10b's refined
    poses, their median |DSM error| at most half the noisy poses' one,
    coverage above 0.5; the errors against the scene (median, RMSE) and the
    ortho's are printed. Returns (e2e, launches by run)."""
    import dataclasses
    import shutil
    import tempfile

    from aerial_mapper_tpu_torch.ba import bundle_adjust
    from aerial_mapper_tpu_torch.ba.bundle_adjust import (
        _obs_jacobians,
        _segment_sum,
        _cost,
        _run_local,
        _segments,
    )
    from aerial_mapper_tpu_torch.camera.rig import save_camera_rig
    from aerial_mapper_tpu_torch.cli import (
        common,
        main_dsm,
        main_ortho_backward_grid,
        main_refine_poses,
    )
    from aerial_mapper_tpu_torch.config import BundleAdjustmentConfig
    from aerial_mapper_tpu_torch.features import (
        refine_poses,
        refine_poses_windowed,
    )
    from aerial_mapper_tpu_torch.io.artifacts import load_layers
    from aerial_mapper_tpu_torch.io.images import save_image
    from aerial_mapper_tpu_torch.io.poses import (
        camera_to_body_poses,
        load_poses,
        save_poses_standard,
    )
    from aerial_mapper_tpu_torch.pipeline import batch
    from aerial_mapper_tpu_torch.pipeline.dataset import load_dataset

    cam = w["cam"]
    runs = DriverRuns(counters)
    want = runs.want
    e2e = {}
    t_phase = time.perf_counter()

    # ---- 10a. bundle_adjust at worker_ba's problem ----
    state, problem, ts_true = bench_torch.ba_problem(
        w["cam"], w["scene"], *bench_poses(), dev)
    cfg = BundleAdjustmentConfig(max_iterations=10)
    n_obs = int(problem.cam_idx.shape[0])

    def solve():
        out = bundle_adjust(state, problem, cam, cfg, device=dev)
        torch.cuda.synchronize()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = runs.counted("10a bundle_adjust", solve, want())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = solve()
        times.append(time.perf_counter() - t0)
    check(all(torch.equal(a, b) for a, b in zip(first, out)),
          "10a: two solves differ")
    med = float(np.median(times))
    dev_ms, top, host = profile_top(solve)
    n_device = sum(c for _t, _k, c in top)
    n_kernels = sum(c for _t, k, c in top if not k.startswith("Memcpy")
                    and not k.startswith("Memset"))
    launches = sum(c for _t, k, c in host if k == "cudaLaunchKernel")
    cost0 = float(_run_local(_cost(state, problem, cam, cfg,
                                   state.trans)))
    cost1 = float(_run_local(_cost(first, problem, cam, cfg,
                                   state.trans)))
    check(cost1 < cost0, f"10a: the cost rose {cost0} -> {cost1}")
    err0 = ate_aligned(state.trans.cpu().numpy(), ts_true)
    err1 = ate_aligned(first.trans.cpu().numpy(), ts_true)
    check(err1 <= 0.5 * err0,
          f"10a: aligned position error {err0:.4f} -> {err1:.4f} m")
    # the segment sums' route: sort once, reduce each segment in order
    # (deterministic) against index_add_ (float atomics) on the Schur
    # step's largest sum, U's 36 entries per camera observation
    segs_c = _segments(problem.cam_idx, state.quats.shape[0])
    _res, jc, _jl = _obs_jacobians(state, problem, cam)
    jctjc = torch.einsum("mri,mrj->mij", jc, jc)
    seg_ms = cuda_ms(lambda: _segment_sum(jctjc, segs_c), reps=20)
    add_ms = cuda_ms(lambda: torch.zeros(
        (state.quats.shape[0], 6, 6), device=dev).index_add_(
            0, problem.cam_idx, jctjc), reps=20)
    check(torch.equal(_segment_sum(jctjc, segs_c),
                      _segment_sum(jctjc, segs_c)),
          "10a: the segment sum differs between two calls")
    del _res, jc, _jl, jctjc
    e2e["bundle_adjust"] = dict(
        cameras=int(state.quats.shape[0]), landmarks=BA_LANDMARKS,
        observations=n_obs, max_iterations=cfg.max_iterations,
        cg_iterations=cfg.cg_iterations, median_s=med, runs_s=times,
        peak_mem_gib=peak, device_ms=dev_ms if top else None,
        busy_share=dev_ms / (med * 1e3) if top else None,
        device_ops_per_solve=n_device, kernels_per_solve=n_kernels,
        cuda_launch_kernel_calls=launches,
        top_kernels=[dict(ms=t, name=k[:80], count=c) for t, k, c in top[:8]],
        cost_initial=cost0, cost_final=cost1,
        aligned_position_err_m=[err0, err1], bit_equal_runs=True,
        segment_sum_ms=seg_ms, index_add_ms=add_ms)
    print(f"[10a bundle_adjust] {state.quats.shape[0]} cameras, "
          f"{BA_LANDMARKS} landmarks, {n_obs} observations, "
          f"{cfg.max_iterations} LM x {cfg.cg_iterations} CG: median "
          f"{med:.4f} s of 3 {[round(x, 4) for x in times]}; peak "
          f"{peak:.3f} GiB; {n_kernels} kernels ({n_device} device ops, "
          f"{launches} cudaLaunchKernel) per solve, device {dev_ms:.1f} ms, "
          f"busy share {e2e['bundle_adjust']['busy_share']}; cost {cost0:.1f}"
          f" -> {cost1:.1f}; aligned position error {err0:.4f} -> "
          f"{err1:.4f} m; two solves bit-equal; U's segment sum "
          f"{seg_ms:.4f} ms (index_add_ {add_ms:.4f} ms)", flush=True)
    for t, k, c in top[:8]:
        print(f"    {t:9.3f} ms  x{c:<6d} {k[:90]}")
    del state, problem, first, out
    e2e["10a_s"] = time.perf_counter() - t_phase

    # ---- the dataset of 10b and 10c: phase 9's PGM files, noisy poses ----
    Rs, ts = bench_poses()
    ds = bench_dataset(cam, w["images"].cpu().numpy())
    pairs = len(range(USE_EVERY_NTH - 1, NUM_IMAGES, USE_EVERY_NTH)) - 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_refine_")
    try:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        os.makedirs(data)
        os.makedirs(out)
        for i, im in enumerate(ds.images):
            save_image(os.path.join(data, f"image_{i}.pgm"), im)
        save_camera_rig(ds.rig, os.path.join(data, "camera_fixed_wing.yaml"))
        save_poses_standard(os.path.join(data, "opt_poses.txt"),
                            ds.quats_G_B, ds.trans_G_B)
        save_poses_standard(os.path.join(data, "noisy_poses.txt"),
                            ds.quats_G_B, noisy_trans(ts))
        # what --refine_poses hands to the refinement: the frames and the
        # camera poses of the dataset read back
        disk = load_dataset(data, "camera_fixed_wing.yaml", "noisy_poses.txt",
                            "image_", extension=".pgm")
        quats_c, noisy = disk.camera_poses()
        images = [torch.as_tensor(im, device=dev) for im in disk.images]
        local0 = local_ate(noisy, ts)

        # ---- 10b. refine_poses_windowed on the bench stream ----
        def windowed():
            return refine_poses_windowed(images, quats_c, noisy, cam,
                                         device=dev)

        torch.cuda.reset_peak_memory_stats()
        results, times = [], []
        for i in range(2):
            t0 = time.perf_counter()
            results.append(runs.counted(f"10b refine_{i}", windowed, want()))
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        (q_ref, t_ref, stats), (q2, t2, _s) = results
        check(np.array_equal(q_ref, q2) and np.array_equal(t_ref, t2),
              "10b: two refine_poses_windowed runs differ")
        local1 = local_ate(t_ref, ts)
        check(np.median(local1) <= 0.5 * np.median(local0),
              f"10b: the median {LOCAL_SPAN}-frame aligned ATE "
              f"{np.median(local0):.4f} -> {np.median(local1):.4f} m")
        # one window (the first 20 frames) profiled: its host reads
        win_ms, win_top, win_host = profile_top(lambda: refine_poses(
            images[:20], quats_c[:20], noisy[:20], cam, device=dev))
        syncs = {k: c for _t, k, c in win_host
                 if k in ("cudaStreamSynchronize", "cudaMemcpyAsync",
                          "aten::_local_scalar_dense")}
        t0 = time.perf_counter()
        refine_poses(images[:20], quats_c[:20], noisy[:20], cam, device=dev)
        win_s = time.perf_counter() - t0
        rec = dict(
            frames=len(images), runs_s=times, peak_mem_gib=peak,
            stats=stats, bit_equal_runs=True,
            ate_m=[ate(noisy, ts), ate(t_ref, ts)],
            aligned_ate_m=[ate_aligned(noisy, ts), ate_aligned(t_ref, ts)],
            local_aligned_ate_m=dict(
                span=LOCAL_SPAN, noisy_median=float(np.median(local0)),
                refined_median=float(np.median(local1)),
                refined_max=float(np.max(local1)), refined=local1),
            window_s=win_s, window_device_ms=win_ms if win_top else None,
            window_busy_share=win_ms / (win_s * 1e3) if win_top else None,
            window_host_syncs=syncs,
            window_top_host=[dict(ms=t, name=k[:60], count=c)
                             for t, k, c in win_host[:8]])
        e2e["refine_poses_windowed"] = rec
        print(f"[10b refine_poses_windowed] {len(images)} frames: "
              f"{times[0]:.3f} s, {times[1]:.3f} s (bit-equal); {stats}; "
              f"peak {peak:.3f} GiB; ATE aligned {rec['aligned_ate_m'][0]:.4f}"
              f" -> {rec['aligned_ate_m'][1]:.4f} m, unaligned "
              f"{rec['ate_m'][0]:.4f} -> {rec['ate_m'][1]:.4f} m; "
              f"{LOCAL_SPAN}-frame aligned ATE median {np.median(local0):.4f}"
              f" -> {np.median(local1):.4f} m (max {np.max(local1):.4f}); "
              f"one 20-frame window {win_s:.3f} s, device {win_ms:.1f} ms, "
              f"host {syncs}", flush=True)
        for t, k, c in win_host[:8]:
            print(f"    host {t:9.3f} ms  x{c:<6d} {k[:80]}")
        e2e["10b_s"] = time.perf_counter() - t_phase - e2e["10a_s"]

        # ---- 10c. the CLIs with the noisy pose file ----
        data_flags = ["--data_directory", data, "--image_extension", ".pgm"]
        base = data_flags + [
            "--num_disparities", str(NUM_DISP),
            "--dense_pcl_use_every_nth_image", str(USE_EVERY_NTH),
            "--center_easting", "0", "--center_northing", "0",
            "--delta_easting", str(MAP_CELLS * RESOLUTION),
            "--delta_northing", str(MAP_CELLS * RESOLUTION),
            "--resolution", str(RESOLUTION), "--interpolation_radius", "2",
            "--kernel_family", "pallas"]

        def path(name):
            return os.path.join(out, name)

        def cli(tag, mod, argv, expect):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.counted(tag, lambda: mod.main(argv), expect)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        tag = "main_refine_poses"
        run_s = cli(tag, main_refine_poses, data_flags + [
            "--filename_poses", "noisy_poses.txt",
            "--output_poses", path("refined.txt")], want())
        _q, t_cli, _m = load_poses(path("refined.txt"))
        local_cli = local_ate(t_cli, ts)
        check(np.median(local_cli) <= 0.5 * np.median(local0),
              f"10c {tag}: the median {LOCAL_SPAN}-frame aligned ATE "
              f"{np.median(local0):.4f} -> {np.median(local_cli):.4f} m")
        e2e[tag] = dict(
            run_s=run_s, launches=runs.launches[tag],
            ate_m=[ate(noisy, ts), ate(t_cli, ts)],
            aligned_ate_m=[ate_aligned(noisy, ts), ate_aligned(t_cli, ts)],
            local_aligned_ate_median_m=float(np.median(local_cli)))
        print(f"[10c {tag}] {run_s:.3f} s; ATE aligned "
              f"{e2e[tag]['aligned_ate_m'][0]:.4f} -> "
              f"{e2e[tag]['aligned_ate_m'][1]:.4f} m, unaligned "
              f"{e2e[tag]['ate_m'][0]:.4f} -> {e2e[tag]['ate_m'][1]:.4f} m; "
              f"{LOCAL_SPAN}-frame aligned ATE median "
              f"{np.median(local_cli):.4f} m", flush=True)

        # the maps the mapping CLIs make from the refined poses equal the
        # drivers run in process on 10b's refinement: the refinement
        # inside each CLI gave 10b's bits again
        qb, tb = camera_to_body_poses(disk.rig, q_ref, t_ref)
        refined = dataclasses.replace(disk, quats_G_B=qb, trans_G_B=tb)
        recs = {}
        for tag, mod, poses, extra, expect, driver in (
                ("main_dsm_true_poses", main_dsm, "opt_poses.txt", [],
                 want(bm_scan=pairs, binned_idw_cuda=1), None),
                ("main_dsm_noisy_poses", main_dsm, "noisy_poses.txt", [],
                 want(bm_scan=pairs, binned_idw_cuda=1), None),
                ("main_dsm_refine_poses", main_dsm, "noisy_poses.txt",
                 ["--refine_poses"],
                 want(bm_scan=pairs, binned_idw_cuda=1), batch.run_dsm),
                ("main_ortho_backward_grid_refine_poses",
                 main_ortho_backward_grid, "noisy_poses.txt",
                 ["--refine_poses", "--orthomosaic_jpg_filename",
                  path("o.pgm")],
                 want(bm_scan=pairs, binned_idw_cuda=1, score_pass_cuda=1),
                 batch.run_ortho_backward_grid)):
            npz = path(f"{tag}.npz")
            argv = base + ["--filename_poses", poses, *extra,
                           "--output_geotiff", path(f"{tag}.tif"),
                           "--output_layers_npz", npz]
            run_s = cli(tag, mod, argv, expect)
            saved, _g = load_layers(npz)
            layers = {k: torch.as_tensor(v, device=dev)
                      for k, v in saved.items()}
            if driver is not None:
                cfg_p = common.pipeline_config_from_args(mod.parse_args(argv))
                check(bit_equal_maps(layers, driver(refined, cfg_p,
                                                    device=dev)[0]),
                      f"10c {tag}: the map differs from the driver's on "
                      "10b's refined poses")
            elevation = layers["elevation"]
            hit = torch.isfinite(elevation)
            err = elevation[hit] - truth_h[hit]
            rec = dict(run_s=run_s, launches=runs.launches[tag],
                       dsm_coverage=hit.float().mean().item(),
                       dsm_median_abs_err_m=err.abs().median().item(),
                       dsm_rmse_m=err.pow(2).mean().sqrt().item())
            check(rec["dsm_coverage"] > 0.5,
                  f"10c {tag}: DSM coverage {rec['dsm_coverage']}")
            if mod is main_ortho_backward_grid:
                textured = torch.isfinite(layers["observation_index"])
                rec["ortho_coverage"] = textured.float().mean().item()
                check(rec["ortho_coverage"] > 0.5,
                      f"10c {tag}: ortho coverage {rec['ortho_coverage']}")
                rec["ortho_median_abs_err_gray"] = (
                    layers["ortho"][textured]
                    - truth_t[textured]).abs().median().item()
            recs[tag] = e2e[tag] = rec
            print(f"[10c {tag}] {run_s:.3f} s; launches {rec['launches']}; "
                  f"DSM coverage {rec['dsm_coverage']:.4f}, median |err| "
                  f"{rec['dsm_median_abs_err_m']:.4f} m, RMSE "
                  f"{rec['dsm_rmse_m']:.4f} m"
                  + (f"; ortho coverage {rec['ortho_coverage']:.4f}, median"
                     f" |err| {rec['ortho_median_abs_err_gray']:.3f} gray"
                     if "ortho_coverage" in rec else "")
                  + ("; equal to the driver on 10b's poses" if driver
                     else ""), flush=True)
        noisy_err = recs["main_dsm_noisy_poses"]["dsm_median_abs_err_m"]
        for tag in ("main_dsm_refine_poses",
                    "main_ortho_backward_grid_refine_poses"):
            got = recs[tag]["dsm_median_abs_err_m"]
            check(got <= 0.5 * noisy_err,
                  f"10c {tag}: median |DSM error| {got} m against "
                  f"{noisy_err} m with the noisy poses")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    e2e["phase_s"] = time.perf_counter() - t_phase
    print(f"[10 done] phase 10 took {e2e['phase_s']:.1f} s (10a "
          f"{e2e['10a_s']:.1f} s, 10b {e2e['10b_s']:.1f} s with the "
          "dataset's write)", flush=True)
    return e2e, runs.launches


# phase 11: the one-process mesh on logical shards of the one card
SHARDS = 8  # 11a's (pairs, tiles) = (2, 4) mesh
SHARD_TILES = 4  # 11c's tiles mesh and 11d's obs mesh
# 11a(i): a capacity of n_tiles x the fair share is the whole of n_loc:
# nothing can overflow; 11a(ii) runs the default factor
ROUTE_FACTOR_EXACT = 4.0
ROUTE_FACTOR_DEFAULT = 2.0


def logical_shards(n, dev):
    """``parallel/mesh.py::default_devices`` patched to ``n`` logical
    shards of ``dev`` (a context manager)."""
    from unittest import mock

    from aerial_mapper_tpu_torch.parallel import mesh as pmesh

    return mock.patch.object(pmesh, "default_devices",
                             lambda device_type="cuda": [dev] * n)


class FirstCall:
    """While entered, ``module.name`` is replaced by a proxy that keeps the
    arguments of its first ``keep`` calls once ``armed`` (from the start
    unless asked otherwise; ``args`` is the first) after the first
    ``skip`` calls, counts its calls in ``calls``, and forwards the call
    and every attribute (the wrapper's launch counters, which its body
    updates through the module's name) to the original."""

    def __init__(self, module, name, armed=True, keep=1, skip=0):
        self.module, self.name = module, name
        self.armed, self.keep, self.calls, self.kept = armed, keep, 0, []
        self.skip = skip

    @property
    def args(self):
        return self.kept[0] if self.kept else None

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)
        box = self

        class Proxy:
            def __call__(self, *a, **k):
                box.calls += 1
                if box.armed and box.calls > box.skip \
                        and len(box.kept) < box.keep:
                    box.kept.append((a, k))
                return orig(*a, **k)

            def __getattr__(self, key):
                return getattr(orig, key)

            def __setattr__(self, key, value):
                setattr(orig, key, value)

        setattr(self.module, self.name, Proxy())
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def counted_sharded_stream(runs, ds, cfg, shards, tag, dev, datasets=None,
                           sync_sites=None, **kw):
    """``run_incremental`` through its sharded driver, timed and counted by
    ``runs`` (a ``DriverRuns``) and held to the driver's calls: per fused
    step one BM and one IDW on each of the ``shards`` shards this process
    holds, per step and per ortho-only pass one score on each. With
    ``sync_sites`` (a dict) the host synchronizes are counted too, by
    line. (map, record: wall seconds, launches, fused steps, ortho-only
    passes, window reads, replays and their retries, the host
    synchronizes; the run's log records)."""
    from aerial_mapper_tpu_torch.pipeline import incremental as tinc

    def go():
        return run_logged(lambda: tinc.run_incremental(
            ds, cfg, update_every_nth=USE_EVERY_NTH, datasets=datasets,
            device=dev, **kw)[0])

    with FirstCall(tinc, "sharded_map_step") as steps, \
            FirstCall(tinc, "sharded_backward_grid_update") as rep, \
            FirstCall(tinc, "sharded_backward_grid_update_banded") \
            as banded, FirstCall(tinc, "_read_scalars") as reads:
        def expect():  # the driver's calls, read after the run
            n_step, n_ortho = steps.calls, rep.calls + banded.calls
            return runs.want(bm_scan=shards * n_step,
                             binned_idw_cuda=shards * n_step,
                             score_pass_cuda=shards * (n_step + n_ortho))

        if sync_sites is None:
            ((out, records), wall), syncs = runs.timed(tag, go, expect), None
        else:
            ((out, records), syncs), wall = runs.timed(
                tag, lambda: count_syncs(go, sync_sites), expect)
    msgs = [r.getMessage() for r in records]
    rec = dict(wall_s=wall, launches=runs.launches[tag],
               fused_steps=steps.calls,
               ortho_only_passes=rep.calls + banded.calls,
               window_reads=reads.calls,
               replays=sum("replaying" in m for m in msgs),
               replay_retries=sum("replay dropped" in m for m in msgs),
               host_syncs=syncs)
    return out, rec, records


def batch_drivers(ds, cfg, want, local, dev):
    """The batch drivers of phases 11c and 14a on the bench stream ``ds``
    (the plane sweep on its first PROFILE_FRAMES frames) with phase 7's
    config ``cfg``: {name: (fn(config, **outputs) -> result as a dict of
    tensors, config, launches of the one-device run, launches of the run on
    a SHARD_TILES-shard tiles mesh in a process that holds ``local`` of its
    shards)}. A shard runs its ring slots one pair per pass and one IDW and
    one score pass on its band; the sweep's z range comes from its 3-pair
    BM prepass, which every process runs whole."""
    import dataclasses

    from aerial_mapper_tpu_torch.config import PlaneSweepConfig
    from aerial_mapper_tpu_torch.pipeline import batch

    pairs = len(range(USE_EVERY_NTH - 1, NUM_IMAGES, USE_EVERY_NTH)) - 1
    slots = -(-pairs // SHARD_TILES) * local  # this process's ring slots
    n_p = PROFILE_FRAMES
    ds_p = dataclasses.replace(ds, quats_G_B=ds.quats_G_B[:n_p],
                               trans_G_B=ds.trans_G_B[:n_p],
                               images=ds.images[:n_p])
    sweep_cfg = dataclasses.replace(
        cfg, plane_sweep=PlaneSweepConfig(neighbor_spacing=USE_EVERY_NTH),
        stereo=dataclasses.replace(cfg.stereo, densifier="plane_sweep"))
    sgm_run = dataclasses.replace(
        cfg, stereo=dataclasses.replace(cfg.stereo, matcher="sgm"))

    def cloud(out):
        return dict(zip(("points", "intensities", "valid"), out))

    return {
        "run_ortho_backward_grid": (
            lambda c, **o: batch.run_ortho_backward_grid(
                ds, c, device=dev, **o)[0],
            cfg, want(bm_scan=pairs, binned_idw_cuda=1, score_pass_cuda=1),
            want(bm_scan=slots, binned_idw_cuda=local,
                 score_pass_cuda=local)),
        "run_dsm sgm": (
            lambda c, **o: batch.run_dsm(ds, c, device=dev, **o)[0],
            sgm_run, want(sgm_scan=8 * pairs, binned_idw_cuda=1),
            want(sgm_scan=8 * slots, binned_idw_cuda=local)),
        "run_dense_pcl": (
            lambda c, **o: cloud(batch.run_dense_pcl(ds, c, device=dev,
                                                     **o)),
            cfg, want(bm_scan=pairs), want(bm_scan=slots)),
        f"run_dense_pcl plane_sweep ({n_p} frames)": (
            lambda c, **o: cloud(batch.run_dense_pcl(ds_p, c, device=dev,
                                                     **o)),
            sweep_cfg, want(bm_scan=3), want(bm_scan=3)),
        "run_ortho_forward_homography": (
            lambda c, **o: {"mosaic": batch.run_ortho_forward_homography(
                ds, c, device=dev, **o)}, cfg, want(), want()),
    }


def shard_phase(w, bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg, counters, truth_h,
                truth_t, step_median_s, dev):
    """Phase 11: the one-process mesh (``parallel/``) on logical shards of
    the one card: ``parallel/mesh.py::default_devices`` patched to repeat
    ``cuda:0``. These times are the cost of sharding on one card (the
    shards' copies and launches run one after another), not a multi-GPU
    scaling figure.

    11a ``sharded_map_step`` over a (pairs, tiles) = (2, 4) mesh on phase
    4's operands (35 pairs padded to 40 with ``pad_ring_pairs``, the
    400x400 map in 4 bands of 100 rows): (i) the replicated images at
    route_capacity_factor 4.0 (the cap is n_loc: nothing can overflow),
    bit-equal to the one-device composition (pairs one per pass, DSM,
    backward grid); (ii) the slab-culled ``band_image_operands`` (the
    [395, 435] m slab of the JAX package's dry run, the stereo z filter
    on it on both sides) at the default factor 2.0: overflow, routed
    points per tile, subset sizes, ``diag.check``, and bit-equal where it
    passes. Launches counted (40 BM, 8 IDW, 8 score per step),
    timed against phase 4's step, peak memory. 11b: BM, IDW and score
    bit-equal to their plain versions on the operands of shard 0's first
    launch of each in 11a(i). 11c: four batch drivers on a 4-shard tiles
    mesh, each equal to its ``auto_shard=False`` run (bit for bit; the
    homography at atol 5e-3), counted. 11d ``sharded_bundle_adjust`` over
    an (obs,) mesh of 4 on phase 10a's problem padded with valid=False:
    within 5e-3 m / 1e-4 of ``bundle_adjust``, two runs bit-equal.
    Returns (e2e_shard, launches by run, max |err| of 11b by kernel, 11c's
    sharded results on the host by driver)."""
    import dataclasses

    from aerial_mapper_tpu_torch import parallel
    from aerial_mapper_tpu_torch.ba import (
        BAProblem,
        bundle_adjust,
        sharded_bundle_adjust,
    )
    from aerial_mapper_tpu_torch.config import BundleAdjustmentConfig
    from aerial_mapper_tpu_torch.dsm.idw import update_elevation_layer
    from aerial_mapper_tpu_torch.ortho import cuda_score
    from aerial_mapper_tpu_torch.ortho.backward_grid import (
        backward_grid_update,
    )
    from aerial_mapper_tpu_torch.parallel import sharded as tsh
    from aerial_mapper_tpu_torch.stereo import cuda_bm
    from aerial_mapper_tpu_torch.stereo.batched import (
        filter_points_z,
        process_pairs_batched,
    )

    cam, geom = w["cam"], w["geom"]
    Rs, ts = bench_poses()
    runs = DriverRuns(counters)
    want = runs.want
    e2e, errs = {}, {}
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0) if dev.type == "cuda" else dev

    # ---- 11a. the fused step over a (2, 4) mesh of logical shards ----
    with logical_shards(SHARDS, card):
        mesh = parallel.make_mesh(("pairs", "tiles"), shape=(2, SHARDS // 2))
    n_tiles = mesh.shape["tiles"]
    ring = tsh.pad_ring_pairs(tsh.prepare_ring_pair_operands(
        cam.K, Rs, ts, w["images"], use_every_nth=USE_EVERY_NTH, phase=0,
        device=dev), SHARDS)
    n_real = w["ops"].image1.shape[0]
    n_slots = ring.frames.shape[0]
    check(n_slots == -(-n_real // SHARDS) * SHARDS
          and ring.frames.shape[1:] == w["ops"].image1.shape[1:],
          f"11a: {n_real} pairs in {n_slots} ring slots")

    def single():
        pts, _i, valid = process_pairs_batched(w["ops"], cam, bm_cfg,
                                               device=dev, batch_chunk=1)
        layers = update_elevation_layer(dict(w["layers"]), pts.reshape(-1, 3),
                                        valid.reshape(-1), geom, dsm_cfg)
        return backward_grid_update(layers, w["quats"], w["ts"], w["images"],
                                    geom, cam, ortho_cfg)

    def step(banded, factor, **z):
        out, diag = tsh.sharded_map_step(
            tsh.shard_layers(w["layers"], mesh), ring, banded, geom, cam,
            dsm_cfg, ortho_cfg, mesh, bm_cfg=bm_cfg,
            route_capacity_factor=factor, **z)
        return tsh.unshard_layers(out, mesh, device=dev), diag

    def timed_runs(tag, fn, expect, reps=3):
        times = []
        for _ in range(reps):
            out, s = runs.timed(tag, fn, expect)
            times.append(s)
        return out, times

    one_dev = want(bm_scan=n_real, binned_idw_cuda=1, score_pass_cuda=1)
    per_step = want(bm_scan=n_slots, binned_idw_cuda=SHARDS,
                    score_pass_cuda=SHARDS)
    ref, single_s = timed_runs("11a one-device composition", single,
                               one_dev)
    replicated = tsh.replicated_band_images(w["quats"], w["ts"],
                                            w["images"], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    # the warm-up run keeps shard 0's first BM, IDW and score operands
    with FirstCall(cuda_bm, "bm_scan") as bm_op, \
            FirstCall(tsh, "binned_idw_cuda") as idw_op, \
            FirstCall(cuda_score, "score_pass_cuda") as score_op:
        (out, diag), warm_s = runs.timed(
            "11a(i) sharded_map_step",
            lambda: step(replicated, ROUTE_FACTOR_EXACT), per_step)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _o, step_s = timed_runs("11a(i) sharded_map_step",
                            lambda: step(replicated, ROUTE_FACTOR_EXACT),
                            per_step)
    diag.check()
    check(bit_equal_maps(out, ref),
          "11a(i): the sharded step differs from the one-device "
          "composition")
    bars = map_bars("11a(i)", out, truth_h, truth_t)
    routed_i = diag.routed.tolist()
    n_valid = int(sum(routed_i))
    hw = ring.frames.shape[1] * ring.frames.shape[2]
    cap_i = tsh.route_capacity(n_slots, hw, 2, n_tiles, ROUTE_FACTOR_EXACT)
    e2e["11a_replicated"] = dict(
        mesh=mesh.shape, pairs=n_real, slots=n_slots,
        route_capacity_factor=ROUTE_FACTOR_EXACT, route_capacity=cap_i,
        overflow=int(diag.overflow), routed_per_tile=routed_i,
        elev_range=[float(diag.elev_min), float(diag.elev_max)],
        warmup_s=warm_s, step_s=step_s,
        step_median_s=float(np.median(step_s)),
        one_device_s=single_s,
        one_device_median_s=float(np.median(single_s)),
        phase4_step_median_s=step_median_s,
        peak_mem_gib=peak_gib, held_before_gib=base_gib,
        launches_per_step=runs.launches["11a(i) sharded_map_step"],
        bit_equal=True, **bars)
    print(f"[11a(i) sharded_map_step] {mesh.shape} mesh on {SHARDS} logical "
          f"shards of {card}: {n_real} pairs in "
          f"{n_slots} ring slots, replicated images, factor "
          f"{ROUTE_FACTOR_EXACT} (cap {cap_i} = n_loc): overflow "
          f"{int(diag.overflow)}, routed per tile {routed_i} ({n_valid} "
          f"valid points); every layer bit-equal to the one-device "
          f"composition; step median {np.median(step_s):.4f} s of "
          f"{step_s} (one-device composition {np.median(single_s):.4f} s, "
          f"phase 4's step {step_median_s:.4f} s); peak {peak_gib:.2f} GiB; "
          f"launches per step {runs.launches['11a(i) sharded_map_step']}",
          flush=True)
    del out

    # 11a(ii): the slab-culled subsets at the default capacity factor. The
    # slab is the JAX package's dryrun_multichip's; the stereo z filter
    # keeps the cloud inside it (BM outliers reach ~95 m at the bench), so
    # every IDW value, a convex combination of in-slab points, is too
    z_lo, z_hi = 395.0, 435.0

    def single_z():
        pts, _i, valid = process_pairs_batched(w["ops"], cam, bm_cfg,
                                               device=dev, batch_chunk=1)
        valid = filter_points_z(pts, valid, z_lo, z_hi)
        layers = update_elevation_layer(dict(w["layers"]), pts.reshape(-1, 3),
                                        valid.reshape(-1), geom, dsm_cfg)
        return backward_grid_update(layers, w["quats"], w["ts"], w["images"],
                                    geom, cam, ortho_cfg)

    ref_z, _s = runs.timed("11a one-device composition, z filter",
                           single_z, one_dev)
    banded = tsh.band_image_operands(
        geom, n_tiles, w["quats"].cpu().numpy(), w["ts"].cpu().numpy(),
        w["images"], cam, elev_min=z_lo, elev_max=z_hi, device=dev)
    subsets = (banded.ids >= 0).sum(dim=1).tolist()
    (out, diag), culled_s = runs.timed(
        "11a(ii) sharded_map_step culled",
        lambda: step(banded, ROUTE_FACTOR_DEFAULT, z_min=z_lo, z_max=z_hi),
        per_step)
    cap_ii = tsh.route_capacity(n_slots, hw, 2, n_tiles,
                                ROUTE_FACTOR_DEFAULT)
    try:
        diag.check(z_lo, z_hi)
        clean, why = True, None
    except RuntimeError as e:  # reported; the bit-equality is then void
        clean, why = False, str(e)
    if clean:
        check(bit_equal_maps(out, ref_z),
              "11a(ii): diag.check passed but the culled step differs "
              "from the one-device composition")
    e2e["11a_culled"] = dict(
        route_capacity_factor=ROUTE_FACTOR_DEFAULT, route_capacity=cap_ii,
        overflow=int(diag.overflow), routed_per_tile=diag.routed.tolist(),
        elev_range=[float(diag.elev_min), float(diag.elev_max)],
        slab=[z_lo, z_hi], z_filter=[z_lo, z_hi], subset_sizes=subsets,
        images=int(w["images"].shape[0]), run_s=culled_s,
        check_passed=clean, check_message=why, bit_equal=clean)
    print(f"[11a(ii) culled] slab and z filter [{z_lo}, {z_hi}] m: images "
          f"per band {subsets} of {w['images'].shape[0]}; factor "
          f"{ROUTE_FACTOR_DEFAULT} (cap {cap_ii}): overflow "
          f"{int(diag.overflow)}, routed per tile {diag.routed.tolist()}, "
          f"elevations [{float(diag.elev_min):.3f}, "
          f"{float(diag.elev_max):.3f}]; diag.check "
          f"{'passed: every layer bit-equal' if clean else why}"
          f"; run {culled_s:.4f} s", flush=True)
    del out, banded, replicated, ref_z

    # ---- 11b. each kernel on shard 0's operands of 11a(i) ----
    (lf, rf, n_disp, d_min, block), _k = bm_op.args
    errs["bm_scan"] = bm_check("11b bm_scan, shard 0's first pair", lf, rf,
                               n_disp, d_min, block, True)
    (binned, ext), kw = idw_op.args
    errs["binned_idw_cuda"] = idw_check(
        "11b binned_idw, tile 0's band", binned, ext, dsm_cfg,
        kw["adaptive"], kw["max_radius_sq"])
    (cells, bank, _cam), kw = score_op.args
    sc = score_check("11b score_pass, tile 0's band", cells, bank,
                     kw["grid_shape"], cam)
    errs["score_pass_cuda"] = sc["max_abs_err"]
    e2e["11b"] = dict(bm_shape=list(lf.shape), idw_shape=list(ext[3:5]),
                      score_cells=sc["cells"], score_cameras=sc["cameras"],
                      score_kept_share=sc["kept_share"], bit_equal=True)
    del bm_op, idw_op, score_op, lf, rf, binned, cells, bank

    # ---- 11c. the batch drivers on a 4-shard tiles mesh ----
    cfg = batch_config(w, bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg)
    ds = bench_dataset(cam, w["images"].cpu().numpy())
    drivers = batch_drivers(ds, cfg, want, SHARD_TILES, dev)
    e2e["11c"] = {}
    maps_11c = {}
    for name, (fn, run_cfg, one, sharded) in drivers.items():
        single_out, s1 = runs.timed(
            f"11c {name} one device",
            lambda: fn(dataclasses.replace(run_cfg, auto_shard=False)), one)
        with logical_shards(SHARD_TILES, card):
            (sh_out, s_sh), logs = run_logged(lambda: runs.timed(
                f"11c {name} sharded", lambda: fn(run_cfg), sharded))
        sharded_logs = [r.getMessage() for r in logs
                        if "sharded" in r.getMessage()]
        check(sharded_logs, f"11c {name}: the driver logged no sharding")
        if name == "run_ortho_forward_homography":
            a, b = sh_out["mosaic"], single_out["mosaic"]
            err = (a - b).abs().max().item()
            check(err <= 5e-3, f"11c {name}: |sharded - one device| {err}")
            verdict = f"max |diff| {err:.3g} <= 5e-3"
        else:
            check(bit_equal_maps(sh_out, single_out),
                  f"11c {name}: the sharded run differs from the "
                  "auto_shard=False run")
            err, verdict = 0.0, "bit-equal"
        e2e["11c"][name] = dict(
            one_device_s=s1, sharded_s=s_sh, max_abs_diff=err,
            launches_one_device=runs.launches[f"11c {name} one device"],
            launches_sharded=runs.launches[f"11c {name} sharded"],
            log=sharded_logs)
        print(f"[11c {name}] {SHARD_TILES} logical shards: {verdict} to "
              f"the auto_shard=False run; {s_sh:.3f} s sharded vs "
              f"{s1:.3f} s; launches {runs.launches[f'11c {name} sharded']}"
              f" vs {runs.launches[f'11c {name} one device']}; "
              f"{sharded_logs}", flush=True)
        # phase 14 holds the runs across processes to these bits
        maps_11c[name] = {k: v.cpu() for k, v in sh_out.items()}
        del single_out, sh_out

    # ---- 11d. sharded_bundle_adjust over an (obs,) mesh of 4 ----
    state, problem, _ts_true = bench_torch.ba_problem(
        w["cam"], w["scene"], *bench_poses(), dev)
    m = int(problem.cam_idx.shape[0])
    pad = (-m) % SHARD_TILES
    problem = BAProblem(
        cam_idx=torch.cat([problem.cam_idx,
                           problem.cam_idx.new_zeros(pad)]),
        lm_idx=torch.cat([problem.lm_idx, problem.lm_idx.new_zeros(pad)]),
        uv=torch.cat([problem.uv, problem.uv.new_zeros((pad, 2))]),
        valid=torch.cat([problem.valid, problem.valid.new_zeros(pad)]))
    ba_cfg = BundleAdjustmentConfig(max_iterations=10)
    obs_mesh = parallel.make_mesh(("obs",), devices=[card] * SHARD_TILES)

    def solve_sharded():
        out = sharded_bundle_adjust(state, problem, cam, ba_cfg, obs_mesh)
        torch.cuda.synchronize()
        return out

    one, ba_s = runs.timed("11d bundle_adjust", lambda: bundle_adjust(
        state, problem, cam, ba_cfg, device=dev), want())
    sh1, sh_s = runs.timed("11d sharded_bundle_adjust", solve_sharded,
                           want())
    sh2, sh_s2 = runs.timed("11d sharded_bundle_adjust", solve_sharded,
                            want())
    check(all(torch.equal(a, b) for a, b in zip(sh1, sh2)),
          "11d: two sharded solves differ")
    d_t = (sh1.trans - one.trans).abs().max().item()
    d_q = (sh1.quats - one.quats).abs().max().item()
    check(d_t <= 5e-3 and d_q <= 1e-4,
          f"11d: sharded vs one device trans {d_t} m, quats {d_q}")
    e2e["11d"] = dict(observations=m, padded=pad, shards=SHARD_TILES,
                      one_device_s=ba_s, sharded_s=[sh_s, sh_s2],
                      max_abs_trans_m=d_t, max_abs_quat=d_q,
                      bit_equal_runs=True)
    print(f"[11d sharded_bundle_adjust] {m} observations + {pad} padding "
          f"over {SHARD_TILES} logical shards: trans within {d_t:.3g} m, "
          f"quats within {d_q:.3g} of bundle_adjust (bars 5e-3 / 1e-4); "
          f"two runs bit-equal; {sh_s:.3f} / {sh_s2:.3f} s vs {ba_s:.3f} s "
          "on one device", flush=True)
    e2e["phase_s"] = time.perf_counter() - t_phase
    print(f"[11 done] phase 11 took {e2e['phase_s']:.1f} s", flush=True)
    return e2e, runs.launches, errs, maps_11c


# phase 12: the sharded incremental driver on logical shards of the card
STREAM_SHARDS = 8  # a (pairs, tiles) = (1, 8) mesh, as the driver builds
PAYLOAD_FRAMES = 70  # 12d's on_update run: the first 10 updates


def stream_shard_phase(w, bm_cfg, dsm_cfg, ortho_cfg, counters, one_map,
                       phase6_median_s, dev):
    """Phase 12: ``run_incremental`` with ``auto_shard`` over 8 logical
    shards of the card (``default_devices`` patched to repeat ``cuda:0``),
    on phase 6's stream (249 frames, an update every 7th: 35 updates) and
    config: the sharded driver (``pipeline/incremental.py::
    _run_incremental_sharded``) on a (pairs, tiles) = (1, 8) mesh, each
    update one fused ``sharded_map_step`` (the pair padded to 8 ring
    slots, the map in 8 bands of 50 rows), the images culled per band
    against the tracked slab and validated once per window. Every run's
    launches are counted (counters set to 0 just before, read just after)
    and held to the driver's calls: 8 BM and 8 IDW per fused step, 8
    score per step and per ortho-only pass. 12a the defaults
    (``cull_images``, ``check_every=8``, ``slab_margin_m=20``): a warm run
    with sync counting and the cull's band sizes recorded, then 2 timed
    runs; every map bit-equal to phase 6's one-device map. 12b
    ``slab_margin_m=-0.5``: a slab violation replayed, bit-equal. 12c
    ``route_capacity_factor=0.2``: the overflow recovered, bit-equal. 12d
    ``on_update`` on the first 70 frames: every deferred payload host
    numpy and bit-equal to the one-device payload of its update. 12e BM,
    IDW and score bit-equal to their plain versions on shard 0's operands
    of a CULLED update. 12f the native image loader: available or not; if
    it is, ``backend="native"`` equal to ``"pil"`` on the bench frames as
    PGM, both timed. Returns (e2e_stream_shard, launches by run, max |err|
    of 12e by kernel)."""
    import dataclasses
    import shutil
    import tempfile

    from aerial_mapper_tpu_torch.io import images as timg
    from aerial_mapper_tpu_torch.io.native_loader import (
        native_loader_available,
    )
    from aerial_mapper_tpu_torch.ortho import cuda_score
    from aerial_mapper_tpu_torch.parallel import sharded as tsh
    from aerial_mapper_tpu_torch.pipeline import incremental as tinc
    from aerial_mapper_tpu_torch.stereo import cuda_bm
    from aerial_mapper_tpu_torch.utils.timing import STAGE_LOG

    cam = w["cam"]
    host_images = w["images"].cpu().numpy()
    full = bench_dataset(cam, host_images)
    cfg = stream_config(bm_cfg, dsm_cfg, ortho_cfg)  # auto_shard on
    check(cfg.auto_shard, "12: auto_shard is off by default")
    card = torch.device("cuda", 0) if dev.type == "cuda" else dev
    n_updates = len(range(USE_EVERY_NTH - 1, NUM_IMAGES, USE_EVERY_NTH))
    check_every = 8
    e2e, errs, runs = {}, {}, DriverRuns(counters)
    t_phase = time.perf_counter()

    def sharded_run(tag, ds=full, record=False, **kw):
        """One sharded run, counted: (map, record of the run). The
        launches must be the driver's calls' (8 BM and 8 IDW per fused
        step, 8 score per step and per ortho-only pass); ``record`` also
        keeps the cull's band sizes and counts the synchronizes."""
        bands, sites = [], {}
        real_band = tinc.band_image_operands

        def band_rec(*a, **k):
            banded = real_band(*a, **k)
            bands.append(banded.ids)  # read after the run: no sync here
            return banded

        with logical_shards(STREAM_SHARDS, card):
            tinc.band_image_operands = band_rec
            try:
                out, rec, records = counted_sharded_stream(
                    runs, ds, cfg, STREAM_SHARDS, tag, dev,
                    sync_sites=sites if record else None, **kw)
            finally:
                tinc.band_image_operands = real_band
        msgs = [r.getMessage() for r in records]
        final = [m for m in msgs if m.startswith("incremental (sharded")]
        check(len(final) == 1 and f"over {STREAM_SHARDS} devices" in final[0],
              f"{tag}: the sharded driver's last line is missing: {final}")
        hit = re.search(r"final cull slab (.*), route_capacity_factor "
                        r"([0-9.]+)", final[0])
        step_ms = [r.args[1] * 1e3 for r in records
                   if r.msg == STAGE_LOG and r.args[0] == "incremental_step"]
        rec.update(
            warnings=[m for m in msgs if "window" in m],
            final_slab=hit.group(1), final_capacity_factor=float(
                hit.group(2)),
            step_ms_median=float(np.median(step_ms)) if step_ms else None)
        if record:
            sizes = [c for ids in bands if ids.dim() == 2
                     for c in (ids >= 0).sum(dim=1).tolist()]
            rec["culled_updates"] = sum(ids.dim() == 2 for ids in bands)
            rec["band_capacity"] = sorted({int(ids.shape[-1])
                                           for ids in bands})
            rec["images_per_band"] = (
                dict(min=min(sizes), mean=float(np.mean(sizes)),
                     max=max(sizes)) if sizes else None)
            rec["sync_sites"] = dict(sorted(sites.items(),
                                            key=lambda kv: -kv[1])[:10])
        return out, rec

    # ---- 12a. the defaults: warm run (recorded), then 2 timed ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    out, warm = sharded_run("12a sharded_incremental", record=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bit_equal_maps(out, one_map), "12a: the sharded map differs from "
          "phase 6's one-device map")
    check(warm["window_reads"] == -(-n_updates // check_every)
          + warm["replays"] + warm["replay_retries"],
          f"12a: {warm['window_reads']} window reads")
    timed = []
    for k in range(2):
        out, rec = sharded_run("12a sharded_incremental")
        check(bit_equal_maps(out, one_map),
              f"12a: timed run {k} differs from phase 6's map")
        timed.append(rec)
    # the one-device run's synchronizes, for comparison
    one_cfg = dataclasses.replace(cfg, auto_shard=False)
    one_sites = {}
    (_o, one_syncs) = count_syncs(lambda: (tinc.run_incremental(
        full, one_cfg, update_every_nth=USE_EVERY_NTH, device=dev),
        torch.cuda.synchronize()), one_sites)
    walls = [r["wall_s"] for r in timed]
    e2e["12a"] = dict(
        shards=STREAM_SHARDS, updates=n_updates, check_every=check_every,
        windows=-(-n_updates // check_every), warm=warm,
        timed_wall_s=walls, median_wall_s=float(np.median(walls)),
        phase6_streaming_median_s=phase6_median_s,
        one_device_host_syncs=one_syncs,
        one_device_sync_sites=dict(sorted(one_sites.items(),
                                          key=lambda kv: -kv[1])[:10]),
        peak_mem_gib=peak_gib,
        held_before_gib=base_gib, bit_equal=True)
    print(f"[12a sharded incremental] {n_updates} updates on "
          f"{STREAM_SHARDS} logical shards of {card}: bit-equal to phase "
          f"6's map in every run; wall {np.median(walls):.4f} s median of "
          f"{walls} (warm {warm['wall_s']:.4f} s; phase 6 one device "
          f"{phase6_median_s:.4f} s); launches per run {warm['launches']} "
          f"({warm['fused_steps']} fused steps, "
          f"{warm['ortho_only_passes']} ortho-only passes); "
          f"{e2e['12a']['windows']} windows, {warm['window_reads']} window "
          f"reads, {warm['replays']} replays ({warm['replay_retries']} "
          f"retries) {warm['warnings']}; final slab {warm['final_slab']}, "
          f"capacity factor {warm['final_capacity_factor']}; images per "
          f"band over {warm['culled_updates']} culled updates "
          f"{warm['images_per_band']} (capacity {warm['band_capacity']}); "
          f"host synchronizes {warm['host_syncs']} (one device "
          f"{one_syncs}); incremental_step median {warm['step_ms_median']}"
          f" ms; peak {peak_gib:.3f} GiB", flush=True)
    print(f"[12a synchronizes] sharded run by line {warm['sync_sites']}; "
          f"one device {e2e['12a']['one_device_sync_sites']}", flush=True)

    # ---- 12b / 12c. the replay paths: bit-equal ----
    for tag, kw, cause in (
            ("12b slab violation", dict(slab_margin_m=-0.5),
             r"overflow=0, slab \("),
            ("12c overflow", dict(route_capacity_factor=0.2),
             r"overflow=[1-9]")):
        out, rec = sharded_run(tag, **kw)
        check(rec["replays"] > 0
              and any(re.search(cause, m) for m in rec["warnings"]),
              f"{tag}: no replay for its cause was logged: "
              f"{rec['warnings']}")
        check(bit_equal_maps(out, one_map),
              f"{tag}: the replayed map differs from phase 6's map")
        e2e[tag.split()[0]] = dict(kw=kw, **rec, bit_equal=True)
        print(f"[{tag}] {kw}: {rec['replays']} replays "
              f"({rec['replay_retries']} retries), final slab "
              f"{rec['final_slab']}, capacity factor "
              f"{rec['final_capacity_factor']}, {rec['fused_steps']} fused "
              f"steps; bit-equal to phase 6's map; {rec['wall_s']:.3f} s; "
              f"{rec['warnings'][:3]}", flush=True)
    del out

    # ---- 12d. deferred payloads: host numpy, equal per update ----
    part = bench_dataset(cam, host_images, PAYLOAD_FRAMES)
    payloads, single = {}, {}
    sharded_run("12d payloads", ds=part,
                on_update=lambda i, ls, g: payloads.update({i: ls}))
    tinc.run_incremental(part, one_cfg, update_every_nth=USE_EVERY_NTH,
                         device=dev, on_update=lambda i, ls, g: single.update(
                             {i: {k: v.clone() for k, v in ls.items()}}))
    check(sorted(payloads) == sorted(single) and len(payloads) == 10,
          f"12d: payload updates {sorted(payloads)} vs {sorted(single)}")
    for i, ls in payloads.items():
        check(all(isinstance(v, np.ndarray) for v in ls.values()),
              f"12d: update {i}'s payload is not host numpy")
        check(bit_equal_maps({k: torch.as_tensor(v) for k, v in ls.items()},
                             {k: v.cpu() for k, v in single[i].items()}),
              f"12d: update {i}'s payload differs from the one-device one")
    e2e["12d"] = dict(frames=PAYLOAD_FRAMES, payloads=len(payloads),
                      host_numpy=True, bit_equal=True)
    print(f"[12d payloads] {len(payloads)} deferred payloads over "
          f"{PAYLOAD_FRAMES} frames: host numpy, each bit-equal to the "
          "one-device payload of its update", flush=True)
    del payloads, single

    # ---- 12e. the kernels on the band operands of a culled update ----
    # windows of 1 update over 4 updates: the slab is set after the first
    # stereo update that reaches the map, and every update after it is
    # culled; the band proxy arms the captures at the first culled update,
    # whose next 8 calls of each kernel are the shards' in order. BM on
    # shard 0's pair (the real one: the others are padding slots), IDW on
    # the band with the most occupied slots, score on the band with the
    # most culled images (then the most slots)
    with FirstCall(cuda_bm, "bm_scan", armed=False) as bm_op, \
            FirstCall(tsh, "binned_idw_cuda", armed=False,
                      keep=STREAM_SHARDS) as idw_op, \
            FirstCall(cuda_score, "score_pass_cuda", armed=False,
                      keep=STREAM_SHARDS) as score_op, \
            logical_shards(STREAM_SHARDS, card):
        real_band = tinc.band_image_operands
        culled = []

        def arm(*a, **k):
            banded = real_band(*a, **k)
            culled.append((banded.ids >= 0).sum(dim=1))
            for op in (bm_op, idw_op, score_op):
                op.armed = True
            return banded

        tinc.band_image_operands = arm
        try:
            tinc.run_incremental(
                bench_dataset(cam, host_images, 4 * USE_EVERY_NTH), cfg,
                update_every_nth=USE_EVERY_NTH, device=dev, check_every=1)
        finally:
            tinc.band_image_operands = real_band
    check(culled and bm_op.args and len(idw_op.kept) == STREAM_SHARDS
          and len(score_op.kept) == STREAM_SHARDS,
          f"12e: {len(culled)} culled updates; operands captured "
          f"{[len(op.kept) for op in (bm_op, idw_op, score_op)]}")
    (lf, rf, n_disp, d_min, block), _k = bm_op.args
    errs["bm_scan"] = bm_check("12e bm_scan, shard 0's pair", lf, rf,
                               n_disp, d_min, block, True)
    occupied = [int(torch.clamp(a[0].count, max=dsm_cfg.bin_capacity)
                    .sum().item()) for a, _k in idw_op.kept]
    images = culled[0].tolist()
    k_idw = max(range(STREAM_SHARDS), key=lambda b: occupied[b])
    k_sc = max(range(STREAM_SHARDS), key=lambda b: (images[b], occupied[b]))
    (binned, ext), kw = idw_op.kept[k_idw]
    errs["binned_idw_cuda"] = idw_check(
        f"12e binned_idw, band {k_idw}", binned, ext, dsm_cfg,
        kw["adaptive"], kw["max_radius_sq"])
    (cells, bank, _cam), kw = score_op.kept[k_sc]
    sc = score_check(f"12e score_pass, band {k_sc} culled", cells, bank,
                     kw["grid_shape"], cam)
    check(sc["visible_share"] > 0,
          f"12e: band {k_sc}'s score operands see no camera")
    errs["score_pass_cuda"] = sc["max_abs_err"]
    e2e["12e"] = dict(images_per_band=images, occupied_slots=occupied,
                      idw_band=k_idw, score_band=k_sc,
                      bm_shape=list(lf.shape), idw_shape=list(ext[3:5]),
                      score_cells=sc["cells"], score_cameras=sc["cameras"],
                      score_kept_share=sc["kept_share"],
                      score_visible_share=sc["visible_share"],
                      bit_equal=True)
    print(f"[12e kernels] on the first culled update (images per band "
          f"{images}, occupied IDW slots {occupied}): BM on shard 0's pair "
          f"{list(lf.shape)}, IDW on band {k_idw} {list(ext[3:5])}, score "
          f"on band {k_sc}: {sc['cells']} cells x {sc['cameras']} cameras: "
          "each bit-equal to its plain version", flush=True)
    del bm_op, idw_op, score_op, lf, rf, binned, cells, bank

    # ---- 12f. the native image loader ----
    available = native_loader_available()
    rec = dict(available=available)
    if available:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_native_")
        try:
            for i, im in enumerate(host_images):
                timg.save_image(os.path.join(tmp, f"image_{i}.pgm"), im)
            times, frames = {}, {}
            for backend in ("native", "pil"):
                t0 = time.perf_counter()
                frames[backend] = timg.load_images_by_prefix(
                    os.path.join(tmp, "image_"), NUM_IMAGES,
                    extension=".pgm", backend=backend)
                times[backend] = time.perf_counter() - t0
            check(all(np.array_equal(a, b) for a, b in
                      zip(frames["native"], frames["pil"])),
                  "12f: the native loader differs from the pil path")
            rec.update(frames=NUM_IMAGES, native_s=times["native"],
                       pil_s=times["pil"], equal=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    e2e["12f"] = rec
    print(f"[12f native loader] {rec}", flush=True)
    e2e["phase_s"] = time.perf_counter() - t_phase
    print(f"[12 done] phase 12 took {e2e['phase_s']:.1f} s", flush=True)
    return e2e, runs.launches, errs


DIST_RANKS = 2  # phase 13's worker processes
DIST_SHARDS = 4  # logical shards of the card in each worker
DIST_TIMEOUT_S = 240.0  # the process group's limit on every wait
DIST_WORKER_TIMEOUT_S = 420.0  # the parent's limit on a worker


def sync(dev):
    """Wait for ``dev``'s work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_workers(work, tag, extra, dev, script=__file__, ranks=DIST_RANKS,
                timeout_s=DIST_WORKER_TIMEOUT_S):
    """Spawn ``ranks`` worker processes of ``script`` (``--dist-worker R
    --dist-dir work --dist-device`` and ``extra``, ``LOCAL_RANK=R`` in
    their environment), each logging to ``work/rank{R}.log``; wait for
    all of them, at most ``timeout_s`` in all, print the end of each log
    and stop any that still runs: (exit codes, seconds)."""
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(ranks):
            logs.append(open(os.path.join(work, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(script), "--dist-worker",
                 str(r), "--dist-dir", work, "--dist-device", dev.type]
                + extra, stdout=logs[-1], stderr=subprocess.STDOUT,
                env=dict(os.environ, LOCAL_RANK=str(r)),
                cwd=os.path.dirname(os.path.abspath(__file__))))
        codes = []
        try:
            for p in procs:
                codes.append(p.wait(timeout=max(
                    1.0, t0 + timeout_s - time.perf_counter())))
        finally:
            for r in range(ranks):
                with open(os.path.join(work, f"rank{r}.log")) as f:
                    tail = f.read()[-3000:]
                print(f"[{tag} rank {r} log] ...{tail}", flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return codes, time.perf_counter() - t0


def dist_step(w, cfgs, mesh, dev):
    """Phase 11a(i)'s ``sharded_map_step`` (phase 4's pairs padded to the
    shard count, replicated images) on ``mesh``, at a route capacity
    factor of the tile count (the cap is n_loc: nothing can overflow):
    (whole layers on this rank, diagnostics)."""
    from aerial_mapper_tpu_torch.parallel import sharded as tsh

    bm_cfg, dsm_cfg, ortho_cfg = cfgs
    cam = w["cam"]
    Rs, ts = bench_poses()
    ring = tsh.pad_ring_pairs(tsh.prepare_ring_pair_operands(
        cam.K, Rs, ts, w["images"], use_every_nth=USE_EVERY_NTH, phase=0,
        device=dev), mesh.size)
    replicated = tsh.replicated_band_images(w["quats"], w["ts"],
                                            w["images"], device=dev)
    out, diag = tsh.sharded_map_step(
        tsh.shard_layers(w["layers"], mesh), ring, replicated, w["geom"],
        cam, dsm_cfg, ortho_cfg, mesh, bm_cfg=bm_cfg,
        route_capacity_factor=float(mesh.shape["tiles"]))
    return tsh.unshard_layers(out, mesh, device=dev), diag


def group_run(fn, dev):
    """``fn()`` -> (result, record) on a rank of a process group, after a
    barrier; the record gains the exchanges, the bytes and the host
    seconds through the group (``parallel/collectives.py::traffic``) and
    the peak memory."""
    import torch.distributed as dist

    from aerial_mapper_tpu_torch.parallel import collectives as cl

    cl.traffic.update(exchanges=0, bytes=0, seconds=0.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    out, rec = fn()
    rec.update(exchanges=cl.traffic["exchanges"],
               bytes_sent=cl.traffic["bytes"],
               exchange_s=cl.traffic["seconds"],
               peak_mem_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if dev.type == "cuda" else None))
    return out, rec


def dist_worker(rank, work, device):
    """Phase 13's worker: rank ``rank`` of a Gloo group of DIST_RANKS
    processes (``file://`` rendezvous in ``work``), each holding
    DIST_SHARDS logical shards of the card (``default_devices`` patched),
    on the inputs the parent wrote to ``work/inputs.npz``. Writes
    ``work/rank{rank}.json`` (its records) and ``work/rank{rank}.npz``
    (the maps, for the parent to check); any failed check raises."""
    import torch.distributed as dist

    from aerial_mapper_tpu_torch.dsm.cuda_idw import binned_idw_cuda
    from aerial_mapper_tpu_torch.ortho.cuda_score import score_pass_cuda
    from aerial_mapper_tpu_torch.parallel import distributed as tdist
    from aerial_mapper_tpu_torch.parallel import make_mesh
    from aerial_mapper_tpu_torch.parallel import sharded as tsh
    from aerial_mapper_tpu_torch.stereo.batched import process_pairs_batched
    from aerial_mapper_tpu_torch.stereo.cuda_bm import bm_scan
    from aerial_mapper_tpu_torch.stereo.cuda_sgm import sgm_scan

    global NUM_IMAGES, IMG_H, IMG_W, MAP_CELLS
    # the ranks share the host's cores: oversubscribed host threads spin
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // DIST_RANKS))
    dev = torch.device(device)
    card = torch.device("cuda", 0) if dev.type == "cuda" else dev
    inputs = np.load(os.path.join(work, "inputs.npz"))
    NUM_IMAGES, IMG_H, IMG_W, MAP_CELLS = map(int, inputs["meta"])
    one_map = {k.split("/", 1)[1]: torch.as_tensor(inputs[k])
               for k in inputs.files if k.startswith("one_map/")}
    tdist.initialize_distributed(
        f"file://{work}/rendezvous", num_processes=DIST_RANKS,
        process_id=rank, backend="gloo", timeout_s=DIST_TIMEOUT_S)
    host_u8 = inputs["images"]
    w = build_workload(dev, images=torch.as_tensor(host_u8, device=dev)
                       .float())
    cfgs = smoke_configs()[:3]
    bm_cfg, dsm_cfg, ortho_cfg = cfgs
    cam, geom = w["cam"], w["geom"]
    # the plain versions on the CPU count no launch
    runs = DriverRuns((bm_scan, binned_idw_cuda, score_pass_cuda, sgm_scan),
                      sync=lambda: sync(dev), counting=dev.type == "cuda")
    want = runs.want

    n = DIST_RANKS * DIST_SHARDS
    mine = list(range(rank * DIST_SHARDS, (rank + 1) * DIST_SHARDS))
    rec, maps = dict(rank=rank), {}
    t_phase = time.perf_counter()
    with logical_shards(DIST_SHARDS, card):
        # ---- 13a. sharded_dsm_update on an (8,) tiles mesh ----
        pts, _i, valid = process_pairs_batched(w["ops"], cam, bm_cfg,
                                               device=dev)
        tiles = make_mesh(("tiles",), shape=(n,))
        check(tiles.spans_processes and tiles.local_shards() == mine,
              f"13a rank {rank}: local shards {tiles.local_shards()}")

        def dsm():
            bands = tsh.shard_layers(
                {"elevation": w["layers"]["elevation"]}, tiles)
            return tsh.sharded_dsm_update(
                bands["elevation"], pts.reshape(-1, 3), valid.reshape(-1),
                geom, dsm_cfg, tiles)

        elev = runs.counted("13a", dsm, want(binned_idw_cuda=DIST_SHARDS))
        maps["13a/elevation"] = tsh.unshard_layers(
            {"e": elev}, tiles)["e"].cpu().numpy()
        gathered = tdist.gather_row_bands_to_host(elev, tiles)
        check((gathered is None) == (rank != 0),
              f"13a rank {rank}: gather_row_bands_to_host gave "
              f"{type(gathered).__name__}")
        if gathered is not None:
            check(np.array_equal(gathered, maps["13a/elevation"],
                                 equal_nan=True),
                  "13a: rank 0's gathered DSM differs from its unsharded")
        rec["13a"] = dict(launches=runs.launches["13a"])
        del pts, valid, elev
        print(f"[13a rank {rank}] {time.perf_counter() - t_phase:.1f} s",
              flush=True)

        # ---- 13b. sharded_map_step on (1, 8) and (2, 4) ----
        per_shard = -(-w["ops"].image1.shape[0] // n)  # ring slots each
        for tag, shape in (("13b (1, 8)", (1, 8)), ("13b (2, 4)", (2, 4))):
            mesh = make_mesh(("pairs", "tiles"), shape=shape)
            dist.barrier()
            sync(dev)
            t0 = time.perf_counter()
            out, diag = runs.counted(
                tag, lambda: dist_step(w, cfgs, mesh, dev),
                want(bm_scan=per_shard * DIST_SHARDS,
                     binned_idw_cuda=DIST_SHARDS,
                     score_pass_cuda=DIST_SHARDS))
            sync(dev)
            diag.check()
            rec[tag] = dict(mesh=mesh.shape, launches=runs.launches[tag],
                            wall_s=time.perf_counter() - t0,
                            overflow=int(diag.overflow),
                            routed_per_tile=diag.routed.tolist())
            maps.update({f"{tag}/{k}": v.cpu().numpy()
                         for k, v in out.items()})
            print(f"[{tag} rank {rank}] {rec[tag]}", flush=True)
        del out, diag

        # ---- 13c. run_incremental on phase 6's stream, (1, 8) ----
        full = bench_dataset(cam, host_u8.astype(np.float32))
        cfg = stream_config(bm_cfg, dsm_cfg, ortho_cfg)
        runs_13c = []
        for k in range(3):  # the warm run, then 2 timed
            out, r = group_run(lambda: counted_sharded_stream(
                runs, full, cfg, DIST_SHARDS, f"13c rank {rank} run {k}",
                dev)[:2], dev)
            r["bytes_per_fused_step"] = r["bytes_sent"] / max(
                r["fused_steps"], 1)
            check(bit_equal_maps({k2: v.cpu() for k2, v in out.items()},
                                 one_map),
                  f"13c rank {rank} run {k}: the map differs from phase "
                  "6's one-device map")
            runs_13c.append(r)
            print(f"[13c rank {rank} run {k}] {runs_13c[-1]}", flush=True)
        maps.update({f"13c/{k}": v.cpu().numpy() for k, v in out.items()})
        walls = [r["wall_s"] for r in runs_13c[1:]]
        n_updates = len(range(USE_EVERY_NTH - 1, NUM_IMAGES, USE_EVERY_NTH))
        rec["13c"] = dict(warm=runs_13c[0], timed=runs_13c[1:],
                          median_wall_s=float(np.median(walls)),
                          updates=n_updates,
                          windows=-(-n_updates // 8), bit_equal=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    np.savez(os.path.join(work, f"rank{rank}.npz"), **maps)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    print(f"[13 rank {rank}] done in {rec['phase_s']:.1f} s", flush=True)
    return 0


def dist_phase(w, cfgs, counters, one_map, ss_median_s, dev):
    """Phase 13: the mesh across processes on the card. The parent writes
    phase 4's frames (uint8) and phase 6's one-device map to a temporary
    ``inputs.npz`` and spawns DIST_RANKS workers of this script
    (``--dist-worker``, a Gloo group, ``file://`` rendezvous), each with
    DIST_SHARDS logical shards of ``cuda:0``: 13a ``sharded_dsm_update``
    on an (8,) tiles mesh over phase 4's cloud, 13b ``sharded_map_step``
    on (1, 8) (tiles cross the processes) and (2, 4) (pairs cross them),
    13c ``run_incremental`` on phase 6's stream over the driver's (1, 8)
    mesh: a warm run and 2 timed, each rank's map bit-equal to phase 6's,
    with per rank the wall time, windows, replays, window reads, launches,
    bytes through the group and peak memory. The parent holds 13a and 13b
    bit-equal to the one-device DSM and composition. 13d: 13b's (1, 8) in
    this process inside a one-rank NCCL group (the device-tensor path),
    bit-equal too. Returns (e2e_dist, launches by run: per rank for
    13a-13c)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from aerial_mapper_tpu_torch.dsm.idw import update_elevation_layer
    from aerial_mapper_tpu_torch.ortho.backward_grid import (
        backward_grid_update,
    )
    from aerial_mapper_tpu_torch.parallel import collectives as cl
    from aerial_mapper_tpu_torch.parallel import distributed as tdist
    from aerial_mapper_tpu_torch.parallel import make_mesh
    from aerial_mapper_tpu_torch.stereo.batched import process_pairs_batched

    bm_cfg, dsm_cfg, ortho_cfg = cfgs
    cam, geom = w["cam"], w["geom"]
    card = torch.device("cuda", 0) if dev.type == "cuda" else dev
    runs = DriverRuns(counters)
    e2e, launches_by_run = {}, {}
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        # the one-device references, before the workers share the card
        pts, _i, valid = process_pairs_batched(w["ops"], cam, bm_cfg,
                                               device=dev)
        ref_dsm = update_elevation_layer(
            dict(w["layers"]), pts.reshape(-1, 3), valid.reshape(-1), geom,
            dsm_cfg)["elevation"].cpu()
        pts, _i, valid = process_pairs_batched(w["ops"], cam, bm_cfg,
                                               device=dev, batch_chunk=1)
        ref = update_elevation_layer(dict(w["layers"]), pts.reshape(-1, 3),
                                     valid.reshape(-1), geom, dsm_cfg)
        ref = {k: v.cpu() for k, v in backward_grid_update(
            ref, w["quats"], w["ts"], w["images"], geom, cam,
            ortho_cfg).items()}
        del pts, valid
        Rs, ts = bench_poses()
        np.savez(os.path.join(work, "inputs.npz"),
                 images=w["images"].to(torch.uint8).cpu().numpy(),
                 Rs=Rs, ts=ts,
                 meta=np.array([NUM_IMAGES, IMG_H, IMG_W, MAP_CELLS]),
                 **{f"one_map/{k}": v.cpu().numpy()
                    for k, v in one_map.items()})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        codes, spawn_s = run_workers(work, "13", [], dev)
        check(codes == [0] * DIST_RANKS, f"13: worker exit codes {codes}")
        recs = []
        for r in range(DIST_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                recs.append(json.load(f))
            got = np.load(os.path.join(work, f"rank{r}.npz"))
            check(bit_equal_maps({"e": torch.as_tensor(got["13a/elevation"])},
                                 {"e": ref_dsm}),
                  f"13a rank {r}: the DSM differs from the one-device DSM")
            for tag in ("13b (1, 8)", "13b (2, 4)"):
                check(bit_equal_maps(
                    {k: torch.as_tensor(got[f"{tag}/{k}"]) for k in ref},
                    ref), f"{tag} rank {r}: the map differs from the "
                    "one-device composition")
            check(bit_equal_maps(
                {k: torch.as_tensor(got[f"13c/{k}"]) for k in one_map},
                {k: v.cpu() for k, v in one_map.items()}),
                f"13c rank {r}: the map differs from phase 6's")
        for tag in ("13a", "13b (1, 8)", "13b (2, 4)"):
            launches_by_run[tag] = [rc[tag]["launches"] for rc in recs]
        launches_by_run["13c"] = [rc["13c"]["warm"]["launches"]
                                  for rc in recs]
        e2e["13abc"] = dict(ranks=DIST_RANKS, shards_per_rank=DIST_SHARDS,
                            backend="gloo", workers_s=spawn_s,
                            per_rank=recs, bit_equal=True)
        for rc in recs:
            c = rc["13c"]
            print(f"[13 rank {rc['rank']}] 13a launches "
                  f"{rc['13a']['launches']}; 13b (1, 8) "
                  f"{rc['13b (1, 8)']['wall_s']:.3f} s, (2, 4) "
                  f"{rc['13b (2, 4)']['wall_s']:.3f} s, launches "
                  f"{rc['13b (1, 8)']['launches']}; 13c wall median "
                  f"{c['median_wall_s']:.4f} s of "
                  f"{[t['wall_s'] for t in c['timed']]} (warm "
                  f"{c['warm']['wall_s']:.3f} s), {c['updates']} updates, "
                  f"{c['warm']['fused_steps']} fused steps, "
                  f"{c['warm']['replays']} replays, "
                  f"{c['warm']['window_reads']} window reads, launches "
                  f"{c['warm']['launches']}, {c['warm']['exchanges']} "
                  f"exchanges, {c['warm']['bytes_sent'] / 1e9:.3f} GB sent "
                  f"({c['warm']['bytes_per_fused_step'] / 1e6:.2f} MB per "
                  f"fused step) in {c['warm']['exchange_s']:.3f} s, peak "
                  f"{c['warm']['peak_mem_gib']} GiB",
                  flush=True)
        print(f"[13abc] {DIST_RANKS} Gloo ranks x {DIST_SHARDS} logical "
              f"shards of {card}: 13a, 13b and every 13c run bit-equal on "
              f"every rank; 13c median per rank "
              f"{[rc['13c']['median_wall_s'] for rc in recs]} s (phase "
              f"12a {ss_median_s:.4f} s); workers {spawn_s:.1f} s",
              flush=True)

        # ---- 13d. (1, 8) in a one-rank NCCL group ----
        backend = "nccl" if dev.type == "cuda" else "gloo"
        tdist.initialize_distributed(
            f"file://{work}/rendezvous13d", num_processes=1, process_id=0,
            backend=backend, timeout_s=DIST_TIMEOUT_S)
        try:
            with logical_shards(DIST_RANKS * DIST_SHARDS, card):
                mesh = make_mesh(("pairs", "tiles"), shape=(1, 8))
            check(mesh.spans_processes, "13d: the mesh is one process's")
            cl.traffic.update(exchanges=0, bytes=0, seconds=0.0)
            per_shard = -(-w["ops"].image1.shape[0] // mesh.size)
            (out, diag), s = runs.timed(
                "13d", lambda: dist_step(w, cfgs, mesh, dev),
                runs.want(bm_scan=per_shard * mesh.size,
                          binned_idw_cuda=mesh.size,
                          score_pass_cuda=mesh.size)
                if dev.type == "cuda" else runs.none)
            diag.check()
            check(bit_equal_maps({k: v.cpu() for k, v in out.items()}, ref),
                  "13d: the one-rank group's map differs from the "
                  "one-device composition")
            e2e["13d"] = dict(backend=dist.get_backend(), mesh=mesh.shape,
                              wall_s=s, launches=runs.launches["13d"],
                              exchanges=cl.traffic["exchanges"],
                              bytes_sent=cl.traffic["bytes"],
                              exchange_s=cl.traffic["seconds"],
                              bit_equal=True)
        finally:
            dist.destroy_process_group()
        launches_by_run["13d"] = runs.launches["13d"]
        print(f"[13d] one-rank {e2e['13d']['backend']} group, (1, 8) mesh: "
              f"bit-equal to the one-device composition; {s:.3f} s, "
              f"{e2e['13d']['exchanges']} exchanges of "
              f"{e2e['13d']['bytes_sent'] / 1e6:.1f} MB through the group; "
              f"launches {runs.launches['13d']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    e2e["phase_s"] = time.perf_counter() - t_phase
    print(f"[13 done] phase 13 took {e2e['phase_s']:.1f} s", flush=True)
    return e2e, launches_by_run


# phase 14: the batch drivers across processes, 11c's tiles mesh split
# over the DIST_RANKS Gloo workers
BATCH_DIST_SHARDS = SHARD_TILES // DIST_RANKS  # logical shards per worker


def batch_dist_worker(rank, work, device):
    """Phase 14a's worker: rank ``rank`` of a Gloo group of DIST_RANKS
    processes (``file://`` rendezvous in ``work``), each holding
    BATCH_DIST_SHARDS logical shards of the card (``default_devices``
    patched), so that the batch drivers' ``auto_shard`` mesh is 11c's
    SHARD_TILES-shard tiles mesh across the processes. Runs 11c's five
    drivers (``batch_drivers``) on the bench stream the parent wrote to
    ``work/inputs.npz``: each a warm run (the backward grid writing 7a's
    files under ``work/files{rank}``) and 2 timed, every run counted (the
    launches of this rank's shards) and its result held bit-equal to 11c's
    sharded one (``ref/...`` in the inputs). Writes
    ``work/batch_rank{rank}.json``; any failed check raises."""
    import torch.distributed as dist

    from aerial_mapper_tpu_torch.dsm.cuda_idw import binned_idw_cuda
    from aerial_mapper_tpu_torch.ortho.cuda_score import score_pass_cuda
    from aerial_mapper_tpu_torch.parallel import distributed as tdist
    from aerial_mapper_tpu_torch.stereo.cuda_bm import bm_scan
    from aerial_mapper_tpu_torch.stereo.cuda_sgm import sgm_scan

    global NUM_IMAGES, IMG_H, IMG_W, MAP_CELLS, PROFILE_FRAMES
    # the ranks share the host's cores: oversubscribed host threads spin
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // DIST_RANKS))
    dev = torch.device(device)
    card = torch.device("cuda", 0) if dev.type == "cuda" else dev
    inputs = np.load(os.path.join(work, "inputs.npz"))
    NUM_IMAGES, IMG_H, IMG_W, MAP_CELLS, PROFILE_FRAMES = map(
        int, inputs["meta"])
    tdist.initialize_distributed(
        f"file://{work}/rendezvous", num_processes=DIST_RANKS,
        process_id=rank, backend="gloo", timeout_s=DIST_TIMEOUT_S)
    cam, scene = bench_camera_scene()
    bm_cfg, dsm_cfg, ortho_cfg, sgm_cfg = smoke_configs()
    cfg = batch_config({"scene": scene}, bm_cfg, sgm_cfg, dsm_cfg,
                       ortho_cfg)
    ds = bench_dataset(cam, inputs["images"].astype(np.float32))
    # the plain versions on the CPU count no launch
    runs = DriverRuns((bm_scan, binned_idw_cuda, score_pass_cuda, sgm_scan),
                      sync=lambda: sync(dev), counting=dev.type == "cuda")
    want = runs.want

    files_dir = os.path.join(work, f"files{rank}")
    os.makedirs(files_dir)
    rec = dict(rank=rank)
    t_phase = time.perf_counter()
    with logical_shards(BATCH_DIST_SHARDS, card):
        drivers = batch_drivers(ds, cfg, want, BATCH_DIST_SHARDS, dev)
        for name, (fn, run_cfg, _one, sharded) in drivers.items():
            pre = f"ref/{name}/"
            ref = {k[len(pre):]: torch.as_tensor(inputs[k])
                   for k in inputs.files if k.startswith(pre)}
            outputs = (backward_grid_files(files_dir)
                       if name == "run_ortho_backward_grid" else {})
            tag = f"14a {name}"
            done = []
            for k in range(3):  # the warm run, then 2 timed
                o = outputs if k == 0 else {}
                (out, records), r = group_run(lambda: runs.run(
                    tag, lambda: run_logged(lambda: fn(run_cfg, **o)),
                    sharded), dev)
                msgs = [m.getMessage() for m in records
                        if "sharded" in m.getMessage()]
                check(msgs, f"{tag} rank {rank}: no sharding logged")
                check(bit_equal_maps({k2: v.cpu() for k2, v in out.items()},
                                     ref),
                      f"{tag} rank {rank} run {k}: the result differs from "
                      "11c's sharded run")
                done.append(dict(**r, log=msgs))
                del out
            rec[name] = dict(warm=done[0], timed=done[1:],
                             median_wall_s=float(np.median(
                                 [d["wall_s"] for d in done[1:]])),
                             bit_equal=True)
            print(f"[{tag} rank {rank}] median {rec[name]['median_wall_s']:.4f}"
                  f" s of {[d['wall_s'] for d in done[1:]]} (warm "
                  f"{done[0]['wall_s']:.3f} s); launches "
                  f"{done[0]['launches']}; {done[0]['exchanges']} exchanges, "
                  f"{done[0]['bytes_sent'] / 1e6:.1f} MB sent in "
                  f"{done[0]['exchange_s']:.3f} s; peak "
                  f"{done[0]['peak_mem_gib']} GiB; {done[0]['log']}",
                  flush=True)
    rec["files"] = sorted(os.listdir(files_dir))
    rec["phase_s"] = time.perf_counter() - t_phase
    with open(os.path.join(work, f"batch_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    print(f"[14a rank {rank}] done in {rec['phase_s']:.1f} s", flush=True)
    return 0


def batch_dist_phase(w, cfgs, counters, maps_11c, dev):
    """Phase 14: the batch drivers' ``auto_shard`` branches across
    processes on the card. 14a: the parent runs 7a's backward grid on one
    device writing its files, writes phase 4's frames (uint8) and 11c's
    sharded results to a temporary ``inputs.npz`` and spawns DIST_RANKS
    workers of this script (``--dist-phase 14``, a Gloo group), each with
    BATCH_DIST_SHARDS logical shards of ``cuda:0``: 11c's tiles mesh across
    the processes. Each worker runs 11c's five drivers (the sweep on
    PROFILE_FRAMES frames), every run counted and bit-equal to 11c's
    sharded result on every rank, with per rank the median wall time of 2
    after a warm run, the bytes and seconds of the exchanges and peak
    memory. Rank 0 alone writes 7a's files, equal to the one-device run's.
    14b: the backward grid in this process inside a one-rank NCCL group
    over SHARD_TILES logical shards, bit-equal to 11c. Returns (e2e, launches
    by run: per rank for 14a)."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist

    from aerial_mapper_tpu_torch.io.artifacts import load_layers
    from aerial_mapper_tpu_torch.parallel import collectives as cl
    from aerial_mapper_tpu_torch.parallel import distributed as tdist
    from aerial_mapper_tpu_torch.pipeline import batch

    bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg = cfgs
    card = torch.device("cuda", 0) if dev.type == "cuda" else dev
    runs = DriverRuns(counters)

    def want(**launches):  # the plain versions on the CPU count none
        return runs.want(**launches) if dev.type == "cuda" else runs.none

    e2e, launches_by_run = {}, {}
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_dist_batch_")
    try:
        cfg = batch_config(w, bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg)
        ds = bench_dataset(w["cam"], w["images"].cpu().numpy())
        drivers = batch_drivers(ds, cfg, want, SHARD_TILES, dev)
        fn, run_cfg, one, sharded = drivers["run_ortho_backward_grid"]
        # 7a's files from the one-device run, before the workers share
        # the card
        one_files = backward_grid_files(os.path.join(work, "one"))
        os.makedirs(os.path.join(work, "one"))
        runs.counted("14 one device", lambda: fn(
            dataclasses.replace(run_cfg, auto_shard=False), **one_files),
            one)
        np.savez(os.path.join(work, "inputs.npz"),
                 images=w["images"].to(torch.uint8).cpu().numpy(),
                 meta=np.array([NUM_IMAGES, IMG_H, IMG_W, MAP_CELLS,
                                PROFILE_FRAMES]),
                 **{f"ref/{name}/{k}": v.numpy()
                    for name, m in maps_11c.items() for k, v in m.items()})
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        codes, spawn_s = run_workers(work, "14a", ["--dist-phase", "14"], dev)
        check(codes == [0] * DIST_RANKS, f"14a: worker exit codes {codes}")
        recs = []
        for r in range(DIST_RANKS):
            with open(os.path.join(work, f"batch_rank{r}.json")) as f:
                recs.append(json.load(f))
        # rank 0 alone wrote 7a's files, those of the one-device run
        names = sorted(os.path.basename(p) for p in one_files.values())
        check(recs[0]["files"] == names
              and all(rc["files"] == [] for rc in recs[1:]),
              f"14a: files written per rank {[rc['files'] for rc in recs]},"
              f" want {names} on rank 0 only")
        for name in names:
            a = os.path.join(work, "files0", name)
            b = os.path.join(work, "one", name)
            if name == "layers.npz":
                (la, ga), (lb, gb) = load_layers(a), load_layers(b)
                same = tuple(ga) == tuple(gb) and bit_equal_maps(
                    {k: torch.as_tensor(v) for k, v in la.items()},
                    {k: torch.as_tensor(v) for k, v in lb.items()})
            elif name.endswith(".html"):  # carries the run's timings
                same = os.path.getsize(a) > 0
            else:
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    same = fa.read() == fb.read()
            check(same, f"14a: rank 0's {name} differs from the one-device "
                  "run's")
        for name in drivers:
            launches_by_run[f"14a {name}"] = [rc[name]["warm"]["launches"]
                                              for rc in recs]
        e2e["14a"] = dict(ranks=DIST_RANKS,
                          shards_per_rank=BATCH_DIST_SHARDS,
                          backend="gloo", workers_s=spawn_s,
                          files_rank0=names, per_rank=recs, bit_equal=True)
        print(f"[14a] {DIST_RANKS} Gloo ranks x {BATCH_DIST_SHARDS} logical "
              f"shards of {card}: every run of the five drivers bit-equal "
              f"to 11c on every rank; rank 0 alone wrote {names}, equal to "
              f"the one-device run's; median per rank "
              + "; ".join(f"{name} {[rc[name]['median_wall_s'] for rc in recs]}"
                          for name in drivers)
              + f" s; workers {spawn_s:.1f} s", flush=True)

        # ---- 14b. the backward grid in a one-rank NCCL group ----
        tdist.initialize_distributed(
            f"file://{work}/rendezvous14b", num_processes=1, process_id=0,
            backend="nccl" if dev.type == "cuda" else "gloo",
            timeout_s=DIST_TIMEOUT_S)
        try:
            cl.traffic.update(exchanges=0, bytes=0, seconds=0.0)
            with logical_shards(SHARD_TILES, card):
                (out, s), records = run_logged(lambda: runs.timed(
                    "14b", lambda: fn(run_cfg), sharded))
            msgs = [r.getMessage() for r in records
                    if "sharded" in r.getMessage()]
            check(msgs, "14b: the driver logged no sharding")
            check(bit_equal_maps({k: v.cpu() for k, v in out.items()},
                                 maps_11c["run_ortho_backward_grid"]),
                  "14b: the one-rank group's map differs from 11c's")
            e2e["14b"] = dict(backend=dist.get_backend(),
                              shards=SHARD_TILES, wall_s=s,
                              launches=runs.launches["14b"],
                              exchanges=cl.traffic["exchanges"],
                              bytes_sent=cl.traffic["bytes"],
                              exchange_s=cl.traffic["seconds"],
                              log=msgs, bit_equal=True)
            del out
        finally:
            dist.destroy_process_group()
        launches_by_run["14b"] = runs.launches["14b"]
        print(f"[14b] one-rank {e2e['14b']['backend']} group, "
              f"{SHARD_TILES} logical shards: the backward grid bit-equal "
              f"to 11c; {s:.3f} s, {e2e['14b']['exchanges']} exchanges of "
              f"{e2e['14b']['bytes_sent'] / 1e6:.1f} MB in "
              f"{e2e['14b']['exchange_s']:.3f} s; launches "
              f"{runs.launches['14b']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    e2e["phase_s"] = time.perf_counter() - t_phase
    print(f"[14 done] phase 14 took {e2e['phase_s']:.1f} s", flush=True)
    return e2e, launches_by_run


# phase 15: the card's two rasters against the C++ reference loops
# (native/reference_baseline.cc) at the bench: bench.py's worker_agreement
# as a check. 15b's cloud: 70 uniform points per cell from this seed, z the
# scene's height plus N(0, 0.15 m) noise
NATIVE_PTS_PER_CELL = 70
NATIVE_SEED = 7
NATIVE_Z_SIGMA = 0.15
# the bars: 15a over the cells both sides texture (|card - cpu| < 2 gray,
# bench.py's measure) and the share textured by one side only; 15b those
# of tests/test_dsm_idw.py's overflow test (hit masks, RMSE) with the
# repo's 0.5 m DSM bar for the maximum
NATIVE_ORTHO_AGREE = 0.999
NATIVE_ORTHO_ONE_SIDED = 1e-3
NATIVE_HIT_MISMATCH = 1e-3
NATIVE_RMSE_M = 0.06
NATIVE_MAX_M = 0.5


def host_cpu() -> str:
    """The host's CPU model (as /proc/cpuinfo names it), its architecture
    and the cores this process may use."""
    import platform

    model = "model not named"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    except OSError:
        pass
    return (f"{model} ({platform.machine()}), "
            f"{len(os.sched_getaffinity(0))} usable cores")


def native_phase(w, dsm_cfg, ortho_cfg, counters, truth_h, smi, dev):
    """Phase 15: the card against the C++ reference loops. 15a: the
    backward grid (``backward_grid_update``, the score kernel) at the bench
    (400x400 cells at 0.5 m, 249 frames of 752x480, the analytic
    elevation) against ``backward_grid_cpu`` on the same cells, poses and
    images. 15b: 70 uniform points per cell through the binned IDW
    (``idw_to_grid``, the IDW kernel, K = 8: every cell capacity-clipped)
    against ``dsm_idw_cpu``, the all-neighbours loop. Both passes run
    once with every counter set to 0 just before and read just after (1
    score and 1 IDW launch); the C++ loops' host seconds and threads, and
    the card's time for the same passes (CUDA events), are data."""
    from aerial_mapper_tpu_torch.dsm.idw import idw_to_grid
    from aerial_mapper_tpu_torch.native import (
        backward_grid_cpu,
        dsm_idw_cpu,
        hardware_threads,
    )
    from aerial_mapper_tpu_torch.ortho.backward_grid import (
        backward_grid_update,
    )

    t_phase = time.perf_counter()
    cam, geom, scene = w["cam"], w["geom"], w["scene"]
    lay = dict(w["layers"])
    lay["elevation"] = truth_h
    # 15b's cloud, on the host as bench.py draws it
    rng = np.random.default_rng(NATIVE_SEED)
    n_pts = NATIVE_PTS_PER_CELL * geom.height * geom.width
    half_e = geom.width * geom.resolution / 2.0
    half_n = geom.height * geom.resolution / 2.0
    pe = rng.uniform(-half_e, half_e, n_pts)
    pn = rng.uniform(-half_n, half_n, n_pts)
    xy = torch.as_tensor(np.stack([pe, pn], 1), dtype=torch.float32,
                         device=dev)
    pz = scene.height(xy[:, 0], xy[:, 1]).cpu().numpy() \
        + rng.normal(0.0, NATIVE_Z_SIGMA, n_pts)
    z = torch.as_tensor(pz, dtype=torch.float32, device=dev)
    valid = torch.ones(n_pts, dtype=torch.bool, device=dev)
    idw_kw = dict(radius_sq=dsm_cfg.interpolation_radius_sq,
                  adaptive=dsm_cfg.adaptive_interpolation,
                  growth=dsm_cfg.adaptive_growth_factor,
                  max_radius_sq=dsm_cfg.max_radius_sq)

    def ortho_pass():
        return backward_grid_update(lay, w["quats"], w["ts"], w["images"],
                                    geom, cam, ortho_cfg)

    def dsm_pass():
        return idw_to_grid(xy, z, valid, geom, dsm_cfg.bin_capacity,
                           kernel=dsm_cfg.idw_kernel, **idw_kw)

    runs = DriverRuns(counters)
    torch.cuda.synchronize()
    out, (vals, hit) = runs.counted(
        "15", lambda: (ortho_pass(), dsm_pass()),
        runs.want(score_pass_cuda=1, binned_idw_cuda=1))
    card_ms = dict(ortho=cuda_ms(ortho_pass, reps=5),
                   dsm=cuda_ms(dsm_pass, reps=5))

    # the C++ loops on the host, all hardware threads
    threads = hardware_threads()
    ce = w["ce"].double().cpu().numpy().ravel()
    cn = w["cn"].double().cpu().numpy().ravel()
    cells = np.stack([ce, cn, truth_h.double().cpu().numpy().ravel()], 1)
    Rs, ts = bench_poses()
    images = w["images"].cpu().numpy()
    t0 = time.perf_counter()
    o_cpu, _angle, obs = backward_grid_cpu(
        cells, np.transpose(Rs, (0, 2, 1)), ts, images, cam.fx, cam.fy,
        cam.cx, cam.cy)
    host_s = dict(ortho=time.perf_counter() - t0)
    del images
    t0 = time.perf_counter()
    ref_vals, ref_hit = dsm_idw_cpu(np.stack([pe, pn, pz], 1), ce, cn,
                                    **idw_kw)
    host_s["dsm"] = time.perf_counter() - t0

    # 15a: the ortho
    ortho = out["ortho"].cpu().numpy().ravel()
    best = out["observation_index"].cpu().numpy().ravel()
    card_tex = np.isfinite(best)
    cpu_tex = obs >= 0
    both = card_tex & cpu_tex
    check(both.any(), "15a: no cell textured by both sides")
    rec_a = dict(
        cells=int(ortho.size), both_textured=float(both.mean()),
        agreement=float(np.mean(np.abs(ortho[both] - o_cpu[both]) < 2.0)),
        one_sided=float(np.mean(card_tex != cpu_tex)),
        same_winner=float(np.mean(best[both] == obs[both])),
        max_abs_gray=float(np.abs(ortho[both] - o_cpu[both]).max()))
    # 15b: the DSM
    v = vals.cpu().numpy().ravel()
    h = hit.cpu().numpy().ravel()
    both_hit = h & ref_hit
    check(both_hit.any(), "15b: no cell hit by both sides")
    err = np.abs(v[both_hit] - ref_vals[both_hit])
    rec_b = dict(
        points=n_pts, capacity=dsm_cfg.bin_capacity,
        hit_mismatch=float(np.mean(h != ref_hit)),
        hit_share=float(h.mean()), rmse_m=float(np.sqrt((err ** 2).mean())),
        max_abs_m=float(err.max()))
    rec = {"15a": rec_a, "15b": rec_b, "card_ms": card_ms, "card": smi,
           "host_s": host_s, "host_threads": threads, "host": host_cpu(),
           "launches": runs.launches["15"]}
    print(f"[15a ortho vs C++] {rec_a['cells']} cells x {len(Rs)} frames: "
          f"both textured {rec_a['both_textured']:.6f}, agreement (< 2 gray)"
          f" {rec_a['agreement']:.6f}, one side only {rec_a['one_sided']:.6f}"
          f", same winner {rec_a['same_winner']:.6f}", flush=True)
    print(f"[15b dsm vs C++] {n_pts} points ({NATIVE_PTS_PER_CELL} per "
          f"cell), K={dsm_cfg.bin_capacity}: hit mismatch "
          f"{rec_b['hit_mismatch']:.6f}, rmse {rec_b['rmse_m']:.6f} m, max "
          f"{rec_b['max_abs_m']:.6f} m", flush=True)
    print(f"[15 times] card ({smi}; CUDA events, median of 5): ortho "
          f"{card_ms['ortho']:.3f} ms, dsm {card_ms['dsm']:.3f} ms; C++ "
          f"loops on the host ({rec['host']}, {threads} threads, host "
          f"clock): ortho {host_s['ortho']:.3f} s, dsm {host_s['dsm']:.3f} s;"
          f" launches {rec['launches']}", flush=True)
    check(rec_a["agreement"] >= NATIVE_ORTHO_AGREE,
          f"15a: ortho agreement {rec_a['agreement']}")
    check(rec_a["one_sided"] <= NATIVE_ORTHO_ONE_SIDED,
          f"15a: cells textured by one side only {rec_a['one_sided']}")
    check(rec_b["hit_mismatch"] <= NATIVE_HIT_MISMATCH,
          f"15b: hit mismatch {rec_b['hit_mismatch']}")
    check(rec_b["rmse_m"] < NATIVE_RMSE_M, f"15b: rmse {rec_b['rmse_m']} m")
    check(rec_b["max_abs_m"] < NATIVE_MAX_M,
          f"15b: max |err| {rec_b['max_abs_m']} m")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[15 done] phase 15 took {rec['phase_s']:.1f} s", flush=True)
    return rec, runs.launches["15"]


RIG_TILT_DEG = 25.0  # camera 1 pitched north about the body x axis
# Camera 1 at 89-111 m above the terrain sees 25 +- 26.6 degrees from
# nadir (fy = 480 over 480 rows): its footprint reaches up to 140 m north
# of its flight line. The northern line runs at +30 m and the bench map
# ends at +100 m, so the rig's map adds 140 rows of 0.5 m to the north.
RIG_NORTH_ROWS = 140
RIG_COVERAGE_GAIN = 1.3  # the fused DSM's cells over camera 0's alone
# (tests/test_multicam.py::test_multicam_extends_coverage)
RIG_SHARDS = 8  # phase 16d's logical shards of the card


def rig_tilt():
    """Camera 1's R_B_C: RIG_TILT_DEG about the body x axis (east), so it
    looks north (the rig of tests/test_multicam.py)."""
    th = np.deg2rad(RIG_TILT_DEG)
    return np.array([[1.0, 0.0, 0.0],
                     [0.0, np.cos(th), -np.sin(th)],
                     [0.0, np.sin(th), np.cos(th)]])


def two_camera_rig(cam):
    """The rig: camera 0 is the body frame, camera 1 pitched north
    (``rig_tilt``), both ``cam``, at the same position."""
    from aerial_mapper_tpu_torch.camera.rig import CameraRig
    from aerial_mapper_tpu_torch.io.poses import _quat_from_matrix_np

    return CameraRig(cameras=(cam, cam), T_C_B_quats=np.stack([
        np.array([1.0, 0.0, 0.0, 0.0]), _quat_from_matrix_np(rig_tilt().T)]),
        T_C_B_trans=np.zeros((2, 3)))


def rig_datasets(rig, quats_G_B, trans_G_B, frames):
    """One in-memory ``Dataset`` per rig camera over one body trajectory,
    camera j's frames ``frames[j]`` ([N, H, W(, 3)] host arrays)."""
    from aerial_mapper_tpu_torch.pipeline.dataset import Dataset

    return [Dataset(rig=rig.select(j), quats_G_B=quats_G_B,
                    trans_G_B=trans_G_B, images=list(f))
            for j, f in enumerate(frames)]


def rig_grid_flags():
    """The rig's map as grid flags of the CLIs: the bench map with
    RIG_NORTH_ROWS more rows to the north."""
    return ["--center_easting", "0",
            "--center_northing", str(RIG_NORTH_ROWS * RESOLUTION / 2),
            "--delta_easting", str(MAP_CELLS * RESOLUTION),
            "--delta_northing", str((MAP_CELLS + RIG_NORTH_ROWS) * RESOLUTION),
            "--resolution", str(RESOLUTION)]


def render_rig_frames(cam, scene, Rs, ts, R_B_C, color, dev):
    """uint8 [N, H, W] (RGB: [N, H, W, 3]) frames on ``dev`` of the rig
    camera with body-to-camera rotation ``R_B_C`` (None: the body frame)
    at each body pose, rendered and quantized as 8-bit imagery."""
    from aerial_mapper_tpu_torch.synth.scene import render_image

    frames = torch.stack([
        render_image(scene, cam, R if R_B_C is None else R @ R_B_C, t,
                     color=color, device=dev) for R, t in zip(Rs, ts)])
    return torch.clamp(torch.round(frames), 0.0, 255.0).to(torch.uint8)


def maps_bit_equal(a, b) -> bool:
    """Every layer equal: the packed RGB layer as int32 bits, the others
    bit for bit, NaN-aware."""
    if set(a) != set(b):
        return False
    rest = [k for k in a if k != "colored_ortho"]
    return packed_equal(a["colored_ortho"], b["colored_ortho"]) and \
        bit_equal_maps(a, b, rest)


def rig_kernel_checks(tag, bm_ops, idw_ops, score_ops, dsm_cfg, cam):
    """Phase 16's kernels on operands its runs gave them: each of
    ``bm_ops``, ``idw_ops`` and ``score_ops`` is a list of (name, one
    call's arguments as ``FirstCall`` keeps them), and each kernel must be
    bit-equal to its plain version; the IDW operands must hold points and
    some score pass must see a camera: max |err| by kernel."""
    errs = dict(bm_scan=0.0, binned_idw_cuda=0.0, score_pass_cuda=0.0)
    for name, ((lf, rf, n_disp, d_min, block), _k) in bm_ops:
        errs["bm_scan"] = max(errs["bm_scan"], bm_check(
            f"{tag} bm_scan, {name}", lf, rf, n_disp, d_min, block, True))
    occupied = 0
    for name, ((binned, ext), kw) in idw_ops:
        errs["binned_idw_cuda"] = max(errs["binned_idw_cuda"], idw_check(
            f"{tag} binned_idw, {name}", binned, ext, dsm_cfg,
            kw["adaptive"], kw["max_radius_sq"]))
        occupied += int(torch.clamp(binned.count, max=binned.de.shape[0])
                        .sum().item())
    check(occupied > 0 or not idw_ops,
          f"{tag}: the IDW operands hold no point")
    seen = 0.0
    for name, ((cells, bank, _cam), kw) in score_ops:
        sc = score_check(f"{tag} score_pass, {name}", cells, bank,
                         kw["grid_shape"], cam)
        seen = max(seen, sc["visible_share"])
        errs["score_pass_cuda"] = max(errs["score_pass_cuda"],
                                      sc["max_abs_err"])
    check(seen > 0, f"{tag}: no score pass's operands see a camera")
    return errs


def colored_rig_phase(w, bm_cfg, dsm_cfg, ortho_cfg, counters, dev):
    """Phase 16: colored frames and the two-camera rig on the card, at the
    bench's width (249 poses of 752x480, every 7th frame: 35 updates or
    34 batch pairs). Camera 0 is the bench camera at the bench poses;
    camera 1 has the same intrinsics, pitched RIG_TILT_DEG north. The RGB
    frames of both and camera 1's gray frames are rendered on the card
    and quantized to uint8; camera 0's gray frames are the bench's. Every
    run is counted (counters set to 0 just before, read just after) and
    held to the path's launches.

    16a ``run_incremental`` on the RGB stream (``colored_ortho``) and on
    its gray twin, the frames ``rgb_to_gray`` makes of it on the card
    (float32 [H, W]): elevation, elevation angle, observation index and
    count bit-equal; the BT.601 gray of the unpacked 8-bit RGB equal to
    the gray run's ortho on every textured cell; the RGB within phase 4's
    ortho bars of ``texture_rgb``; both controls (blue dropped, the layer
    through x * 0.5 * 2.0) fail the luma and the bits check, their
    readings printed. 16b the same pair of ``run_ortho_backward_grid``
    jobs, the same checks; the RGB GeoTiff and the ortho image (written
    as PPM: lossless) read back equal to ``_ortho_image(layers, True)``,
    NaN cells white. 16c the rig written to disk (PPM frames per camera,
    the rig YAML read back without PyYAML, the poses); the map RIG_NORTH_
    ROWS rows taller to the north. The fused job and stream on the gray
    frames against phase 4's DSM and ortho bars, a DSM covering more than
    RIG_COVERAGE_GAIN x camera 0's alone, observation ids integral in
    [0, 2 N) with cells won by each camera; the same two runs on the RGB
    frames, their RGB held to ``texture_rgb``. 16d the gray stream, the
    RGB job and the RGB stream (with ``on_update`` payloads) sharded over
    RIG_SHARDS logical shards of the card, each map bit-equal to its
    one-device run (the packed layer as int32 bits). 16e the batch and
    the incremental CLI with ``--load_colored_images --colored_ortho
    --all_cameras`` on 16c's files, with ``yaml`` and ``PIL`` blocked:
    their layers bit-equal to 16c's RGB runs, the GeoTiff and image to
    ``_ortho_image``. The configs of 16c-16e are the CLIs' own
    (``cli.common.pipeline_config_from_args``). The kernels on the rig's
    shapes, each bit-equal to its plain version: in 16c BM, IDW and score
    on the operands of the colored stream's update of frame 118 (two
    pairs, the fused cloud on the taller map, two score passes over all
    its cells);
    in 16d IDW and score on every band of the sharded colored stream's
    middle fused step and score pass. Returns (e2e_colored_rig, launches
    by run, max |err| of those checks by kernel)."""
    import dataclasses
    import importlib.util
    import shutil
    import tempfile

    from aerial_mapper_tpu_torch.camera.rig import (
        load_camera_rig,
        save_camera_rig,
    )
    from aerial_mapper_tpu_torch.cli import (
        common,
        main_ortho_backward_grid,
        main_ortho_backward_grid_incremental,
    )
    from aerial_mapper_tpu_torch.image.color import (
        pack_rgb_to_float,
        rgb_to_gray,
        unpack_float_to_rgb,
    )
    from aerial_mapper_tpu_torch.io.artifacts import load_layers
    from aerial_mapper_tpu_torch.io.geotiff import read_geotiff
    from aerial_mapper_tpu_torch.io.images import (
        load_images_by_names,
        save_image,
    )
    from aerial_mapper_tpu_torch.io.poses import (
        _quat_from_matrix_np,
        load_poses,
        save_poses_standard,
    )
    from aerial_mapper_tpu_torch.mapgrid.grid import (
        MapGeometry,
        cell_centers,
    )
    from aerial_mapper_tpu_torch.dsm import cuda_idw
    from aerial_mapper_tpu_torch.ortho import cuda_score
    from aerial_mapper_tpu_torch.parallel import sharded as tsh
    from aerial_mapper_tpu_torch.pipeline import batch
    from aerial_mapper_tpu_torch.pipeline import incremental as tinc
    from aerial_mapper_tpu_torch.stereo import cuda_bm

    cam, scene = w["cam"], w["scene"]
    Rs, ts = bench_poses()
    runs = DriverRuns(counters)
    want = runs.want
    n_updates = len(range(USE_EVERY_NTH - 1, NUM_IMAGES, USE_EVERY_NTH))
    pairs = n_updates - 1  # the stream's stereo updates, the job's pairs
    e2e = {}
    secs = e2e["run_s"] = {}  # each counted run's seconds, by tag
    t_phase = time.perf_counter()

    # ---- the frames ----
    t0 = time.perf_counter()
    col = [render_rig_frames(cam, scene, Rs, ts, R_B_C, True, dev)
           for R_B_C in (None, rig_tilt())]
    gray1 = render_rig_frames(cam, scene, Rs, ts, rig_tilt(), False, dev)
    twin0 = rgb_to_gray(col[0].float())  # the gray twin, made on the card
    # the texel pass's round trip: every 8-bit value, divided by 255,
    # packed, unpacked and scaled back, is the same integer
    v = torch.arange(256, dtype=torch.float32, device=dev)
    rgb = torch.stack([v, v.flip(0), v.roll(85)], dim=-1)
    back = torch.round(unpack_float_to_rgb(pack_rgb_to_float(rgb / 255.0))
                       * 255.0)
    check(torch.equal(back, rgb), "16: an 8-bit value does not survive "
          "the texel pass's / 255, pack, unpack and x 255")
    col_h = [c.cpu().numpy() for c in col]
    gray1_h, twin0_h = gray1.cpu().numpy(), twin0.cpu().numpy()
    gray0_h = w["images"].cpu().numpy()
    del col, gray1, twin0, rgb, back
    e2e["render_s"] = time.perf_counter() - t0
    print(f"[16 frames] RGB frames of both cameras, camera 1's gray frames "
          f"and camera 0's gray twin ({NUM_IMAGES} x {IMG_W}x{IMG_H} each) "
          f"in {e2e['render_s']:.2f} s; all 256 8-bit values survive the "
          "texel pass's round trip", flush=True)
    truth_rgb = scene.texture_rgb(w["ce"], w["cn"])

    def color_checks(tag, col_map, gray_map, truth):
        """16a/16b's checks of a colored map against its gray twin's."""
        check(bit_equal_maps(col_map, gray_map, keys=(
            "elevation", "elevation_angle", "observation_index",
            "num_observations")), f"{tag}: the colored run's elevation, "
            "angle, ids or counts differ from the gray twin's")
        textured = torch.isfinite(gray_map["observation_index"])
        packed = col_map["colored_ortho"]
        bad, n = luma_mismatch(packed, gray_map["ortho"], textured)
        check(bad == 0, f"{tag}: the luma of the colored ortho differs from "
              f"the gray ortho on {bad} of {n} textured cells")
        rgb255 = torch.round(unpack_float_to_rgb(packed) * 255.0)
        rec = dict(textured_cells=n, luma_mismatch=bad,
                   **ortho_bars(f"{tag} RGB", rgb255, textured, truth))
        for name, fn in PACKED_CONTROLS.items():
            ctl = fn(packed)
            c_bad, _n = luma_mismatch(ctl, gray_map["ortho"], textured)
            c_bits = packed_equal(ctl, packed)
            close = torch.allclose(ctl.nan_to_num(), packed.nan_to_num())
            print(f"[{tag} control {name}] luma differs on {c_bad} of {n} "
                  f"textured cells ({c_bad / n:.4f}); packed bits equal: "
                  f"{c_bits}; torch.allclose: {close}", flush=True)
            check(c_bad > 0 and not c_bits,
                  f"{tag}: control {name} passed the color checks")
            rec[f"control_{name}"] = dict(luma_mismatch=c_bad,
                                          share=c_bad / n, bits_equal=c_bits,
                                          allclose=close)
        print(f"[{tag}] non-color layers bit-equal to the gray twin's; luma "
              f"equal on all {n} textured cells; RGB coverage "
              f"{rec['ortho_coverage']:.4f}, median |RGB - texture_rgb| "
              f"{rec['ortho_median_abs_err_gray']:.3f}", flush=True)
        return rec

    # ---- 16a. the colored stream and its gray twin ----
    ds_col = bench_dataset(cam, col_h[0])
    ds_twin = bench_dataset(cam, twin0_h)
    col_ortho = dataclasses.replace(ortho_cfg, colored_ortho=True)
    inc_want = want(bm_scan=pairs, binned_idw_cuda=pairs,
                    score_pass_cuda=n_updates)

    def stream(tag, ds, cfg, expect, datasets=None):
        out, dt = runs.timed(tag, lambda: tinc.run_incremental(
            ds, cfg, update_every_nth=USE_EVERY_NTH, datasets=datasets,
            device=dev)[0], expect)
        secs[tag] = dt
        return out

    a_col = stream("16a colored stream", ds_col,
                   stream_config(bm_cfg, dsm_cfg, col_ortho), inc_want)
    a_gray = stream("16a gray twin stream", ds_twin,
                    stream_config(bm_cfg, dsm_cfg, ortho_cfg), inc_want)
    e2e["16a"] = color_checks("16a", a_col, a_gray, truth_rgb)
    del a_col, a_gray

    # ---- 16b. the colored batch job and its gray twin ----
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rig_")
    try:
        batch_want = want(bm_scan=pairs, binned_idw_cuda=1, score_pass_cuda=1)

        def job(tag, ds, cfg, expect, datasets=None, **outputs):
            out, dt = runs.timed(tag, lambda: batch.run_ortho_backward_grid(
                ds, cfg, datasets=datasets, device=dev, **outputs)[0],
                expect)
            secs[tag] = dt
            return out

        files = dict(output_geotiff=os.path.join(tmp, "16b.tif"),
                     output_jpg=os.path.join(tmp, "16b.ppm"))
        b_col = job("16b colored job", ds_col, stream_config(
            bm_cfg, dsm_cfg, col_ortho, use_every_nth_image=USE_EVERY_NTH),
            batch_want, **files)
        b_gray = job("16b gray twin job", ds_twin, stream_config(
            bm_cfg, dsm_cfg, ortho_cfg, use_every_nth_image=USE_EVERY_NTH),
            batch_want)
        e2e["16b"] = color_checks("16b", b_col, b_gray, truth_rgb)
        image = batch._ortho_image(b_col, True)
        tif, _geo, _zone = read_geotiff(files["output_geotiff"])
        check(tif.dtype == np.uint8 and np.array_equal(tif, image),
              "16b: the RGB GeoTiff read back differs from _ortho_image")
        ppm = load_images_by_names(tmp, ["16b.ppm"], color=True)[0]
        check(np.array_equal(ppm, image),
              "16b: the ortho image read back differs from _ortho_image")
        nan = torch.isnan(b_col["colored_ortho"]).cpu().numpy()
        check(nan.any() and bool((image[nan] == 255).all()),
              f"16b: the {int(nan.sum())} NaN cells do not export white")
        e2e["16b"].update(nan_cells=int(nan.sum()), geotiff_equal=True,
                          image_equal=True)
        if importlib.util.find_spec("PIL") is not None:
            # a JPEG is lossy: its decoded difference is data, not a check
            save_image(os.path.join(tmp, "16b.jpg"), image)
            jpg = load_images_by_names(tmp, ["16b.jpg"], color=True)[0]
            check(jpg.shape == image.shape, f"16b: JPEG shape {jpg.shape}")
            e2e["16b"]["jpeg_mean_abs_diff"] = float(np.abs(
                jpg.astype(np.float64) - image).mean())
        print(f"[16b] RGB GeoTiff and PPM read back equal to _ortho_image, "
              f"{int(nan.sum())} NaN cells white; JPEG mean |decoded - "
              f"image| {e2e['16b'].get('jpeg_mean_abs_diff')}", flush=True)
        del b_col, b_gray, ds_col, ds_twin, twin0_h, image, tif, ppm

        # ---- 16c. the rig on disk; the fused job and stream ----
        data, out = os.path.join(tmp, "rig"), os.path.join(tmp, "out")
        os.makedirs(out)
        t0 = time.perf_counter()
        for j, frames in enumerate(col_h):
            os.makedirs(os.path.join(data, f"cam{j}"))
            for i, im in enumerate(frames):
                save_image(os.path.join(data, f"cam{j}", f"image_{i}.ppm"),
                           im)
        quats_b = np.stack([_quat_from_matrix_np(R) for R in Rs])
        save_poses_standard(os.path.join(data, "opt_poses.txt"), quats_b, ts)
        rig = two_camera_rig(cam)
        save_camera_rig(rig, os.path.join(data, "camera_fixed_wing.yaml"))
        with _ModulesBlocked("yaml", "PIL"):
            rig_back = load_camera_rig(
                os.path.join(data, "camera_fixed_wing.yaml"))
        quats_back, trans_back, _meta = load_poses(
            os.path.join(data, "opt_poses.txt"))
        write_s = time.perf_counter() - t0
        rig_err = float(np.abs(rig_back.T_C_B_quats - rig.T_C_B_quats).max())
        check(tuple(rig_back.cameras) == tuple(rig.cameras)
              and rig_err < 1e-9, f"16c: the rig read back differs by "
              f"{rig_err}: {rig_back}")
        e2e["16c_dataset"] = dict(write_s=write_s, rig_quat_err=rig_err,
                                  bytes=sum(
                                      os.path.getsize(os.path.join(r, f))
                                      for r, _d, fs in os.walk(data)
                                      for f in fs))
        print(f"[16c dataset] {2 * NUM_IMAGES} PPM frames, the poses and "
              f"the two-camera rig YAML written in {write_s:.2f} s "
              f"({e2e['16c_dataset']['bytes']} bytes); the rig read back "
              f"without PyYAML within {rig_err:.1e}", flush=True)

        # the poses and the rig as read back from the files, the frames
        # in memory: the CLIs read the same files
        mc_gray = rig_datasets(rig_back, quats_back, trans_back,
                               (gray0_h, gray1_h))
        mc_col = rig_datasets(rig_back, quats_back, trans_back, col_h)
        rig_flags = [
            "--data_directory", data, "--prefix_images", "cam{cam}/image_",
            "--image_extension", ".ppm", "--load_colored_images",
            "--colored_ortho", "--all_cameras", "--kernel_family", "pallas",
            "--num_disparities", str(NUM_DISP), "--interpolation_radius",
            "2"] + rig_grid_flags()
        batch_argv = rig_flags + [
            "--dense_pcl_use_every_nth_image", str(USE_EVERY_NTH),
            "--output_geotiff", os.path.join(out, "rig.tif"),
            "--orthomosaic_jpg_filename", os.path.join(out, "rig.ppm"),
            "--output_layers_npz", os.path.join(out, "rig_job.npz")]
        inc_argv = rig_flags + [
            "--update_every_nth", str(USE_EVERY_NTH),
            "--orthomosaic_jpg_filename", os.path.join(out, "rig_inc.pgm"),
            "--output_layers_npz", os.path.join(out, "rig_stream.npz")]
        cfg_job = common.pipeline_config_from_args(
            main_ortho_backward_grid.parse_args(batch_argv))
        cfg_stream = common.pipeline_config_from_args(
            main_ortho_backward_grid_incremental.parse_args(inc_argv))

        def gray_of(cfg):
            return dataclasses.replace(cfg, ortho_backward=dataclasses.replace(
                cfg.ortho_backward, colored_ortho=False))

        geom = MapGeometry.from_config(cfg_job.grid)
        check(tuple(geom[3:]) == (MAP_CELLS + RIG_NORTH_ROWS, MAP_CELLS)
              and geom.north == (MAP_CELLS / 2 + RIG_NORTH_ROWS) * RESOLUTION
              and cfg_job.ortho_backward.colored_ortho
              and cfg_job.bm.kernel == cfg_job.ortho_backward.score_kernel
              == cfg_job.dsm.idw_kernel == "pallas",
              f"16c: the CLIs' config is not the rig's: {geom}, {cfg_job}")
        ce, cn = cell_centers(geom, device=dev)
        truth_h, truth_t = scene.height(ce, cn), scene.texture(ce, cn)
        truth_rgb = scene.texture_rgb(ce, cn)
        del ce, cn
        n_ids = 2 * NUM_IMAGES
        check(n_ids < 2 ** 24, "16c: the global ids are not exact in float32")
        job_want = want(bm_scan=2 * pairs, binned_idw_cuda=1,
                        score_pass_cuda=2)
        stream_want = want(bm_scan=2 * pairs, binned_idw_cuda=pairs,
                           score_pass_cuda=2 * n_updates)

        def rig_checks(tag, m, alone, colored):
            """16c's checks of a fused map: phase 4's bars (the RGB against
            ``texture_rgb``), more DSM than camera 0's, the ids."""
            textured = torch.isfinite(m["observation_index"])
            if colored:
                ortho = torch.round(unpack_float_to_rgb(m["colored_ortho"])
                                    * 255.0)
                bars = ortho_bars(f"{tag} RGB", ortho, textured, truth_rgb)
            else:
                bars = ortho_bars(tag, m["ortho"], textured, truth_t)
            bars.update(dsm_bars(tag, m["elevation"], truth_h))
            cov = int(torch.isfinite(m["elevation"]).sum().item())
            cov0 = int(torch.isfinite(alone).sum().item())
            check(cov > RIG_COVERAGE_GAIN * cov0, f"{tag}: the fused DSM "
                  f"covers {cov} cells, camera 0 alone {cov0}")
            ids = m["observation_index"][textured]
            by_cam = [int((ids < NUM_IMAGES).sum().item()),
                      int((ids >= NUM_IMAGES).sum().item())]
            check(bool(torch.equal(ids, torch.round(ids)))
                  and ids.min().item() >= 0 and ids.max().item() < n_ids
                  and min(by_cam) > 0, f"{tag}: observation ids in "
                  f"[{ids.min().item()}, {ids.max().item()}], cells by "
                  f"camera {by_cam}")
            rec = dict(dsm_cells=cov, camera0_dsm_cells=cov0,
                       dsm_gain=cov / cov0, textured_by_camera=by_cam,
                       **bars)
            print(f"[{tag}] DSM {cov} cells ({cov / cov0:.3f} x camera 0's "
                  f"{cov0}), median |err| {bars['dsm_median_abs_err_m']:.4f}"
                  f" m; ortho coverage {bars['ortho_coverage']:.4f}, median "
                  f"|err| {bars['ortho_median_abs_err_gray']:.3f}; cells "
                  f"textured by camera 0 / 1: {by_cam}", flush=True)
            return rec

        alone_job, secs["16c camera 0 DSM"] = runs.timed(
            "16c camera 0 DSM", lambda: batch.run_dsm(
                mc_gray[0], gray_of(cfg_job), device=dev)[0]["elevation"],
            want(bm_scan=pairs, binned_idw_cuda=1))
        alone_stream = stream("16c camera 0 stream", mc_gray[0],
                              gray_of(cfg_stream), inc_want)["elevation"]
        c_job = job("16c rig job", mc_gray[0], gray_of(cfg_job), job_want,
                    datasets=mc_gray)
        e2e["16c job"] = rig_checks("16c rig job", c_job, alone_job, False)
        c_stream = stream("16c rig stream", mc_gray[0], gray_of(cfg_stream),
                          stream_want, datasets=mc_gray)
        e2e["16c stream"] = rig_checks("16c rig stream", c_stream,
                                       alone_stream, False)
        c_job_col = job("16c colored rig job", mc_col[0], cfg_job, job_want,
                        datasets=mc_col)
        e2e["16c colored job"] = rig_checks("16c colored rig job", c_job_col,
                                            alone_job, True)
        # the operands of each kernel at the update before the middle of
        # the colored rig stream (update u_k: its two pairs, its fused
        # cloud, its two score passes) on the rig's map; at the bench's
        # cadence it is frame 118 against 111, along the first flight
        # line (the next pair crosses the turn, phase 6d)
        u_k = n_updates // 2 - 1
        with FirstCall(cuda_bm, "bm_scan", keep=2, skip=2 * (u_k - 1)) \
                as bm_op, \
                FirstCall(cuda_idw, "binned_idw_cuda", skip=u_k - 1) \
                as idw_op, \
                FirstCall(cuda_score, "score_pass_cuda", keep=2,
                          skip=2 * u_k) as score_op:
            c_stream_col = stream("16c colored rig stream", mc_col[0],
                                  cfg_stream, stream_want, datasets=mc_col)
        check(len(bm_op.kept) == 2 and len(idw_op.kept) == 1
              and len(score_op.kept) == 2, f"16c: operands captured "
              f"{[len(op.kept) for op in (bm_op, idw_op, score_op)]}")
        cams = ("camera 0", "camera 1")
        errs = rig_kernel_checks(
            f"16c update {u_k}", list(zip(cams, bm_op.kept)),
            [("the fused cloud", idw_op.kept[0])],
            list(zip(cams, score_op.kept)), dsm_cfg, cam)
        e2e["16c kernels"] = dict(update=u_k, **errs)
        del bm_op, idw_op, score_op
        e2e["16c colored stream"] = rig_checks(
            "16c colored rig stream", c_stream_col, alone_stream, True)
        del c_job, alone_job, alone_stream

        # ---- 16d. on logical shards of the card ----
        card = torch.device("cuda", 0) if dev.type == "cuda" else dev

        def sharded_stream(tag, datasets, cfg, **kw):
            """The rig stream on RIG_SHARDS logical shards, counted and
            held to the driver's calls; both streams in the run."""
            with logical_shards(RIG_SHARDS, card):
                m, rec, records = counted_sharded_stream(
                    runs, datasets[0], cfg, RIG_SHARDS, tag, dev,
                    datasets=datasets, **kw)
            check(any(f"sharded over {RIG_SHARDS} devices, 2 camera streams"
                      in r.getMessage() for r in records), f"{tag}: the "
                  "sharded driver did not run both streams")
            secs[tag] = rec["wall_s"]
            return m, rec

        d_stream, rec = sharded_stream("16d rig stream, 8 shards", mc_gray,
                                       gray_of(cfg_stream))
        check(maps_bit_equal(d_stream, c_stream), "16d: the sharded rig "
              "stream differs from its one-device run")
        e2e["16d stream"] = rec
        del d_stream, c_stream
        slots = -(-pairs // RIG_SHARDS) * RIG_SHARDS  # the padded ring
        with logical_shards(RIG_SHARDS, card):
            d_job = job("16d colored rig job, 8 shards", mc_col[0], cfg_job,
                        want(bm_scan=2 * slots, binned_idw_cuda=RIG_SHARDS,
                             score_pass_cuda=2 * RIG_SHARDS),
                        datasets=mc_col)
        check(maps_bit_equal(d_job, c_job_col), "16d: the sharded colored "
              "rig job differs from its one-device run")
        del d_job
        # the IDW and score operands of every band (shard) at the fused
        # step and the score pass halfway down the colored stream, whose
        # passes are the gray stream's; each pass runs the shards in order
        last = {}
        gray_rec = e2e["16d stream"]
        half = RIG_SHARDS * (gray_rec["fused_steps"] // 2)
        half_sc = RIG_SHARDS * ((gray_rec["fused_steps"]
                                 + gray_rec["ortho_only_passes"]) // 2)
        with FirstCall(tsh, "binned_idw_cuda", keep=RIG_SHARDS,
                       skip=half) as idw_op, \
                FirstCall(cuda_score, "score_pass_cuda", keep=RIG_SHARDS,
                          skip=half_sc) as score_op:
            d_col, rec = sharded_stream(
                "16d colored rig stream, 8 shards", mc_col, cfg_stream,
                on_update=lambda i, ls, _g: last.update(
                    i=i, layers=ls, n=last.get("n", 0) + 1))
        check(len(idw_op.kept) == len(score_op.kept) == RIG_SHARDS,
              f"16d: band operands captured {len(idw_op.kept)}, "
              f"{len(score_op.kept)}")
        bands = [f"band {b}" for b in range(RIG_SHARDS)]
        d_errs = rig_kernel_checks(
            "16d colored stream", [], list(zip(bands, idw_op.kept)),
            list(zip(bands, score_op.kept)), dsm_cfg, cam)
        e2e["16d kernels"] = dict(
            fused_step=half // RIG_SHARDS, score_pass=half_sc // RIG_SHARDS,
            band_rows=[int(kw["grid_shape"][0]) for _a, kw in score_op.kept],
            **d_errs)
        errs = {k: max(v, d_errs.get(k, 0.0)) for k, v in errs.items()}
        del idw_op, score_op
        check(maps_bit_equal(d_col, c_stream_col), "16d: the sharded "
              "colored rig stream differs from its one-device run")
        check(last.get("n") == n_updates and all(
            isinstance(x, np.ndarray) for x in last["layers"].values())
            and maps_bit_equal({k: torch.from_numpy(x) for k, x in
                                last["layers"].items()},
                               {k: x.cpu() for k, x in d_col.items()}),
            f"16d: {last.get('n')} payloads; the last is not the final map "
            "as host numpy")
        rec["payloads"] = last["n"]
        e2e["16d colored stream"] = rec
        del d_col, last
        print(f"[16d] on {RIG_SHARDS} logical shards: the rig stream "
              f"{e2e['16d stream']['wall_s']:.2f} s, the colored job "
              f"{secs['16d colored rig job, 8 shards']:.2f} s, the colored "
              f"stream {e2e['16d colored stream']['wall_s']:.2f} s "
              f"({e2e['16d colored stream']['payloads']} payloads), each "
              "map bit-equal to its one-device run", flush=True)

        # ---- 16e. the two backward-grid CLIs ----
        with _ModulesBlocked("yaml", "PIL"):
            for tag, mod, argv, expect in (
                    ("16e main_ortho_backward_grid", main_ortho_backward_grid,
                     batch_argv, job_want),
                    ("16e main_ortho_backward_grid_incremental",
                     main_ortho_backward_grid_incremental, inc_argv,
                     stream_want)):
                secs[tag] = runs.timed(tag, lambda: mod.main(argv),
                                       expect)[1]
        for name, ref in (("rig_job.npz", c_job_col),
                          ("rig_stream.npz", c_stream_col)):
            layers, g = load_layers(os.path.join(out, name))
            check(g == geom and maps_bit_equal(
                {k: torch.from_numpy(x) for k, x in layers.items()},
                {k: x.cpu() for k, x in ref.items()}),
                f"16e: {name} differs from 16c's run of the same files")
        image = batch._ortho_image(c_job_col, True)
        tif, _geo, _zone = read_geotiff(os.path.join(out, "rig.tif"))
        ppm = load_images_by_names(out, ["rig.ppm"], color=True)[0]
        check(np.array_equal(tif, image) and np.array_equal(ppm, image),
              "16e: the CLI's GeoTiff or image differs from _ortho_image")
        print(f"[16e] the batch CLI "
              f"({secs['16e main_ortho_backward_grid']:.2f} s) and the "
              f"incremental CLI "
              f"({secs['16e main_ortho_backward_grid_incremental']:.2f} s) "
              "with yaml and PIL blocked: layers bit-equal to 16c's colored "
              "runs, the GeoTiff and image to _ortho_image", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    e2e["geometry"] = dict(rows=geom.height, cols=geom.width,
                           resolution=geom.resolution, north=geom.north,
                           south=geom.north - geom.height * geom.resolution)
    e2e["launches"] = runs.launches
    e2e["phase_s"] = time.perf_counter() - t_phase
    print(f"[16 done] phase 16 took {e2e['phase_s']:.1f} s", flush=True)
    return e2e, runs.launches, errs


def smoke_configs():
    """(bm, dsm, ortho, sgm) configs of the main path: every kernel
    switch on the hand kernel (``bench_torch.py``'s and SGM's)."""
    from aerial_mapper_tpu_torch.config import SgmConfig

    return (*bench_torch.bench_configs(),
            SgmConfig(num_disparities=NUM_DISP, kernel="pallas"))


def stream_config(bm_cfg, dsm_cfg, ortho_cfg, **kw):
    """Phase 6's ``PipelineConfig`` for the bench stream
    (``bench_torch.py``'s, on this script's map)."""
    return bench_torch.stream_config(bm_cfg, dsm_cfg, ortho_cfg,
                                     map_cells=MAP_CELLS, **kw)


def build_workload(dev, images=None):
    """The bench workload (``bench_torch.py``) at this script's sizes,
    without the pose jitter, the frames as float32 (``images``, [N, H, W]
    on ``dev``, skip the render)."""
    w = bench_torch.build_workload(
        dev, images, num_images=NUM_IMAGES, width=IMG_W, height=IMG_H,
        map_cells=MAP_CELLS, jitter=0.0, use_every_nth=USE_EVERY_NTH)
    w["images"] = w["images"].float()
    return w


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--sgm-chunk", default="none",
        help="pairs per pass of the SGM step (process_pairs_batched's "
             "batch_chunk); 'none' = all pairs in one pass")
    ap.add_argument("--dist-worker", type=int, default=None,
                    help=argparse.SUPPRESS)  # phase 13's worker: its rank
    ap.add_argument("--dist-dir", help=argparse.SUPPRESS)
    ap.add_argument("--dist-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--dist-phase", type=int, default=13,
                    help=argparse.SUPPRESS)  # 13 or 14: the worker's phase
    args = ap.parse_args()
    sgm_chunk = None if args.sgm_chunk == "none" else int(args.sgm_chunk)
    if not torch.cuda.is_available() and args.dist_device == "cuda":
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    # full float32 products on the card: TF32 would round the geometry to
    # ~3 decimal digits and blur the kernel-vs-plain comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dist_worker is not None:
        worker = batch_dist_worker if args.dist_phase == 14 else dist_worker
        return worker(args.dist_worker, args.dist_dir, args.dist_device)
    from aerial_mapper_tpu_torch import _build
    from aerial_mapper_tpu_torch.config import BlockMatchingConfig
    from aerial_mapper_tpu_torch.dsm.cuda_idw import binned_idw_cuda
    from aerial_mapper_tpu_torch.dsm.idw import (
        _circular_offsets,
        bin_with_halo,
        binned_idw,
        idw_to_grid,
    )
    from aerial_mapper_tpu_torch.ortho.backward_grid import (
        _score_pass,
        backward_grid_update,
    )
    from aerial_mapper_tpu_torch.ortho.cuda_score import score_pass_cuda
    from aerial_mapper_tpu_torch.pipeline.step import map_step
    from aerial_mapper_tpu_torch.stereo.batched import process_pairs_batched
    from aerial_mapper_tpu_torch.stereo.cuda_bm import (
        bm_scan,
        bm_scan_plain,
        float_entry,
        prefilter_pair,
    )
    from aerial_mapper_tpu_torch.stereo.cuda_sgm import (
        NUM_PASSES,
        sgm_scan,
        sgm_scan_plain,
    )
    from aerial_mapper_tpu_torch.stereo.matching import (
        _sgm_cost,
        _xsobel_prefilter,
        sgm_cost_volume,
        sgm_lr_check,
        sgm_uniqueness,
        sgm_wta,
        use_integer_costs,
    )
    from aerial_mapper_tpu_torch.stereo.rectify import _rectify_image

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ----
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {kind}; nvidia-smi: {smi}; torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.load()
    print(f"[2 build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({os.path.relpath(_build.library_path(), here)})", flush=True)
    # phase 15's oracle: the C++ reference loops (make's libambaseline.so
    # target, a C++ compiler and nothing else); missing, the run fails
    from aerial_mapper_tpu_torch.native import load_native

    t0 = time.perf_counter()
    check(load_native() is not None, "native/libambaseline.so did not build"
          " or load (make -C native libambaseline.so needs a C++ compiler)")
    print(f"[2 build] native reference loops built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the host image loader (native/; io/images.py's "auto" backend takes
    # it where it builds): built here so no later phase pays for it
    from aerial_mapper_tpu_torch.io.native_loader import (
        native_loader_available,
    )

    t0 = time.perf_counter()
    native = native_loader_available()
    print(f"[2 build] native image loader "
          f"{'built and loaded' if native else 'unavailable (make failed)'}"
          f" in {time.perf_counter() - t0:.1f} s", flush=True)
    bm_cfg, dsm_cfg, ortho_cfg, sgm_cfg = smoke_configs()
    # both BM kernels have one instantiation per radius: print those of the
    # blocks the smoke times (the integer entry's bench block, the float
    # entry's 15 and 25), and the others' register and spill figures in sum
    shown = (f"bm_scan_int_kernelILi{bm_cfg.block_size // 2}E",
             "bm_scan_float_kernelILi7E", "bm_scan_float_kernelILi12E")
    entry, others = "", {}
    for line in _build.build_log.splitlines():
        if "entry function" in line:
            entry = line
        kernel = next((k for k in ("bm_scan_int_kernel",
                                   "bm_scan_float_kernel") if k in entry),
                      None)
        if kernel and not any(s in entry for s in shown):
            names, regs, spill = others.setdefault(kernel, (set(), [], [0]))
            names.add(entry)
            regs += [int(n) for n in re.findall(r"Used (\d+) registers",
                                                line)]
            spill[0] += sum(int(n) for n in re.findall(
                r"(\d+) bytes spill stores", line))
            continue
        if ("registers" in line or "spill" in line
                or "entry function" in line):
            print(f"    ptxas: {line.strip()}")
    for kernel, (names, regs, spill) in others.items():
        if regs:
            print(f"    ptxas: {len(names)} more radii of {kernel}: "
                  f"{min(regs)}-{max(regs)} registers, {spill[0]} bytes of "
                  f"spill stores in all")

    t0 = time.perf_counter()
    w = build_workload(dev)
    torch.cuda.synchronize()
    ops, cam, geom = w["ops"], w["cam"], w["geom"]
    print(f"[workload] {NUM_IMAGES} images {IMG_W}x{IMG_H}, "
          f"{ops.image1.shape[0]} pairs, map {MAP_CELLS}x{MAP_CELLS} at "
          f"{RESOLUTION} m, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kernels = []

    # ---- 3a. BM scan: both entries bit-equal to the plain version ----
    rect1 = _rectify_image(ops.image1, ops.T1_inv)
    rect2 = _rectify_image(ops.image2, ops.T2_inv)
    cap = bm_cfg.pre_filter_cap
    lf, rf = prefilter_pair(rect1, rect2, bm_cfg)  # integer-valued
    bm_err = bm_check("3a bm_scan int, bench pairs", lf, rf, NUM_DISP,
                      bm_cfg.min_disparity, bm_cfg.block_size, True)
    # the largest window sums and the u < min_disp + d border everywhere
    worst_l = torch.full_like(lf[:1], 2.0 * cap)
    bm_err = max(bm_err, bm_check(
        "3a bm_scan int, worst case", worst_l, torch.zeros_like(worst_l),
        NUM_DISP, bm_cfg.min_disparity, bm_cfg.block_size, True))
    # H, W not multiples of the 32 x 64 tile, and W < D + r, at blocks of
    # several instantiations: block 21 is the guard's limit at cap 31, 127
    # its limit at cap 1 (values 0..2)
    gen = torch.Generator(device=dev).manual_seed(0)
    for block, hi in ((1, 2 * cap), (5, 2 * cap), (9, 2 * cap),
                      (bm_cfg.block_size, 2 * cap), (21, 2 * cap), (127, 2)):
        ragged = torch.randint(0, hi + 1, (2, 3, 45, 83), generator=gen,
                               device=dev).float()
        bm_err = max(bm_err, bm_check(
            "3a bm_scan int, ragged", ragged[0], ragged[1], NUM_DISP, 3,
            block, True))
    float_cfg = BlockMatchingConfig(num_disparities=NUM_DISP,
                                    kernel="pallas", integer_costs=False)
    lf_f, rf_f = prefilter_pair(rect1, rect2, float_cfg)  # not integers
    check(not torch.equal(lf_f, torch.round(lf_f)), "float prefilter gave "
          "integers: the float entry's check would prove nothing")
    # the float entry: block 15 (integer_costs=False) and 25 (the guard's
    # float path at cap 31) on the bench pairs; on ragged non-integer
    # batches from block 1 to 89, the largest the wide kernel takes at 80
    # disparities (45: a large ring, r = 22; 89: the wide kernel)
    bm_float_err = 0.0
    for block in (float_cfg.block_size, 25):
        bm_float_err = max(bm_float_err, bm_check(
            "3a bm_scan float, bench pairs", lf_f, rf_f, NUM_DISP,
            float_cfg.min_disparity, block, False))
    for block in (1, 5, 15, 23, 25, 45, 89):
        ragged = torch.rand((2, 3, 45, 83), generator=gen,
                            device=dev) * (2 * cap)
        bm_float_err = max(bm_float_err, bm_check(
            "3a bm_scan float, ragged", ragged[0], ragged[1], NUM_DISP, 3,
            block, False))
    # past its limit the CUDA branch raises before any launch
    over = next(b for b in range(1, 257, 2) if not _fits(float_entry, b))
    n0 = bm_scan.float_launches
    try:
        bm_scan(lf_f[:1], rf_f[:1], NUM_DISP, 0, over, integer_costs=False)
        check(False, f"bm_scan float took block {over} past its limit")
    except ValueError as e:
        check(bm_scan.float_launches == n0, "bm_scan float launched a "
              "kernel before it raised")
        print(f"[3a bm_scan float] block {over} raises before any launch: "
              f"{e}", flush=True)
    del rect1, rect2, worst_l, ragged
    # the integer entry on the integer-valued bench input
    bm_args = (lf, rf, NUM_DISP, bm_cfg.min_disparity, bm_cfg.block_size)
    bm_ms = cuda_ms(lambda: bm_scan(*bm_args, integer_costs=True), reps=10)
    bm_plain_ms = cuda_ms(lambda: bm_scan_plain(*bm_args), reps=3)
    bm_dev_ms = device_ms(lambda: bm_scan(*bm_args, integer_costs=True),
                          "bm_scan_int_kernel", reps=10)
    b_, h_, w_ = lf.shape
    pixels = float(b_ * h_ * w_)
    bm_bound, bm_by = bound(7 * 4.0 * pixels, pixels * NUM_DISP * OPS_BM)
    kernels.append(dict(
        name="bm_scan", route="cuda",
        source="aerial_mapper_tpu_torch/csrc/bm.cu",
        replaces="aerial_mapper_tpu/stereo/pallas_bm.py:57",
        max_abs_err=bm_err, ms=bm_ms, device_ms=bm_dev_ms,
        plain_ms=bm_plain_ms, bound_ms=bm_bound, bound_by=bm_by,
        library_ms=None,
    ))
    print(f"[3a bm_scan] {b_}x{h_}x{w_} D={NUM_DISP}, integer input: "
          f"integer kernel {bm_ms:.3f} ms (device {bm_dev_ms}), plain "
          f"{bm_plain_ms:.3f} ms, bound {bm_bound:.3f} ms ({bm_by})",
          flush=True)
    # the float entry on the float-prefiltered bench input, at blocks 15
    # and 25: the bound of the integer entry's count (OPS_BM) and the
    # order-keeping bound (4r + 9 operations) beside its times
    float_fig = {}
    for block in (float_cfg.block_size, 25):
        fargs = (lf_f, rf_f, NUM_DISP, float_cfg.min_disparity, block)
        order_bound, order_by = bound(
            7 * 4.0 * pixels, pixels * NUM_DISP * (
                OPS_BM_FLOAT_PER_R * (block // 2) + OPS_BM_FLOAT_FIXED))
        float_fig[block] = dict(
            block=block, kernel=float_entry(block, NUM_DISP),
            ms=cuda_ms(lambda: bm_scan(*fargs, integer_costs=False),
                       reps=10),
            device_ms=device_ms(lambda: bm_scan(*fargs, integer_costs=False),
                                "bm_scan_float_kernel", reps=10),
            plain_ms=cuda_ms(lambda: bm_scan_plain(*fargs), reps=2),
            bound_ms=bm_bound, bound_by=bm_by,
            order_bound_ms=order_bound, order_bound_by=order_by)
        f = float_fig[block]
        print(f"[3a bm_scan float] block {block} ({f['kernel']}), float "
              f"input: {f['ms']:.3f} ms (device {f['device_ms']}), plain "
              f"{f['plain_ms']:.3f} ms, bound {bm_bound:.3f} ms ({bm_by}), "
              f"order-keeping bound {order_bound:.3f} ms ({order_by}): "
              f"{order_bound / f['ms']:.3f} of it", flush=True)
    f15 = float_fig[float_cfg.block_size]
    kernels.append(dict(
        name="bm_scan_float", route="cuda",
        source="aerial_mapper_tpu_torch/csrc/bm.cu",
        replaces="aerial_mapper_tpu/stereo/pallas_bm.py:57",
        max_abs_err=bm_float_err, ms=f15["ms"], device_ms=f15["device_ms"],
        plain_ms=f15["plain_ms"], bound_ms=bm_bound, bound_by=bm_by,
        library_ms=None, order_bound_ms=f15["order_bound_ms"],
        block25=float_fig[25],
    ))
    del lf, rf, lf_f, rf_f

    # ---- 3b. IDW on the bench cloud's binned arrays: bit-equal ----
    pts, _intens, valid = process_pairs_batched(ops, cam, bm_cfg,
                                                device=dev)
    p = pts.reshape(-1, 3)
    v = valid.reshape(-1)
    binned, ext, halo = bin_with_halo(p[:, :2], p[:, 2], v, geom,
                                      dsm_cfg.bin_capacity,
                                      dsm_cfg.max_radius_sq)
    idw_args = (binned, ext, dsm_cfg.interpolation_radius_sq, True,
                dsm_cfg.adaptive_growth_factor, dsm_cfg.max_radius_sq)
    idw_err = idw_check("3b binned_idw adaptive", binned, ext, dsm_cfg,
                        True, dsm_cfg.max_radius_sq)
    # the kernel's other instantiation: pass 2 over every offset, without
    # the ladder and for windows of more than 128 offsets
    idw_err = max(idw_err, idw_check("3b binned_idw no ladder", binned, ext,
                                     dsm_cfg, False, dsm_cfg.max_radius_sq))
    idw_err = max(idw_err, idw_check(
        "3b binned_idw adaptive, max_radius_sq 12", binned, ext, dsm_cfg,
        True, 12.0))
    idw_ms = cuda_ms(lambda: binned_idw_cuda(*idw_args), reps=20)
    idw_plain_ms = cuda_ms(lambda: binned_idw(*idw_args), reps=5)
    idw_dev_ms = device_ms(lambda: binned_idw_cuda(*idw_args), "idw_kernel",
                           reps=20)
    kk, hh, ww = binned.de.shape
    m_off = len(_circular_offsets(halo, geom.resolution,
                                  dsm_cfg.max_radius_sq))
    occupied = float(torch.clamp(binned.count, max=kk).sum().item())
    visits1, visits2 = idw_visits(binned, ext, dsm_cfg)
    idw_bound, idw_by = bound(
        (3 * kk + 2) * 4.0 * hh * ww + m_off * 8.0,
        visits1 * OPS_IDW_PASS1 + visits2 * OPS_IDW_PASS2
        + float(hh * ww) * OPS_IDW_LADDER,
    )
    kernels.append(dict(
        name="binned_idw_cuda", route="cuda",
        source="aerial_mapper_tpu_torch/csrc/idw.cu",
        replaces="aerial_mapper_tpu/dsm/pallas_idw.py:45",
        max_abs_err=idw_err, ms=idw_ms, device_ms=idw_dev_ms,
        plain_ms=idw_plain_ms,
        bound_ms=idw_bound, bound_by=idw_by, library_ms=None,
    ))
    print(f"[3b binned_idw] K={kk} {hh}x{ww}, {m_off} offsets, "
          f"{int(v.sum().item())} valid points, {int(occupied)} occupied "
          f"slots, {int(visits1)} slot visits in pass 1, {int(visits2)} "
          f"in pass 2: kernel {idw_ms:.3f} ms "
          f"(device {idw_dev_ms}), "
          f"plain {idw_plain_ms:.3f} "
          f"ms, bound {idw_bound:.4f} ms ({idw_by})", flush=True)
    del pts, valid, p, v, binned

    # ---- 3c. score pass: bit-equal at the bench shape, the survey shape
    # and on an adversarial input ----
    scene = w["scene"]
    sa = score_check("3c score_pass adversarial",
                     *adversarial_score_input(cam, dev), cam)
    sv = score_check("3c score_pass survey",
                     *score_input(scene, *survey_poses(), SURVEY_CELLS, dev),
                     cam, reps=10)
    bench_in = score_input(scene, *bench_poses(), MAP_CELLS, dev)
    sb = score_check("3c score_pass bench", *bench_in, cam, reps=20)
    # the plain version's time in one call, as in every earlier run
    sb["plain_ms"] = cuda_ms(lambda: _score_pass(*bench_in[:2], cam), reps=5)
    score_err = max(f["max_abs_err"] for f in (sa, sv, sb))
    del bench_in
    kernels.append(dict(
        name="score_pass_cuda", route="cuda",
        source="aerial_mapper_tpu_torch/csrc/score.cu",
        replaces="aerial_mapper_tpu/ortho/pallas_score.py:42",
        max_abs_err=score_err, ms=sb["ms"], device_ms=sb["device_ms"],
        plain_ms=sb["plain_ms"], bound_ms=sb["bound_ms"],
        bound_by=sb["bound_by"], library_ms=None,
        kept_share=sb["kept_share"], mean_n_vis=sb["mean_n_vis"],
        survey={k: sv[k] for k in (
            "cells", "cameras", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "kept_share", "mean_n_vis")},
    ))
    print(f"[3c score_pass] bench {sb['cells']} x {sb['cameras']}: kernel "
          f"{sb['ms']:.3f} ms (device {sb['device_ms']}), plain "
          f"{sb['plain_ms']:.3f} ms, bound {sb['bound_ms']:.4f} ms "
          f"({sb['bound_by']}); survey {sv['cells']} x {sv['cameras']}: "
          f"kernel {sv['ms']:.3f} ms (device {sv['device_ms']}), plain "
          f"{sv['plain_ms']:.1f} ms, bound {sv['bound_ms']:.4f} ms "
          f"({sv['bound_by']})", flush=True)

    # ---- 3d. SGM scan: bit-equal to the plain version, both forms ----
    rect1 = _rectify_image(ops.image1, ops.T1_inv)
    rect2 = _rectify_image(ops.image2, ops.T2_inv)
    n_pairs = rect1.shape[0]
    chunk = sgm_chunk or n_pairs
    # the real BT cost, in the SGM step's chunks: [chunk, H, W, D] each
    costs = [_sgm_cost(rect1[i:i + chunk], rect2[i:i + chunk], sgm_cfg)[1]
             for i in range(0, n_pairs, chunk)]
    # the step's x-Sobel images of all 35 pairs, for 3e
    sgm_cap = float(sgm_cfg.pre_filter_cap)
    sgm_lf = _xsobel_prefilter(rect1, sgm_cap)
    sgm_rf = _xsobel_prefilter(rect2, sgm_cap)
    del rect1, rect2
    # the whole first chunk: the pair axis (grid.y) at the step's shape
    sgm_err, compared = sgm_check("3d sgm_scan", costs[0], sgm_cfg)

    def sgm_all(scan):
        for c in costs:
            for pass_id in range(NUM_PASSES):
                scan(c, sgm_cfg.p1, sgm_cfg.p2, pass_id, True)

    sgm_ms = cuda_ms(lambda: sgm_all(sgm_scan), reps=3)
    sgm_dev_ms = device_ms(lambda: sgm_all(sgm_scan), "sgm_scan_kernel",
                           reps=2)
    sgm_plain_ms = cuda_ms(lambda: sgm_all(sgm_scan_plain), reps=1,
                           warmup=0)
    _b, sh, sw, sd = costs[0].shape
    sgm_vals = float(n_pairs * sh * sw * sd)
    sgm_bound, sgm_by = bound(NUM_PASSES * 2 * 4.0 * sgm_vals,
                              NUM_PASSES * sgm_vals * OPS_SGM)
    kernels.append(dict(
        name="sgm_scan", route="cuda",
        source="aerial_mapper_tpu_torch/csrc/sgm.cu",
        replaces="aerial_mapper_tpu/stereo/pallas_sgm.py:48",
        max_abs_err=sgm_err, ms=sgm_ms, device_ms=sgm_dev_ms,
        plain_ms=sgm_plain_ms,
        bound_ms=sgm_bound, bound_by=sgm_by, library_ms=None,
    ))
    print(f"[3d sgm_scan] {NUM_PASSES} passes on {_b}x{sh}x{sw} D={sd}: "
          f"bit-equal in {compared} pass/form cases; over the step's "
          f"{len(costs)} chunks of {chunk} pairs ({n_pairs} pairs, "
          f"{NUM_PASSES * len(costs)} launches): kernel {sgm_ms:.3f} ms "
          f"(device {sgm_dev_ms}), "
          f"plain {sgm_plain_ms:.3f} ms, bound {sgm_bound:.3f} ms "
          f"({sgm_by})", flush=True)
    del costs

    # ---- 3e. SGM's cost and post-filter kernels: bit-equal, timed ----
    kernels += sgm_match_phase(sgm_lf, sgm_rf, sgm_cfg, dev, smi)
    del sgm_lf, sgm_rf

    truth_h = scene.height(w["ce"], w["cn"])
    truth_t = scene.texture(w["ce"], w["cn"])

    counters = (bm_scan, binned_idw_cuda, score_pass_cuda, sgm_scan)
    # SGM's cost and post-filter kernels: counted on the steps of phases 4
    # and 5 (the later phases' expectations hold the four above)
    sgm_match = (sgm_cost_volume, sgm_wta, sgm_uniqueness, sgm_lr_check)

    def drive_step(tag, match_kw, step_bm_cfg=bm_cfg, strict_bars=True):
        """Drive ``map_step`` with ``match_kw`` (matcher, sgm_cfg,
        batch_chunk) and ``step_bm_cfg``: 6 runs (the first is the warm-up)
        with every counter set to 0 just before and read just after, the
        DSM and ortho scored against the scene (without ``strict_bars`` a
        missed bar is listed under ``bars_missed``, not raised), per-stage
        times, one profiled step. ``launches["bm_scan"]`` counts the
        integer BM entry, ``launches["bm_scan_float"]`` the float one."""
        step_args = (w["layers"], ops, w["quats"], w["ts"], w["images"],
                     geom, cam, step_bm_cfg, dsm_cfg, ortho_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters + sgm_match:
            fn.launches = 0
        bm_scan.float_launches = 0
        step_s = []
        for _ in range(6):  # the first run is the warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = map_step(*step_args, device=dev, **match_kw)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in counters + sgm_match}
        launches["bm_scan_float"] = bm_scan.float_launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        missed = None if strict_bars else []
        bars = map_bars(tag, out, truth_h, truth_t, missed)
        if missed is not None:
            bars["bars_missed"] = missed
        elevation = out["elevation"]

        # per-stage times (CUDA events, median of 3 after a warm-up)
        stage = {}
        pts_box = {}

        def stereo():
            pts_box["r"] = process_pairs_batched(ops, cam, step_bm_cfg,
                                                 device=dev, **match_kw)

        stage["stereo_ms"] = cuda_ms(stereo, reps=3)
        pts, _i, valid = pts_box["r"]
        p = pts.reshape(-1, 3)
        idw_kw = dict(radius_sq=dsm_cfg.interpolation_radius_sq,
                      adaptive=True, growth=dsm_cfg.adaptive_growth_factor,
                      max_radius_sq=dsm_cfg.max_radius_sq, kernel="pallas")
        stage["dsm_ms"] = cuda_ms(lambda: idw_to_grid(
            p[:, :2], p[:, 2], valid.reshape(-1), geom,
            dsm_cfg.bin_capacity, **idw_kw), reps=3)
        lay = dict(w["layers"])
        lay["elevation"] = elevation
        stage["ortho_ms"] = cuda_ms(lambda: backward_grid_update(
            lay, w["quats"], w["ts"], w["images"], geom, cam, ortho_cfg),
            reps=3)
        del pts_box, pts, valid, p

        # where the device time goes: one profiled step, kernels by name
        device_ms, top, _host = profile_top(
            lambda: map_step(*step_args, device=dev, **match_kw))
        step_med_s = float(np.median(step_s[1:]))
        e2e = dict(
            step_s=step_s[1:], step_median_s=step_med_s,
            step_warmup_s=step_s[0],
            # kernel time of the profiled step over the unprofiled median
            # step (one stream, so kernels do not overlap); None = no trace
            device_ms=device_ms if top else None,
            device_busy_share=(device_ms / (step_med_s * 1e3) if top
                               else None),
            top_kernels=[dict(ms=t, name=k[:80], count=c)
                         for t, k, c in top[:12]],
            peak_mem_gib=peak_gib, launches=launches, **bars, **stage,
        )
        print(f"[{tag} e2e] step median {step_med_s:.4f} s of "
              f"{len(step_s) - 1} (warm-up {step_s[0]:.3f} s); stages "
              f"stereo {stage['stereo_ms']:.2f} ms, "
              f"dsm {stage['dsm_ms']:.2f} ms, ortho "
              f"{stage['ortho_ms']:.2f} ms; DSM coverage "
              f"{bars['dsm_coverage']:.4f}, median |err| "
              f"{bars['dsm_median_abs_err_m']:.4f} m; ortho coverage "
              f"{bars['ortho_coverage']:.4f}, median |err| "
              f"{bars['ortho_median_abs_err_gray']:.3f} gray; peak "
              f"{peak_gib:.2f} GiB; launches {launches}", flush=True)
        if top:
            print(f"[{tag} profile] kernels {device_ms:.2f} ms of the "
                  f"{step_med_s * 1e3:.2f} ms step "
                  f"(busy share {e2e['device_busy_share']:.3f}):")
            for t, k, c in top[:12]:
                print(f"    {t:9.3f} ms  x{c:<4d} {k[:90]}")
        else:
            print(f"[{tag} profile] torch.profiler recorded no device "
                  "time: busy share not measured")
        return e2e

    # ---- 4. the fused mapping step end to end (BM) ----
    e2e = drive_step("4", {})
    for name in ("bm_scan", "binned_idw_cuda", "score_pass_cuda"):
        check(e2e["launches"][name] > 0,
              f"{name} was never launched on the BM path")
    check(e2e["launches"]["bm_scan"] == 6
          and e2e["launches"]["bm_scan_float"] == 0,
          f"the BM step must be one integer-path BM launch: "
          f"{e2e['launches']} in 6 runs")
    check(e2e["launches"]["sgm_scan"] == 0
          and not any(e2e["launches"][fn.__name__] for fn in sgm_match),
          f"the BM step launched an SGM kernel: {e2e['launches']}")

    # ---- 4f. the BM step on the float path (integer_costs=False) ----
    e2e_float = drive_step("4f", {}, float_cfg)
    check(e2e_float["launches"]["bm_scan_float"] == 6
          and e2e_float["launches"]["bm_scan"] == 0,
          f"the float BM step must be one float-path BM launch: "
          f"{e2e_float['launches']} in 6 runs")

    # ---- 4f(ii). the BM step at block 25: the integer guard (2 * 31 *
    # 25^2 > 32767) sends it to the float entry ----
    bm25_cfg = BlockMatchingConfig(num_disparities=NUM_DISP, block_size=25,
                                   kernel="pallas")
    check(not use_integer_costs(bm25_cfg), "block 25 at the default cap "
          "passed the integer guard")
    e2e_float25 = drive_step("4f(ii)", {}, bm25_cfg, strict_bars=False)
    n = e2e_float25["launches"]
    check(n["bm_scan_float"] == 6 and n["bm_scan"] == 0
          and n["binned_idw_cuda"] == 6 and n["score_pass_cuda"] == 6
          and n["sgm_scan"] == 0,
          f"the block-25 step must be 1 float BM, 1 IDW and 1 score launch: "
          f"{n} in 6 runs")
    e2e_float["block25"] = e2e_float25

    # ---- 5. the same step with the SGM matcher ----
    e2e_sgm = drive_step(
        "5", dict(matcher="sgm", sgm_cfg=sgm_cfg, batch_chunk=sgm_chunk))
    for name in ("sgm_scan", "binned_idw_cuda", "score_pass_cuda"):
        check(e2e_sgm["launches"][name] > 0,
              f"{name} was never launched on the SGM path")
    check(e2e_sgm["launches"]["bm_scan"] == 0
          and e2e_sgm["launches"]["bm_scan_float"] == 0,
          "the SGM step launched bm_scan")
    # one cost, WTA, uniqueness and LR launch per pass of 8 scans
    check(e2e_sgm["launches"]["sgm_scan"] > 0 and all(
        8 * e2e_sgm["launches"][fn.__name__]
        == e2e_sgm["launches"]["sgm_scan"] for fn in sgm_match),
        f"the SGM step must launch each of SGM's cost and post-filter "
        f"kernels once per 8 scans: {e2e_sgm['launches']}")

    # ---- 6. the incremental driver at full width ----
    e2e_inc, inc_launches, inc_errs, inc_map = incremental_phase(
        w, bm_cfg, dsm_cfg, ortho_cfg, counters, truth_h, truth_t, dev)

    # ---- 7. the five batch drivers at full width ----
    e2e_batch, batch_launches, batch_errs = batch_phase(
        w, bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg, counters, truth_h, truth_t,
        dev)

    # ---- 8. the plane sweep and the distorted-camera path ----
    e2e_s7, s7_launches, s7_errs = slice7_phase(
        w, bm_cfg, dsm_cfg, ortho_cfg, counters, truth_h, truth_t, dev)

    # ---- 9. the demo CLIs on a dataset on disk ----
    e2e_cli, cli_launches = cli_phase(w, counters, truth_h, truth_t, dev)

    # ---- 10. feature-track bundle adjustment and --refine_poses ----
    e2e_refine, refine_launches = refine_phase(w, counters, truth_h,
                                               truth_t, dev)

    # ---- 11. the one-process mesh on logical shards of the card ----
    e2e_shard, shard_launches, shard_errs, maps_11c = shard_phase(
        w, bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg, counters, truth_h, truth_t,
        e2e["step_median_s"], dev)

    # ---- 12. the sharded incremental driver on logical shards ----
    e2e_ss, ss_launches, ss_errs = stream_shard_phase(
        w, bm_cfg, dsm_cfg, ortho_cfg, counters, inc_map,
        e2e_inc["streaming_median_s"], dev)

    # ---- 13. the mesh across processes: two Gloo workers, one NCCL rank
    e2e_dist, dist_launches = dist_phase(
        w, (bm_cfg, dsm_cfg, ortho_cfg), counters, inc_map,
        e2e_ss["12a"]["median_wall_s"], dev)
    del inc_map

    # ---- 14. the batch drivers across processes: two Gloo workers, one
    # NCCL rank
    e2e_dist_batch, dist_batch_launches = batch_dist_phase(
        w, (bm_cfg, sgm_cfg, dsm_cfg, ortho_cfg), counters, maps_11c, dev)
    del maps_11c

    # ---- 15. the card's two rasters against the C++ reference loops ----
    e2e_native, native_launches = native_phase(
        w, dsm_cfg, ortho_cfg, counters, truth_h, smi, dev)

    # ---- 16. colored frames and the two-camera rig ----
    e2e_rig, rig_launches, rig_errs = colored_rig_phase(
        w, bm_cfg, dsm_cfg, ortho_cfg, counters, dev)

    path_of = {"sgm_scan": e2e_sgm, "bm_scan_float": e2e_float,
               **{fn.__name__: e2e_sgm for fn in sgm_match}}
    for k in kernels:  # the count over its path's 6 runs
        k["launches"] = path_of.get(k["name"], e2e)["launches"][k["name"]]
        if k["name"] not in inc_launches:  # counted on phases 4 and 5 only
            continue
        # and over 4f(ii)'s 6 runs of the step at block 25
        k["block25_launches"] = e2e_float25["launches"][k["name"]]
        # and over one run of the incremental driver (35 updates)
        k["incremental_launches"] = inc_launches[k["name"]]
        # and over one run of each batch driver
        k["batch_launches"] = {driver: n[k["name"]]
                               for driver, n in batch_launches.items()}
        # and over each run of phase 8 (plane sweep, lens)
        k["slice7_launches"] = {tag: n[k["name"]]
                                for tag, n in s7_launches.items()}
        # and over each CLI run of phase 9b
        k["cli_launches"] = {tag: n[k["name"]]
                             for tag, n in cli_launches.items()}
        # and over each run of phase 10 (BA, refinement, the CLIs)
        k["refine_launches"] = {tag: n[k["name"]]
                                for tag, n in refine_launches.items()}
        # and over each run of phase 11 (the sharded step per step, the
        # sharded drivers, the sharded BA)
        k["shard_launches"] = {tag: n[k["name"]]
                               for tag, n in shard_launches.items()}
        # and over each run of phase 12 (the sharded incremental driver)
        k["stream_shard_launches"] = {tag: n[k["name"]]
                                      for tag, n in ss_launches.items()}
        # and over each run of phase 13: per rank of the two workers (13a
        # to 13c), in the one-rank NCCL group (13d)
        k["dist_launches"] = {
            tag: ([r[k["name"]] for r in n] if isinstance(n, list)
                  else n[k["name"]]) for tag, n in dist_launches.items()}
        # and over each driver of phase 14: per rank of the two workers
        # (14a), in the one-rank NCCL group (14b)
        k["dist_batch_launches"] = {
            tag: ([r[k["name"]] for r in n] if isinstance(n, list)
                  else n[k["name"]])
            for tag, n in dist_batch_launches.items()}
        # and over phase 15's one ortho and one DSM pass
        k["native_launches"] = native_launches[k["name"]]
        # and over each run of phase 16 (the colored stream and job, the
        # rig's runs on one device and on logical shards, the two CLIs)
        k["colored_rig_launches"] = {tag: n[k["name"]]
                                     for tag, n in rig_launches.items()}
        # the checks on one update's operands (phase 6d), on the batch
        # drivers' SGM shape (phase 7b), on phase 8's operands and on a
        # shard's band operands (11b) too
        k["max_abs_err"] = max(k["max_abs_err"],
                               inc_errs.get(k["name"], 0.0),
                               batch_errs.get(k["name"], 0.0),
                               s7_errs.get(k["name"], 0.0),
                               shard_errs.get(k["name"], 0.0),
                               ss_errs.get(k["name"], 0.0),
                               rig_errs.get(k["name"], 0.0))
    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"e2e_bm_float": e2e_float}))
    print(json.dumps({"e2e_sgm": e2e_sgm}))
    print(json.dumps({"e2e_incremental": e2e_inc}))
    print(json.dumps({"e2e_batch": e2e_batch}))
    print(json.dumps({"e2e_slice7": e2e_s7}))
    print(json.dumps({"e2e_cli": e2e_cli}))
    print(json.dumps({"e2e_refine": e2e_refine}))
    print(json.dumps({"e2e_shard": e2e_shard}))
    print(json.dumps({"e2e_stream_shard": e2e_ss}))
    print(json.dumps({"e2e_dist": e2e_dist}))
    print(json.dumps({"e2e_dist_batch": e2e_dist_batch}))
    print(json.dumps({"e2e_native": e2e_native}))
    print(json.dumps({"e2e_colored_rig": e2e_rig}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
