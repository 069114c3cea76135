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
   events' time of one wrapper call (``ms``). 3a: both BM entries
   bit-equal on all 5 maps: the integer kernel on the bench pairs, on a
   worst-case pair (left 2 * cap, right 0) and on a ragged batch (H, W not
   multiples of its tile, W < D + r) at blocks 1, 5, 9, 15, 21 and 127;
   the float kernel on the bench pairs prefiltered with
   ``integer_costs=False``; both timed on the same integer-valued bench
   input. 3b: IDW hit and values bit-equal on the bench cloud, adaptive
   (the timed case), without the ladder and with a window of more than 128
   offsets. 3c: the score pass bit-equal on all 5 outputs on an
   adversarial input (UTM-sized coordinates, cells on the image edges, NaN
   and infinite elevations, cameras behind the cells, duplicate cameras
   past the first 256), at the survey shape (2000x2000 cells at 0.5 m x
   825 cameras, the plain version chunked over cells) and at the bench
   shape, with the cull's kept share of pairs and the visible pairs that
   its bound counts. 3d: the SGM scan on the real BT cost of the SGM
   step's first chunk of bench pairs (the launch shape of phase 5), all 8
   passes, bit-equal in both restart forms, then timed over all of the
   step's chunks (35 pairs).
4. The fused mapping step end to end at bench scale (the workload of
   ``bench.py``: 249 synthetic 752x480 images, a 400x400-cell map at
   0.5 m, 35 pairs), with every launch counter set to 0 just before and
   read just after; the DSM and ortho are scored against the synthetic
   scene's analytic height and texture. 4f: the same step on the float
   BM path (``integer_costs=False``), counted and scored the same way.
5. The same step with the SGM matcher (``SgmConfig(num_disparities=80,
   kernel="pallas")``, 8 directions, ``--sgm-chunk`` pairs per pass: by
   default all 35 at once), counters set to 0 just before and read just
   after, scored the same way.
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

The lines before the last are the ``nvidia-smi`` line, the ``{"e2e": ...}``,
``{"e2e_bm_float": ...}``, ``{"e2e_sgm": ...}`` and
``{"e2e_incremental": ...}`` objects and one JSON object ``{"kernels":
[...]}`` (each kernel with its launches in one incremental run beside those
of its step); the last line is
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

NUM_IMAGES = 249
IMG_W, IMG_H = 752, 480
MAP_CELLS = 400
RESOLUTION = 0.5
NUM_DISP = 80
USE_EVERY_NTH = 7

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores. Every kernel here is float32 / integer work on
# the CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Operations per unit of work, the least a kernel of each function needs:
# BM per (pixel, disparity): AD (sub, abs), a sliding (2r+1)^2 window sum
# (2 adds in, 2 out), and the state update (3 compares, 3 selects).
OPS_BM = 12
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
# the survey shape of phase 3c: a 1 km x 1 km map at 0.5 m, 25 lines of 33
# images at 80 % forward and 60 % side overlap with the bench camera
SURVEY_CELLS = 2000
SURVEY_LINES, SURVEY_PER_LINE = 25, 33
SURVEY_PLAIN_CHUNK = 32768  # cells per call of the plain version


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
    """The bench camera (752x480, fx = fy = 480) and synthetic scene."""
    from aerial_mapper_tpu_torch.camera.models import Camera
    from aerial_mapper_tpu_torch.synth.scene import SyntheticScene

    cam = Camera(fx=480.0, fy=480.0, cx=IMG_W / 2.0, cy=IMG_H / 2.0,
                 width=IMG_W, height=IMG_H)
    return cam, SyntheticScene(base_elevation=414.0, relief_amplitude=6.0)


def bench_poses():
    """The bench survey: 2 lines over the 200 m map, 100 m above ground."""
    from aerial_mapper_tpu_torch.synth.scene import make_survey_poses

    return make_survey_poses(
        NUM_IMAGES, altitude=514.0, spacing=200.0 / max(NUM_IMAGES // 2, 1),
        num_lines=2, line_spacing=60.0, start_easting=-100.0,
        start_northing=-30.0,
    )


def survey_poses():
    """The survey shape's poses: 25 lines of 33 images 31 m apart, 40 m
    between lines (80 % forward, 60 % side overlap of the bench camera's
    157 m x 100 m footprint), jitter 0.5 m and ~0.01 rad."""
    from aerial_mapper_tpu_torch.synth.scene import make_survey_poses

    return make_survey_poses(
        SURVEY_LINES * SURVEY_PER_LINE, altitude=514.0, spacing=31.0,
        num_lines=SURVEY_LINES, line_spacing=40.0, start_easting=-496.0,
        start_northing=-480.0, jitter=0.5)


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


def bm_check(tag, lf, rf, num_disp, min_disp, block, integer_costs):
    """One bm_scan entry against bm_scan_plain on all 5 maps, bit for bit,
    its launch counted; max |err|."""
    from aerial_mapper_tpu_torch.stereo.cuda_bm import bm_scan, bm_scan_plain

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
    print(f"[{tag}] {tuple(lf.shape)} disparities [{min_disp}, "
          f"{min_disp + num_disp}) block {block}: bit-equal on all 5 maps",
          flush=True)
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


def map_bars(tag, out, truth_h, truth_t):
    """The DSM and ortho bars on a final map (coverage > 0.5 of both,
    median |elevation - height| < 0.5 m, median |ortho - texture| < 5
    gray), every layer MAP_CELLS square; returns the four figures."""
    elevation = out["elevation"]
    hit = torch.isfinite(elevation)
    coverage = hit.float().mean().item()
    check(coverage > 0.5, f"{tag}: DSM coverage {coverage}")
    dsm_med = (elevation[hit] - truth_h[hit]).abs().median().item()
    check(dsm_med < 0.5, f"{tag}: median |elevation - height| {dsm_med} m")
    textured = torch.isfinite(out["observation_index"])
    ortho_cov = textured.float().mean().item()
    check(ortho_cov > 0.5, f"{tag}: ortho coverage {ortho_cov}")
    ortho_med = (out["ortho"][textured] - truth_t[textured]).abs() \
        .median().item()
    check(ortho_med < 5.0, f"{tag}: median |ortho - texture| {ortho_med}")
    for name, t in out.items():
        check(t.shape == (MAP_CELLS, MAP_CELLS), f"{tag}: layer {name} shape")
    return dict(dsm_coverage=coverage, dsm_median_abs_err_m=dsm_med,
                ortho_coverage=ortho_cov, ortho_median_abs_err_gray=ortho_med)


def bit_equal_maps(a: dict, b: dict) -> bool:
    """Every layer equal bit for bit, NaN-aware."""
    return set(a) == set(b) and all(
        torch.equal(torch.isnan(a[k]), torch.isnan(b[k]))
        and torch.equal(torch.nan_to_num(a[k]), torch.nan_to_num(b[k]))
        for k in a)


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
    top = sorted(
        ((e.self_device_time_total / 1e3, e.key, e.count)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA")
         and e.self_device_time_total > 0),
        reverse=True,
    )
    host = sorted(
        ((e.self_cpu_time_total / 1e3, e.key, e.count)
         for e in prof.key_averages()
         if not str(e.device_type).endswith("CUDA")
         and e.self_cpu_time_total > 0),
        reverse=True,
    )
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
    kernel)."""
    from aerial_mapper_tpu_torch.camera.rig import CameraRig
    from aerial_mapper_tpu_torch.config import (
        GridMapConfig,
        PipelineConfig,
        StereoConfig,
    )
    from aerial_mapper_tpu_torch.dsm.idw import bin_with_halo
    from aerial_mapper_tpu_torch.io.poses import (
        _quat_from_matrix_np,
        _rot_matrix_np,
    )
    from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry
    from aerial_mapper_tpu_torch.ortho.backward_grid import score_operands
    from aerial_mapper_tpu_torch.pipeline.dataset import Dataset
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
    Rs, ts = bench_poses()
    rig = CameraRig(cameras=(cam,), T_C_B_quats=np.array([[1.0, 0, 0, 0]]),
                    T_C_B_trans=np.zeros((1, 3)))
    quats = np.stack([_quat_from_matrix_np(R) for R in Rs])
    host_images = w["images"].cpu().numpy()  # the 8-bit frames as float32

    def dataset(n=NUM_IMAGES):
        # identity extrinsic: body poses are the camera poses
        return Dataset(rig=rig, quats_G_B=quats[:n], trans_G_B=ts[:n],
                       images=list(host_images[:n]))

    full = dataset()
    extent = MAP_CELLS * RESOLUTION
    cfg = PipelineConfig(
        grid=GridMapConfig(delta_easting=extent, delta_northing=extent,
                           resolution=RESOLUTION),
        stereo=StereoConfig(use_every_nth_image=1),
        bm=bm_cfg, dsm=dsm_cfg, ortho_backward=ortho_cfg)
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
            [_stereo_image_from(_to_device(host_images[k], dev))
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
    return e2e, launches, errs


def build_workload(dev):
    """The bench workload, built with the port's own synth."""
    from aerial_mapper_tpu_torch.geo.se3 import matrix_to_quat
    from aerial_mapper_tpu_torch.mapgrid.grid import (
        MapGeometry,
        cell_centers,
        create_map_state,
    )
    from aerial_mapper_tpu_torch.stereo.batched import prepare_pair_operands
    from aerial_mapper_tpu_torch.synth.scene import render_image

    cam, scene = bench_camera_scene()
    Rs, ts = bench_poses()
    # 8-bit imagery, as the bench quantizes it, then float32
    images = torch.stack([render_image(scene, cam, R, t, device=dev)
                          for R, t in zip(Rs, ts)])
    images = torch.clamp(torch.round(images), 0.0, 255.0).to(torch.uint8)
    images = images.float()
    geom = MapGeometry(0.0, 0.0, RESOLUTION, MAP_CELLS, MAP_CELLS)
    ce, cn = cell_centers(geom, device=dev)
    ops = prepare_pair_operands(cam.K, Rs, ts, images,
                                use_every_nth=USE_EVERY_NTH, phase=0,
                                device=dev)
    quats = matrix_to_quat(torch.as_tensor(Rs, dtype=torch.float32,
                                           device=dev))
    return dict(
        cam=cam, scene=scene, images=images, geom=geom, ce=ce, cn=cn,
        ops=ops, quats=quats,
        ts=torch.as_tensor(ts, dtype=torch.float32, device=dev),
        layers=create_map_state(geom, device=dev),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--sgm-chunk", default="none",
        help="pairs per pass of the SGM step (process_pairs_batched's "
             "batch_chunk); 'none' = all pairs in one pass")
    args = ap.parse_args()
    sgm_chunk = None if args.sgm_chunk == "none" else int(args.sgm_chunk)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from aerial_mapper_tpu_torch import _build
    from aerial_mapper_tpu_torch.config import (
        BlockMatchingConfig,
        DsmConfig,
        OrthoBackwardGridConfig,
        SgmConfig,
    )
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
        prefilter_pair,
    )
    from aerial_mapper_tpu_torch.stereo.cuda_sgm import (
        NUM_PASSES,
        sgm_scan,
        sgm_scan_plain,
    )
    from aerial_mapper_tpu_torch.stereo.matching import _sgm_cost
    from aerial_mapper_tpu_torch.stereo.rectify import _rectify_image

    # full float32 products on the card: TF32 would round the geometry to
    # ~3 decimal digits and blur the kernel-vs-plain comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    bm_cfg = BlockMatchingConfig(num_disparities=NUM_DISP, kernel="pallas")
    # the integer BM kernel has one instantiation per radius: print the
    # bench block's, and the others' register and spill figures in sum
    bench_inst = f"bm_scan_int_kernelILi{bm_cfg.block_size // 2}E"
    entry, others, regs, spill = "", set(), [], 0
    for line in _build.build_log.splitlines():
        if "entry function" in line:
            entry = line
        if "bm_scan_int_kernel" in entry and bench_inst not in entry:
            others.add(entry)
            regs += [int(n) for n in re.findall(r"Used (\d+) registers",
                                                line)]
            spill += sum(int(n) for n in re.findall(
                r"(\d+) bytes spill stores", line))
            continue
        if ("registers" in line or "spill" in line
                or "entry function" in line):
            print(f"    ptxas: {line.strip()}")
    if regs:
        print(f"    ptxas: {len(others)} more radii of bm_scan_int_kernel: "
              f"{min(regs)}-{max(regs)} registers, {spill} bytes of spill "
              f"stores in all")

    dsm_cfg = DsmConfig(interpolation_radius_sq=2.0, bin_capacity=8,
                        idw_kernel="pallas")
    ortho_cfg = OrthoBackwardGridConfig(score_kernel="pallas")
    sgm_cfg = SgmConfig(num_disparities=NUM_DISP, kernel="pallas")

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
    bm_float_err = bm_check("3a bm_scan float, bench pairs", lf_f, rf_f,
                            NUM_DISP, float_cfg.min_disparity,
                            float_cfg.block_size, False)
    del rect1, rect2, lf_f, rf_f, worst_l, ragged
    # both entries timed on the same integer-valued bench input
    bm_args = (lf, rf, NUM_DISP, bm_cfg.min_disparity, bm_cfg.block_size)
    bm_ms = cuda_ms(lambda: bm_scan(*bm_args, integer_costs=True), reps=10)
    bm_float_ms = cuda_ms(lambda: bm_scan(*bm_args, integer_costs=False),
                          reps=10)
    bm_plain_ms = cuda_ms(lambda: bm_scan_plain(*bm_args), reps=3)
    bm_dev_ms = device_ms(lambda: bm_scan(*bm_args, integer_costs=True),
                          "bm_scan_int_kernel", reps=10)
    bm_float_dev_ms = device_ms(
        lambda: bm_scan(*bm_args, integer_costs=False),
        "bm_scan_float_kernel", reps=5)
    b_, h_, w_ = lf.shape
    bm_bound, bm_by = bound(7 * 4.0 * b_ * h_ * w_,
                            float(b_ * h_ * w_) * NUM_DISP * OPS_BM)
    for name, ms, dev_ms, err in (
            ("bm_scan", bm_ms, bm_dev_ms, bm_err),
            ("bm_scan_float", bm_float_ms, bm_float_dev_ms, bm_float_err)):
        kernels.append(dict(
            name=name, route="cuda",
            source="aerial_mapper_tpu_torch/csrc/bm.cu",
            replaces="aerial_mapper_tpu/stereo/pallas_bm.py:57",
            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=bm_plain_ms,
            bound_ms=bm_bound, bound_by=bm_by, library_ms=None,
        ))
    print(f"[3a bm_scan] {b_}x{h_}x{w_} D={NUM_DISP}, the same integer "
          f"input: integer kernel {bm_ms:.3f} ms (device {bm_dev_ms}), "
          f"float kernel {bm_float_ms:.3f} ms (device {bm_float_dev_ms}), "
          f"plain {bm_plain_ms:.3f} ms, bound {bm_bound:.3f} ms ({bm_by})",
          flush=True)
    del lf, rf

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
    del rect1, rect2
    # the whole first chunk: the pair axis (grid.y) at the step's shape
    first = costs[0]
    compared, sgm_err = 0, 0.0
    for pass_id in range(NUM_PASSES):
        # the restart forms differ on the diagonals (passes 4..7) only
        for pallas_form in ((True, False) if pass_id >= 4 else (True,)):
            a = sgm_scan(first, sgm_cfg.p1, sgm_cfg.p2, pass_id, pallas_form)
            b = sgm_scan_plain(first, sgm_cfg.p1, sgm_cfg.p2, pass_id,
                               pallas_form)
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"sgm pass {pass_id} (pallas_form="
                  f"{pallas_form}) differs from the plain version on "
                  f"{(a != b).sum().item()} values")
            sgm_err = max(sgm_err, (a - b).abs().max().item())
            compared += 1
    del a, b

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
    del costs, first

    truth_h = scene.height(w["ce"], w["cn"])
    truth_t = scene.texture(w["ce"], w["cn"])

    counters = (bm_scan, binned_idw_cuda, score_pass_cuda, sgm_scan)

    def drive_step(tag, match_kw, step_bm_cfg=bm_cfg):
        """Drive ``map_step`` with ``match_kw`` (matcher, sgm_cfg,
        batch_chunk) and ``step_bm_cfg``: 6 runs (the first is the warm-up)
        with every counter set to 0 just before and read just after, the
        DSM and ortho scored against the scene, per-stage times, one
        profiled step. ``launches["bm_scan"]`` counts the integer BM entry,
        ``launches["bm_scan_float"]`` the float one."""
        step_args = (w["layers"], ops, w["quats"], w["ts"], w["images"],
                     geom, cam, step_bm_cfg, dsm_cfg, ortho_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        bm_scan.float_launches = 0
        step_s = []
        for _ in range(6):  # the first run is the warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = map_step(*step_args, device=dev, **match_kw)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in counters}
        launches["bm_scan_float"] = bm_scan.float_launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        bars = map_bars(tag, out, truth_h, truth_t)
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
    check(e2e["launches"]["sgm_scan"] == 0, "the BM step launched sgm_scan")

    # ---- 4f. the BM step on the float path (integer_costs=False) ----
    e2e_float = drive_step("4f", {}, float_cfg)
    check(e2e_float["launches"]["bm_scan_float"] == 6
          and e2e_float["launches"]["bm_scan"] == 0,
          f"the float BM step must be one float-path BM launch: "
          f"{e2e_float['launches']} in 6 runs")

    # ---- 5. the same step with the SGM matcher ----
    e2e_sgm = drive_step(
        "5", dict(matcher="sgm", sgm_cfg=sgm_cfg, batch_chunk=sgm_chunk))
    for name in ("sgm_scan", "binned_idw_cuda", "score_pass_cuda"):
        check(e2e_sgm["launches"][name] > 0,
              f"{name} was never launched on the SGM path")
    check(e2e_sgm["launches"]["bm_scan"] == 0
          and e2e_sgm["launches"]["bm_scan_float"] == 0,
          "the SGM step launched bm_scan")

    # ---- 6. the incremental driver at full width ----
    e2e_inc, inc_launches, inc_errs = incremental_phase(
        w, bm_cfg, dsm_cfg, ortho_cfg, counters, truth_h, truth_t, dev)

    path_of = {"sgm_scan": e2e_sgm, "bm_scan_float": e2e_float}
    for k in kernels:  # the count over its path's 6 runs
        k["launches"] = path_of.get(k["name"], e2e)["launches"][k["name"]]
        # and over one run of the incremental driver (35 updates)
        k["incremental_launches"] = inc_launches[k["name"]]
        # the checks on one update's operands (phase 6d) too
        k["max_abs_err"] = max(k["max_abs_err"],
                               inc_errs.get(k["name"], 0.0))
    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"e2e_bm_float": e2e_float}))
    print(json.dumps({"e2e_sgm": e2e_sgm}))
    print(json.dumps({"e2e_incremental": e2e_inc}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
