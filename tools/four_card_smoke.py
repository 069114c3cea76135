#!/usr/bin/env python3
"""The port's sharded paths on four distinct cards, each against one card.

    python3 tools/four_card_smoke.py [--out FILE]

It exits 2, and prints no result, unless exactly four CUDA cards are
visible. It builds the kernels from the checkout, makes ``chip_smoke.py``'s
workload (the bench stream: 249 frames of 752x480 on a 400x400 map at
0.5 m, every 7th frame: 35 updates or 34 batch pairs; every kernel switch
on the hand kernel) and runs, each map held bit for bit to the same run on
one card (``auto_shard=False``; the packed RGB layer as int32 bits):

- C1: ``run_incremental`` on the stream with ``auto_shard`` at its
  default, in this process, which sees the four cards: a (pairs, tiles) =
  (1, 4) mesh, one shard per card.
- C2: the default four-card ``run_ortho_backward_grid`` job, colored and
  on ``chip_smoke.py`` phase 16's two-camera rig (RGB frames of both
  cameras, the map 140 rows taller to the north).
- C3: four worker processes of this script in one NCCL process group
  (``tcp://localhost`` on a free port), each on its own card
  (``LOCAL_RANK``), spawned by ``chip_smoke.run_workers``. Each runs
  ``chip_smoke.py`` phase 13c's ``run_incremental`` and phase 14a's
  backward-grid job (phase 7's config) over the group's four cards, and
  holds its map to the parent's one-card map. Per rank: the wall time,
  launches, exchanges, bytes and host seconds in exchanges
  (``parallel/collectives.py::traffic``).

Every run is counted by ``chip_smoke.DriverRuns``: every launch counter is
set to 0 just before it and read just after, and held to the path's
launches (the sharded streams through ``chip_smoke.counted_sharded_stream``:
one BM and one IDW per shard and fused step, one score per shard, step and
ortho-only pass; the job one BM per ring slot). The lines before the last
are one record per run, the ``nvidia-smi`` lines; the last line is the JSON
summary ``{"ok": ..., "cards": [...], "C1": ..., "C2": ..., "C3": ...}``.
Any failed check ends the run with exit code 1.
"""

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CARDS = 4
WORKER_TIMEOUT_S = 900.0  # the parent's limit on the four workers
GROUP_TIMEOUT_S = 600.0  # the process group's limit on every wait


def sync_all():
    """Wait for the work of every card this process drives: all four, or
    under a process group its own."""
    if torch.distributed.is_initialized():
        torch.cuda.synchronize()
        return
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def driver_runs():
    """``chip_smoke.DriverRuns`` over the four kernels' launch counters,
    its timed runs waiting for every card this process drives."""
    from aerial_mapper_tpu_torch.dsm.cuda_idw import binned_idw_cuda
    from aerial_mapper_tpu_torch.ortho.cuda_score import score_pass_cuda
    from aerial_mapper_tpu_torch.stereo.cuda_bm import bm_scan
    from aerial_mapper_tpu_torch.stereo.cuda_sgm import sgm_scan

    return cs.DriverRuns((bm_scan, binned_idw_cuda, score_pass_cuda,
                          sgm_scan), sync=sync_all)


def sharded_stream(runs, ds, cfg, dev, tag, shards, datasets=None):
    """``run_incremental`` over the mesh its ``auto_shard`` builds on the
    four cards, ``shards`` of them in this process, counted: (map,
    record)."""
    out, rec, records = cs.counted_sharded_stream(
        runs, ds, cfg, shards, tag, dev, datasets=datasets)
    cs.check(any(f"sharded over {CARDS} devices" in r.getMessage()
                 for r in records),
             f"{tag}: the driver did not shard over {CARDS} devices")
    return out, rec


def bit_equal(a, b):
    return cs.maps_bit_equal({k: v.cpu() for k, v in a.items()},
                             {k: v.cpu() for k, v in b.items()})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank, work, port):
    """C3's rank ``rank``: join the group, run phase 13c's stream and
    phase 14a's job over the group's cards, hold each map to the parent's
    one-card map, write the record."""
    from aerial_mapper_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from aerial_mapper_tpu_torch.pipeline import batch

    initialize_distributed(f"tcp://localhost:{port}", CARDS, rank,
                           timeout_s=GROUP_TIMEOUT_S)
    dev = torch.device("cuda", torch.cuda.current_device())
    cs.check(dev.index == rank, f"rank {rank} drives cuda:{dev.index}")
    runs = driver_runs()
    with np.load(os.path.join(work, "inputs.npz")) as z:
        frames = z["frames"]
        refs = {k: torch.from_numpy(z[k]) for k in z.files
                if k != "frames"}
    one = {r: {k.split("/", 1)[1]: v for k, v in refs.items()
               if k.startswith(r + "/")} for r in ("stream", "job")}
    w = cs.build_workload(dev, images=torch.as_tensor(frames, device=dev))
    bm, dsm, ortho, _sgm = cs.smoke_configs()
    ds = cs.bench_dataset(w["cam"], w["images"].cpu().numpy())
    rec = dict(rank=rank, device=str(dev))
    pairs = len(range(cs.USE_EVERY_NTH - 1, cs.NUM_IMAGES,
                      cs.USE_EVERY_NTH)) - 1
    slots = -(-pairs // CARDS)  # this rank's ring slots

    def job():
        return batch.run_ortho_backward_grid(
            ds, job_config(bm, dsm, ortho), device=dev)[0]

    for tag, run in (
            ("13c stream", lambda t: sharded_stream(
                runs, ds, cs.stream_config(bm, dsm, ortho), dev, t, 1)),
            ("14a job", lambda t: runs.run(t, job, runs.want(
                bm_scan=slots, binned_idw_cuda=1, score_pass_cuda=1)))):
        done = []
        for k in range(2):  # a warm run, then one timed
            t = f"C3 rank {rank} {tag} run {k}"
            out, r = cs.group_run(lambda: run(t), dev)
            cs.check(bit_equal(out, one[tag.split()[1]]),
                     f"{t}: the map differs from the one-card map")
            r["bit_equal"] = True
            done.append(r)
            print(f"[{t}] {r}", flush=True)
        rec[tag] = done
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def job_config(bm, dsm, ortho):
    """Phase 7's batch config (14a's): every 7th frame paired, the bench
    map, ``auto_shard`` at its default."""
    return cs.stream_config(bm, dsm, ortho,
                            use_every_nth_image=cs.USE_EVERY_NTH)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the summary to this file")
    # C3's workers (``chip_smoke.run_workers``'s arguments)
    ap.add_argument("--dist-worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", help=argparse.SUPPRESS)
    ap.add_argument("--dist-device", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dist_worker is not None:
        return worker(args.dist_worker, args.dist_dir, args.port)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n != CARDS:
        print(f"four_card_smoke: {n} CUDA cards visible; this script needs "
              f"exactly {CARDS}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    from aerial_mapper_tpu_torch import _build
    from aerial_mapper_tpu_torch.parallel import mesh as pmesh
    from aerial_mapper_tpu_torch.pipeline import batch
    from aerial_mapper_tpu_torch.pipeline.incremental import run_incremental

    summary = dict(ok=False)
    t_start = time.perf_counter()
    summary["cards"] = [torch.cuda.get_device_name(i) for i in range(CARDS)]
    summary["smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.load()
    summary["build_s"] = time.perf_counter() - t0
    devices = pmesh.default_devices("cuda")
    cs.check(len({d.index for d in devices}) == CARDS,
             f"default_devices gives {devices}, not {CARDS} cards")
    print(f"[cards] {summary['smi']}; kernels built in "
          f"{summary['build_s']:.1f} s", flush=True)
    runs = driver_runs()
    want = runs.want
    bm, dsm, ortho, _sgm = cs.smoke_configs()
    w = cs.build_workload(dev)
    frames = w["images"].to(torch.uint8).cpu().numpy()
    ds = cs.bench_dataset(w["cam"], w["images"].cpu().numpy())
    pairs = len(range(cs.USE_EVERY_NTH - 1, cs.NUM_IMAGES,
                      cs.USE_EVERY_NTH)) - 1
    n_updates = pairs + 1
    slots = -(-pairs // CARDS) * CARDS

    # ---- C1. the stream, one process, four cards ----
    # each side runs twice, a warm run and a timed one, every map held to
    # the first one-card map
    cfg = cs.stream_config(bm, dsm, ortho)
    one = [runs.run(
        f"C1 one card, run {k}", lambda: run_incremental(
            ds, unsharded(cfg), update_every_nth=cs.USE_EVERY_NTH,
            device=dev)[0],
        want(bm_scan=pairs, binned_idw_cuda=pairs, score_pass_cuda=n_updates))
        for k in range(2)]
    four = [sharded_stream(runs, ds, cfg, dev, f"C1 four cards, run {k}",
                           CARDS) for k in range(2)]
    cs.check(all(bit_equal(m, one[0][0]) for m, _r in one[1:] + four),
             "C1: a stream differs from the one-card stream")
    summary["C1"] = dict(one_card=[r for _m, r in one],
                         four_cards=[r for _m, r in four], bit_equal=True)
    print(f"[C1] {summary['C1']}", flush=True)
    refs = {f"stream/{k}": v.cpu().numpy() for k, v in one[0][0].items()}
    del one, four

    # ---- C2. the colored rig job on four cards ----
    mc = rig_job_inputs(w, dev)
    rig_cfg = rig_job_config(bm, dsm, ortho)

    def rig_job(c):
        return batch.run_ortho_backward_grid(mc[0], c, datasets=mc,
                                             device=dev)[0]

    one = [runs.run(f"C2 one card, run {k}",
                    lambda: rig_job(unsharded(rig_cfg)),
                    want(bm_scan=2 * pairs, binned_idw_cuda=1,
                         score_pass_cuda=2)) for k in range(2)]
    four = [runs.run(f"C2 four cards, run {k}", lambda: rig_job(rig_cfg),
                     want(bm_scan=2 * slots, binned_idw_cuda=CARDS,
                          score_pass_cuda=2 * CARDS)) for k in range(2)]
    one_mc = one[0][0]
    cs.check(all(bit_equal(m, one_mc) for m, _r in one[1:] + four),
             "C2: a colored rig job differs from the one-card job")
    textured = torch.isfinite(one_mc["observation_index"])
    ids = one_mc["observation_index"][textured]
    cs.check(bool((ids >= cs.NUM_IMAGES).any() & (ids < cs.NUM_IMAGES).any()),
             "C2: the rig job's cells are not won by both cameras")
    summary["C2"] = dict(one_card=[r for _m, r in one],
                         four_cards=[r for _m, r in four], bit_equal=True,
                         rows=int(one_mc["elevation"].shape[0]))
    print(f"[C2] {summary['C2']}", flush=True)
    del mc, one, four, one_mc

    # ---- C3. four processes, one card each, one NCCL group ----
    job_one, rec_one = runs.run(
        "C3 one-card job", lambda: batch.run_ortho_backward_grid(
            ds, unsharded(job_config(bm, dsm, ortho)), device=dev)[0],
        want(bm_scan=pairs, binned_idw_cuda=1, score_pass_cuda=1))
    refs.update({f"job/{k}": v.cpu().numpy() for k, v in job_one.items()})
    del w, job_one
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="four_card_smoke_") as work:
        np.savez(os.path.join(work, "inputs.npz"), frames=frames, **refs)
        codes, secs = cs.run_workers(
            work, "C3", ["--port", str(free_port())], dev, script=__file__,
            ranks=CARDS, timeout_s=WORKER_TIMEOUT_S)
        cs.check(codes == [0] * CARDS, f"C3: worker exit codes {codes}")
        ranks = []
        for r in range(CARDS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    summary["C3"] = dict(one_card_job=rec_one, seconds=secs, ranks=ranks)
    summary["ok"] = True
    summary["total_s"] = time.perf_counter() - t_start
    print("\n".join(summary["smi"]))
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


def unsharded(cfg):
    return dataclasses.replace(cfg, auto_shard=False)


def rig_job_inputs(w, dev):
    """Phase 16's two-camera rig: RGB frames of both cameras rendered on
    ``dev`` at the bench poses, as in-memory datasets."""
    from aerial_mapper_tpu_torch.io.poses import _quat_from_matrix_np

    Rs, ts = cs.bench_poses()
    frames = [cs.render_rig_frames(w["cam"], w["scene"], Rs, ts, R_B_C, True,
                                   dev).cpu().numpy()
              for R_B_C in (None, cs.rig_tilt())]
    quats = np.stack([_quat_from_matrix_np(R) for R in Rs])
    return cs.rig_datasets(cs.two_camera_rig(w["cam"]), quats, ts, frames)


def rig_job_config(bm, dsm, ortho):
    """Phase 16's colored rig job config (its map, every 7th frame)."""
    from aerial_mapper_tpu_torch.cli import common, main_ortho_backward_grid

    return common.pipeline_config_from_args(
        main_ortho_backward_grid.parse_args(
            ["--data_directory", ".", "--colored_ortho", "--kernel_family",
             "pallas", "--num_disparities", str(bm.num_disparities),
             "--interpolation_radius", str(dsm.interpolation_radius_sq),
             "--dense_pcl_use_every_nth_image", str(cs.USE_EVERY_NTH)]
            + cs.rig_grid_flags()))


if __name__ == "__main__":
    sys.exit(main())
