"""CLI: incremental "mapping on the fly" backward-grid orthomosaic.

Mirrors ``aerial_mapper_demos_ortho_backward_grid_incremental``
(main-ortho-backward-grid-incremental.cc:64-170); twin of
``aerial_mapper_tpu/cli/main_ortho_backward_grid_incremental.py``. With
``--auto_shard`` (the default) and more than one device in
``parallel/mesh.py::default_devices``, the run is the sharded incremental
driver: ``--band_cull``, ``--check_every`` and ``--slab_margin`` configure
it, and the live cloud feed of the preview is off there (the fused step
never materializes the cloud). On one device those three flags are
ignored.
"""

import argparse
import os

import numpy as np

from aerial_mapper_tpu_torch.cli import common
from aerial_mapper_tpu_torch.cli.main_ortho_backward_grid import _strip_prefix
from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.io.artifacts import (
    load_layers,
    save_layers,
    to_host,
)
from aerial_mapper_tpu_torch.io.images import save_image
from aerial_mapper_tpu_torch.io.preview_server import (
    start_preview_server,
    stop_preview_server,
)
from aerial_mapper_tpu_torch.parallel import mesh as pmesh
from aerial_mapper_tpu_torch.pipeline.incremental import run_incremental
from aerial_mapper_tpu_torch.stereo.visualize import cloud_topdown_panel
from aerial_mapper_tpu_torch.utils.palettes import apply_palette


def parse_args(argv=None):
    """This CLI's flags from ``argv`` (``sys.argv[1:]`` when None), with
    its flagfiles, gflags booleans and flag prefixes expanded."""
    p = common.base_parser(__doc__)
    common.add_grid_flags(p)
    common.add_stereo_flags(p)
    common.add_dsm_flags(p)
    common.add_reference_compat_flags(p)
    p.add_argument("--orthomosaic_elevation_m", type=float, default=0.0)
    p.add_argument("--use_digital_elevation_map", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--colored_ortho", action=argparse.BooleanOptionalAction)
    p.add_argument("--update_every_nth", type=int, default=5,
                   help="Map update cadence in frames.")
    p.add_argument("--orthomosaic_jpg_filename", default="/tmp/ortho_incr.jpg",
                   help="The final ortho image; its extension picks the "
                        "format (.pgm/.ppm need no Pillow).")
    p.add_argument("--save_updates_to", default="",
                   help="Directory for per-update mosaic snapshots (JPEG: "
                        "needs Pillow).")
    p.add_argument("--preview_every_updates", type=int, default=0,
                   help="Every K map updates, dump a live preview (ortho + "
                        "elevation PNGs, which need Pillow, and a resumable "
                        "layers .npz) into --preview_dir — the framework's "
                        "replacement for the reference's 0.1 Hz grid_map "
                        "publish loop (aerial-mapper-grid-map.cc:51-64).")
    p.add_argument("--preview_dir", default="/tmp/aerial_mapper_preview")
    p.add_argument("--serve_preview", type=int, default=0, metavar="PORT",
                   help="Serve --preview_dir over HTTP on this port with "
                        "an auto-refreshing page (io/preview_server.py) — "
                        "the live-view analogue of the reference's rviz "
                        "loop. 0 disables; implies preview dumps every "
                        "update unless --preview_every_updates is set.")
    p.add_argument("--output_layers_npz", default=None)
    p.add_argument("--resume_layers_npz", default=None,
                   help="Resume mapping onto a previously saved layers "
                        "artifact (from --output_layers_npz or the live "
                        "preview dump) instead of a fresh map.")
    p.add_argument("--start_frame", type=int, default=0,
                   help="First frame to stream (use with "
                        "--resume_layers_npz: the frame right after the "
                        "checkpointed run's last map update; must be a "
                        "multiple of --update_every_nth).")
    p.add_argument("--band_cull", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Sharded mode: cull each row band's image subset "
                        "against the slab-tracked elevation range so "
                        "per-device image bytes shrink with the mesh "
                        "(validated per window; violations replay "
                        "exactly). --no-band_cull broadcasts the full "
                        "subset to every band.")
    p.add_argument("--check_every", type=int, default=8,
                   help="Sharded mode: validation window in map updates "
                        "(one device readback per window checks routing "
                        "overflow + the cull slab).")
    p.add_argument("--slab_margin", type=float, default=20.0,
                   help="Meters added around the measured elevation range "
                        "to form the next window's cull slab.")
    common.add_multicam_flag(p)
    return common.parse(p, _strip_prefix(argv))


def main(argv=None, *, device=None):
    args = parse_args(argv)
    dev = resolve_device(device)

    with common.profiled(args, dev, "main_ortho_backward_grid_incremental"):
        datasets = common.datasets_from_args(args)
        dataset = datasets[0] if datasets else common.dataset_from_args(args)
        cfg = common.pipeline_config_from_args(args)

        preview_http = None
        if args.serve_preview:
            if not args.preview_every_updates:
                args.preview_every_updates = 1
            preview_http = start_preview_server(args.preview_dir,
                                                args.serve_preview)
        try:
            layers, geom = _run(args, dataset, datasets, cfg, dev)
        finally:
            if preview_http is not None:
                stop_preview_server(preview_http)
        save_image(args.orthomosaic_jpg_filename, to_host(layers["ortho"]))
        if args.output_layers_npz:
            save_layers(args.output_layers_npz, layers, geom)


def _run(args, dataset, datasets, cfg, dev):
    """``run_incremental`` with the CLI's per-update callbacks: snapshots,
    preview dumps and the growing decimated cloud."""
    update_count = [0]
    cloud_acc = []  # decimated host points accumulated across updates
    cloud_cap = 400_000

    def on_cloud(step, points, valid):
        # growing decimated cloud (the rviz PointCloud2 analogue,
        # stereo.cpp:78-79); re-decimate 2x whenever the host buffer
        # exceeds the cap so memory stays bounded over long runs
        cloud_acc.append(points[valid])
        total = sum(len(p) for p in cloud_acc)
        if total > cloud_cap:
            merged = np.concatenate(cloud_acc)[::2]
            cloud_acc.clear()
            cloud_acc.append(merged)

    def dump_cloud_preview(geom):
        pts = (np.concatenate(cloud_acc) if cloud_acc
               else np.zeros((0, 3), np.float32))
        panel = cloud_topdown_panel(
            pts, west=geom.west, north=geom.north,
            resolution=geom.resolution, height=geom.height,
            width=geom.width,
        )
        save_image(os.path.join(args.preview_dir, "cloud_live.png"), panel)
        tmp = os.path.join(args.preview_dir,
                           f".cloud_live.{os.getpid()}.npz")
        np.savez(tmp, points=pts)
        os.replace(tmp, os.path.join(args.preview_dir, "cloud_live.npz"))

    def on_update(step, layers, geom):
        update_count[0] += 1
        if args.save_updates_to:
            save_image(f"{args.save_updates_to}/ortho_{step:06d}.jpg",
                       to_host(layers["ortho"]))
        if (args.preview_every_updates
                and update_count[0] % args.preview_every_updates == 0):
            os.makedirs(args.preview_dir, exist_ok=True)
            save_image(os.path.join(args.preview_dir, "ortho_live.png"),
                       to_host(layers["ortho"]))
            save_image(
                os.path.join(args.preview_dir, "elevation_live.png"),
                apply_palette(to_host(layers["elevation"]), "terrain"),
            )
            save_layers(os.path.join(args.preview_dir, "layers_live.npz"),
                        layers, geom)
            if cloud_acc:
                dump_cloud_preview(geom)

    initial_layers = None
    if args.resume_layers_npz:
        initial_layers, _resume_geom = load_layers(args.resume_layers_npz)

    # live cloud feed: single-device driver only (the sharded fused step
    # never materializes the cloud); previews degrade to rasters there
    want_cloud = bool(args.preview_every_updates) and (
        not cfg.auto_shard or len(pmesh.mesh_devices(dev.type)[0]) <= 1
    )
    return run_incremental(
        dataset, cfg, update_every_nth=args.update_every_nth,
        on_update=on_update, initial_layers=initial_layers,
        start_frame=args.start_frame, cull_images=args.band_cull,
        check_every=args.check_every, slab_margin_m=args.slab_margin,
        datasets=datasets,
        on_cloud=on_cloud if want_cloud else None,
        device=dev,
    )


if __name__ == "__main__":
    main()
