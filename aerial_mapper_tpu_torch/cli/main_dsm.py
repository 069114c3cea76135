"""CLI: digital surface model from point cloud or image sequence.

Mirrors ``aerial_mapper_demos_dsm`` (main-dsm.cc:46-111); twin of
``aerial_mapper_tpu/cli/main_dsm.py``.
"""

from aerial_mapper_tpu_torch.cli import common
from aerial_mapper_tpu_torch.device import resolve_device


def parse_args(argv=None):
    """This CLI's flags from ``argv`` (``sys.argv[1:]`` when None), with
    its flagfiles, gflags booleans and flag prefixes expanded."""
    p = common.base_parser(__doc__)
    common.add_grid_flags(p)
    common.add_stereo_flags(p)
    common.add_dsm_flags(p)
    p.add_argument("--point_cloud_filename", default="",
                   help="Load cloud from txt instead of running stereo.")
    p.add_argument("--output_geotiff", default="/tmp/dsm.tif")
    p.add_argument("--output_layers_npz", default=None)
    p.add_argument("--output_png", default=None,
                   help="Optional false-color elevation PNG (needs "
                        "Pillow; a .ppm path needs none).")
    p.add_argument("--output_color_geotiff", default=None,
                   help="Optional palette-colored 3-band DEM GeoTiff "
                        "(writeDataToDEMGeoTiffColor parity).")
    p.add_argument("--color_palette", default="terrain",
                   help="Palette for --output_color_geotiff/--output_png.")
    common.add_refine_poses_flag(p)
    common.add_multicam_flag(p)
    return common.parse(p, argv)


def main(argv=None, *, device=None):
    args = parse_args(argv)
    dev = resolve_device(device)

    import numpy as np

    from aerial_mapper_tpu_torch.io.artifacts import to_host
    from aerial_mapper_tpu_torch.io.pointcloud import load_point_cloud_txt
    from aerial_mapper_tpu_torch.pipeline.batch import run_dsm

    with common.profiled(args, dev, "main_dsm"):
        datasets = common.datasets_from_args(args)
        if datasets:
            datasets = common.maybe_refine_datasets(datasets, args,
                                                    device=dev)
            dataset = datasets[0]
        else:
            dataset = common.maybe_refine_poses(
                common.dataset_from_args(args), args, device=dev)
        cfg = common.pipeline_config_from_args(args)
        cloud = None
        if args.point_cloud_filename:
            cloud = load_point_cloud_txt(args.point_cloud_filename)
        layers, geom = run_dsm(
            dataset, cfg, point_cloud=cloud,
            output_geotiff=args.output_geotiff,
            output_layers_npz=args.output_layers_npz,
            output_report_html=args.report_html,
            utm_zone=args.utm_zone,
            datasets=datasets,
            device=dev,
        )
        if args.output_png or args.output_color_geotiff:
            elevation = to_host(layers["elevation"]).astype(np.float32)
        if args.output_png:
            from aerial_mapper_tpu_torch.io.images import save_image
            from aerial_mapper_tpu_torch.utils.palettes import apply_palette

            save_image(args.output_png,
                       apply_palette(elevation, args.color_palette))
        if args.output_color_geotiff:
            from aerial_mapper_tpu_torch.io.geotiff import (
                write_dem_geotiff_color,
            )

            write_dem_geotiff_color(
                args.output_color_geotiff, elevation,
                west=geom.west, north=geom.north,
                resolution=geom.resolution,
                palette=args.color_palette, utm_zone=args.utm_zone,
            )


if __name__ == "__main__":
    main()
