"""CLI: batch backward-grid orthomosaic (DSM + best-angle texturing).

Mirrors ``aerial_mapper_demos_ortho_backward_grid``
(main-ortho-backward-grid.cc:66-145); twin of
``aerial_mapper_tpu/cli/main_ortho_backward_grid.py``. The reference
prefixes every flag with ``backward_grid_``; both spellings are accepted
here.
"""

import argparse

from aerial_mapper_tpu_torch.cli import common
from aerial_mapper_tpu_torch.device import resolve_device


def _strip_prefix(argv):
    return common.strip_flag_prefix(argv, "backward_grid_")


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
    p.add_argument("--flat_ground", dest="use_digital_elevation_map",
                   action="store_false")
    p.add_argument("--colored_ortho", action=argparse.BooleanOptionalAction)
    p.add_argument("--point_cloud_filename", default="")
    p.add_argument("--load_point_cloud_from_file", action=argparse.BooleanOptionalAction)
    p.add_argument("--orthomosaic_jpg_filename", default="/tmp/ortho.jpg",
                   help="The ortho image; its extension picks the format "
                        "(.pgm/.ppm need no Pillow).")
    p.add_argument("--output_geotiff", default="/tmp/ortho.tif")
    p.add_argument("--output_layers_npz", default=None)
    common.add_refine_poses_flag(p)
    common.add_multicam_flag(p)
    return common.parse(p, _strip_prefix(argv))


def main(argv=None, *, device=None):
    args = parse_args(argv)
    dev = resolve_device(device)

    from aerial_mapper_tpu_torch.io.pointcloud import load_point_cloud_txt
    from aerial_mapper_tpu_torch.pipeline.batch import run_ortho_backward_grid

    with common.profiled(args, dev, "main_ortho_backward_grid"):
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
        if args.load_point_cloud_from_file and args.point_cloud_filename:
            cloud = load_point_cloud_txt(args.point_cloud_filename)
        run_ortho_backward_grid(
            dataset, cfg, point_cloud=cloud,
            output_geotiff=args.output_geotiff,
            output_jpg=args.orthomosaic_jpg_filename,
            output_layers_npz=args.output_layers_npz,
            output_report_html=args.report_html,
            utm_zone=args.utm_zone,
            datasets=datasets,
            device=dev,
        )


if __name__ == "__main__":
    main()
