"""CLI: refine a trajectory by feature tracks + bundle adjustment.

Twin of ``aerial_mapper_tpu/cli/main_refine_poses.py`` (no reference
equivalent: the reference assumes pre-optimized poses): detect and match
features, build tracks, triangulate, run Schur-complement BA on the card,
and write the refined poses in Standard format for the downstream demos.
"""

from aerial_mapper_tpu_torch.cli import common
from aerial_mapper_tpu_torch.device import resolve_device


def parse_args(argv=None):
    """This CLI's flags from ``argv`` (``sys.argv[1:]`` when None), with
    its flagfiles and gflags booleans expanded."""
    p = common.base_parser(__doc__)
    p.add_argument("--output_poses", default="/tmp/refined_poses.txt")
    p.add_argument("--num_corners", type=int, default=512)
    p.add_argument("--match_window", type=int, default=2)
    p.add_argument("--ba_iterations", type=int, default=12)
    p.add_argument("--position_prior_sigma_m", type=float, default=3.0)
    return common.parse(p, argv)


def main(argv=None, *, device=None):
    args = parse_args(argv)
    dev = resolve_device(device)

    import torch

    from aerial_mapper_tpu_torch.config import BundleAdjustmentConfig
    from aerial_mapper_tpu_torch.features import refine_poses
    from aerial_mapper_tpu_torch.io.poses import (
        camera_to_body_poses,
        save_poses_standard,
    )

    with common.profiled(args, dev, "main_refine_poses"):
        dataset = common.dataset_from_args(args)
        quats_c, trans_c = dataset.camera_poses()
        images = [torch.as_tensor(im, dtype=torch.float32, device=dev)
                  for im in dataset.images]
        q_ref, t_ref, stats = refine_poses(
            images, quats_c, trans_c, dataset.rig.camera,
            ba_cfg=BundleAdjustmentConfig(
                max_iterations=args.ba_iterations,
                position_prior_sigma_m=args.position_prior_sigma_m,
            ),
            num_corners=args.num_corners,
            match_window=args.match_window,
            device=dev,
        )
        # the refined poses are CAMERA poses; back to the body frame
        # through the rig extrinsics (T_G_B = T_G_C * T_C_B)
        quats_b, trans_b = camera_to_body_poses(dataset.rig, q_ref, t_ref)
        save_poses_standard(args.output_poses, quats_b, trans_b)
    print(f"refined {len(images)} poses -> {args.output_poses} "
          f"(tracks={stats['tracks']}, matches={stats['matches']})")


if __name__ == "__main__":
    main()
