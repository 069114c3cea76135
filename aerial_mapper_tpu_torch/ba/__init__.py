"""ba: see the twin module under aerial_mapper_tpu/ba/."""

from aerial_mapper_tpu_torch.ba.bundle_adjust import (  # noqa: F401
    sharded_bundle_adjust,
    BAProblem,
    BAState,
    bundle_adjust,
    reprojection_residuals,
)
