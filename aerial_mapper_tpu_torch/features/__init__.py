"""features: see the twin module under aerial_mapper_tpu/features/."""

from aerial_mapper_tpu_torch.features.detect import detect_corners  # noqa: F401
from aerial_mapper_tpu_torch.features.describe import (  # noqa: F401
    describe_patches,
)
from aerial_mapper_tpu_torch.features.match import (  # noqa: F401
    match_descriptors,
)
from aerial_mapper_tpu_torch.features.tracks import (  # noqa: F401
    build_tracks,
    triangulate_tracks,
)
from aerial_mapper_tpu_torch.features.refine import (  # noqa: F401
    refine_poses,
    refine_poses_windowed,
)
