"""image: see the twin module under aerial_mapper_tpu/image/."""

from aerial_mapper_tpu_torch.image.sample import (  # noqa: F401
    bilinear_sample,
    nearest_sample,
    remap,
    homography_warp,
    point_in_quad,
)
from aerial_mapper_tpu_torch.image.color import (  # noqa: F401
    rgb_to_gray,
    pack_rgb_to_float,
    unpack_float_to_rgb,
)
