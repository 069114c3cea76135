"""Color conversions and grid_map-style packed-RGB encoding (twin of
``aerial_mapper_tpu/image/color.py``)."""

from __future__ import annotations

import torch

# ITU-R BT.601 luma weights — what cv::cvtColor(RGB2GRAY) uses
# (reference converts RGB inputs to gray at stereo.cpp:117-125).
_LUMA = (0.299, 0.587, 0.114)


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> [...] gray, BT.601 weights, in the JAX order."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b


def pack_rgb_to_float(rgb01: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0,1] -> [...] float32 with RGB packed in 24 bits
    (``grid_map::colorVectorToValue``): the int is bit-cast, not converted."""
    rgb255 = torch.clamp(torch.round(rgb01 * 255.0), 0, 255).to(torch.int32)
    packed = (rgb255[..., 0] << 16) | (rgb255[..., 1] << 8) | rgb255[..., 2]
    return packed.contiguous().view(torch.float32)


def unpack_float_to_rgb(value: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_rgb_to_float -> [..., 3] RGB in [0,1]. The bits are
    read as int32 (PyTorch has no uint32 shifts); the masks keep the same
    8 bits a uint32 shift would."""
    packed = value.contiguous().view(torch.int32)
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return torch.stack([r, g, b], dim=-1).to(torch.float32) / 255.0
