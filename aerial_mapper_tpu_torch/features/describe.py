"""Patch descriptors: normalized intensity patches sampled at corners (twin
of ``aerial_mapper_tpu/features/describe.py``).

A ``P x P`` bilinear patch around each corner, mean/std normalized,
flattened to a P^2 vector. With normalized descriptors, matching similarity
is one [K, D] @ [D, K] product and equals zero-mean NCC. For nadir aerial
surveys (small rotation between overlapping frames) this is robust enough
to feed BA.
"""

from __future__ import annotations

import torch

from aerial_mapper_tpu_torch.image.sample import bilinear_sample


def describe_patches(
    image: torch.Tensor,
    uv: torch.Tensor,
    patch_size: int = 8,
    stride: float = 2.0,
):
    """[K, 2] corners -> [K, patch_size^2] L2-normalized descriptors, on
    the image's device.

    ``stride`` spaces the patch samples (patch spans patch_size * stride
    pixels: a little context beats pixel-level detail for matching).
    """
    p = patch_size
    offs = (torch.arange(p, dtype=torch.float32, device=image.device)
            - (p - 1) / 2.0) * stride
    du, dv = torch.meshgrid(offs, offs, indexing="xy")
    # [K, P*P] sample coordinates, row-major over the patch
    u = uv[:, 0:1] + du.reshape(1, -1)
    v = uv[:, 1:2] + dv.reshape(1, -1)
    patch = bilinear_sample(image.float(), u, v, fill_value=0.0)
    mean = torch.mean(patch, dim=-1, keepdim=True)
    centered = patch - mean
    norm = torch.sqrt(torch.sum(centered**2, dim=-1, keepdim=True) + 1e-6)
    return centered / norm
