"""Dense image resampling: bilinear and nearest gathers, remap, homography
warp, point-in-quad.

Twin of ``aerial_mapper_tpu/image/sample.py``. Images are ``[..., H, W]``
float tensors with any leading batch shape (channels, where there are any,
lead too: the JAX package puts them last); the coordinates ``u`` (column)
and ``v`` (row) share those leading dimensions. Sampling at integer
coordinates hits pixel centers, matching OpenCV.
"""

from __future__ import annotations

import torch


def bilinear_sample(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    fill_value: float = 0.0) -> torch.Tensor:
    """Bilinear sample ``image [B, H, W]`` at float coords ``u, v [B, ...]``.

    Out-of-bounds coordinates return ``fill_value`` (cv::BORDER_CONSTANT).

    The JAX version packs the four neighbours into one rolled [H, W, 4]
    array and fetches them with a single gather (a TPU gather trick: its
    cost there is per index). Here they are four clamped gathers. The
    values are the same: a rolled (wrapped) neighbour and a clamped one
    differ only at the last row or column, where the sample is either
    outside (filled) or its interpolation weight is exactly 0. The weights
    are combined in the JAX order: ``top``, ``bot``, then ``out``.
    """
    h, w = image.shape[-2], image.shape[-1]
    u = u.float()
    v = v.float()
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    # clamp in float before the integer cast: NaN/inf coordinates are
    # outside (filled) anyway, and a float->int cast of them is undefined
    iu0 = torch.nan_to_num(u0, nan=0.0).clamp(0, w - 1).long()
    iv0 = torch.nan_to_num(v0, nan=0.0).clamp(0, h - 1).long()
    iu1 = (iu0 + 1).clamp(max=w - 1)
    iv1 = (iv0 + 1).clamp(max=h - 1)

    p00 = _gather(image, iv0, iu0, u.shape)
    p01 = _gather(image, iv0, iu1, u.shape)
    p10 = _gather(image, iv1, iu0, u.shape)
    p11 = _gather(image, iv1, iu1, u.shape)

    top = p00 * (1.0 - fu) + p01 * fu
    bot = p10 * (1.0 - fu) + p11 * fu
    out = top * (1.0 - fv) + bot * fv

    inside = (u >= 0.0) & (v >= 0.0) & (u <= w - 1.0) & (v <= h - 1.0)
    return torch.where(inside, out, torch.full_like(out, fill_value))


def _gather(image: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
            shape) -> torch.Tensor:
    """``image[..., iy, ix]`` for in-range int64 indices that share the
    image's leading dimensions, as ``shape``."""
    h, w = image.shape[-2], image.shape[-1]
    flat = image.reshape(image.shape[:-2] + (h * w,))
    lead = shape[:-2] if len(shape) > 2 else ()
    idx = (iy * w + ix).reshape(lead + (-1,))
    return torch.gather(flat, -1, idx).reshape(shape)


def nearest_sample(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   fill_value: float = 0.0) -> torch.Tensor:
    """Nearest-neighbour sample (cv::INTER_NEAREST, the reference's
    warpPerspective at ortho-forward-homography.cc:112-115): ``u, v``
    rounded half to even, as ``jnp.round`` does; a rounded index outside
    the image returns ``fill_value``."""
    h, w = image.shape[-2], image.shape[-1]
    # round and clamp in float before the integer cast: a NaN / inf
    # coordinate is outside (filled), and its cast is undefined
    ru = torch.round(u.float())
    rv = torch.round(v.float())
    inside = (ru >= 0) & (rv >= 0) & (ru <= w - 1) & (rv <= h - 1)
    iu = torch.nan_to_num(ru, nan=0.0).clamp(0, w - 1).long()
    iv = torch.nan_to_num(rv, nan=0.0).clamp(0, h - 1).long()
    out = _gather(image, iv, iu, u.shape)
    return torch.where(inside, out, torch.full_like(out, fill_value))


def remap(image: torch.Tensor, map_u: torch.Tensor, map_v: torch.Tensor,
          fill_value: float = 0.0, nearest: bool = False) -> torch.Tensor:
    """cv::remap: output[..., i, j] = image(map_v, map_u), bilinear or
    (``nearest``) nearest-neighbour."""
    if nearest:
        return nearest_sample(image, map_u, map_v, fill_value)
    return bilinear_sample(image, map_u, map_v, fill_value)


def homography_warp(image: torch.Tensor, h_matrix, out_shape: tuple,
                    fill_value: float = 0.0,
                    nearest: bool = False) -> torch.Tensor:
    """Warp ``image [..., H, W]`` by the 3x3 homography ``h_matrix``, which
    maps source pixel (u, v, 1) to output coordinates, onto an
    ``out_shape = (H', W')`` grid: ``[..., H', W']``.

    The inverse map, as cv::warpPerspective does it: ``h_matrix`` is
    inverted once in float32 and evaluated projectively on the output grid
    (a ``|z| < 1e-12`` is replaced by 1e-12), then :func:`remap` gathers
    from the source. The grid follows the image's device.
    """
    hh, ww = out_shape
    dev = image.device
    h_inv = torch.linalg.inv(torch.as_tensor(h_matrix, dtype=torch.float32,
                                             device=dev))
    v = torch.arange(hh, dtype=torch.float32, device=dev)[:, None] \
        .expand(hh, ww)
    u = torch.arange(ww, dtype=torch.float32, device=dev)[None, :] \
        .expand(hh, ww)
    x = h_inv[0, 0] * u + h_inv[0, 1] * v + h_inv[0, 2]
    y = h_inv[1, 0] * u + h_inv[1, 1] * v + h_inv[1, 2]
    z = h_inv[2, 0] * u + h_inv[2, 1] * v + h_inv[2, 2]
    z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    lead = image.shape[:-2]
    src_u = (x / z).expand(lead + (hh, ww))
    src_v = (y / z).expand(lead + (hh, ww))
    return remap(image, src_u, src_v, fill_value, nearest=nearest)


def point_in_quad(u: torch.Tensor, v: torch.Tensor,
                  corners_uv: torch.Tensor) -> torch.Tensor:
    """Point-in-convex-quad test; ``corners_uv`` is [..., 4, 2] in winding
    order and broadcasts against ``u``/``v`` after two trailing dims are
    added (``[B, 4, 2]`` corners with ``[B, H, W]`` or ``[H, W]`` grids).
    Either orientation passes: all edge cross products share a sign."""
    cross = []
    for i in range(4):
        a = corners_uv[..., i, :]
        b = corners_uv[..., (i + 1) % 4, :]
        ax, ay = a[..., 0, None, None], a[..., 1, None, None]
        bx, by = b[..., 0, None, None], b[..., 1, None, None]
        cross.append((bx - ax) * (v - ay) - (by - ay) * (u - ax))
    cross = torch.stack(cross, dim=0)
    return (cross >= 0.0).all(dim=0) | (cross <= 0.0).all(dim=0)
