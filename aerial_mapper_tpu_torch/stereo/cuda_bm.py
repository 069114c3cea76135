"""Fused block matching: CUDA kernels ``csrc/bm.cu`` and their plain version.

Replaces ``aerial_mapper_tpu/stereo/pallas_bm.py``. The kernels compute the
running-state scan over disparities (``_bm_kernel``): five ``[B, H, W]``
maps (best cost, winner index, the costs at winner -1 / +1, and a running
runner-up outside +-1) without ever materialising the cost volume. The
prefilter before it and the sub-pixel / uniqueness / texture / speckle pass
after it are PyTorch ops here, as they are XLA ops around the Pallas call.

:func:`bm_scan` has two entries, both hand kernels, chosen by
``integer_costs`` (``block_matching_disparity_cuda`` passes
``use_integer_costs(cfg)``):

- ``integer_costs=True`` (the default config): the prefiltered images are
  integers in 0..2*cap <= 255 and every window sum is below 2^15, so sums
  are exact in any order. The integer kernel keeps byte copies of the
  images and O(1) running window sums per (pixel, disparity). It is built
  for every block up to 127, the largest that ``use_integer_costs`` admits.
- ``integer_costs=False`` (the float config, or a cap or block too large
  for the integer guard): the values are not integers, and only the plain
  version's summation order gives its bits. The float kernel keeps that
  order with one in-order fold per direction over a register ring (4r + 9
  operations per (pixel, disparity)); it is built for blocks up to 55. A
  larger block, or one whose tiles would not fit the card's shared memory
  at ``num_disp``, takes the wide float kernel, chosen before the launch
  (:func:`float_entry`); past that, the CUDA branch raises ``ValueError``.

Neither entry falls back to the other or to the plain version; on a CPU
tensor both take :func:`bm_scan_plain`, which is exact for either and
takes any block.

Semantics are those of the Pallas matcher, including its two documented
acceptance-set deviations from the cost-volume matcher: the runner-up is a
running minimum (it can only under-estimate, so uniqueness rejects more),
and there is no left-right check (``disp_12_max_diff`` is ignored).
"""

from __future__ import annotations

import torch

from aerial_mapper_tpu_torch import _build
from aerial_mapper_tpu_torch.config import BlockMatchingConfig
from aerial_mapper_tpu_torch.stereo.matching import (
    INVALID_DISPARITY,
    _box_filter,
    _xsobel_prefilter,
    apply_speckle_filter,
    use_integer_costs,
)

_BIG = 1.0e9
# the integer kernel's largest block (csrc/bm.cu MAX_R = 63): the largest
# block use_integer_costs admits, 2 * 1 * 127^2 < 32767 at pre_filter_cap 1
INT_MAX_BLOCK = 127
# the float ring kernel's tile (csrc/bm.cu FTH x FTW, FWARPS disparities per
# chunk) and largest radius FR_MAX; the wide float kernel's tile WTH x WTW
_RING_TH, _RING_TW, _RING_WARPS, FLOAT_RING_MAX_R = 32, 64, 8, 27
_WIDE_TH, _WIDE_TW = 16, 64
# the shared memory a block may opt in to on the H100 (227 KB)
SMEM_PER_BLOCK = 232448


def float_ring_smem(r: int, num_disp: int) -> int:
    """Bytes of shared memory ``bm_scan_float_kernel<r>`` takes: the
    [FWARPS][FTH][odd pitch] sums and the left / right strips."""
    ah, aw = _RING_TH + 2 * r, _RING_TW + 2 * r
    return 4 * (_RING_WARPS * _RING_TH * (aw | 1) + ah * aw
                + ah * (aw + num_disp - 1))


def float_wide_smem(r: int, num_disp: int) -> int:
    """Bytes of shared memory ``bm_scan_float_wide_kernel`` takes: the
    left strip, the AD tile, the right strip and the column sums."""
    ah, aw = _WIDE_TH + 2 * r, _WIDE_TW + 2 * r
    return 4 * (2 * ah * aw + ah * (aw + num_disp - 1) + _WIDE_TH * aw)


def float_entry(block: int, num_disp: int) -> str:
    """The launcher of the float kernel that takes ``block`` at
    ``num_disp``: the ring kernel up to its largest radius where its shared
    memory fits, else the wide one; ``ValueError`` where neither fits."""
    r = block // 2
    if r <= FLOAT_RING_MAX_R and float_ring_smem(r, num_disp) \
            <= SMEM_PER_BLOCK:
        return "amt_bm_float_launch"
    need = float_wide_smem(r, num_disp)
    if need <= SMEM_PER_BLOCK:
        return "amt_bm_float_wide_launch"
    raise ValueError(
        f"bm_scan: block {block} at {num_disp} disparities needs {need} bytes "
        f"of shared memory per block in the float kernel, more than the "
        f"{SMEM_PER_BLOCK} a block may have")


def bm_scan_plain(lf: torch.Tensor, rf: torch.Tensor, num_disp: int,
                  min_disp: int, block: int):
    """Plain PyTorch running-state scan over d on ``[B, H, W]`` prefiltered
    images; the arithmetic of ``pallas_bm.py:87-118`` in the same order.

    Returns ``(best, bestd int32, cm, cp, runner)``, each ``[B, H, W]``.
    """
    b, h, w = lf.shape
    r = block // 2
    dev = lf.device
    # rows edge-replicated through the padded strips (pallas_bm.py:169-170)
    rows = torch.arange(-r, h + r, device=dev).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=dev).clamp(0, w - 1)
    lp = lf.index_select(1, rows)  # [B, H + 2r, W]
    rp = rf.index_select(1, rows)
    u = torch.arange(w, device=dev)
    shape = (b, h, w)
    best = torch.full(shape, _BIG, dtype=torch.float32, device=dev)
    bestd = torch.full(shape, -2, dtype=torch.int32, device=dev)
    cm = best.clone()
    cp = best.clone()
    prev = best.clone()
    runner = best.clone()
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    for d in range(num_disp):
        s = d + min_disp
        rs = torch.zeros_like(lp)
        if s < w:
            rs[..., s:] = rp[..., :w - s]
        # out-of-range right pixels are 0-filled, so ad = lf there
        ad = torch.where(u >= s, (lp - rs).abs(), lp)
        # the AD, not the image, is edge-replicated horizontally
        ad = ad.index_select(2, cols)  # [B, H + 2r, W + 2r]
        acc = ad[:, 0:h, :]
        for o in range(1, 2 * r + 1):
            acc = acc + ad[:, o:o + h, :]
        cost = acc[:, :, 0:w]
        for o in range(1, 2 * r + 1):
            cost = cost + acc[:, :, o:o + w]
        cost = torch.where(u >= s, cost, big)

        is_better = cost < best
        away = (bestd - d).abs() > 1
        runner = torch.where(
            is_better,
            torch.minimum(runner, torch.where(away, best, big)),
            torch.minimum(runner, torch.where(away, cost, big)),
        )
        cp = torch.where(bestd + 1 == d, cost, cp)
        cm = torch.where(is_better, prev, cm)
        bestd = torch.where(is_better, torch.full_like(bestd, d), bestd)
        best = torch.minimum(best, cost)
        prev = cost
    return best, bestd, cm, cp, runner


def bm_scan(lf: torch.Tensor, rf: torch.Tensor, num_disp: int,
            min_disp: int, block: int, *, integer_costs: bool):
    """The running-state scan: for a CUDA tensor the integer kernel
    (``integer_costs=True``: the caller guarantees integer values in
    0..255 whose window sums stay below 2^15, as ``use_integer_costs``
    does) or the float kernel; the plain version for a CPU tensor. Same
    outputs as :func:`bm_scan_plain`.

    ``bm_scan.launches`` counts the integer kernel's launches,
    ``bm_scan.float_launches`` the float kernels' (ring or wide).
    """
    if lf.dim() != 3 or lf.shape != rf.shape or rf.device != lf.device:
        raise ValueError("bm_scan: lf and rf must be [B, H, W] on one device")
    if block % 2 != 1 or num_disp < 1 or min_disp < 0:
        raise ValueError("bm_scan: odd block, num_disp >= 1, min_disp >= 0")
    if integer_costs and block > INT_MAX_BLOCK:
        raise ValueError(f"bm_scan: integer costs need block <= "
                         f"{INT_MAX_BLOCK}")
    if lf.device.type == "cpu":
        return bm_scan_plain(lf, rf, num_disp, min_disp, block)
    if lf.device.type != "cuda":
        raise ValueError(f"bm_scan: unsupported device {lf.device}")
    name = ("amt_bm_int_launch" if integer_costs
            else float_entry(block, num_disp))
    lf = lf.float().contiguous()
    rf = rf.float().contiguous()
    b, h, w = lf.shape
    best, cm, cp, runner = (torch.empty_like(lf) for _ in range(4))
    bestd = torch.empty(lf.shape, dtype=torch.int32, device=lf.device)
    err = getattr(_build.load(), name)(
        lf.data_ptr(), rf.data_ptr(), best.data_ptr(), bestd.data_ptr(),
        cm.data_ptr(), cp.data_ptr(), runner.data_ptr(), b, h, w,
        num_disp, min_disp, block // 2,
        torch.cuda.current_stream(lf.device).cuda_stream,
    )
    _build.check(err, name)
    if integer_costs:
        bm_scan.launches += 1
    else:
        bm_scan.float_launches += 1
    return best, bestd, cm, cp, runner


bm_scan.launches = 0
bm_scan.float_launches = 0


def prefilter_pair(left: torch.Tensor, right: torch.Tensor,
                   cfg: BlockMatchingConfig):
    """Quantize (integer-cost path) and x-Sobel-prefilter both images."""
    left_f = left.float()
    right_f = right.float()
    if use_integer_costs(cfg):
        # cv-faithful quantization (the same guard as the JAX matchers):
        # integer-valued images give integer window sums, exact in float32.
        # torch.round and jnp.round both round half to even.
        left_f = torch.round(left_f)
        right_f = torch.round(right_f)
    return (_xsobel_prefilter(left_f, cfg.pre_filter_cap),
            _xsobel_prefilter(right_f, cfg.pre_filter_cap))


def block_matching_disparity_cuda(left: torch.Tensor, right: torch.Tensor,
                                  mask: torch.Tensor,
                                  cfg: BlockMatchingConfig) -> torch.Tensor:
    """Fused-kernel block matching of rectified pairs ``[B, H, W]``.

    The twin of ``block_matching_disparity_pallas`` with the pair axis as a
    real batch dimension (one kernel launch for the whole batch). Returns
    disparities ``[B, H, W]`` with ``INVALID_DISPARITY`` where rejected.
    """
    b, h, w = left.shape
    d_num = cfg.num_disparities
    lf, rf = prefilter_pair(left, right, cfg)
    c0, bestd, cm, cp, runner = bm_scan(
        lf, rf, d_num, cfg.min_disparity, cfg.block_size,
        integer_costs=use_integer_costs(cfg))
    disp_i = bestd.float() + cfg.min_disparity

    # sub-pixel refinement (pallas_bm.py:212-223): parabolic delta only at
    # interior winner indices; masked neighbours carry the _BIG sentinel
    denom = cm - 2.0 * c0 + cp
    delta = torch.where(denom.abs() > 1e-9, (cm - cp) / (2.0 * denom),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    best_idx = disp_i - cfg.min_disparity
    interior = (best_idx > 0.0) & (best_idx < d_num - 1.0)
    disp = disp_i + torch.where(interior, delta, torch.zeros_like(delta))

    if cfg.uniqueness_ratio < 0:
        valid = torch.ones((b, h, w), dtype=torch.bool, device=left.device)
    elif use_integer_costs(cfg):
        # cv integer threshold: thresh = c0 + c0*ratio//100, equality rejects
        thresh = torch.floor(c0 * (100 + cfg.uniqueness_ratio) / 100.0)
        valid = runner > thresh
    else:
        valid = runner > c0 * (1.0 + cfg.uniqueness_ratio / 100.0)
    texture = _box_filter((lf - cfg.pre_filter_cap).abs(), cfg.block_size)
    valid = valid & (texture >= cfg.texture_threshold)
    u = torch.arange(w, device=left.device)
    valid = valid & (u >= cfg.min_disparity)  # some candidate exists
    valid = valid & mask
    valid = apply_speckle_filter(disp, valid, cfg)
    return torch.where(valid, disp, torch.full_like(disp, INVALID_DISPARITY))
