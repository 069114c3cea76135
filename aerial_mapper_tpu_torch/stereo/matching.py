"""Dense stereo correspondence: cost-volume BM and semi-global matching.

Twin of ``aerial_mapper_tpu/stereo/matching.py``, ported whole:

- the BM helpers the fused kernel path shares (x-Sobel prefilter, box
  filter, speckle filters, the integer-cost guard);
- the cost-volume BM with the left-right check
  (``block_matching_disparity``, BM ``kernel="xla"``);
- SGM (``sgm_disparity``, SGM ``kernel="xla"``): BT cost, block sum,
  4 or 8 directional scans, WTA + sub-pixel + uniqueness + LR check.

Every function takes a leading batch of pairs: images are ``[..., H, W]``
and cost volumes ``[..., D, H, W]`` (the SGM aggregation ``[..., H, W, D]``),
where the JAX functions take one pair. SGM's directional scans run through
``sgm_scan``: the CUDA kernel ``csrc/sgm.cu`` on a CUDA tensor, its plain
version ``sgm_scan_plain`` on a CPU tensor. SGM's cost volume and its
post-filters take hand kernels of their own, which the JAX package has no
Pallas twin of: ``sgm_cost_volume`` (``csrc/sgm_cost.cu``) writes the
[..., H, W, D] cost once, and ``sgm_wta``, ``sgm_uniqueness`` and
``sgm_lr_check`` (``csrc/sgm_select.cu``) read the aggregated volume in
place; each has a plain version, bit-equal to it on the card, that runs on
a CPU tensor. ``stereo/cuda_sgm.py`` holds the twins of ``pallas_sgm.py`` as
thin calls into this module.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aerial_mapper_tpu_torch import _build
from aerial_mapper_tpu_torch.config import BlockMatchingConfig, SgmConfig

INVALID_DISPARITY = 1.0  # kMaxInvalidDisparity (common.h / densifier.cpp:60)
_BIG = 1.0e9


def use_integer_costs(cfg: BlockMatchingConfig) -> bool:
    """True when the cv-faithful quantized integer-cost path applies:
    window sums must fit int16 and the prefilter output must fit uint8."""
    return bool(
        cfg.integer_costs
        and 2 * cfg.pre_filter_cap * cfg.block_size ** 2 < 32767
        and 2 * cfg.pre_filter_cap <= 255
    )


def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and dtype != torch.bool


def _big_for(dtype: torch.dtype):
    """Invalid-cost sentinel (Python scalar): dtype max for ints, 1e9 for
    floats, as every masked-cost site of the int16 cost volume needs."""
    if _is_integer(dtype):
        return int(torch.iinfo(dtype).max)
    return _BIG


def _edge_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Indices that edge-pad an axis of length ``n`` (numpy mode='edge')."""
    return torch.arange(-before, n + after, device=device).clamp(0, n - 1)


def _box_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum over a k x k window (edge-padded) via integral images.

    The same cumsum formulation as the JAX version. Float inputs: the two
    frameworks' cumsums round differently, so on non-integer inputs the
    sums agree to float rounding only (integer-valued inputs are exact in
    both). Integer inputs: the JAX version runs the integral in int16 and
    relies on wrap-around; here it runs in int32 and the window sums are
    cast to int16 — the same values, since the caller guarantees that the
    window sums fit int16 (``use_integer_costs``).
    """
    r = k // 2
    integer = _is_integer(x.dtype)
    for ax in (-2, -1):
        n = x.shape[ax]
        xp = x.index_select(ax, _edge_index(n, r + 1, r, x.device))
        if integer:
            cs = torch.cumsum(xp, dim=ax, dtype=torch.int32)
            x = (cs.narrow(ax, k, n) - cs.narrow(ax, 0, n)).to(torch.int16)
        else:
            cs = torch.cumsum(xp, dim=ax)
            x = cs.narrow(ax, k, n) - cs.narrow(ax, 0, n)
    return x


def _xsobel_prefilter(image: torch.Tensor, cap: float) -> torch.Tensor:
    """cv::StereoBM's PREFILTER_XSOBEL: horizontal Sobel clamped to
    [-cap, cap], shifted by +cap so values stay nonnegative."""
    h, w = image.shape[-2], image.shape[-1]
    p = image.index_select(-2, _edge_index(h, 1, 1, image.device))
    p = p.index_select(-1, _edge_index(w, 1, 1, image.device))
    gx = (
        (p[..., :-2, 2:] - p[..., :-2, :-2])
        + 2.0 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
        + (p[..., 2:, 2:] - p[..., 2:, :-2])
    )
    return torch.clamp(gx, -cap, cap) + cap


def _diag_shear(vol: torch.Tensor, sign: int, fill) -> torch.Tensor:
    """out[..., d, v, u] = vol[..., d, v, u + sign * d]; out of range ->
    ``fill``. Pad + transpose + one strided reshape, as the JAX version."""
    d_, h, w = vol.shape[-3:]
    lead = vol.shape[:-3]
    if sign > 0:
        wp = w + d_ + 1
        padded = F.pad(vol, (0, wp - w, 0, 0, 0, 1), value=fill)
        flat = padded.transpose(-3, -2).reshape(*lead, h, (d_ + 1) * wp)
        out = flat[..., : d_ * (wp + 1)].reshape(*lead, h, d_, wp + 1)
        out = out[..., :w]
    else:
        p = d_  # left pad = max shift
        wp = w + p + 1
        padded = F.pad(vol, (p, wp - w - p, 0, 0, 0, 1), value=fill)
        flat = padded.transpose(-3, -2).reshape(*lead, h, (d_ + 1) * wp)
        out = flat[..., : d_ * (wp - 1)].reshape(*lead, h, d_, wp - 1)
        out = out[..., p: p + w]
    return out.transpose(-3, -2)


def _shifted_right(image: torch.Tensor, num_disp: int,
                   min_disp: int) -> torch.Tensor:
    """[..., D, H, W] stack: out[d] = right image shifted right by
    (min_disp + d); out-of-range pixels are 0 (the border mask drops them).
    """
    h, w = image.shape[-2:]
    base = F.pad(image, (min_disp, 0))[..., :w] if min_disp else image
    vol = base.unsqueeze(-3).expand(*base.shape[:-2], num_disp, h, w)
    return _diag_shear(vol, sign=-1, fill=0)


def _cost_volume_sad(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                     min_disp: int, block: int) -> torch.Tensor:
    """SAD cost volume [..., D, H, W] with k x k aggregation. uint8 inputs
    (the quantized path) take |diff| as max - min (unsigned subtraction
    wraps) and give int16 window sums."""
    r_stack = _shifted_right(right, num_disp, min_disp)
    lex = left.unsqueeze(-3)
    if left.dtype == torch.uint8:
        ad = torch.maximum(lex, r_stack) - torch.minimum(lex, r_stack)
    else:
        ad = (lex - r_stack).abs()
    return _box_filter(ad, block)


def _bt_cost(left: torch.Tensor, right: torch.Tensor, num_disp: int,
             min_disp: int) -> torch.Tensor:
    """Birchfield-Tomasi sampling-insensitive pixel cost [..., D, H, W]:
    each pixel against the interval spanned by the other image's
    half-samples, with edge-replicated neighbours at the first and last
    columns."""
    def half_samples(img):
        prev = torch.cat([img[..., :1], img[..., :-1]], dim=-1)
        nxt = torch.cat([img[..., 1:], img[..., -1:]], dim=-1)
        lo = 0.5 * (img + prev)
        hi = 0.5 * (img + nxt)
        mn = torch.minimum(torch.minimum(lo, hi), img)
        mx = torch.maximum(torch.maximum(lo, hi), img)
        return mn, mx

    lmin, lmax = half_samples(left)
    rmin, rmax = half_samples(right)
    r_v = _shifted_right(right, num_disp, min_disp)
    rmin_v = _shifted_right(rmin, num_disp, min_disp)
    rmax_v = _shifted_right(rmax, num_disp, min_disp)
    lv = left.unsqueeze(-3)
    d_lr = torch.clamp(torch.maximum(lv - rmax_v, rmin_v - lv), min=0.0)
    del rmin_v, rmax_v
    d_rl = torch.clamp(torch.maximum(r_v - lmax.unsqueeze(-3),
                                     lmin.unsqueeze(-3) - r_v), min=0.0)
    return torch.minimum(d_lr, d_rl)


def _border_mask(h: int, w: int, num_disp: int, min_disp: int,
                 device) -> torch.Tensor:
    """[D, H, W] True where the shifted right pixel actually exists."""
    u = torch.arange(w, device=device)
    d = torch.arange(num_disp, device=device)[:, None] + min_disp
    ok = (u[None, :] - d) >= 0  # [D, W]
    return ok[:, None, :].expand(num_disp, h, w)


def _select_plane(cost: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cost[..., idx, v, u] for idx [..., H, W]. The JAX version sums the
    one selected plane under a mask; a gather returns the same value."""
    return cost.gather(-3, idx.unsqueeze(-3)).squeeze(-3)


def _wta_subpixel(cost: torch.Tensor, min_disp: int, d_last: bool = False):
    """Winner-take-all over D + parabolic sub-pixel refinement.

    Returns (disparity [..., H, W] float, min_cost [..., H, W], best_idx
    [..., H, W] int64); ties go to the first index, as argmin's do.
    ``cost`` is [..., D, H, W]; with ``d_last`` it is SGM's aggregated
    [..., H, W, D] float32 volume and ``sgm_wta`` computes the result (the
    hand kernel on a CUDA tensor).
    """
    if d_last:
        return sgm_wta(cost, min_disp)
    return _wta_dhw(cost, min_disp)


def _wta_dhw(cost: torch.Tensor, min_disp: int):
    """``_wta_subpixel`` on a [..., D, H, W] volume in PyTorch ops."""
    num_disp = cost.shape[-3]
    best = torch.argmin(cost, dim=-3)
    c0 = torch.amin(cost, dim=-3)
    cm = _select_plane(cost, (best - 1).clamp(0, num_disp - 1)).float()
    cp = _select_plane(cost, (best + 1).clamp(0, num_disp - 1)).float()
    c0f = c0.float()
    if _is_integer(cost.dtype):
        # the int sentinel (dtype max at border-masked planes) becomes the
        # float _BIG, so deltas at the disparity border match the float path
        big = float(_big_for(cost.dtype))
        cm = torch.where(cm == big, _BIG, cm)
        cp = torch.where(cp == big, _BIG, cp)
    denom = cm - 2.0 * c0f + cp
    zero = torch.zeros_like(denom)
    delta = torch.where(denom.abs() > 1e-9, (cm - cp) / (2.0 * denom), zero)
    delta = torch.clamp(delta, -0.5, 0.5)
    interior = (best > 0) & (best < num_disp - 1)
    disp = best.float() + torch.where(interior, delta, zero) + min_disp
    return disp, c0, best


def _uniqueness_mask(cost: torch.Tensor, best: torch.Tensor, c0: torch.Tensor,
                     ratio: int, d_last: bool = False) -> torch.Tensor:
    """cv::StereoBM/SGBM uniqueness: invalidate when some d' with
    |d' - best| > 1 has ``sad[d'] <= minsad + minsad*ratio/100`` (integer
    truncating arithmetic on integer costs, equality rejects); float costs
    use the strict-> analogue. ``ratio < 0`` disables the check. With
    ``d_last``, ``cost`` is SGM's [..., H, W, D] float32 volume and
    ``sgm_uniqueness`` computes the mask."""
    if d_last:
        return sgm_uniqueness(cost, best, c0, ratio)
    return _uniqueness_dhw(cost, best, c0, ratio)


def _uniqueness_dhw(cost: torch.Tensor, best: torch.Tensor, c0: torch.Tensor,
                    ratio: int) -> torch.Tensor:
    """``_uniqueness_mask`` on a [..., D, H, W] volume in PyTorch ops."""
    if ratio < 0:
        return torch.ones(best.shape, dtype=torch.bool, device=cost.device)
    num_disp = cost.shape[-3]
    d_idx = torch.arange(num_disp, device=cost.device)[:, None, None]
    away = (d_idx - best.unsqueeze(-3)).abs() > 1
    big = _big_for(cost.dtype)
    runner = torch.where(away, cost, big).amin(dim=-3)
    if _is_integer(cost.dtype):
        runner_i = runner.to(torch.int32)
        # all-masked pixels carry the dtype-max sentinel, which can be
        # smaller than the int32 threshold: remap to int32 max first
        runner_i = torch.where(runner_i == int(big), 2 ** 31 - 1, runner_i)
        thresh = c0.to(torch.int32) * (100 + ratio) // 100
        return runner_i > thresh
    runner_f = runner.float()
    runner_f = torch.where(runner_f == float(big), _BIG, runner_f)
    return runner_f > c0.float() * (1.0 + ratio / 100.0)


def _lr_consistency_mask(cost: torch.Tensor, best: torch.Tensor,
                         min_disp: int, max_diff: int = 1,
                         d_last: bool = False) -> torch.Tensor:
    """Left-right check on the left cost volume alone (cv's
    validateDisparity at index level, ``max_diff`` = disp12MaxDiff).

    The right-view cost is the diagonal of the left volume,
    ``cost_R[d, v, u_r] = cost_L[d, v, u_r + min_disp + d]``; right winners
    are marked by equality with the right-column minima and sheared back to
    left coordinates, and a left pixel passes when one of the marks at
    ``(dL + off, u + off)``, |off| <= max_diff, is set (the JAX docstring
    derives it). The final any-reduction over d is a gather at ``best``.
    With ``d_last``, ``cost`` is SGM's [..., H, W, D] float32 volume and
    ``sgm_lr_check`` computes the mask.
    """
    if d_last:
        return sgm_lr_check(cost, best, min_disp, max_diff)
    return _lr_check_dhw(cost, best, min_disp, max_diff)


def _lr_check_dhw(cost: torch.Tensor, best: torch.Tensor, min_disp: int,
                  max_diff: int) -> torch.Tensor:
    """``_lr_consistency_mask`` on a [..., D, H, W] volume in PyTorch
    ops."""
    w = cost.shape[-1]
    big = _big_for(cost.dtype)
    shifted = (F.pad(cost, (0, min_disp), value=big)[..., min_disp:]
               if min_disp else cost)
    cost_r = _diag_shear(shifted, sign=+1, fill=big)
    win_r = cost_r == cost_r.amin(dim=-3, keepdim=True)
    del cost_r
    aligned = _diag_shear(win_r, sign=-1, fill=False)
    if min_disp:
        aligned = F.pad(aligned, (min_disp, 0))[..., :w]
    near = aligned
    for off in range(1, max_diff + 1):
        near = near | F.pad(aligned, (0, off, 0, 0, 0, off))[
            ..., off:, :, off:]
        near = near | F.pad(aligned, (off, 0, 0, 0, off, 0))[
            ..., :-off, :, :w]
    return _select_plane(near, best)


def _speckle_mask(disp: torch.Tensor, valid: torch.Tensor, window_size: int,
                  speckle_range: float) -> torch.Tensor:
    """Windowed approximation of cv::filterSpeckles: keep a pixel if enough
    neighbours in a k x k window agree within ``speckle_range``."""
    if window_size <= 0:
        return valid
    k = max(3, int(round(window_size ** 0.5)) | 1)
    validf = valid.to(disp.dtype)
    support = _box_filter(validf, k)
    mean = _box_filter(torch.where(valid, disp, torch.zeros_like(disp)), k) \
        / torch.clamp(support, min=1.0)
    density = support / float(k * k)
    coherent = (disp - mean).abs() <= speckle_range
    return valid & coherent & (density > 0.25)


def _speckle_mask_cc(disp: torch.Tensor, valid: torch.Tensor, max_size: int,
                     speckle_range: float, num_iters: int = 0) -> torch.Tensor:
    """Connected-component speckle filter (cv::filterSpeckles parity).

    Pixels are 4-connected when both are valid and their disparities differ
    by <= ``speckle_range``; every region of <= ``max_size`` pixels is
    invalidated. Labels are linear indices over the whole batch (pair b's
    pixels are b*H*W + i, so a label never leaves its pair); each iteration
    takes the min label over the allowed edges, scatter-mins it onto each
    pixel's root (``scatter_reduce`` "amin"), and flattens with two pointer
    jumps, until a fixed point or the ceil(log2(H*W)) + 4 bound. Region
    sizes come from an integer ``index_add_``. Min and integer sums do not
    depend on order, so the result is deterministic on any device.
    """
    if max_size <= 0:
        return valid
    h, w = disp.shape[-2:]
    n = h * w
    if num_iters <= 0:
        num_iters = max(1, int(math.ceil(math.log2(max(n, 2))))) + 4
    disp3 = disp.reshape(-1, h, w)
    valid3 = valid.reshape(-1, h, w)
    total = disp3.shape[0] * n
    no_label = total - 1  # >= every label: min() with it is a no-op

    def shifted(a, di, dj, fill):
        # out[..., i, j] = a[..., i - di, j - dj]; outside -> fill
        ap = F.pad(a, (max(dj, 0), max(-dj, 0), max(di, 0), max(-di, 0)),
                   value=fill)
        r0, c0 = max(-di, 0), max(-dj, 0)
        return ap[..., r0: r0 + h, c0: c0 + w]

    shifts = ((0, 1), (0, -1), (1, 0), (-1, 0))
    edges = []
    for di, dj in shifts:
        nd = shifted(disp3, di, dj, _BIG)
        nv = shifted(valid3, di, dj, False)
        edges.append(valid3 & nv & ((disp3 - nd).abs() <= speckle_range))

    def hook(lab):
        labg = lab.reshape(-1, h, w)
        best = labg
        for (di, dj), ok in zip(shifts, edges):
            nl = shifted(labg, di, dj, no_label)
            best = torch.minimum(best, torch.where(ok, nl, no_label))
        # the min neighbour label seen at p flows to p's root slot
        new = lab.scatter_reduce(0, lab, best.reshape(-1), reduce="amin",
                                 include_self=True)
        new = new[new]  # flatten the (depth <= 3) forest
        return new[new]

    # labels only decrease, so a fixed point ends the loop with the result
    # of the full worst-case bound
    label = torch.arange(total, device=disp.device)
    for _ in range(num_iters):
        new = hook(label)
        changed = bool((new != label).any())
        label = new
        if not changed:
            break
    counts = torch.zeros(total, dtype=torch.int32, device=disp.device)
    counts.index_add_(0, label, valid3.reshape(-1).to(torch.int32))
    region_size = counts[label].reshape(valid.shape)
    return valid & (region_size > max_size)


def apply_speckle_filter(disp: torch.Tensor, valid: torch.Tensor,
                         cfg) -> torch.Tensor:
    """Dispatch on ``cfg.speckle_mode``: 'windowed' (fast approximation)
    or 'cc' (cv::filterSpeckles-parity connected components)."""
    if getattr(cfg, "speckle_mode", "windowed") == "cc":
        return _speckle_mask_cc(disp, valid, cfg.speckle_window_size,
                                cfg.speckle_range)
    return _speckle_mask(disp, valid, cfg.speckle_window_size,
                         cfg.speckle_range)


def block_matching_disparity(left: torch.Tensor, right: torch.Tensor,
                             mask: torch.Tensor,
                             cfg: BlockMatchingConfig) -> torch.Tensor:
    """cv::StereoBM-equivalent disparity of rectified pairs [..., H, W]
    from the full cost volume (BM ``kernel="xla"``).

    ``mask``: bool valid-rectification region; pixels outside get
    ``INVALID_DISPARITY``. With ``cfg.integer_costs`` the images are
    rounded, the prefiltered images are uint8 and the [..., D, H, W] cost
    volume is int16 (its window-sum bound is checked by
    ``use_integer_costs``; configs that could overflow use float32).
    """
    h, w = left.shape[-2:]
    use_int = use_integer_costs(cfg)
    left_f = left.float()
    right_f = right.float()
    if use_int:
        left_f = torch.round(left_f)
        right_f = torch.round(right_f)
    lf = _xsobel_prefilter(left_f, cfg.pre_filter_cap)
    rf = _xsobel_prefilter(right_f, cfg.pre_filter_cap)
    # prefilter output is in [0, 2*cap] <= 126: uint8, like cv::StereoBM's
    lfq = lf.to(torch.uint8) if use_int else lf
    rfq = rf.to(torch.uint8) if use_int else rf

    cost = _cost_volume_sad(lfq, rfq, cfg.num_disparities, cfg.min_disparity,
                            cfg.block_size)
    border = _border_mask(h, w, cfg.num_disparities, cfg.min_disparity,
                          left.device)
    cost = torch.where(border, cost, _big_for(cost.dtype))
    disp, c0, best = _wta_subpixel(cost, cfg.min_disparity)

    # texture: the RAW window sum of |sobel - ftzero| (cv::StereoBM)
    texture = _box_filter((lf - cfg.pre_filter_cap).abs(), cfg.block_size)
    valid = texture >= cfg.texture_threshold
    valid = valid & _uniqueness_mask(cost, best, c0, cfg.uniqueness_ratio)
    if cfg.disp_12_max_diff >= 0:
        valid = valid & _lr_consistency_mask(cost, best, cfg.min_disparity,
                                             cfg.disp_12_max_diff)
    valid = valid & mask & border.any(dim=0)
    valid = apply_speckle_filter(disp, valid, cfg)
    return torch.where(valid, disp, INVALID_DISPARITY)


def _sgm_scan_1d(cost: torch.Tensor, p1: float, p2: float, reverse: bool,
                 restart=None, pallas_form: bool = False) -> torch.Tensor:
    """The SGM recurrence along the [..., L, D] scan axis, a loop over L
    with everything else vectorized (twin of the JAX ``_sgm_scan_1d``).

    ``restart`` (optional bool, broadcastable to [..., L]): True where a
    position begins a new DP segment in FORWARD order; the recurrence
    resets there (out = raw cost). For ``reverse=True`` the flags are
    re-derived: a segment's first element in reverse order is its last in
    forward order. The arithmetic at a flagged step is the JAX scan's
    ``where(r, c, (c + best) - m)``, or with ``pallas_form`` the Pallas
    kernel's ``c + (best - m) * (1 - r)`` (pallas_sgm.py:79), which rounds
    differently where r = 0. Without flags both are ``(c + best) - m``.
    """
    if restart is not None:
        if reverse:
            restart = torch.cat(
                [restart[..., 1:], torch.ones_like(restart[..., :1])], dim=-1)
            restart = restart.flip(-1)
        keep = 1.0 - restart.to(cost.dtype)
    if reverse:
        cost = cost.flip(-2)
    out = torch.empty_like(cost)
    carry = cost[..., 0, :]
    out[..., 0, :] = carry
    for k in range(1, cost.shape[-2]):
        c = cost[..., k, :]
        m = carry.amin(dim=-1, keepdim=True)
        # the d -+ 1 neighbour is the clamped copy at the ends, +P1 too
        up = torch.cat([carry[..., :1] + p1, carry[..., :-1] + p1], dim=-1)
        down = torch.cat([carry[..., 1:] + p1, carry[..., -1:] + p1], dim=-1)
        best = torch.minimum(torch.minimum(carry, up),
                             torch.minimum(down, m + p2))
        if restart is None:
            carry = c + best - m
        elif pallas_form:
            carry = c + (best - m) * keep[..., k, None]
        else:
            carry = torch.where(restart[..., k, None], c, c + best - m)
        out[..., k, :] = carry
    return out.flip(-2) if reverse else out


# The 8 scan passes of the aggregation. The JAX package gets them by
# transposing, flipping and modularly row-shearing the volume; here each pass
# walks its lines by index (``_pass_lines``), which is the same bijection,
# and writes its output at the original (h, w):
#
#   pass  line n, step t (forward order)             restart (forward order)
#   0, 1  (h, w) = (n, t): left->right, right->left  none
#   2, 3  (h, w) = (t, n): top->bottom, bottom->top  none
#   4, 5  (h, w) = (t, (n + t) mod W), fwd / rev     where w == 0
#   6, 7  (h, w) = (t, (n - t) mod W), fwd / rev     where w == W - 1
#
# Odd passes walk their lines in reverse. The diagonals' restart flags mark
# where the modular shear wraps a diagonal round the border (JAX
# ``matching.py:619-627``); ``_sgm_scan_1d`` re-derives them for the reverse
# walk.
NUM_PASSES = 8
MAX_SGM_DISPARITIES = 256  # sgm.cu, sgm_select.cu: ceil(D / 32) <= 8


def _pass_lines(pass_id: int, h: int, w: int, device):
    """Pass ``pass_id``'s lines in forward order: (hh [N, L], ww [N, L],
    restart [N, L] bool or None, reverse)."""
    reverse = bool(pass_id % 2)
    if pass_id < 2:
        hh, ww = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        return hh, ww, None, reverse
    n = torch.arange(w, device=device)[:, None]
    t = torch.arange(h, device=device)[None, :]
    hh = t.expand(w, h)
    if pass_id < 4:
        return hh, n.expand(w, h), None, reverse
    sign = 1 if pass_id < 6 else -1
    ww = torch.remainder(n + sign * t, w)
    return hh, ww, ww == (0 if sign > 0 else w - 1), reverse


def sgm_scan_plain(cost: torch.Tensor, p1: float, p2: float, pass_id: int,
                   pallas_form: bool) -> torch.Tensor:
    """Plain PyTorch version of one scan pass of ``csrc/sgm.cu`` on
    ``[B, H, W, D]``: gather the pass's lines, run ``_sgm_scan_1d`` (a loop
    over the scan axis with the kernel's arithmetic, step for step),
    scatter back."""
    h, w = cost.shape[1:3]
    hh, ww, restart, reverse = _pass_lines(pass_id, h, w, cost.device)
    lines = cost[:, hh, ww]  # [B, N, L, D]
    agg = _sgm_scan_1d(lines, p1, p2, reverse, restart=restart,
                       pallas_form=pallas_form)
    out = torch.empty_like(cost)
    out[:, hh, ww] = agg
    return out


def sgm_scan(cost: torch.Tensor, p1: float, p2: float, pass_id: int,
             pallas_form: bool) -> torch.Tensor:
    """One scan pass: the CUDA kernel ``csrc/sgm.cu`` for a CUDA tensor, the
    plain version for a CPU tensor. Same output as :func:`sgm_scan_plain`."""
    if cost.device.type == "cpu":
        return sgm_scan_plain(cost, p1, p2, pass_id, pallas_form)
    if cost.device.type != "cuda":
        raise ValueError(f"sgm_scan: unsupported device {cost.device}")
    if cost.dim() != 4 or cost.dtype != torch.float32:
        raise ValueError("sgm_scan: cost must be float32 [B, H, W, D]")
    if not 0 <= pass_id < NUM_PASSES:
        raise ValueError(f"sgm_scan: pass_id must be in 0..7, got {pass_id}")
    b, h, w, d = cost.shape
    if not (1 <= d <= MAX_SGM_DISPARITIES and 1 <= b <= 65535 and h and w):
        raise ValueError(f"sgm_scan: unsupported shape {tuple(cost.shape)}")
    cost = cost.contiguous()
    out = torch.empty_like(cost)
    lib = _build.load()
    err = lib.amt_sgm_launch(
        cost.data_ptr(), out.data_ptr(), b, h, w, d, pass_id,
        int(bool(pallas_form)), float(p1), float(p2),
        torch.cuda.current_stream(cost.device).cuda_stream,
    )
    _build.check(err, "amt_sgm_launch")
    sgm_scan.launches += 1
    return out


sgm_scan.launches = 0


def aggregate_passes(cost: torch.Tensor, p1: float, p2: float,
                     num_directions: int, pallas_form: bool) -> torch.Tensor:
    """Sum of the 4 or 8 scan passes of a [..., H, W, D] volume, in the
    bracket order of the JAX aggregations (``sgm_disparity_pallas``,
    ``pallas_sgm.py:184-219``): ``(p0 + p1) + (p2 + p3) + (p4 + p5) +
    (p6 + p7)``. The adds run in place (the same values as out-of-place
    adds) to keep one volume fewer alive."""
    shape = cost.shape
    cost = cost.reshape(-1, *shape[-3:])

    def pair(p):
        a = sgm_scan(cost, p1, p2, p, pallas_form)
        a += sgm_scan(cost, p1, p2, p + 1, pallas_form)
        return a

    agg = pair(0)
    agg += pair(2)
    if num_directions >= 8:
        agg += pair(4)
        agg += pair(6)
    return agg.reshape(shape)


def sgm_aggregate(cdhw: torch.Tensor, cfg: SgmConfig) -> torch.Tensor:
    """Directional SGM aggregation of a [..., H, W, D] cost volume (4 or 8
    directions per ``cfg.num_directions``) in the arithmetic of the JAX
    ``sgm_aggregate``; every path starts fresh at the image border."""
    return aggregate_passes(cdhw, cfg.p1, cfg.p2, cfg.num_directions,
                            pallas_form=False)


# The SGM cost volume and post-filters as hand kernels. Each wrapper takes
# its plain version on a CPU tensor and launches its kernel on a CUDA tensor
# (or raises), and counts its launches in ``<wrapper>.launches``.
SGM_COST_MAX_BLOCK = 15  # csrc/sgm_cost.cu instantiates windows 1..15
# the LR kernel's three [W] key arrays, 12 bytes a column of dynamic shared
# memory (144 KB at this width, of the 227 KB a block can take)
_SGM_LR_MAX_WIDTH = 12288


def _cuda_volume(name: str, cost: torch.Tensor,
                 max_d: int = MAX_SGM_DISPARITIES) -> torch.Tensor:
    """``cost`` checked as a CUDA float32 [..., H, W, D] volume with
    D <= ``max_d``, as [B, H, W, D] contiguous."""
    if cost.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {cost.device}")
    if (cost.dim() < 3 or cost.dtype != torch.float32 or 0 in cost.shape
            or cost.shape[-1] > max_d):
        raise ValueError(f"{name}: cost must be a float32 [..., H, W, D] "
                         f"volume with D <= {max_d}, got {cost.dtype} "
                         f"{tuple(cost.shape)}")
    return cost.reshape(-1, *cost.shape[-3:]).contiguous()


def _cuda_pixels(name: str, x: torch.Tensor, dtype, shape) -> torch.Tensor:
    """A per-pixel operand of a post-filter kernel, checked, contiguous."""
    if x.device.type != "cuda" or x.dtype != dtype or x.shape != shape:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on the "
                         f"card, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sgm_cost_volume_plain(lf: torch.Tensor, rf: torch.Tensor, num_disp: int,
                          min_disp: int, block: int) -> torch.Tensor:
    """Plain version of ``csrc/sgm_cost.cu``: SGM's cost [..., H, W, D] of
    x-Sobel images ``lf``, ``rf`` [..., H, W]. BT (``_bt_cost``), its mean
    over the k x k window with the cost plane edge-padded, 1e4 where the
    shifted pixel does not exist. The window sum is shifted-slice adds in
    the kernel's order: the k rows top to bottom, then the k columns left to
    right (``_box_filter``'s cumsum-difference rounds otherwise, and its
    CUDA scan order is not fixed); the division is by a tensor, so that on
    the card too it is a true division and not a product with 1 / k^2."""
    h, w = lf.shape[-2:]
    cost = _bt_cost(lf, rf, num_disp, min_disp)
    k = block
    if k > 1:
        r = k // 2
        x = cost.index_select(-2, _edge_index(h, r, k - 1 - r, cost.device))
        del cost
        acc = x[..., 0:h, :] + x[..., 1:1 + h, :]
        for i in range(2, k):
            acc += x[..., i:i + h, :]
        x = acc.index_select(-1, _edge_index(w, r, k - 1 - r, acc.device))
        acc = x[..., 0:w] + x[..., 1:1 + w]
        for j in range(2, k):
            acc += x[..., j:j + w]
        del x
        cost = acc / acc.new_tensor(float(k * k))
    border = _border_mask(h, w, num_disp, min_disp, cost.device)
    cost = torch.where(border, cost, 1e4)
    return cost.movedim(-3, -1).contiguous()


def sgm_cost_volume(lf: torch.Tensor, rf: torch.Tensor, num_disp: int,
                    min_disp: int, block: int) -> torch.Tensor:
    """SGM's cost volume [..., H, W, D] float32 of the x-Sobel images
    [..., H, W]: the kernel ``csrc/sgm_cost.cu`` on a CUDA tensor, its plain
    version on a CPU tensor; the same output."""
    if lf.device.type == "cpu":
        return sgm_cost_volume_plain(lf, rf, num_disp, min_disp, block)
    # the kernel's grid is one dimension of blocks: no limit on pairs or
    # disparities
    if not (1 <= block <= SGM_COST_MAX_BLOCK and min_disp >= 0
            and num_disp >= 1):
        raise ValueError(
            f"sgm_cost_volume: unsupported block {block}, min_disp "
            f"{min_disp} or {num_disp} disparities (blocks "
            f"1..{SGM_COST_MAX_BLOCK}, min_disp >= 0, disparities >= 1)")
    if lf.device.type != "cuda" or rf.device != lf.device:
        raise ValueError(f"sgm_cost_volume: unsupported devices {lf.device}, "
                         f"{rf.device}")
    if (lf.dtype != torch.float32 or rf.dtype != torch.float32
            or lf.shape != rf.shape or lf.dim() < 2 or 0 in lf.shape):
        raise ValueError("sgm_cost_volume: images must be float32 "
                         "[..., H, W] of one shape")
    h, w = lf.shape[-2:]
    lf3 = lf.reshape(-1, h, w).contiguous()
    rf3 = rf.reshape(-1, h, w).contiguous()
    b = lf3.shape[0]
    out = torch.empty((b, h, w, num_disp), dtype=torch.float32,
                      device=lf.device)
    err = _build.load().amt_sgm_cost_launch(
        lf3.data_ptr(), rf3.data_ptr(), out.data_ptr(), b, h, w, num_disp,
        min_disp, block, _stream(lf3))
    _build.check(err, "amt_sgm_cost_launch")
    sgm_cost_volume.launches += 1
    return out.reshape(*lf.shape[:-2], h, w, num_disp)


sgm_cost_volume.launches = 0


def sgm_wta_plain(cost: torch.Tensor, min_disp: int):
    """Plain version of ``csrc/sgm_select.cu``'s WTA: ``_wta_subpixel`` on
    the [..., D, H, W] view of ``cost`` [..., H, W, D]."""
    return _wta_dhw(cost.movedim(-1, -3), min_disp)


def sgm_wta(cost: torch.Tensor, min_disp: int):
    """WTA + sub-pixel step of SGM's aggregated volume [..., H, W, D] read
    in place: (disparity, min cost, best index), as ``_wta_subpixel``. The
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if cost.device.type == "cpu":
        return sgm_wta_plain(cost, min_disp)
    vol = _cuda_volume("sgm_wta", cost)
    b, h, w, d = vol.shape
    disp = torch.empty((b, h, w), dtype=torch.float32, device=vol.device)
    c0 = torch.empty_like(disp)
    best = torch.empty((b, h, w), dtype=torch.int64, device=vol.device)
    err = _build.load().amt_sgm_wta_launch(
        vol.data_ptr(), disp.data_ptr(), c0.data_ptr(), best.data_ptr(),
        b * h * w, d, min_disp, _stream(vol))
    _build.check(err, "amt_sgm_wta_launch")
    sgm_wta.launches += 1
    shape = cost.shape[:-1]
    return disp.reshape(shape), c0.reshape(shape), best.reshape(shape)


sgm_wta.launches = 0


def sgm_uniqueness_plain(cost: torch.Tensor, best: torch.Tensor,
                         c0: torch.Tensor, ratio: int) -> torch.Tensor:
    """Plain version of ``csrc/sgm_select.cu``'s uniqueness test:
    ``_uniqueness_mask`` on the [..., D, H, W] view of ``cost``."""
    return _uniqueness_dhw(cost.movedim(-1, -3), best, c0, ratio)


def sgm_uniqueness(cost: torch.Tensor, best: torch.Tensor, c0: torch.Tensor,
                   ratio: int) -> torch.Tensor:
    """The uniqueness mask [..., H, W] of SGM's aggregated volume
    [..., H, W, D] read in place, as ``_uniqueness_mask``. The kernel on a
    CUDA tensor (``ratio < 0`` too: it writes every pixel valid), its plain
    version on a CPU tensor."""
    if cost.device.type == "cpu":
        return sgm_uniqueness_plain(cost, best, c0, ratio)
    vol = _cuda_volume("sgm_uniqueness", cost)
    b, h, w, d = vol.shape
    best = _cuda_pixels("sgm_uniqueness", best, torch.int64, cost.shape[:-1])
    c0 = _cuda_pixels("sgm_uniqueness", c0, torch.float32, cost.shape[:-1])
    valid = torch.empty(cost.shape[:-1], dtype=torch.bool, device=vol.device)
    err = _build.load().amt_sgm_uniqueness_launch(
        vol.data_ptr(), best.data_ptr(), c0.data_ptr(), valid.data_ptr(),
        b * h * w, d, int(ratio < 0), 1.0 + ratio / 100.0, _stream(vol))
    _build.check(err, "amt_sgm_uniqueness_launch")
    sgm_uniqueness.launches += 1
    return valid


sgm_uniqueness.launches = 0


def sgm_lr_check_plain(cost: torch.Tensor, best: torch.Tensor, min_disp: int,
                       max_diff: int) -> torch.Tensor:
    """Plain version of ``csrc/sgm_select.cu``'s left-right check:
    ``_lr_consistency_mask`` on the [..., D, H, W] view of ``cost``."""
    return _lr_check_dhw(cost.movedim(-1, -3), best, min_disp, max_diff)


def sgm_lr_check(cost: torch.Tensor, best: torch.Tensor, min_disp: int,
                 max_diff: int) -> torch.Tensor:
    """The left-right mask [..., H, W] of SGM's aggregated volume
    [..., H, W, D] read in place, as ``_lr_consistency_mask``: one launch
    that reads each image row once, taking its right-view column minima and
    each pixel's candidates in the same pass, then its pixels' tests. The
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if cost.device.type == "cpu":
        return sgm_lr_check_plain(cost, best, min_disp, max_diff)
    w = cost.shape[-2] if cost.dim() >= 2 else 0
    if min_disp < 0 or max_diff < 0 or w > _SGM_LR_MAX_WIDTH:
        raise ValueError(
            f"sgm_lr_check: unsupported min_disp {min_disp}, max_diff "
            f"{max_diff} or width {w} (both >= 0, width <= "
            f"{_SGM_LR_MAX_WIDTH})")
    vol = _cuda_volume("sgm_lr_check", cost, max_d=2 ** 31 - 1)
    b, h, w, d = vol.shape
    best = _cuda_pixels("sgm_lr_check", best, torch.int64, cost.shape[:-1])
    valid = torch.empty(cost.shape[:-1], dtype=torch.bool, device=vol.device)
    err = _build.load().amt_sgm_lr_launch(
        vol.data_ptr(), best.data_ptr(), valid.data_ptr(), b * h, w, d,
        min_disp, max_diff, _stream(vol))
    _build.check(err, "amt_sgm_lr_launch")
    sgm_lr_check.launches += 1
    return valid


sgm_lr_check.launches = 0


def _sgm_cost(left: torch.Tensor, right: torch.Tensor, cfg: SgmConfig):
    """SGM's matching cost: BT on x-Sobel images, block-averaged, border
    planes at 1e4 (``sgm_cost_volume``). Returns (left prefiltered
    [..., H, W], cost [..., H, W, D] contiguous, border [D, H, W])."""
    h, w = left.shape[-2:]
    lf = _xsobel_prefilter(left.float(), float(cfg.pre_filter_cap))
    rf = _xsobel_prefilter(right.float(), float(cfg.pre_filter_cap))
    cost = sgm_cost_volume(lf, rf, cfg.num_disparities, cfg.min_disparity,
                           cfg.block_size)
    border = _border_mask(h, w, cfg.num_disparities, cfg.min_disparity,
                          left.device)
    return lf, cost, border


def _sgm_disparity(left: torch.Tensor, right: torch.Tensor,
                   mask: torch.Tensor, cfg: SgmConfig,
                   pallas_form: bool) -> torch.Tensor:
    """The SGM pipeline behind both twins. ``pallas_form`` selects
    ``sgm_disparity_pallas``'s behaviour: the Pallas restart arithmetic on
    the diagonals and no texture gate (``pallas_sgm.py:221-229``);
    otherwise the JAX ``sgm_disparity``'s: the XLA restart arithmetic and
    the opt-in texture gate."""
    lf, cost, border = _sgm_cost(left, right, cfg)
    agg = aggregate_passes(cost, cfg.p1, cfg.p2, cfg.num_directions,
                           pallas_form)
    del cost
    # the post-filters read the [..., H, W, D] sum in place (d_last: the
    # hand kernels of csrc/sgm_select.cu on a CUDA tensor)
    disp, c0, best = _wta_subpixel(agg, cfg.min_disparity, d_last=True)
    valid = _uniqueness_mask(agg, best, c0, cfg.uniqueness_ratio,
                             d_last=True)
    if not pallas_form and cfg.texture_threshold > 0:
        # opt-in BM-style gate: raw block sum of |sobel - cap|
        texture = _box_filter((lf - float(cfg.pre_filter_cap)).abs(),
                              cfg.block_size)
        valid = valid & (texture >= cfg.texture_threshold)
    if cfg.disp_12_max_diff >= 0:
        # cv::StereoSGBM's validateDisparity on the AGGREGATED volume
        valid = valid & _lr_consistency_mask(agg, best, cfg.min_disparity,
                                             cfg.disp_12_max_diff,
                                             d_last=True)
    valid = valid & mask & border.any(dim=0)
    valid = apply_speckle_filter(disp, valid, cfg)
    return torch.where(valid, disp, INVALID_DISPARITY)


def sgm_disparity(left: torch.Tensor, right: torch.Tensor, mask: torch.Tensor,
                  cfg: SgmConfig) -> torch.Tensor:
    """Semi-global matching disparity of rectified pairs [..., H, W]
    (cv::StereoSGBM-equivalent; SGM ``kernel="xla"``).

    BT cost on x-Sobel prefiltered images, block-averaged, aggregated along
    ``cfg.num_directions`` scan directions (the JAX scan's arithmetic),
    WTA + sub-pixel + uniqueness + the opt-in texture gate + LR check +
    mask + speckle.
    """
    return _sgm_disparity(left, right, mask, cfg, pallas_form=False)
