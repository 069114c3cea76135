"""Bundle adjustment: Levenberg-Marquardt with a matrix-free Schur
complement (twin of ``aerial_mapper_tpu/ba/bundle_adjust.py``, single
device).

Refines camera poses and landmarks by minimizing the Huber-robust
reprojection error before rasterization (the reference assumes
pre-optimized PIX4D/COLMAP trajectories and has no such stage).

- **Jacobians by forward-mode autodiff**: the per-observation residual is
  differentiated with ``torch.func.jvp`` with respect to a 6-dof tangent
  increment (rotation vector, translation) at zero and a 3-dof landmark
  increment, one direction of the 9 at a time, ``vmap``-ed over the
  directions: the numbers of the JAX version's ``vmap(jacfwd)``.
- **Matrix-free Schur complement**: the reduced camera system
  ``S = U - W V^-1 W^T`` is never formed; its matvec is gathers plus
  segment sums over the observations, solved by block-Jacobi
  preconditioned CG.
- **Deterministic segment sums**: the camera and landmark indices are fixed
  for a whole solve, so the observations are sorted by each once
  (:class:`_Segments`) and every sum reduces each segment's rows in
  observation order (``torch.segment_reduce`` over the sorted rows). No
  float atomics: two solves on the card give the same bits, and on the CPU
  each segment adds its rows in the order JAX's ``segment_sum`` does.
- **The LM loop and its accept or reject stay on the device**
  (``torch.where``), as in JAX's ``lax.scan``: no host read per iteration.
- **One program for one device and for a mesh**: the loop is a generator
  whose every reduction over the observations is a ``yield`` of the
  partial sum. On one device the sum comes straight back;
  :func:`sharded_bundle_adjust` runs one program per observation shard
  and sends back the ``psum`` over the shards, added in shard order
  (``parallel/collectives.py``), while the camera and landmark state stays
  replicated: JAX's ``allsum`` in ``_bundle_adjust_impl``.

Gauge freedom is fixed by zeroing the first camera's update
(``cfg.fix_first_pose``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from aerial_mapper_tpu_torch.camera.models import Camera, distort
from aerial_mapper_tpu_torch.config import BundleAdjustmentConfig
from aerial_mapper_tpu_torch.device import resolve_device
from aerial_mapper_tpu_torch.geo.se3 import (
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_rotate,
)
from aerial_mapper_tpu_torch.parallel import collectives as cl

_CG_ITERS = 40


class BAProblem(NamedTuple):
    """Observations: landmark ``lm_idx[k]`` seen by camera ``cam_idx[k]`` at
    pixel ``uv[k]``. Invalid observations are masked out. The indices are
    int64 (PyTorch's index type; int32 in the JAX package)."""

    cam_idx: torch.Tensor  # [M] int64
    lm_idx: torch.Tensor  # [M] int64
    uv: torch.Tensor  # [M, 2] float32
    valid: torch.Tensor  # [M] bool


class BAState(NamedTuple):
    quats: torch.Tensor  # [N, 4] camera-to-world (wxyz)
    trans: torch.Tensor  # [N, 3]
    landmarks: torch.Tensor  # [L, 3]


def _exp_quat(omega: torch.Tensor) -> torch.Tensor:
    """Rotation-vector [..., 3] -> quaternion (wxyz).

    Differentiable at omega = 0 (where BA evaluates the Jacobian): the
    norm's sqrt is guarded with the double-where trick and the w/sinc terms
    switch to their Taylor expansions, whose derivatives at zero are exact.
    """
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta_sq < 1e-12
    theta = torch.sqrt(torch.where(small, 1.0, theta_sq))
    sinc_half = torch.where(
        small, 0.5 - theta_sq / 48.0, torch.sin(0.5 * theta) / theta
    )
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(0.5 * theta))
    return torch.cat([w, omega * sinc_half], dim=-1)


def _apply_cam_delta(quat, t, delta6):
    """Right-perturbation: R' = R exp(w^), t' = t + dt."""
    dq = _exp_quat(delta6[..., :3])
    return quat_normalize(quat_multiply(quat, dq)), t + delta6[..., 3:]


def _project_residual(quat, t, lm, uv, cam: Camera):
    """Reprojection residual [..., 2] of observations (camera-to-world
    pose), over any batch shape."""
    p_c = quat_rotate(quat_conjugate(quat), lm - t)
    z = torch.clamp(p_c[..., 2:3], min=1e-6)
    xy = distort(cam, p_c[..., :2] / z)
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u - uv[..., 0], v - uv[..., 1]], dim=-1)


def reprojection_residuals(state: BAState, problem: BAProblem, cam: Camera):
    """[M, 2] residuals (masked observations -> 0), on the tensors'
    device."""
    quats = state.quats[problem.cam_idx]
    trans = state.trans[problem.cam_idx]
    lms = state.landmarks[problem.lm_idx]
    res = _project_residual(quats, trans, lms, problem.uv, cam)
    return torch.where(problem.valid[:, None], res, 0.0)


def _obs_jacobians(state: BAState, problem: BAProblem, cam: Camera):
    """Per-observation residual + Jacobians wrt camera tangent and landmark.

    Returns (res [M, 2], Jc [M, 2, 6], Jl [M, 2, 3]).
    """
    quats = state.quats[problem.cam_idx]
    trans = state.trans[problem.cam_idx]
    lms = state.landmarks[problem.lm_idx]

    def res_of(delta6, dlm, quat, t, lm, uv):
        q2, t2 = _apply_cam_delta(quat, t, delta6)
        return _project_residual(q2, t2, lm + dlm, uv, cam)

    m = quats.shape[0]
    zeros6 = quats.new_zeros((m, 6))
    zeros3 = quats.new_zeros((m, 3))
    res = res_of(zeros6, zeros3, quats, trans, lms, problem.uv)

    # jacfwd as JAX builds it: one jvp per basis direction of the 9
    # increments, vmapped over the basis. The observations stay a plain
    # batch axis (each residual depends on its own row only), so column i
    # of every observation's Jacobian comes out of direction i at once.
    # (A vmap over the observations would make each row's coordinates
    # 0-dim tensors, and torch.func then computes their products with
    # Python floats in float64.)
    basis = torch.eye(9, dtype=quats.dtype, device=quats.device)
    basis = basis[:, None, :].expand(9, m, 9)

    def column(tangent):
        return jvp(
            lambda d6, dl: res_of(d6, dl, quats, trans, lms, problem.uv),
            (zeros6, zeros3), (tangent[..., :6], tangent[..., 6:]))[1]

    jac = vmap(column)(basis).permute(1, 2, 0)  # [M, 2, 9]
    jc, jl = jac[..., :6], jac[..., 6:]
    mask = problem.valid[:, None]
    return (
        torch.where(mask, res, 0.0),
        torch.where(mask[..., None], jc, 0.0),
        torch.where(mask[..., None], jl, 0.0),
    )


def _huber_weights(res: torch.Tensor, delta: float,
                   gate: float = float("inf")) -> torch.Tensor:
    """IRLS weights for the Huber loss, per observation [M].

    Residuals beyond ``gate`` get weight 0 (redescending outlier cut).
    """
    norm = torch.linalg.vector_norm(res, dim=-1)
    w = torch.where(norm <= delta, 1.0,
                    delta / torch.clamp(norm, min=1e-12))
    return torch.where(norm <= gate, w, 0.0)


class _Segments(NamedTuple):
    """The observations grouped by one index: ``order`` sorts them by
    segment (stable, so each segment keeps observation order) and
    ``lengths`` [num_segments] counts each segment's rows."""

    order: torch.Tensor
    lengths: torch.Tensor


def _segments(segment_ids: torch.Tensor, num_segments: int) -> _Segments:
    """Sort once per problem: the indices are fixed for a whole solve.
    Raises ``ValueError`` for an index outside ``[0, num_segments)`` (JAX's
    ``segment_sum`` drops such rows silently; no caller produces one)."""
    ids = segment_ids.long()
    if ids.numel() and not bool(
            ((ids >= 0) & (ids < num_segments)).all()):
        raise ValueError(f"segment index outside [0, {num_segments})")
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 1, device=ids.device))
    return _Segments(order=order, lengths=bounds.diff())


def _segment_sum(data: torch.Tensor, seg: _Segments) -> torch.Tensor:
    """Sum of ``data``'s rows per segment, [num_segments, ...]: each segment
    reduced in a fixed order (empty segments give 0), deterministic on the
    card. ``unsafe=True`` skips the lengths' host-side checks, which
    :func:`_segments` has made once."""
    return torch.segment_reduce(data.index_select(0, seg.order), "sum",
                                lengths=seg.lengths, axis=0, unsafe=True)


def _schur_solve(res, jc, jl, w_obs, problem: BAProblem, segs_c: _Segments,
                 segs_l: _Segments, damping, fix_first: bool,
                 prior_weight=0.0, prior_residual_t=None,
                 cg_iters: int = _CG_ITERS):
    """One damped GN step via matrix-free Schur complement + CG, as a
    generator: each segment sum over the observations is yielded and the
    total over every observation shard comes back (module docstring).

    ``segs_c`` / ``segs_l`` group the observations by camera and by
    landmark. Returns (delta_cams [N, 6], delta_lms [L, 3]).
    """
    cam_idx, lm_idx = problem.cam_idx, problem.lm_idx
    wj = w_obs[:, None, None]
    n_cams = segs_c.lengths.shape[0]

    # Block diagonals: U [N, 6, 6], V [L, 3, 3]
    jctjc = torch.einsum("mri,mrj->mij", jc, wj * jc)
    jltjl = torch.einsum("mri,mrj->mij", jl, wj * jl)
    U = yield _segment_sum(jctjc, segs_c)
    V = yield _segment_sum(jltjl, segs_l)
    eye6 = torch.eye(6, dtype=res.dtype, device=res.device)
    eye3 = torch.eye(3, dtype=res.dtype, device=res.device)
    U = U + damping * eye6[None]
    V = V + damping * eye3[None]
    # soft position prior on the translation block (gauge/scale anchor)
    prior_diag = torch.cat([
        torch.zeros(3, dtype=res.dtype, device=res.device),
        torch.full((3,), prior_weight, dtype=res.dtype, device=res.device)])
    U = U + torch.diag(prior_diag)[None]
    V_inv = torch.linalg.inv(V)  # [L, 3, 3] batched tiny inversions

    # RHS: b_c = -Jc^T W r, b_l = -Jl^T W r
    wr = w_obs[:, None] * res
    b_c = yield _segment_sum(-torch.einsum("mri,mr->mi", jc, wr), segs_c)
    if prior_residual_t is not None:
        b_c = b_c - prior_weight * torch.cat(
            [torch.zeros_like(prior_residual_t), prior_residual_t], dim=-1)
    b_l = yield _segment_sum(-torch.einsum("mri,mr->mi", jl, wr), segs_l)

    # Schur RHS: b~ = b_c - W V^-1 b_l  (W = Jc^T W_obs Jl, obs-structured)
    def w_mul_landvec(y_l):
        """x_c = sum_obs Jc^T W Jl y_{lm(obs)} -> [N, 6]"""
        contrib = torch.einsum("mri,mrj,mj->mi", jc, wj * jl, y_l[lm_idx])
        return (yield _segment_sum(contrib, segs_c))

    def wt_mul_camvec(x_c):
        """y_l = sum_obs Jl^T W Jc x_{cam(obs)} -> [L, 3]"""
        contrib = torch.einsum("mri,mrj,mj->mi", jl, wj * jc, x_c[cam_idx])
        return (yield _segment_sum(contrib, segs_l))

    vinv_bl = torch.einsum("lij,lj->li", V_inv, b_l)
    b_schur = b_c - (yield from w_mul_landvec(vinv_bl))

    free = (torch.arange(n_cams, device=res.device) != 0)[:, None]

    def gauge(x):
        if fix_first:
            return torch.where(free, x, 0.0)
        return x

    b_schur = gauge(b_schur)

    def s_matvec(x_c):
        """S x = U x - W V^-1 W^T x (gauge-projected)."""
        x_c = gauge(x_c)
        ux = torch.einsum("nij,nj->ni", U, x_c)
        wtx = yield from wt_mul_camvec(x_c)
        vinv_wtx = torch.einsum("lij,lj->li", V_inv, wtx)
        return gauge(ux - (yield from w_mul_landvec(vinv_wtx)))

    # CG on the reduced camera system (S is SPD with damping), with the
    # block-Jacobi preconditioner M = U (the damped camera diagonal of S):
    # without it plain CG needs O(n_cams) iterations on long-strip surveys
    # and a fixed iteration budget under-converges at scale.
    U_inv = torch.linalg.inv(U)  # [N, 6, 6]

    def precond(r):
        return gauge(torch.einsum("nij,nj->ni", U_inv, r))

    def guarded(d):
        return torch.where(d.abs() < 1e-20, 1e-20, d)

    x = torch.zeros_like(b_schur)
    r = b_schur
    p = precond(b_schur)
    rz = torch.sum(b_schur * p)
    for _ in range(cg_iters):
        sp = yield from s_matvec(p)
        alpha = rz / guarded(torch.sum(p * sp))
        x = x + alpha * p
        r = r - alpha * sp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / guarded(rz)
        p = z + beta * p
        rz = rz_new
    x_c = gauge(x)

    # Back-substitute landmarks: y = V^-1 (b_l - W^T x)
    y_l = torch.einsum("lij,lj->li", V_inv,
                       b_l - (yield from wt_mul_camvec(x_c)))
    return x_c, y_l


def _prior_weight(cfg: BundleAdjustmentConfig) -> float:
    return (1.0 / cfg.position_prior_sigma_m**2
            if cfg.position_prior_sigma_m > 0 else 0.0)


def _cost(state: BAState, problem: BAProblem, cam: Camera,
            cfg: BundleAdjustmentConfig, trans_init: torch.Tensor):
    """The LM objective at ``state`` (a 0-dim tensor): the capped Huber of
    the reprojection error (its sum over the observations yielded, as in
    :func:`_schur_solve`) plus the position prior around ``trans_init``
    (over the replicated state: added after the sum)."""
    norm = torch.linalg.vector_norm(
        reprojection_residuals(state, problem, cam), dim=-1)
    # capped Huber: constant beyond the outlier gate, so gated
    # observations exert no force on the accept decision either
    norm = torch.clamp(norm, max=cfg.outlier_threshold_px)
    huber = torch.where(
        norm <= cfg.huber_delta,
        0.5 * norm**2,
        cfg.huber_delta * (norm - 0.5 * cfg.huber_delta),
    )
    prior = 0.5 * _prior_weight(cfg) * torch.sum(
        (state.trans - trans_init) ** 2)
    total = yield torch.sum(torch.where(problem.valid, huber, 0.0))
    return total + prior


def _bundle_adjust_impl(
    state: BAState,
    problem: BAProblem,
    cam: Camera,
    cfg: BundleAdjustmentConfig,
    n_cams: int,
    n_lms: int,
) -> BAState:
    """The LM loop: ``cfg.max_iterations`` steps, each accepted or rejected
    on the device. A generator over this device's observations (module
    docstring): drive it with :func:`_run_local` or
    ``collectives.run_psum_programs``."""
    trans_init = state.trans
    prior_weight = _prior_weight(cfg)
    segs_c = _segments(problem.cam_idx, n_cams)
    segs_l = _segments(problem.lm_idx, n_lms)

    def cost_of(st):
        return _cost(st, problem, cam, cfg, trans_init)

    st = state
    damping = torch.tensor(cfg.damping_init, dtype=torch.float32,
                           device=state.trans.device)
    cost = yield from cost_of(st)
    for _ in range(cfg.max_iterations):
        res, jc, jl = _obs_jacobians(st, problem, cam)
        w_obs = (
            _huber_weights(res, cfg.huber_delta, cfg.outlier_threshold_px)
            * problem.valid
        )
        dx_c, dx_l = yield from _schur_solve(
            res, jc, jl, w_obs, problem, segs_c, segs_l, damping,
            cfg.fix_first_pose,
            prior_weight=prior_weight,
            prior_residual_t=st.trans - trans_init,
            cg_iters=cfg.cg_iterations,
        )
        q2, t2 = _apply_cam_delta(st.quats, st.trans, dx_c)
        cand = BAState(quats=q2, trans=t2, landmarks=st.landmarks + dx_l)
        new_cost = yield from cost_of(cand)
        accept = new_cost < cost
        st = BAState(*(torch.where(accept, a, b) for a, b in zip(cand, st)))
        damping = torch.where(accept, damping / cfg.damping_factor,
                              damping * cfg.damping_factor)
        damping = torch.clamp(damping, 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return st


def _run_local(program):
    """Drive a program of :func:`_bundle_adjust_impl` on one device: every
    partial sum is already the total."""
    try:
        value = next(program)
        while True:
            value = program.send(value)
    except StopIteration as stop:
        return stop.value


def _to_device(state: BAState, problem: BAProblem, dev: torch.device):
    """The state (float32) and problem (int64 indices, float32 pixels, bool
    mask) as tensors on ``dev``; numpy arrays are taken too."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def idx(x):
        return torch.as_tensor(x, device=dev).long()

    return (
        BAState(*(f32(x) for x in state)),
        BAProblem(cam_idx=idx(problem.cam_idx), lm_idx=idx(problem.lm_idx),
                  uv=f32(problem.uv),
                  valid=torch.as_tensor(problem.valid, dtype=torch.bool,
                                        device=dev)),
    )


def bundle_adjust(
    state: BAState,
    problem: BAProblem,
    cam: Camera,
    cfg: BundleAdjustmentConfig = BundleAdjustmentConfig(),
    n_cams: int = None,
    n_lms: int = None,
    *,
    device=None,
) -> BAState:
    """Levenberg-Marquardt bundle adjustment; returns the refined state as
    float32 tensors on ``device`` (``None`` means CUDA; raises without it).

    ``cfg.max_iterations`` iterations, each recomputing the Jacobians,
    solving the damped Schur system and accepting or rejecting the step
    with the usual LM damping schedule, all on the device.
    """
    dev = resolve_device(device)
    state, problem = _to_device(state, problem, dev)
    n_cams = state.quats.shape[0] if n_cams is None else n_cams
    n_lms = state.landmarks.shape[0] if n_lms is None else n_lms
    return _run_local(
        _bundle_adjust_impl(state, problem, cam, cfg, n_cams, n_lms))


def sharded_bundle_adjust(state, problem, cam, cfg: BundleAdjustmentConfig,
                          mesh, axis_name: str = "obs") -> BAState:
    """Distributed BA over ``mesh`` (``parallel/mesh.py``): observations
    sharded across ``axis_name``, the camera and landmark state replicated,
    every Schur and cost reduction a ``psum`` over the shards' partial
    sums, added in shard order. Equal to :func:`bundle_adjust` up to the
    float summation order; two sharded runs are bit-equal. Returns the
    state as float32 tensors on this rank's first shard's device (the
    mesh's first device in one process); across processes every rank gets
    the same state.

    The observation count must be divisible by the axis size (pad with
    ``valid=False`` rows), or ``ValueError`` is raised, as in JAX.
    """
    n_dev = mesh.shape[axis_name]
    m = problem.cam_idx.shape[0]
    if m % n_dev != 0:
        raise ValueError(
            f"observation count {m} not divisible by {n_dev} devices; pad "
            "with valid=False"
        )
    home = mesh.home_device()
    state, problem = _to_device(state, problem, home)
    n_cams, n_lms = state.quats.shape[0], state.landmarks.shape[0]
    states = zip(*(cl.replicate(mesh, x) for x in state))
    problems = zip(*(cl.scatter(mesh, x, axis_name) for x in problem))
    programs = [
        _bundle_adjust_impl(BAState(*st), BAProblem(*pr), cam, cfg, n_cams,
                            n_lms)
        for st, pr in zip(states, problems)
    ]
    return cl.first_local(mesh,
                          cl.run_psum_programs(mesh, programs, axis_name))
