"""The port's feature pipeline (``aerial_mapper_tpu_torch/features``)
against the JAX package's on the same numpy inputs, on the CPU.

The views are ``tests/test_features.py``'s 320x240 renders of its
synthetic scene (the JAX synth, handed to the port as numpy). Tolerances:

- ``detect_corners``: the score maps come from the box filter's float
  cumsums, which XLA and PyTorch round differently (ROADMAP §3), so the
  scores agree to rtol 1e-4, not bit for bit. Two corners whose scores lie
  within that tolerance may trade places in the list; so the valid corners
  (score > 0) must agree as sets on >= 99 %, and in the same order wherever
  the scores differ by more than the tolerance. On an image whose sums are
  exact (a checkerboard of small integers) every score is tied with many
  others, and the list must equal JAX's exactly: ties go to the lowest
  flat index, as ``lax.top_k`` orders them;
- ``describe_patches`` from the same corners: atol 1e-5;
- ``match_descriptors`` fed JAX's descriptors: indices and mask exactly
  equal, ties included (first maximum);
- ``epipolar_gate``: equal except for pairs within 1e-3 px of the
  threshold;
- ``build_tracks``: exactly equal;
- ``triangulate_tracks``: each landmark within 1e-3 m plus twice the
  float32 forward-error bound of its 3x3 solve, ``cond(A) * 2^-24 * |x|``
  (cond(A) from A in float64), of JAX's, and of a float64 solve of the
  same rays. Near-parallel rays make the normal matrices ill-conditioned
  (cond up to ~2e3 here): JAX's own float32 answer lies up to 0.03 m from
  the float64 one, and on bit-identical A and b ``jnp.linalg.solve`` (LU
  plus XLA's triangular solves) and ``torch.linalg.solve`` (LAPACK gesv)
  differ by up to 0.014 m, so 1e-3 m alone holds only where A is
  well-conditioned;
- ``refine_poses``: the same tracks and matches as JAX, the poses within
  ``tests/test_ba.py``'s sharded-vs-single bar (5e-3 m, 1e-4), and the
  port's ATE below half the noisy one (``tests/test_features.py``'s bar).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aerial_mapper_tpu.config import BundleAdjustmentConfig as JCfg
from aerial_mapper_tpu.features import build_tracks as jax_build_tracks
from aerial_mapper_tpu.features import describe_patches as jax_describe
from aerial_mapper_tpu.features import detect_corners as jax_detect
from aerial_mapper_tpu.features import match_descriptors as jax_match
from aerial_mapper_tpu.features import refine_poses as jax_refine
from aerial_mapper_tpu.features import (
    refine_poses_windowed as jax_refine_windowed,
)
from aerial_mapper_tpu.features import triangulate_tracks as jax_triangulate
from aerial_mapper_tpu.features.match import epipolar_gate as jax_gate
from aerial_mapper_tpu.geo.se3 import matrix_to_quat
from aerial_mapper_tpu_torch.camera.models import Camera
from aerial_mapper_tpu_torch.config import BundleAdjustmentConfig
from aerial_mapper_tpu_torch.features import (
    build_tracks,
    describe_patches,
    detect_corners,
    match_descriptors,
    refine_poses,
    refine_poses_windowed,
    triangulate_tracks,
)
from aerial_mapper_tpu_torch.features.match import epipolar_gate
from test_features import CAM, render_views

torch.set_num_threads(2)

TCAM = Camera(*CAM)
RTOL_SCORE = 1e-4


@pytest.fixture(scope="module")
def views():
    """8 views 6 m apart: (Rs, ts, images as numpy)."""
    Rs, ts, images = render_views(8, spacing=6.0)
    return Rs, ts, [np.asarray(im) for im in images]


def t(x):
    return torch.as_tensor(np.asarray(x))


def jax_features(images, k=256):
    """JAX's (uv, score, descriptors) of each image, as numpy."""
    out = []
    for im in images:
        uv, s = jax_detect(jnp.asarray(im), num_corners=k)
        out.append((np.asarray(uv), np.asarray(s),
                    np.asarray(jax_describe(jnp.asarray(im), uv))))
    return out


@pytest.mark.parametrize("k", [256, 512])
def test_detect_corners_matches_jax(views, k):
    for im in views[2][:3]:
        uj, sj = (np.asarray(x) for x in jax_detect(jnp.asarray(im),
                                                    num_corners=k))
        ut, st = (x.numpy() for x in detect_corners(t(im), num_corners=k))
        assert ut.shape == uj.shape == (k, 2) and st.shape == (k,)
        np.testing.assert_allclose(st, sj, rtol=RTOL_SCORE, atol=0)
        valid_j = {tuple(p) for p in uj[sj > 0]}
        valid_t = {tuple(p) for p in ut[st > 0]}
        assert len(valid_j & valid_t) >= 0.99 * len(valid_j)
        # a slot may differ only where its two scores are within the
        # tolerance of each other (a near-tie traded places)
        moved = (uj != ut).any(axis=1)
        np.testing.assert_allclose(st[moved], sj[moved], rtol=RTOL_SCORE)


def test_detect_corners_ties_in_jax_order():
    """A checkerboard of small integers: every sum is exact in both
    packages, every checker corner scores the same, and non-max
    suppression keeps plateaus, so the list is decided by the tie order
    alone."""
    yy, xx = np.mgrid[0:120, 0:160]
    image = (((yy // 10) + (xx // 10)) % 2 * 8.0).astype(np.float32)
    image[50:70, 70:90] = 3.0  # a second score level
    uj, sj = (np.asarray(x) for x in jax_detect(jnp.asarray(image),
                                                num_corners=300))
    ut, st = (x.numpy() for x in detect_corners(t(image), num_corners=300))
    assert len(np.unique(sj)) < 10  # ties everywhere
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(ut, uj)


def test_describe_patches_matches_jax(views):
    im = views[2][0]
    uv, _s = jax_detect(jnp.asarray(im), num_corners=256)
    want = np.asarray(jax_describe(jnp.asarray(im), uv))
    got = describe_patches(t(im), t(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ratio", [1.0, 0.9])
def test_match_descriptors_matches_jax(views, ratio):
    (_u1, s1, d1), (_u2, s2, d2) = jax_features(views[2][:2])
    # JAX's jitted match_descriptors traces ``ratio``, so its Python
    # ``if ratio < 1.0`` raises unless the argument is left out: its
    # function runs eagerly here (ROADMAP §3)
    idx_j, m_j = jax_match.__wrapped__(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(s1 > 0),
        jnp.asarray(s2 > 0), ratio=ratio)
    idx_t, m_t = match_descriptors(t(d1), t(d2), t(s1 > 0), t(s2 > 0),
                                   ratio=ratio)
    # the ratio test keeps few matches on this repetitive texture
    assert int(m_t.sum()) > (40 if ratio == 1.0 else 0)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_match_descriptors_ties_go_to_the_first():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(6, 16)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d1 = d[[0, 1, 2, 2, 3, 4]]  # rows 2 and 3 tie in every column
    d2 = d[[5, 2, 1, 1, 0, 3]]  # columns 2 and 3 tie in every row
    v = np.ones(6, bool)
    idx_j, m_j = jax_match(jnp.asarray(d1), jnp.asarray(d2),
                           jnp.asarray(v), jnp.asarray(v))
    idx_t, m_t = match_descriptors(t(d1), t(d2), t(v), t(v))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert int(idx_t[1]) == 2 and bool(m_t[1])  # first of the tied pair
    assert not bool(m_t[3])  # the second tied row is no mutual match


@pytest.mark.parametrize("lens", ["pinhole", "radtan"])
def test_epipolar_gate_matches_jax(views, lens):
    """Matched corners of two views under noisy poses: the gate equals
    JAX's except for pairs that JAX itself decides differently 1e-3 px
    either side of the threshold."""
    Rs, ts, images = views
    (u1, s1, d1), (u2, s2, d2) = jax_features(images[:2])
    idx, _m = jax_match(jnp.asarray(d1), jnp.asarray(d2),
                        jnp.asarray(s1 > 0), jnp.asarray(s2 > 0))
    uv2 = u2[np.asarray(idx)]
    rng = np.random.default_rng(3)
    t1 = ts[0] + rng.normal(scale=0.3, size=3)
    t2 = ts[1] + rng.normal(scale=0.3, size=3)
    jcam = CAM if lens == "pinhole" else CAM._replace(
        dist_kind="radial-tangential", dist_params=(-0.2, 0.05, 1e-4, -1e-4))
    f32 = np.float32
    args = (Rs[0].astype(f32), t1.astype(f32), Rs[1].astype(f32),
            t2.astype(f32), CAM.fx, CAM.fy, CAM.cx, CAM.cy)

    def jg(th):
        return np.asarray(jax_gate(jnp.asarray(u1), jnp.asarray(uv2),
                                   *(jnp.asarray(a) for a in args[:4]),
                                   *args[4:], threshold_px=th, cam=jcam))

    got = epipolar_gate(t(u1), t(uv2), *(t(a) for a in args[:4]),
                        *args[4:], threshold_px=3.0,
                        cam=Camera(*jcam)).numpy()
    want = jg(3.0)
    decided = jg(3.0 - 1e-3) == jg(3.0 + 1e-3)
    assert 0.1 < want.mean() < 0.99  # the gate cuts on both sides
    np.testing.assert_array_equal(got[decided], want[decided])


def pair_matches(feats, pairs):
    out = []
    for i, j in pairs:
        idx, m = jax_match(*(jnp.asarray(x) for x in (
            feats[i][2], feats[j][2], feats[i][1] > 0, feats[j][1] > 0)))
        ii = np.nonzero(np.asarray(m))[0]
        out.append((i, j, ii, np.asarray(idx)[ii]))
    return out


def test_build_tracks_and_triangulate_match_jax(views):
    Rs, ts, images = views
    feats = jax_features(images[:3])
    matches = pair_matches(feats, [(0, 1), (1, 2), (0, 2)])
    kps = [f[0] for f in feats]
    (pj, nj) = jax_build_tracks(matches, kps, min_track_length=2)
    (pt, nt) = build_tracks(matches, kps, min_track_length=2, device="cpu")
    assert nj == nt > 30
    m = pj.cam_idx.shape[0]
    pad_j, _ = jax_build_tracks(matches, kps, max_observations=m + 37)
    pad_t, _ = build_tracks(matches, kps, max_observations=m + 37,
                            device="cpu")
    for a, b in ((pj, pt), (pad_j, pad_t)):
        for name, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x),
                                          err_msg=name)
    with pytest.raises(ValueError, match="max_observations"):
        build_tracks(matches, kps, max_observations=m - 1, device="cpu")

    quats = np.asarray(matrix_to_quat(jnp.asarray(Rs[:3], jnp.float32)))
    ts32 = np.asarray(ts[:3], np.float32)
    want = np.asarray(jax_triangulate(pad_j, jnp.asarray(quats),
                                      jnp.asarray(ts32), nj + 5, CAM.fx,
                                      CAM.fy, CAM.cx, CAM.cy))
    got = triangulate_tracks(pad_t, t(quats), t(ts32), nj + 5, CAM.fx,
                             CAM.fy, CAM.cx, CAM.cy).numpy()
    A64, x64 = normal_equations_f64(pad_j, quats, ts32, nj + 5)
    tol = 1e-3 + 2.0 * np.linalg.cond(A64) * 2.0**-24 * np.linalg.norm(
        x64, axis=-1)
    assert (np.linalg.norm(got - want, axis=-1) <= tol).all()
    assert (np.linalg.norm(got - x64, axis=-1) <= tol).all()
    assert (np.linalg.norm(want - x64, axis=-1) <= tol).all()


def normal_equations_f64(problem, quats, trans, n_lms):
    """The triangulation's normal matrices [L, 3, 3] (regularized as the
    packages do) and their solutions [L, 3], in float64 from the same
    rays."""
    from aerial_mapper_tpu.io.poses import _rot_matrix_np

    uv = np.asarray(problem.uv, np.float64)
    cam_idx, lm_idx = np.asarray(problem.cam_idx), np.asarray(problem.lm_idx)
    valid = np.asarray(problem.valid)
    d = np.stack([(uv[:, 0] - CAM.cx) / CAM.fx, (uv[:, 1] - CAM.cy) / CAM.fy,
                  np.ones(len(uv))], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    R = np.stack([_rot_matrix_np(q) for q in np.asarray(quats, np.float64)])
    d = np.einsum("mij,mj->mi", R[cam_idx], d)
    P = (np.eye(3)[None] - d[:, :, None] * d[:, None, :]) \
        * valid[:, None, None]
    A = np.zeros((n_lms, 3, 3))
    b = np.zeros((n_lms, 3))
    np.add.at(A, lm_idx, P)
    np.add.at(b, lm_idx, np.einsum("mij,mj->mi", P,
                                   np.asarray(trans, np.float64)[cam_idx]))
    A += 1e-6 * np.eye(3)
    return A, np.linalg.solve(A, b[..., None])[..., 0]


def ate(a, b):
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def noisy(ts, seed=42):
    out = ts.copy()
    out[1:] += np.random.default_rng(seed).normal(scale=0.4,
                                                  size=(len(ts) - 1, 3))
    return out


def test_refine_poses_matches_jax(views):
    Rs, ts, images = views
    Rs, ts, images = Rs[:6], ts[:6], images[:6]
    quats = np.asarray(matrix_to_quat(jnp.asarray(Rs)))
    ts_noisy = noisy(ts)
    cfg = dict(max_iterations=10, position_prior_sigma_m=5.0)
    qj, tj, sj = jax_refine([jnp.asarray(im) for im in images], quats,
                            ts_noisy, CAM, ba_cfg=JCfg(**cfg))
    qt, tt, st = refine_poses(images, quats, ts_noisy, TCAM,
                              ba_cfg=BundleAdjustmentConfig(**cfg),
                              device="cpu")
    assert st == sj and st["tracks"] > 30
    assert qt.dtype == tt.dtype == np.float64
    np.testing.assert_allclose(tt, tj, atol=5e-3, rtol=0)
    np.testing.assert_allclose(qt, qj, atol=1e-4, rtol=0)
    assert ate(tt, ts) < ate(ts_noisy, ts) / 2


def test_refine_poses_windowed_matches_jax(views):
    """8 views in windows of 5 overlapping by 2: two windows, the second
    starting from the first one's refined overlap."""
    Rs, ts, images = views
    quats = np.asarray(matrix_to_quat(jnp.asarray(Rs)))
    ts_noisy = noisy(ts, seed=7)
    kw = dict(window_size=5, overlap=2, num_corners=256)
    qj, tj, sj = jax_refine_windowed([jnp.asarray(im) for im in images],
                                     quats, ts_noisy, CAM, **kw)
    qt, tt, st = refine_poses_windowed(images, quats, ts_noisy, TCAM,
                                       device="cpu", **kw)
    assert st == sj and st["windows"] == 2
    np.testing.assert_allclose(tt, tj, atol=5e-3, rtol=0)
    np.testing.assert_allclose(qt, qj, atol=1e-4, rtol=0)
    assert ate(tt, ts) < ate(ts_noisy, ts) / 2


def test_refine_poses_with_few_tracks_returns_the_input(views):
    Rs, ts, images = views
    quats = np.asarray(matrix_to_quat(jnp.asarray(Rs[:2])))
    blank = [np.zeros_like(images[0])] * 2
    q, tr, stats = refine_poses(blank, quats, ts[:2], TCAM, device="cpu")
    assert q is quats and tr is ts[:2] or np.array_equal(tr, ts[:2])
    assert stats == {"tracks": 0, "matches": 0}


@pytest.mark.parametrize("fn", ["refine_poses", "refine_poses_windowed",
                                "build_tracks"])
def test_entry_points_need_cuda_unless_cpu_is_asked(views, fn):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    Rs, ts, images = views
    quats = np.asarray(matrix_to_quat(jnp.asarray(Rs[:2])))
    call = {
        "refine_poses": lambda: refine_poses(images[:2], quats, ts[:2],
                                             TCAM),
        "refine_poses_windowed": lambda: refine_poses_windowed(
            images[:2], quats, ts[:2], TCAM),
        "build_tracks": lambda: build_tracks([], [], min_track_length=2),
    }[fn]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
