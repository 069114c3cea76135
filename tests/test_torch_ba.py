"""The port's bundle adjustment (``aerial_mapper_tpu_torch/ba``) against
the JAX package's on the same numpy inputs, on the CPU.

The problems are ``tests/test_ba.py::build_problem`` (numpy-seeded survey
poses, landmarks and observations), handed to both packages as numpy
arrays. Tolerances:

- residuals atol 1e-4 px, Jacobians rtol 1e-4 / atol 1e-4 (float32
  arithmetic in another order: XLA contracts multiply-adds on the CPU);
- the solve: ``trans`` (and the landmarks) within atol 5e-3 m and
  ``quats`` within 1e-4 of JAX's, the bar JAX holds between its own
  sharded and single-device solves (``tests/test_ba.py:197-201``);
- the segment sums equal JAX's ``segment_sum`` bit for bit (each segment
  adds its rows in observation order, as XLA's CPU scatter does);
- recovery, outlier and gauge bars: JAX's own (``tests/test_ba.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aerial_mapper_tpu.ba import bundle_adjust as jax_bundle_adjust
from aerial_mapper_tpu.ba import reprojection_residuals as jax_residuals
from aerial_mapper_tpu.ba.bundle_adjust import _obs_jacobians as jax_jac
from aerial_mapper_tpu.config import BundleAdjustmentConfig as JCfg
from aerial_mapper_tpu_torch.ba import (
    BAProblem,
    BAState,
    bundle_adjust,
    reprojection_residuals,
    sharded_bundle_adjust,
)
from aerial_mapper_tpu_torch.ba.bundle_adjust import (
    _obs_jacobians,
    _segment_sum,
    _segments,
    _to_device,
)
from aerial_mapper_tpu_torch.camera.models import Camera
from aerial_mapper_tpu_torch.config import BundleAdjustmentConfig
from test_ba import CAM, ate, ate_aligned, build_problem

torch.set_num_threads(2)

CPU = torch.device("cpu")
LENSES = {
    "pinhole": ("none", (0.0, 0.0, 0.0, 0.0)),
    "radtan": ("radial-tangential", (-0.2, 0.05, 1e-4, -1e-4)),
    "equidistant": ("equidistant", (0.01, -0.005, 0.001, 0.0)),
}


def cameras(lens="pinhole"):
    kind, params = LENSES[lens]
    j = CAM._replace(dist_kind=kind, dist_params=params)
    return j, Camera(*j)


def port_inputs(state0, problem):
    """The JAX problem's arrays as numpy, then as CPU tensors."""
    state = BAState(*(np.array(x) for x in state0))
    prob = BAProblem(*(np.array(x) for x in problem))
    return state, prob, _to_device(state, prob, CPU)


def test_residuals_match_jax(rng):
    state0, problem, *_ = build_problem(rng, pix_noise=0.3)
    _s, _p, (st, pt) = port_inputs(state0, problem)
    want = np.asarray(jax_residuals(state0, problem, CAM))
    got = reprojection_residuals(st, pt, Camera(*CAM)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("lens", list(LENSES))
def test_obs_jacobians_match_jax(rng, lens):
    state0, problem, *_ = build_problem(rng, pix_noise=0.3)
    jcam, tcam = cameras(lens)
    _s, _p, (st, pt) = port_inputs(state0, problem)
    want = jax_jac(state0, problem, jcam)
    got = _obs_jacobians(st, pt, tcam)
    for name, a, b in zip(("res", "jc", "jl"), want, got):
        assert b.dtype == torch.float32, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_segment_sum_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, 5000)
    scale = 10.0 ** rng.uniform(-3, 3, (5000, 1, 1))
    data = (rng.normal(size=(5000, 3, 3)) * scale).astype(np.float32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data),
                                          jnp.asarray(ids), num_segments=60))
    got = _segment_sum(torch.as_tensor(data),
                       _segments(torch.as_tensor(ids), 60)).numpy()
    np.testing.assert_array_equal(got, want)  # segments 50-59 empty: 0
    with pytest.raises(ValueError, match="segment index"):
        _segments(torch.as_tensor(ids), 49)


@pytest.mark.parametrize("lens", ["pinhole", "radtan"])
def test_bundle_adjust_matches_jax(rng, lens):
    state0, problem, _q, ts_true = build_problem(rng, pix_noise=0.3)
    jcam, tcam = cameras(lens)
    cfg = dict(max_iterations=8)
    want = jax_bundle_adjust(state0, problem, jcam, JCfg(**cfg))
    state, prob, _ = port_inputs(state0, problem)
    got = bundle_adjust(state, prob, tcam, BundleAdjustmentConfig(**cfg),
                        device="cpu")
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans),
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(got.quats.numpy(), np.asarray(want.quats),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.landmarks.numpy(),
                               np.asarray(want.landmarks), atol=5e-3, rtol=0)


def test_ba_recovers_perturbed_poses(rng):
    state0, problem, _q, ts_true = build_problem(rng)
    state, prob, (_st, pt) = port_inputs(state0, problem)
    ate0 = ate(state.trans, ts_true)
    assert ate0 > 0.3
    out = bundle_adjust(state, prob, Camera(*CAM),
                        BundleAdjustmentConfig(max_iterations=12),
                        device="cpu")
    ate1 = ate_aligned(out.trans.numpy(), ts_true)
    assert ate1 < ate_aligned(state.trans, ts_true) / 10
    assert ate1 < 0.05
    assert ate(out.trans.numpy(), ts_true) < ate0 / 2
    res = reprojection_residuals(out, pt, Camera(*CAM))
    assert float(torch.sqrt(torch.mean(res**2))) < 0.1


def test_ba_robust_to_outliers(rng):
    state0, problem, _q, ts_true = build_problem(rng, pix_noise=0.3,
                                                  outlier_frac=0.1)
    state, prob, (_st, pt) = port_inputs(state0, problem)
    ate0 = ate_aligned(state.trans, ts_true)
    out = bundle_adjust(state, prob, Camera(*CAM),
                        BundleAdjustmentConfig(max_iterations=15,
                                               huber_delta=2.0),
                        device="cpu")
    ate1 = ate_aligned(out.trans.numpy(), ts_true)
    assert ate1 < ate0 / 3, f"aligned ATE {ate0:.3f} -> {ate1:.3f}"
    assert ate(out.trans.numpy(), ts_true) < ate(state.trans, ts_true)
    norm = np.linalg.norm(
        reprojection_residuals(out, pt, Camera(*CAM)).numpy(), axis=1)
    assert 0.05 < (norm >= 20.0).mean() < 0.15
    assert float(np.sqrt(np.mean(norm[norm < 20.0] ** 2))) < 1.0


def test_ba_fixes_gauge(rng):
    state0, problem, *_ = build_problem(rng)
    state, prob, _ = port_inputs(state0, problem)
    out = bundle_adjust(state, prob, Camera(*CAM),
                        BundleAdjustmentConfig(max_iterations=5),
                        device="cpu")
    np.testing.assert_allclose(out.trans[0].numpy(), state.trans[0],
                               atol=1e-6)
    np.testing.assert_allclose(out.quats[0].numpy(), state.quats[0],
                               atol=1e-6)


def test_ba_converges_at_survey_scale(rng):
    """JAX's block-Jacobi PCG regression bar (``tests/test_ba.py``): 40
    cameras, 0.5 px noise, the noise floor reached."""
    state0, problem, _q, ts_true = build_problem(
        rng, n_cams=40, n_lms=800, pos_noise=1.0, rot_noise=0.005,
        pix_noise=0.5)
    state, prob, (_st, pt) = port_inputs(state0, problem)
    out = bundle_adjust(state, prob, Camera(*CAM),
                        BundleAdjustmentConfig(max_iterations=25,
                                               huber_delta=2.0,
                                               position_prior_sigma_m=3.0),
                        device="cpu")
    r = np.linalg.norm(
        reprojection_residuals(out, pt, Camera(*CAM)).numpy(), axis=-1)
    assert np.median(r) < 0.8, np.median(r)
    assert np.percentile(r, 99) < 3.0, np.percentile(r, 99)
    assert ate_aligned(out.trans.numpy(), ts_true) < 0.35


def test_ba_runs_bit_equal_twice(rng):
    state0, problem, *_ = build_problem(rng, pix_noise=0.3)
    state, prob, _ = port_inputs(state0, problem)
    cfg = BundleAdjustmentConfig(max_iterations=3)
    a = bundle_adjust(state, prob, Camera(*CAM), cfg, device="cpu")
    b = bundle_adjust(state, prob, Camera(*CAM), cfg, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sharded_bundle_adjust_is_item_8(rng):
    state0, problem, *_ = build_problem(rng)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        sharded_bundle_adjust(state0, problem, Camera(*CAM),
                              BundleAdjustmentConfig(), None)


def test_bundle_adjust_needs_cuda_unless_cpu_is_asked(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    state0, problem, *_ = build_problem(rng)
    state, prob, _ = port_inputs(state0, problem)
    with pytest.raises(RuntimeError, match="CUDA"):
        bundle_adjust(state, prob, Camera(*CAM))
