"""The port's ``native.py`` (ctypes bindings to the C++ reference loops of
``native/reference_baseline.cc``) against the JAX package's, and the port's
two rasterizers against those loops on the CPU: the plain binned IDW in the
overflow regime at the bars of ``tests/test_dsm_idw.py:171-199`` (hit masks
equal, max |err| < 0.15 m, RMSE < 0.06 m at capacity 32), and the backward
grid with the plain score pass at >= 99.9 % agreement within 2 gray over
the cells both texture (``bench.py``'s measure), <= 0.1 % textured by one
side only. Where no C++ compiler builds the library these tests skip, as
the JAX package's native tests do."""

import numpy as np
import pytest
import torch

from aerial_mapper_tpu import native as jnative
from aerial_mapper_tpu_torch import native as tnative
from aerial_mapper_tpu_torch.camera.models import Camera
from aerial_mapper_tpu_torch.config import OrthoBackwardGridConfig
from aerial_mapper_tpu_torch.dsm.idw import idw_to_grid
from aerial_mapper_tpu_torch.geo.se3 import matrix_to_quat
from aerial_mapper_tpu_torch.mapgrid.grid import (
    MapGeometry,
    cell_centers,
    create_map_state,
)
from aerial_mapper_tpu_torch.ortho.backward_grid import backward_grid_update
from aerial_mapper_tpu_torch.synth.scene import (
    SyntheticScene,
    make_survey_poses,
    render_image,
)

torch.set_num_threads(2)

THREADS = 2


@pytest.fixture()
def native():
    if tnative.load_native() is None or jnative.load_native() is None:
        pytest.skip("native baseline library unavailable (no C++ compiler)")


def _bg_inputs(rng, m=300, n=5, h=12, w=16):
    cells = np.concatenate([rng.uniform(-30, 30, (m, 2)),
                            rng.uniform(400, 420, (m, 1))], axis=1)
    cells[:4, 2] = np.nan  # skipped like an invalid projection
    R_cw = np.stack([np.diag([1.0, -1.0, -1.0])] * n) \
        + rng.normal(0, 0.02, (n, 3, 3))
    t = np.concatenate([rng.uniform(-20, 20, (n, 2)),
                        np.full((n, 1), 500.0)], axis=1)
    images = rng.uniform(0, 255, (n, h, w)).astype(np.float32)
    return cells, R_cw, t, images, 20.0, 21.0, w / 2.0, h / 2.0


def test_backward_grid_cpu_equals_jax(native):
    args = _bg_inputs(np.random.default_rng(0))
    got = tnative.backward_grid_cpu(*args, num_threads=THREADS)
    want = jnative.backward_grid_cpu(*args, num_threads=THREADS)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    ortho, angle, obs = got
    assert (obs >= 0).any() and (obs[:4] == -1).all()
    assert (ortho[obs < 0] == 255.0).all() and (angle[obs < 0] == 0.0).all()


@pytest.mark.parametrize("adaptive", [True, False])
def test_dsm_idw_cpu_equals_jax(native, adaptive):
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-4, 4, (500, 2)),
                          rng.uniform(400, 410, (500, 1))], axis=1)
    qx = rng.uniform(-6, 6, 200)
    qy = rng.uniform(-6, 6, 200)
    kw = dict(radius_sq=0.3, adaptive=adaptive, growth=1.1,
              max_radius_sq=7.0)
    got = tnative.dsm_idw_cpu(pts, qx, qy, num_threads=THREADS, **kw)
    want = jnative.dsm_idw_cpu(pts, qx, qy, num_threads=THREADS, **kw)
    assert got[1].dtype == bool and got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].any() and not got[1].all()


def test_native_rejects_mismatched_shapes(native):
    cells, R_cw, t, images, *intr = _bg_inputs(np.random.default_rng(2))
    with pytest.raises(ValueError):
        tnative.backward_grid_cpu(cells, R_cw[:-1], t, images, *intr)
    with pytest.raises(ValueError):
        tnative.dsm_idw_cpu(cells, cells[:, 0], cells[:-1, 1], 1.0, True,
                            1.1, 7.0)
    assert tnative.hardware_threads() >= 1


def test_build_runs_the_baseline_target_only(tmp_path, monkeypatch):
    """The library is built with its own make target, so the build does
    not need the image loader's libjpeg / libpng; a failed build returns
    None (as JAX's does)."""
    runs = []

    def fake_run(cmd, **kw):
        runs.append(cmd)
        raise tnative.subprocess.CalledProcessError(2, cmd)

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_LIB_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr(tnative.subprocess, "run", fake_run)
    assert tnative.load_native() is None
    assert runs == [["make", "-C", tnative._NATIVE_DIR, "libambaseline.so"]]
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.dsm_idw_cpu(np.zeros((1, 3)), np.zeros(1), np.zeros(1), 1.0,
                            True, 1.1, 7.0)


def _overflow_workload(rng, pts_per_cell=70):
    """``tests/test_dsm_idw.py::_overflow_workload``: ~70 points per 0.5 m
    cell, a smooth field plus noise."""
    geom = MapGeometry(center_easting=0.0, center_northing=0.0,
                       resolution=0.5, height=24, width=20)
    n = pts_per_cell * geom.height * geom.width
    e = rng.uniform(-5.5, 5.5, n)
    nn = rng.uniform(-6.5, 6.5, n)
    z = (410.0 + 3.0 * np.sin(0.8 * e) + 2.0 * np.cos(0.5 * nn)
         + rng.normal(0.0, 0.15, n))
    return geom, np.stack([e, nn], axis=1), z


def test_plain_idw_overflow_vs_native(native, rng):
    geom, pts, z = _overflow_workload(rng)
    ce, cn = cell_centers(geom, device="cpu")
    kw = dict(radius_sq=2.0, adaptive=True, growth=1.1, max_radius_sq=7.0)
    ref_vals, ref_hit = tnative.dsm_idw_cpu(
        np.concatenate([pts, z[:, None]], axis=1),
        ce.double().numpy().ravel(), cn.double().numpy().ravel(),
        num_threads=THREADS, **kw)
    vals, hit = idw_to_grid(
        torch.as_tensor(pts, dtype=torch.float32),
        torch.as_tensor(z, dtype=torch.float32),
        torch.ones(pts.shape[0], dtype=torch.bool), geom, 32, **kw)
    v, h = vals.numpy().ravel(), hit.numpy().ravel()
    np.testing.assert_array_equal(h, ref_hit)
    err = np.abs(v[h] - ref_vals[ref_hit])
    assert err.max() < 0.15 and np.sqrt((err ** 2).mean()) < 0.06


def test_plain_backward_grid_vs_native(native):
    """The analytic elevation under 9 jittered frames of a 160x120 camera:
    the port's backward grid (plain score pass) against the C++ loop."""
    cam = Camera(fx=160.0, fy=160.0, cx=80.0, cy=60.0, width=160,
                 height=120)
    scene = SyntheticScene(base_elevation=414.0, relief_amplitude=6.0)
    Rs, ts = make_survey_poses(9, altitude=514.0, spacing=6.0, num_lines=3,
                               line_spacing=8.0, start_easting=-6.0,
                               start_northing=-8.0, jitter=0.5, seed=3)
    images = torch.stack([render_image(scene, cam, R, t, device="cpu")
                          for R, t in zip(Rs, ts)])
    images = torch.clamp(torch.round(images), 0.0, 255.0)
    geom = MapGeometry(0.0, 0.0, 0.5, 80, 80)
    ce, cn = cell_centers(geom, device="cpu")
    layers = create_map_state(geom, device="cpu")
    layers["elevation"] = scene.height(ce, cn)
    out = backward_grid_update(
        layers, matrix_to_quat(torch.as_tensor(Rs, dtype=torch.float32)),
        torch.as_tensor(ts, dtype=torch.float32), images, geom, cam,
        OrthoBackwardGridConfig())
    cells = np.stack([ce.double().numpy().ravel(),
                      cn.double().numpy().ravel(),
                      layers["elevation"].double().numpy().ravel()], axis=1)
    o_cpu, _a, obs = tnative.backward_grid_cpu(
        cells, np.transpose(Rs, (0, 2, 1)), ts, images.numpy(), cam.fx,
        cam.fy, cam.cx, cam.cy, num_threads=THREADS)
    port_tex = np.isfinite(out["observation_index"].numpy().ravel())
    cpu_tex = obs >= 0
    both = port_tex & cpu_tex
    assert both.mean() > 0.9
    assert (port_tex != cpu_tex).mean() <= 1e-3
    ortho = out["ortho"].numpy().ravel()
    agree = np.abs(ortho[both] - o_cpu[both]) < 2.0
    assert agree.mean() >= 0.999
