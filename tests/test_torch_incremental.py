"""The port's incremental driver (``pipeline/incremental.py::run_incremental``)
vs the JAX driver on the CPU.

Synthetic frames (9 frames of 64x48 from the JAX synth, rendered once and
fed to both drivers as the same numpy arrays), ``update_every_nth=2``, 16
disparities, a 32x32 map at 1 m. JAX runs its default "xla" switches on one
device (``auto_shard=False``); the port runs "xla" or "pallas" switches
(the plain versions of its kernels on the CPU). Final layers are held to the
observed-cell bars of ``tests/test_torch_step.py``.
"""

import dataclasses as dc
import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_mapper_tpu import config as jc
from aerial_mapper_tpu.camera.models import Camera as JCam
from aerial_mapper_tpu.camera.rig import CameraRig as JRig
from aerial_mapper_tpu.geo.se3 import matrix_to_quat
from aerial_mapper_tpu.io.poses import _quat_from_matrix_np
from aerial_mapper_tpu.pipeline.dataset import Dataset as JDataset
from aerial_mapper_tpu.pipeline.incremental import (
    run_incremental as jax_run_incremental,
)
from aerial_mapper_tpu.stereo.batched import (
    disparity_range_from_slab as jax_disparity_range,
)
from aerial_mapper_tpu.synth.scene import (
    SyntheticScene,
    make_survey_poses,
    render_image,
)
from aerial_mapper_tpu_torch import config as tc
from aerial_mapper_tpu_torch.camera.models import Camera as TCam
from aerial_mapper_tpu_torch.camera.rig import CameraRig as TRig
from aerial_mapper_tpu_torch.io.artifacts import load_layers, save_layers
from aerial_mapper_tpu_torch.pipeline.dataset import Dataset as TDataset
from aerial_mapper_tpu_torch.pipeline.incremental import run_incremental
from aerial_mapper_tpu_torch.stereo.batched import disparity_range_from_slab

torch.set_num_threads(2)

CAM = JCam(fx=64.0, fy=64.0, cx=32.0, cy=24.0, width=64, height=48)
SCENE = SyntheticScene(base_elevation=414.0, relief_amplitude=3.0)
N_FRAMES = 9
EVERY = 2
TILT_DEG = 15.0  # the second stream's camera, pitched about body x

_CLS = dict(grid="GridMapConfig", stereo="StereoConfig",
            bm="BlockMatchingConfig", sgm="SgmConfig", dsm="DsmConfig",
            ortho_backward="OrthoBackwardGridConfig")
_BASE = dict(
    grid=dict(center_easting=16.0, center_northing=0.0, delta_easting=32.0,
              delta_northing=32.0, resolution=1.0),
    stereo=dict(use_every_nth_image=1),
    bm=dict(num_disparities=16),
    sgm=dict(num_disparities=16),
    dsm=dict(interpolation_radius_sq=2.0),
    ortho_backward=dict(cell_chunk=256),
)
_PALLAS = dict(bm=dict(kernel="pallas"), sgm=dict(kernel="pallas"),
               dsm=dict(idw_kernel="pallas"),
               ortho_backward=dict(score_kernel="pallas"))


def _merge(a, b):
    return {k: {**a.get(k, {}), **b.get(k, {})} for k in set(a) | set(b)}


def configs(over=None, switches="xla"):
    """(JAX PipelineConfig on "xla" switches, port PipelineConfig on
    ``switches``) from the same field values."""
    kw = _merge(_BASE, over or {})
    jcfg = jc.PipelineConfig(auto_shard=False, **{
        k: getattr(jc, _CLS[k])(**v) for k, v in kw.items()})
    if switches == "pallas":
        kw = _merge(kw, _PALLAS)
    tcfg = tc.PipelineConfig(**{
        k: getattr(tc, _CLS[k])(**v) for k, v in kw.items()})
    return jcfg, tcfg


def _tilt():
    th = np.deg2rad(TILT_DEG)
    return np.array([[1.0, 0.0, 0.0],
                     [0.0, np.cos(th), -np.sin(th)],
                     [0.0, np.sin(th), np.cos(th)]])


_FRAMES = {}


def frames(color=False, stream=0):
    """The synthetic stream (rendered once per process): body poses and
    the frames of rig camera ``stream`` (0 nadir, 1 tilted)."""
    key = (color, stream)
    if key not in _FRAMES:
        Rs, ts = make_survey_poses(N_FRAMES, altitude=514.0, spacing=4.0)
        R_B_C = np.eye(3) if stream == 0 else _tilt()
        images = [
            np.asarray(render_image(SCENE, CAM,
                                    jnp.asarray(R @ R_B_C, jnp.float32),
                                    jnp.asarray(t, jnp.float32),
                                    color=color))
            for R, t in zip(Rs, ts)
        ]
        quats = np.asarray(matrix_to_quat(jnp.asarray(Rs)), np.float64)
        _FRAMES[key] = (quats, np.asarray(ts, np.float64), images)
    return _FRAMES[key]


def datasets(color=False, n_streams=1, n=N_FRAMES):
    """(JAX datasets, port datasets) over the same numpy fields."""
    rots = [np.eye(3), _tilt()][:n_streams]
    quats_cb = np.stack([_quat_from_matrix_np(R.T) for R in rots])
    jrig = JRig(cameras=(CAM,) * n_streams, T_C_B_quats=quats_cb,
                T_C_B_trans=np.zeros((n_streams, 3)))
    trig = TRig(cameras=(TCam(*CAM),) * n_streams, T_C_B_quats=quats_cb,
                T_C_B_trans=np.zeros((n_streams, 3)))
    jds, tds = [], []
    for s in range(n_streams):
        quats, ts, images = frames(color, s)
        jds.append(JDataset(rig=jrig.select(s), quats_G_B=quats[:n],
                            trans_G_B=ts[:n], images=images[:n]))
        tds.append(TDataset(rig=trig.select(s), quats_G_B=quats[:n],
                            trans_G_B=ts[:n], images=images[:n]))
    return jds, tds


def run_both(jcfg, tcfg, color=False, n_streams=1, **kw):
    jds, tds = datasets(color, n_streams)
    multi = n_streams > 1
    ref, _ = jax_run_incremental(jds[0], jcfg, update_every_nth=EVERY,
                                 datasets=jds if multi else None, **kw)
    out, _ = run_incremental(tds[0], tcfg, update_every_nth=EVERY,
                             datasets=tds if multi else None, device="cpu",
                             **kw)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    assert set(out) == set(ref)
    return ref, out


def assert_layers_close(ref, out, target="ortho"):
    """``tests/test_torch_step.py:75-93``'s bars on the final layers."""
    elev_a, elev_b = ref["elevation"], out["elevation"]
    fin_a, fin_b = np.isfinite(elev_a), np.isfinite(elev_b)
    union = fin_a | fin_b
    if union.any():
        assert (fin_a & fin_b).sum() / union.sum() > 0.995
        both = fin_a & fin_b
        assert (np.abs(elev_a[both] - elev_b[both]) < 0.01).mean() > 0.995

    obs = (ref["observation_index"] >= 0) | (out["observation_index"] >= 0)
    assert obs.sum() > 0
    for key in (target, "observation_index"):
        a, b = ref[key][obs], out[key][obs]
        if key == "colored_ortho":  # packed RGB: compare the bits
            a, b = a.view(np.int32), b.view(np.int32)
        eq = (np.where(np.isnan(a), -1.0, a) == np.where(np.isnan(b), -1.0, b))
        assert eq.mean() > 0.995, key
    ang_a = np.nan_to_num(ref["elevation_angle"])
    ang_b = np.nan_to_num(out["elevation_angle"])
    assert (np.abs(ang_a - ang_b)[obs] < 1e-3).mean() > 0.995
    np.testing.assert_array_equal(out["num_observations"],
                                  ref["num_observations"])


def assert_bit_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert torch.equal(torch.isnan(x), torch.isnan(y)), k
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), k


# each case: (port switches, config overrides, color, streams)
CASES = {
    "bm_xla": ("xla", {}, False, 1),
    "bm_pallas": ("pallas", {}, False, 1),
    "sgm": ("pallas", dict(stereo=dict(matcher="sgm")), False, 1),
    "flat_plane": ("pallas", dict(ortho_backward=dict(
        use_digital_elevation_map=False, orthomosaic_elevation_m=414.0)),
        False, 1),
    "colored": ("pallas", dict(ortho_backward=dict(colored_ortho=True)),
                True, 1),
    # the "pallas" BM has no LR check: its acceptance set differs from the
    # JAX "xla" matcher's (bm_pallas above holds that pair to the bars)
    "two_streams": ("xla", dict(grid=dict(delta_northing=96.0)),
                    False, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_incremental_matches_jax(case):
    switches, over, color, n_streams = CASES[case]
    jcfg, tcfg = configs(over, switches)
    ref, out = run_both(jcfg, tcfg, color=color, n_streams=n_streams)
    assert_layers_close(ref, out,
                        "colored_ortho" if color else "ortho")
    if n_streams == 2:
        # stream 1 wins cells, under its global ids (s * n_frames + j)
        ids = out["observation_index"]
        assert (ids[np.isfinite(ids)] >= N_FRAMES).any()


@pytest.mark.parametrize("n_streams", [1, 2])
def test_resume_at_update_boundary_is_bit_equal(tmp_path, n_streams):
    """The map after the update at frame 3, saved through io/artifacts,
    then the stream resumed at frame 4 == one uninterrupted run, bit for
    bit (one stream, and two synchronized streams with global ids)."""
    over = dict(grid=dict(delta_northing=96.0)) if n_streams == 2 else {}
    _jcfg, tcfg = configs(over, switches="pallas")
    _j, tds = datasets(n_streams=n_streams)
    path = str(tmp_path / "state.npz")

    def on_update(i, layers, geom):
        if i == 3:
            save_layers(path, layers, geom)

    def run(**kw):
        return run_incremental(tds[0], tcfg, update_every_nth=EVERY,
                               datasets=tds if n_streams > 1 else None,
                               device="cpu", **kw)

    full, geom = run(on_update=on_update)
    saved, geom2 = load_layers(path)
    assert geom2 == geom
    resumed, _ = run(initial_layers=saved, start_frame=4)
    assert_bit_equal(full, resumed)


def test_prestaged_equals_streaming_and_callbacks():
    """prestage_images changes no bit; on_update gets the device layers
    after every update, on_cloud one host readback per stereo update."""
    _jcfg, tcfg = configs(switches="pallas")
    _j, (ds,) = datasets()
    updates, clouds = [], []

    def on_update(i, layers, geom):
        assert all(isinstance(v, torch.Tensor) for v in layers.values())
        updates.append(i)

    def on_cloud(i, pts, valid):
        assert isinstance(pts, np.ndarray) and pts.shape[1] == 3
        assert valid.dtype == bool and valid.shape == (pts.shape[0],)
        clouds.append(i)

    streamed, _ = run_incremental(ds, tcfg, update_every_nth=EVERY,
                                  on_update=on_update, on_cloud=on_cloud,
                                  device="cpu")
    prestaged, _ = run_incremental(ds, tcfg, update_every_nth=EVERY,
                                   prestage_images=True, device="cpu")
    assert_bit_equal(streamed, prestaged)
    assert updates == [1, 3, 5, 7]
    assert clouds == [3, 5, 7]


def _run_logged(fn, logger_name):
    records = []

    class _Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    lg = logging.getLogger(logger_name)
    h = _Catch()
    lg.addHandler(h)
    old = lg.level
    lg.setLevel(logging.INFO)
    try:
        out = fn()
    finally:
        lg.removeHandler(h)
        lg.setLevel(old)
    return out, records


def _window(records):
    for m in records:
        hit = re.search(r"disparities \[(\d+), (\d+)\)", m)
        if hit:
            return int(hit.group(1)), int(hit.group(2))
    return None


@pytest.mark.parametrize("envelope", [False, True])
def test_disparity_from_slab_matches_jax(envelope):
    """The same log messages as ``tests/test_stereo.py:561-630`` and, with
    the envelope, the same chosen window as JAX and the bars."""
    stereo = dict(disparity_from_slab=True)
    if envelope:
        stereo.update(z_min=404.0, z_max=424.0)
    jcfg, tcfg = configs(dict(stereo=stereo))
    jds, tds = datasets()
    ref, jrec = _run_logged(lambda: jax_run_incremental(
        jds[0], jcfg, update_every_nth=EVERY)[0], "aerial_mapper_tpu")
    out, trec = _run_logged(lambda: run_incremental(
        tds[0], tcfg, update_every_nth=EVERY, device="cpu")[0],
        "aerial_mapper_tpu_torch")
    if not envelope:
        for recs in (jrec, trec):
            assert any("ignored by the incremental driver" in m
                       for m in recs)
        assert _window(trec) is None
    else:
        for recs in (jrec, trec):
            assert any("incremental slab-bounded" in m for m in recs)
        assert _window(trec) == _window(jrec) is not None
    assert any("incremental: 4 map updates" in m for m in trec)
    assert_layers_close({k: np.asarray(v) for k, v in ref.items()},
                        {k: v.numpy() for k, v in out.items()})


def test_disparity_from_slab_colored_stream():
    """A colored stream bounds the search with the window of its gray twin
    in the port. The JAX driver reads (H, W) from the last two axes of the
    first frame, (W, 3) for an [H, W, 3] frame, so its window differs
    (a JAX-side fault, ROADMAP §3): at the bench camera pitched 25 degrees
    it searches 80 disparities where the frame needs 64."""
    from aerial_mapper_tpu.pipeline.incremental import (
        _maybe_bound_disparity_incremental as jax_bound,
    )
    from aerial_mapper_tpu_torch.pipeline.incremental import (
        _maybe_bound_disparity_incremental as port_bound,
    )

    stereo = dict(disparity_from_slab=True, z_min=400.0, z_max=426.0)
    jcfg, tcfg = configs(dict(stereo=stereo, bm=dict(num_disparities=80)))
    Rs, ts = make_survey_poses(21, altitude=514.0, spacing=200.0 / 124)
    th = np.deg2rad(25.0)
    pitch = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(th), -np.sin(th)],
                      [0.0, np.sin(th), np.cos(th)]])
    quats = np.stack([_quat_from_matrix_np(R @ pitch) for R in Rs])
    cam = JCam(fx=480.0, fy=480.0, cx=376.0, cy=240.0, width=752, height=480)
    rig = dict(cameras=(cam,), T_C_B_quats=np.array([[1.0, 0, 0, 0]]),
               T_C_B_trans=np.zeros((1, 3)))
    windows = {}
    for color in (False, True):
        frame = np.zeros((480, 752, 3) if color else (480, 752), np.float32)
        jds = JDataset(JRig(**rig), quats, ts, [frame] * 21)
        tds = TDataset(TRig(**{**rig, "cameras": (TCam(*cam),)}), quats, ts,
                       [frame] * 21)
        j, t = jax_bound(jcfg, [jds], 7), port_bound(tcfg, [tds], 7)
        windows[color] = ((j.bm.min_disparity, j.bm.num_disparities),
                          (t.bm.min_disparity, t.bm.num_disparities))
    (j_gray, t_gray), (j_color, t_color) = windows[False], windows[True]
    assert t_gray == j_gray == (24, 64)
    assert t_color == t_gray
    assert j_color == (24, 80)


@pytest.mark.parametrize("every,z", [(1, (404.0, 424.0)), (7, (398.0, 430.0)),
                                     (7, (200.0, 500.0))])
def test_disparity_range_from_slab_matches_jax(every, z):
    """The window helper against JAX at the bench geometry (752x480,
    fx 480, two flight lines: the turn pair is an outlier) and at a slab
    that reaches far below the terrain."""
    Rs, ts = make_survey_poses(249, altitude=514.0, spacing=200.0 / 124,
                               num_lines=2, line_spacing=60.0,
                               start_easting=-100.0, start_northing=-30.0)
    K = np.array([[480.0, 0, 376.0], [0, 480.0, 240.0], [0, 0, 1.0]])
    args = (K, Rs, ts, (480, 752), *z)
    got = disparity_range_from_slab(*args, use_every_nth=every)
    assert got == jax_disparity_range(*args, use_every_nth=every)
    assert all(isinstance(x, int) for x in got)


def test_disparity_range_from_slab_degenerate_raises():
    Rs, ts = make_survey_poses(4, altitude=514.0, spacing=6.0)
    for args in ((CAM.K, Rs, ts, (48, 64), 404.0, 600.0),
                 (CAM.K, Rs[:1], ts[:1], (48, 64), 404.0, 424.0)):
        with pytest.raises(ValueError):
            jax_disparity_range(*args)
        with pytest.raises(ValueError):
            disparity_range_from_slab(*args)


def _bad_initial():
    return dict(initial_layers={"elevation": np.zeros((5, 5), np.float32)})


ERRORS = {
    "plane_sweep": (dict(stereo=dict(densifier="plane_sweep")), {}, 1,
                    ValueError, "densifier"),
    "off_boundary": ({}, dict(start_frame=3), 1, ValueError, "multiple"),
    "unequal_streams": ({}, {}, "short", ValueError, "synchronized"),
    "other_trajectory": ({}, {}, "shifted", ValueError, "body"),
    "initial_shape": ({}, _bad_initial(), 1, ValueError, "initial_layers"),
    "undistortion": (dict(stereo=dict(images_need_undistortion=True)), {},
                     1, NotImplementedError, "ROADMAP item 5"),
    "sharded_check_every": ({}, dict(check_every=2), 1, NotImplementedError,
                            "check_every .*ROADMAP item 10"),
    "sharded_cull_images": ({}, dict(cull_images=False), 1,
                            NotImplementedError,
                            "cull_images .*ROADMAP item 10"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_run_incremental_errors(case):
    over, kw, streams, exc, match = ERRORS[case]
    _jcfg, tcfg = configs(over)
    _j, (ds,) = datasets()
    if streams == "short":
        other = dc.replace(ds, quats_G_B=ds.quats_G_B[:-1],
                           trans_G_B=ds.trans_G_B[:-1],
                           images=ds.images[:-1])
        kw = dict(datasets=[ds, other])
    elif streams == "shifted":
        kw = dict(datasets=[ds, dc.replace(ds, trans_G_B=ds.trans_G_B + 1)])
    with pytest.raises(exc, match=match):
        run_incremental(ds, tcfg, update_every_nth=EVERY, device="cpu", **kw)
