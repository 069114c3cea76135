"""The port's host loaders and dataset (``io/poses.py``, ``camera/rig.py``,
``io/images.py``, ``io/artifacts.py``, ``pipeline/dataset.py``) and
``backward_grid_update(..., image_ids=...)`` against their JAX twins, on
files written to ``tmp_path`` from seeded numpy arrays."""

import numpy as np
import pytest
import torch
from PIL import Image

from aerial_mapper_tpu.camera.models import Camera as JCam
from aerial_mapper_tpu.camera import rig as jrig
from aerial_mapper_tpu.config import OrthoBackwardGridConfig as JOrtho
from aerial_mapper_tpu.io import artifacts as jart
from aerial_mapper_tpu.io import images as jimg
from aerial_mapper_tpu.io import poses as jposes
from aerial_mapper_tpu.mapgrid.grid import MapGeometry as JGeom
from aerial_mapper_tpu.ortho.backward_grid import (
    backward_grid_update as jax_backward_grid_update,
)
from aerial_mapper_tpu.pipeline import dataset as jdata
from aerial_mapper_tpu_torch.camera import rig as trig
from aerial_mapper_tpu_torch.camera.models import Camera as TCam
from aerial_mapper_tpu_torch.config import OrthoBackwardGridConfig as TOrtho
from aerial_mapper_tpu_torch.image.color import (
    pack_rgb_to_float,
    rgb_to_gray,
    unpack_float_to_rgb,
)
from aerial_mapper_tpu_torch.io import artifacts as tart
from aerial_mapper_tpu_torch.io import images as timg
from aerial_mapper_tpu_torch.io import poses as tposes
from aerial_mapper_tpu_torch.mapgrid.grid import MapGeometry as TGeom
from aerial_mapper_tpu_torch.mapgrid.grid import create_map_state
from aerial_mapper_tpu_torch.ortho.backward_grid import backward_grid_update
from aerial_mapper_tpu_torch.pipeline import dataset as tdata
from aerial_mapper_tpu_torch.utils.timing import STAGE_LOG, StageTimer

torch.set_num_threads(2)


def random_quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q * np.where(q[:, :1] < 0, -1, 1)


def _write_poses(fmt, path, rng):
    quats = random_quats(rng, 6)
    trans = rng.uniform(-1e5, 1e5, size=(6, 3))
    if fmt == "standard":
        jposes.save_poses_standard(path, quats, trans)
        return
    with open(path, "w") as f:
        for i, (q, t) in enumerate(zip(quats, trans)):
            if fmt == "ros":
                if i == 0:
                    f.write("time,x,y,z,qx,qy,qz,qw\n")  # plain header
                f.write(f"{100 + i}, {t[0]}, {t[1]}, {t[2]}, {q[1]}, "
                        f"{q[2]}, {q[3]}, {q[0]}\n")
            elif fmt == "pix4d":
                om, ph, ka = rng.uniform(-30, 30, 3)
                f.write(f"img_{i}.jpg {t[0]} {t[1]} {t[2]} {om} {ph} {ka}\n")
            else:  # colmap: world->camera pose lines + observation lines
                R_cw = jposes._rot_matrix_np(q).T
                t_cw = -R_cw @ t
                f.write(f"{i + 1} {q[0]} {-q[1]} {-q[2]} {-q[3]} {t_cw[0]} "
                        f"{t_cw[1]} {t_cw[2]} 1 img_{5 - i:03d}.jpg\n")
                f.write("1.0 2.0 -1\n")


@pytest.mark.parametrize("fmt", ["standard", "ros", "pix4d", "colmap"])
def test_load_poses_matches_jax(tmp_path, rng, fmt):
    path = str(tmp_path / f"poses_{fmt}.txt")
    _write_poses(fmt, path, rng)
    pf = tposes.PoseFormat(fmt)
    q, t, meta = tposes.load_poses(path, pf)
    qj, tj, metaj = jposes.load_poses(path, jposes.PoseFormat(fmt))
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(t, tj)
    if metaj is None:
        assert meta is None
    elif isinstance(metaj, list):
        assert meta == metaj
    else:
        np.testing.assert_array_equal(meta, metaj)
    origin = (t[0, 0], t[0, 1], 0.0)
    np.testing.assert_array_equal(tposes.subtract_origin(t, origin),
                                  jposes.subtract_origin(tj, origin))


def test_pose_helpers_match_jax(tmp_path, rng):
    for q in random_quats(rng, 20):
        R = tposes._rot_matrix_np(q)
        np.testing.assert_array_equal(R, jposes._rot_matrix_np(q))
        np.testing.assert_array_equal(tposes._quat_from_matrix_np(R),
                                      jposes._quat_from_matrix_np(R))
    with pytest.raises(ValueError, match="Unknown pose format"):
        tposes.load_poses(str(tmp_path / "x"), "bogus")


def _rigs(dist=None):
    """(JAX rig, port rig) with two cameras and a non-trivial extrinsic."""
    kw = {} if dist is None else dict(dist_kind=dist[0], dist_params=dist[1])
    cams = [dict(fx=500.0, fy=480.0, cx=320.0, cy=240.0, width=640,
                 height=480, **kw),
            dict(fx=200.0, fy=200.0, cx=96.0, cy=60.0, width=192,
                 height=120)]
    q = np.array([[1.0, 0, 0, 0], jposes._quat_from_matrix_np(
        jposes._rot_matrix_np(np.array([0.9, 0.1, -0.3, 0.2])
                              / np.linalg.norm([0.9, 0.1, -0.3, 0.2])))])
    t = np.array([[0.1, -0.2, 0.05], [-0.5, 0.0, 0.3]])
    return (jrig.CameraRig(tuple(JCam(**c) for c in cams), q, t),
            trig.CameraRig(tuple(TCam(**c) for c in cams), q, t))


def _same_rig(a, b):
    assert [tuple(c) for c in a.cameras] == [tuple(c) for c in b.cameras]
    np.testing.assert_array_equal(a.T_C_B_quats, b.T_C_B_quats)
    np.testing.assert_array_equal(a.T_C_B_trans, b.T_C_B_trans)


@pytest.mark.parametrize("dist", [None, ("radial-tangential",
                                         (-0.28, 0.07, 1e-4, 2e-5)),
                                  ("equidistant", (0.1, -0.02, 0.0, 0.0))])
def test_camera_rig_load_save_select(tmp_path, dist):
    """Each package reads the YAML the other wrote into the same rig;
    select promotes a camera in both."""
    j, t = _rigs(dist)
    pj, pt = str(tmp_path / "j.yaml"), str(tmp_path / "t.yaml")
    jrig.save_camera_rig(j, pj)
    trig.save_camera_rig(t, pt)
    with open(pj) as f1, open(pt) as f2:
        assert f1.read() == f2.read()
    _same_rig(jrig.load_camera_rig(pt), trig.load_camera_rig(pj))
    _same_rig(jrig.load_camera_rig(pj).select(1),
              trig.load_camera_rig(pj).select(1))
    assert t.select(0) is t
    with pytest.raises(ValueError, match="out of range"):
        t.select(2)


@pytest.mark.parametrize("yaml_text,match", [
    ("cameras:\n- camera: {image_width: 8, image_height: 6, intrinsics: "
     "{rows: 4, cols: 1, data: [5, 5, 4, 3]}, distortion: {type: bogus}}\n",
     "Unsupported distortion type"),
    ("cameras:\n- camera: {image_width: 8, image_height: 6, intrinsics: "
     "{rows: 4, cols: 1, data: [5, 5, 4, 3]}, distortion: {type: plumb_bob,"
     " parameters: {rows: 5, cols: 1, data: [0.1, 0, 0, 0, 0.2]}}}\n",
     "beyond 4"),
    ("ncameras:\n  cameras:\n  - camera: {image_width: 8, image_height: 6, "
     "intrinsics: {rows: 4, cols: 1, data: [5, 5, 4, 3]}, distortion: "
     "{type: radtan, parameters: {rows: 4, cols: 1, data: [0, 0, 0, 0]}}}\n"
     "    T_B_C: {rows: 4, cols: 4, data: [0, -1, 0, 1, 1, 0, 0, 2, 0, 0, 1, "
     "3, 0, 0, 0, 1]}\n", None),
])
def test_camera_rig_distortion_parsing(tmp_path, yaml_text, match):
    path = str(tmp_path / "rig.yaml")
    with open(path, "w") as f:
        f.write(yaml_text)
    if match is None:  # aslam nesting, T_B_C inverted, zero params -> none
        _same_rig(jrig.load_camera_rig(path), trig.load_camera_rig(path))
        assert trig.load_camera_rig(path).camera.dist_kind == "none"
        return
    for load in (jrig.load_camera_rig, trig.load_camera_rig):
        with pytest.raises(ValueError, match=match):
            load(path)


@pytest.mark.parametrize("color", [False, True])
def test_images_match_jax(tmp_path, rng, color):
    shape = (8, 10, 3) if color else (8, 10)
    arrays = [rng.uniform(0, 255, shape) for _ in range(3)]
    for i, a in enumerate(arrays):
        timg.save_image(str(tmp_path / f"image_{i}.png"), a)
        jimg.save_image(str(tmp_path / f"jax_{i}.png"), a)
    for i in range(3):
        with Image.open(tmp_path / f"image_{i}.png") as x, \
                Image.open(tmp_path / f"jax_{i}.png") as y:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    got = timg.load_images_by_prefix(str(tmp_path / "image_"), 3,
                                     color=color, extension=".png")
    ref = jimg.load_images_by_prefix(str(tmp_path / "image_"), 3,
                                     color=color, extension=".png",
                                     backend="pil")
    names = timg.load_images_by_names(str(tmp_path), ["image_0", "jax_1.png"],
                                      color=color)
    for a, b in zip(got + names, ref + [ref[0], ref[1]]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        timg.load_images_by_prefix(str(tmp_path / "image_"), 4,
                                   extension=".png")
    with pytest.raises(ValueError, match="No images"):
        timg.load_images_by_names(str(tmp_path), [])


def test_artifacts_cross_package(tmp_path, rng):
    """An npz written by one package loads in the other, bit for bit."""
    geom = (1.0, 2.0, 0.5, 10, 20)
    layers = {"elevation": rng.normal(size=(10, 20)).astype(np.float32),
              "ortho": np.full((10, 20), np.nan, np.float32)}
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, 50).astype(np.float32)
    valid = rng.random(50) > 0.3
    for save_pkg, load_pkg, G in ((jart, tart, JGeom), (tart, jart, TGeom)):
        lp, pp = str(tmp_path / "layers"), str(tmp_path / "points.npz")
        save_pkg.save_layers(lp, {k: torch.tensor(v) if save_pkg is tart
                                  else v for k, v in layers.items()},
                             G(*geom))
        save_pkg.save_points(pp, pts, inten, valid)
        got, g2 = load_pkg.load_layers(lp)
        assert tuple(g2) == geom
        assert set(got) == set(layers)
        for k in layers:
            np.testing.assert_array_equal(got[k], layers[k])
        for a, b in zip(load_pkg.load_points(pp), (pts, inten, valid)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="not a layers"):
            load_pkg.load_layers(pp)
        with pytest.raises(ValueError, match="not a points"):
            load_pkg.load_points(lp)


def _write_dataset(tmp_path, rng, n_cams):
    j, _t = _rigs()
    rig = jrig.CameraRig(j.cameras[:n_cams], j.T_C_B_quats[:n_cams],
                         j.T_C_B_trans[:n_cams])
    jrig.save_camera_rig(rig, str(tmp_path / "rig.yaml"))
    jposes.save_poses_standard(str(tmp_path / "poses.txt"),
                               random_quats(rng, 5),
                               rng.uniform(-1e3, 1e3, (5, 3)))
    for c in range(n_cams):
        (tmp_path / f"cam{c}").mkdir()
        for i in range(5):
            jimg.save_image(str(tmp_path / f"cam{c}" / f"image_{i}.png"),
                            rng.uniform(0, 255, (6, 7)))


def _same_dataset(a, b):
    _same_rig(a.rig, b.rig)
    np.testing.assert_array_equal(a.quats_G_B, b.quats_G_B)
    np.testing.assert_array_equal(a.trans_G_B, b.trans_G_B)
    assert len(a.images) == len(b.images) == a.num_frames
    for x, y in zip(a.images, b.images):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.camera_poses(), b.camera_poses()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("camera_index", [0, 1])
def test_load_dataset_matches_jax(tmp_path, rng, camera_index):
    _write_dataset(tmp_path, rng, 2)
    args = (str(tmp_path), "rig.yaml", "poses.txt", "cam{cam}/image_")
    kw = dict(origin=(10.0, 20.0, 0.0), extension=".png", max_frames=4,
              camera_index=camera_index)
    t = tdata.load_dataset(*args, **kw)
    j = jdata.load_dataset(*args, **kw)
    _same_dataset(t, j)
    assert t.num_frames == 4 and t.image_names is None
    multi_t = tdata.load_multicam_datasets(*args, extension=".png")
    multi_j = jdata.load_multicam_datasets(*args, extension=".png")
    assert len(multi_t) == 2
    for a, b in zip(multi_t, multi_j):
        _same_dataset(a, b)
    with pytest.raises(ValueError, match="placeholder"):
        tdata.load_multicam_datasets(str(tmp_path), "rig.yaml", "poses.txt",
                                     "cam0/image_", extension=".png")
    assert tdata.per_camera_prefix("cam{cam}/x_", 3) == \
        jdata.per_camera_prefix("cam{cam}/x_", 3) == "cam3/x_"
    assert tdata.per_camera_prefix("x_", 3) == "x_"


@pytest.mark.parametrize("with_ids", [False, True])
def test_backward_grid_image_ids_matches_jax(rng, with_ids):
    """image_ids maps the winning slot to its global id; invisible cells
    (best = N, clamped before the lookup) stay unchanged."""
    cam = (64.0, 64.0, 32.0, 24.0, 64, 48)
    geom = (16.0, 0.0, 1.0, 120, 120)  # wider than the footprints
    n = 3
    quats = np.tile([[0.0, 1.0, 0.0, 0.0]], (n, 1)).astype(np.float32)
    ts = np.stack([np.arange(n) * 4.0, np.zeros(n),
                   np.full(n, 514.0)], 1).astype(np.float32)
    images = rng.uniform(0, 255, (n, 48, 64)).astype(np.float32)
    layers = {k: v.numpy() for k, v in
              create_map_state(TGeom(*geom), device="cpu").items()}
    layers["elevation"] = (414.0 + rng.normal(size=(120, 120))) \
        .astype(np.float32)
    ids = np.array([7, 12, 30], np.int32) if with_ids else None
    ref = jax_backward_grid_update(
        layers, quats, ts, images, JGeom(*geom), JCam(*cam),
        JOrtho(score_kernel="xla"),
        image_ids=None if ids is None else np.asarray(ids))
    out = backward_grid_update(
        {k: torch.tensor(v) for k, v in layers.items()}, torch.tensor(quats),
        torch.tensor(ts), torch.tensor(images), TGeom(*geom), TCam(*cam),
        TOrtho(score_kernel="pallas"),
        image_ids=None if ids is None else torch.tensor(ids))
    obs_ref = np.asarray(ref["observation_index"])
    obs = out["observation_index"].numpy()
    assert np.isnan(obs).any() and np.isfinite(obs).any()  # some unseen
    np.testing.assert_array_equal(obs, obs_ref)
    if with_ids:
        assert set(np.unique(obs[np.isfinite(obs)])) <= {7.0, 12.0, 30.0}
    np.testing.assert_array_equal(out["ortho"].numpy(),
                                  np.asarray(ref["ortho"]))


def test_color_helpers_match_jax(rng):
    import jax.numpy as jnp

    from aerial_mapper_tpu.image import color as jcolor

    rgb = rng.uniform(0, 255, (6, 5, 3)).astype(np.float32)
    gray = rgb_to_gray(torch.tensor(rgb)).numpy()
    np.testing.assert_allclose(gray, np.asarray(jcolor.rgb_to_gray(
        jnp.asarray(rgb))), rtol=1e-6)
    packed = pack_rgb_to_float(torch.tensor(rgb / 255.0))
    packed_j = jcolor.pack_rgb_to_float(jnp.asarray(rgb / 255.0))
    np.testing.assert_array_equal(packed.numpy().view(np.int32),
                                  np.asarray(packed_j).view(np.int32))
    np.testing.assert_array_equal(
        unpack_float_to_rgb(packed).numpy(),
        np.asarray(jcolor.unpack_float_to_rgb(packed_j)))


def test_stage_timer_on_the_cpu(caplog):
    timer = StageTimer("cpu")
    with caplog.at_level("INFO", logger="aerial_mapper_tpu_torch"):
        with timer.stage("a"):
            pass
        with timer.stage("a"):
            pass
        with timer.stage("b"):
            pass
    dts = [r.args for r in caplog.records if r.msg == STAGE_LOG]
    assert [n for n, _dt in dts] == ["a", "a", "b"]
    assert timer.durations["a"] == pytest.approx(dts[0][1] + dts[1][1])
    assert timer.durations["b"] == pytest.approx(dts[2][1])
    assert "a:" in timer.report() and "b:" in timer.report()
