"""The port's CLIs (``aerial_mapper_tpu_torch/cli``) build the same driver
call as the JAX CLIs.

For each argv, the JAX CLI and the port CLI run with their driver
monkeypatched (``run_*`` on each package's ``pipeline.batch``; the
incremental driver where each CLI looks it up; the renderer for
``main_make_synthetic_dataset``): the stub records the call and stops the
run. The two calls must carry the same config (``dataclasses.asdict``),
the same keyword arguments (the port's with ``device`` on top) and the
same dataset arrays. The datasets are tiny files in ``tmp_path`` (PGM,
PPM and PNG frames); the flagfiles are fixtures in ``tests/data/flags/``
written in the reference demos' layouts. The config defaults differ in
one documented field: ``OrthoHomographyConfig.auto_window`` is off in the
port.
"""

import dataclasses as dc
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aerial_mapper_tpu.camera.models import Camera as JCam
from aerial_mapper_tpu.camera.rig import CameraRig as JRig
from aerial_mapper_tpu.camera.rig import save_camera_rig as jax_save_rig
from aerial_mapper_tpu.io.artifacts import save_layers as jax_save_layers
from aerial_mapper_tpu.io.images import save_image as jax_save_image
from aerial_mapper_tpu.io.pointcloud import save_point_cloud_txt
from aerial_mapper_tpu.io.poses import _quat_from_matrix_np
from aerial_mapper_tpu.io.poses import save_poses_standard
from aerial_mapper_tpu.mapgrid.grid import MapGeometry
from aerial_mapper_tpu_torch.cli import common

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = os.path.join(ROOT, "tests", "data", "flags")
N = 5


class _Called(Exception):
    """Raised by a stub driver once it has recorded its call."""


def _write_dataset(d, n_cams=1, ext=".pgm", color=False, seed=0):
    """A tiny dataset: a rig of ``n_cams`` 16x12 cameras (the second
    pitched 15 degrees), N poses, N frames per camera."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    cams = (JCam(fx=16.0, fy=16.0, cx=8.0, cy=6.0, width=16, height=12),) \
        * n_cams
    th = np.deg2rad(15.0)
    R1 = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                   [0, np.sin(th), np.cos(th)]])
    quats = np.stack([[1.0, 0, 0, 0], _quat_from_matrix_np(R1.T)][:n_cams])
    jax_save_rig(JRig(cams, quats, np.zeros((n_cams, 3))),
                 os.path.join(d, "camera_fixed_wing.yaml"))
    R = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])
    qs = np.stack([_quat_from_matrix_np(R)] * N)
    ts = np.stack([[2.0 * i, 0.5 * i, 454.0] for i in range(N)])
    save_poses_standard(os.path.join(d, "opt_poses.txt"), qs, ts)
    shape = (12, 16, 3) if color else (12, 16)
    for j in range(n_cams):
        sub = os.path.join(d, f"cam{j}") if n_cams > 1 else d
        os.makedirs(sub, exist_ok=True)
        for i in range(N):
            jax_save_image(os.path.join(sub, f"image_{i}{ext}"),
                           rng.uniform(0, 255, shape))
    return d


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_parity")
    d = dict(
        gray=_write_dataset(str(root / "gray")),
        color=_write_dataset(str(root / "color"), ext=".ppm", color=True),
        png=_write_dataset(str(root / "png"), ext=".png"),
        multi=_write_dataset(str(root / "multi"), n_cams=2),
    )
    rng = np.random.default_rng(1)
    d["cloud"] = str(root / "cloud.txt")
    save_point_cloud_txt(d["cloud"],
                         rng.uniform(-10, 10, (50, 3)) + [0, 0, 414],
                         rng.uniform(0, 255, 50))
    d["npz"] = str(root / "resume.npz")
    geom = MapGeometry(0.0, 0.0, 1.0, 8, 10)
    jax_save_layers(d["npz"], {"elevation": rng.uniform(0, 1, (8, 10))
                               .astype(np.float32)}, geom)
    d["out"] = str(root / "out")
    return d


def _stub(monkeypatch, module, name):
    calls = []

    def fake(*args, **kwargs):
        calls.append((args, kwargs))
        raise _Called

    monkeypatch.setattr(module, name, fake)
    return calls


# each CLI: (JAX module and name of its driver, the port's)
DRIVERS = {
    "main_dense_pcl": ("pipeline.batch", "run_dense_pcl"),
    "main_dsm": ("pipeline.batch", "run_dsm"),
    "main_ortho_backward_grid": ("pipeline.batch",
                                 "run_ortho_backward_grid"),
    "main_ortho_forward_homography": ("pipeline.batch",
                                      "run_ortho_forward_homography"),
    "main_ortho_from_pcl": ("pipeline.batch", "run_ortho_from_pcl"),
    # the port's incremental CLI binds its driver at import
    "main_ortho_backward_grid_incremental": ("pipeline.incremental",
                                             "run_incremental"),
}


def _calls(monkeypatch, cli, argv, jax_argv=()):
    """(JAX call, port call) of ``cli``'s driver for ``argv``."""
    sub, name = DRIVERS[cli]
    jcalls = _stub(monkeypatch,
                   importlib.import_module(f"aerial_mapper_tpu.{sub}"), name)
    port_mod = importlib.import_module(f"aerial_mapper_tpu_torch.cli.{cli}")
    tcalls = _stub(monkeypatch, port_mod if hasattr(port_mod, name) else
                   importlib.import_module(f"aerial_mapper_tpu_torch.{sub}"),
                   name)
    with pytest.raises(_Called):
        importlib.import_module(f"aerial_mapper_tpu.cli.{cli}").main(
            list(argv) + list(jax_argv))
    with pytest.raises(_Called):
        port_mod.main(list(argv), device="cpu")
    assert len(jcalls) == len(tcalls) == 1
    return jcalls[0], tcalls[0]


def _asdict(cfg):
    d = dc.asdict(cfg)
    d["ortho_homography"].pop("auto_window")  # the documented difference
    return d


def assert_same_dataset(j, t):
    assert [tuple(c) for c in j.rig.cameras] == \
        [tuple(c) for c in t.rig.cameras]
    np.testing.assert_array_equal(j.rig.T_C_B_quats, t.rig.T_C_B_quats)
    np.testing.assert_array_equal(j.rig.T_C_B_trans, t.rig.T_C_B_trans)
    np.testing.assert_array_equal(j.quats_G_B, t.quats_G_B)
    np.testing.assert_array_equal(j.trans_G_B, t.trans_G_B)
    assert j.image_names == t.image_names
    assert len(j.images) == len(t.images)
    for a, b in zip(j.images, t.images):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def assert_same_value(j, t, path="arg"):
    if hasattr(j, "rig") and hasattr(j, "images"):
        assert_same_dataset(j, t)
    elif dc.is_dataclass(j):
        assert _asdict(j) == _asdict(t), path
    elif isinstance(j, dict):
        assert set(j) == set(t), path
        for k in j:
            assert_same_value(j[k], t[k], f"{path}[{k!r}]")
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same_value(a, b, f"{path}[{i}]")
    elif isinstance(j, np.ndarray):
        np.testing.assert_array_equal(j, t, err_msg=path)
    elif callable(j):
        assert callable(t), path
    else:
        assert j == t, path


def assert_same_call(jcall, tcall):
    (jargs, jkw), (targs, tkw) = jcall, tcall
    assert tkw.pop("device") == torch.device("cpu")
    assert set(jkw) == set(tkw)
    assert len(jargs) == len(targs)
    for i, (a, b) in enumerate(zip(jargs, targs)):
        assert_same_value(a, b, f"args[{i}]")
    for k in jkw:
        assert_same_value(jkw[k], tkw[k], k)


def _ff(name):
    return f"--flagfile={os.path.join(FLAGS, name)}"


# each case: (cli, argv template, extra argv for JAX only)
CASES = {
    "dense_pcl_defaults": ("main_dense_pcl", [
        "--data_directory", "{gray}", "--image_extension", ".pgm",
        "--output_cloud_txt", "{out}/c.txt"], []),
    "dense_pcl_flagfile_sgm_pallas": ("main_dense_pcl", [
        _ff("0-synthetic-cadastre-dense-pcl.ff"), "--data_directory",
        "{gray}", "--image_extension", ".pgm", "--use_BM=false",
        "--kernel_family", "pallas", "--output_cloud_npz", "{out}/c.npz"],
        []),
    "dense_pcl_all_cameras": ("main_dense_pcl", [
        "--data_directory", "{multi}", "--image_extension", ".pgm",
        "--all_cameras", "--prefix_images", "cam{{cam}}/image_",
        "--camera_index", "1"], []),
    "dsm_flagfile": ("main_dsm", [
        _ff("0-synthetic-cadastre-dsm.ff"), "--data_directory", "{gray}",
        "--image_extension", ".pgm", "--num_disparities", "16",
        "--output_geotiff", "{out}/dsm.tif"], []),
    "dsm_use_sgm_false": ("main_dsm", [
        "--data_directory", "{gray}", "--image_extension", ".pgm",
        "--use_SGM=false", "--adaptive_interpolation=false",
        "--interpolation_radius", "2.5", "--max_frames", "4",
        "--origin", "1", "2", "3", "--stereo_z_min", "400",
        "--stereo_z_max", "430", "--disparity_from_slab",
        "--kernel_family", "pallas", "--report_html", "{out}/r.html"], []),
    "dsm_use_sgm": ("main_dsm", [
        "--data_directory", "{gray}", "--image_extension", ".pgm",
        "--use_SGM", "--images_need_undistortion", "--utm_zone", "33"],
        []),
    "dsm_plane_sweep": ("main_dsm", [
        "--data_directory", "{gray}", "--image_extension", ".pgm",
        "--densifier", "plane_sweep", "--ps_z_min", "399", "--ps_z_max",
        "429", "--ps_num_planes", "31", "--ps_num_neighbors", "3",
        "--ps_neighbor_spacing", "2", "--ps_max_cost", "8.0"], []),
    "dsm_point_cloud_png": ("main_dsm", [
        "--data_directory", "{png}", "--image_extension", ".png",
        "--point_cloud_filename", "{cloud}", "--output_png",
        "{out}/e.png", "--output_color_geotiff", "{out}/c.tif",
        "--color_palette", "false_color_jet"], []),
    "dsm_camera_index": ("main_dsm", [
        "--data_directory", "{multi}", "--image_extension", ".pgm",
        "--prefix_images", "cam{{cam}}/image_", "--camera_index", "1"], []),
    "backward_grid_flagfile_prefix": ("main_ortho_backward_grid", [
        _ff("0-synthetic-cadastre-ortho-backward-batch.ff"),
        "--backward_grid_data_directory={gray}",
        "--backward_grid_image_extension=.pgm",
        "--backward_grid_use_digital_elevation_map=false",
        "--backward_grid_orthomosaic_jpg_filename={out}/o.pgm",
        "--output_geotiff", "{out}/o.tif"], []),
    "backward_grid_colored_cloud": ("main_ortho_backward_grid", [
        "--data_directory", "{color}", "--image_extension", ".ppm",
        "--load_colored_images", "--colored_ortho",
        "--load_point_cloud_from_file", "--point_cloud_filename",
        "{cloud}", "--output_layers_npz", "{out}/l.npz",
        "--kernel_family", "pallas"], []),
    "backward_grid_flat_ground_all_cameras": ("main_ortho_backward_grid", [
        "--data_directory", "{multi}", "--image_extension", ".pgm",
        "--flat_ground", "--orthomosaic_elevation_m", "414",
        "--all_cameras", "--prefix_images", "cam{{cam}}/image_",
        "--geotiff_compression", "deflate", "--geotiff_overviews", "auto"],
        []),
    "incremental_flagfile": ("main_ortho_backward_grid_incremental", [
        _ff("0-synthetic-cadastre-ortho-backward-incremental.ff"),
        "--data_directory", "{gray}", "--image_extension", ".pgm",
        "--backward_grid_update_every_nth=2",
        "--orthomosaic_jpg_filename", "{out}/i.pgm"], []),
    "incremental_resume_preview": ("main_ortho_backward_grid_incremental", [
        "--data_directory", "{gray}", "--image_extension", ".pgm",
        "--update_every_nth", "2", "--resume_layers_npz", "{npz}",
        "--start_frame", "2", "--preview_every_updates", "2",
        "--preview_dir", "{out}/preview", "--save_updates_to",
        "{out}/updates", "--no-auto_shard"], []),
    "incremental_sharded_knobs": ("main_ortho_backward_grid_incremental", [
        "--data_directory", "{gray}", "--image_extension", ".pgm",
        "--kernel_family", "pallas", "--no-band_cull", "--check_every", "2",
        "--slab_margin", "5"], []),
    "homography_rafz_flagfile": ("main_ortho_forward_homography", [
        _ff("1-real-rafz-ortho-from-homography.ff"),
        "--forward_homography_data_directory={gray}",
        "--image_extension", ".pgm", "--ground_plane_elevation_m", "414",
        "--width_mosaic_pixels", "40", "--height_mosaic_pixels", "32",
        "--mosaic_resolution", "0.5", "--filename_mosaic_output",
        "{out}/m.pgm", "--output_geotiff", "{out}/m.tif"], []),
    "homography_all_cameras": ("main_ortho_forward_homography", [
        "--data_directory", "{multi}", "--image_extension", ".pgm",
        "--all_cameras", "--prefix_images", "cam{{cam}}/image_",
        "--mosaic_origin", "-3", "12", "414"], []),
    "from_pcl_flagfile_prefix": ("main_ortho_from_pcl", [
        _ff("0-synthetic-cadastre-ortho-from-pcl.ff"),
        "--ortho_from_pcl_point_cloud_filename={cloud}",
        "--data_directory", "{gray}",
        "--orthomosaic_jpg_filename", "{out}/p.pgm"], []),
    "from_pcl_stereo_adaptive": ("main_ortho_from_pcl", [
        "--data_directory", "{gray}", "--image_extension", ".pgm",
        "--use_adaptive_interpolation", "--interpolation_radius", "3",
        "--kernel_family", "pallas", "--output_geotiff", "{out}/p.tif"],
        []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_builds_the_same_driver_call_as_jax(monkeypatch, data, case):
    cli, argv, jax_argv = CASES[case]
    argv = [a.format(**data) for a in argv]
    jcall, tcall = _calls(monkeypatch, cli, argv, jax_argv)
    assert_same_call(jcall, tcall)


def test_make_synthetic_dataset_renders_what_jax_renders(monkeypatch,
                                                        tmp_path):
    """The renderer's calls (pose, lens, color) and the rig and poses
    written before the first frame: the same in both packages."""
    from aerial_mapper_tpu.synth import scene as jscene
    from aerial_mapper_tpu_torch.cli import main_make_synthetic_dataset as t
    from aerial_mapper_tpu_torch.synth import scene as tscene

    argv = ["--num_images", "3", "--image_width", "16", "--image_height",
            "12", "--focal_length", "16", "--num_cameras", "3",
            "--camera_tilt_deg", "25", "--with_distortion", "--color",
            "--pose_jitter", "0.5", "--seed", "3", "--num_lines", "2"]
    calls = {}
    for pkg, mod in (("jax", jscene), ("port", tscene)):
        calls[pkg] = _stub(monkeypatch, mod, "render_image")
    from aerial_mapper_tpu.cli import main_make_synthetic_dataset as j

    with pytest.raises(_Called):
        j.main(["--output_directory", str(tmp_path / "jax")] + argv)
    with pytest.raises(_Called):
        t.main(["--output_directory", str(tmp_path / "port")] + argv,
               device="cpu")
    (ja, jkw), = calls["jax"]
    (ta, tkw), = calls["port"]
    assert tkw.pop("device") == torch.device("cpu")
    assert tuple(ja[1]) == tuple(ta[1])  # the camera
    assert dc.asdict(ja[0]) == dc.asdict(ta[0])  # the scene
    np.testing.assert_array_equal(np.asarray(ja[2]), ta[2])
    np.testing.assert_array_equal(np.asarray(ja[3]), ta[3])
    assert jkw == tkw
    for name in ("camera_fixed_wing.yaml", "opt_poses.txt"):
        with open(tmp_path / "jax" / name) as a, \
                open(tmp_path / "port" / name) as b:
            assert a.read() == b.read(), name


@pytest.fixture(scope="module")
def refine_data(tmp_path_factory):
    """6 frames of 160x120 rendered by the port's synthetic-dataset CLI,
    40 m above the terrain, for one camera and for a two-camera rig (the
    second pitched 25 degrees), each with noisy poses (0.5 m on frames 1-5)
    in ``noisy_poses.txt``; ``refined`` caches the expected refinement of
    each rig's primary stream."""
    from aerial_mapper_tpu_torch.cli import main_make_synthetic_dataset
    from aerial_mapper_tpu_torch.io.poses import load_poses
    from aerial_mapper_tpu_torch.io.poses import (
        save_poses_standard as port_save_poses,
    )

    root = tmp_path_factory.mktemp("cli_refine")
    noise = np.random.default_rng(5).normal(scale=0.5, size=(5, 3))
    out = {"refined": {}}
    for n_cams in (1, 2):
        d = str(root / f"cams{n_cams}")
        main_make_synthetic_dataset.main(
            ["--output_directory", d, "--num_images", "6", "--image_width",
             "160", "--image_height", "120", "--focal_length", "160",
             "--altitude", "454", "--spacing", "5", "--num_cameras",
             str(n_cams), "--camera_tilt_deg", "25"], device="cpu")
        quats, trans, _ = load_poses(os.path.join(d, "opt_poses.txt"))
        noisy = trans.copy()
        noisy[1:] += noise
        port_save_poses(os.path.join(d, "noisy_poses.txt"), quats, noisy)
        out[n_cams] = d
        out["noisy"] = noisy
    return out


@pytest.mark.parametrize("cli,all_cameras", [
    ("main_dsm", False), ("main_dsm", True),
    ("main_ortho_backward_grid", False), ("main_ortho_backward_grid", True)])
def test_refine_poses_maps_with_the_refined_poses(refine_data, tmp_path, cli,
                                                  all_cameras):
    """``--refine_poses`` refines the primary stream's poses by feature
    tracks + BA, and the CLI's map equals the port's driver run on a
    dataset carrying the refined body trajectory (every stream of the rig
    under ``--all_cameras``). The refinement's accuracy is held by
    ``test_cli_dsm_refine_poses_recovers_accuracy``: 6 frames of 160x120
    give BA too few tracks to halve the error, in JAX as in the port."""
    from aerial_mapper_tpu_torch.features import refine_poses_windowed
    from aerial_mapper_tpu_torch.io.artifacts import load_layers
    from aerial_mapper_tpu_torch.io.poses import camera_to_body_poses
    from aerial_mapper_tpu_torch.pipeline import batch

    n_cams = 2 if all_cameras else 1
    npz = str(tmp_path / "layers.npz")
    argv = ["--data_directory", refine_data[n_cams], "--filename_poses",
            "noisy_poses.txt", "--center_easting", "12",
            "--center_northing", "0", "--delta_easting", "30",
            "--delta_northing", "24", "--resolution", "1.0",
            "--dense_pcl_use_every_nth_image", "1", "--num_disparities", "16",
            "--output_geotiff", str(tmp_path / "map.tif"),
            "--output_layers_npz", npz, "--refine_poses"]
    if cli == "main_ortho_backward_grid":
        argv += ["--orthomosaic_jpg_filename", str(tmp_path / "o.pgm")]
    if all_cameras:
        argv += ["--all_cameras", "--prefix_images", "cam{cam}/image_"]
    mod = importlib.import_module(f"aerial_mapper_tpu_torch.cli.{cli}")
    mod.main(argv, device="cpu")

    args = mod.parse_args(argv)
    datasets = common.datasets_from_args(args)
    dataset = datasets[0] if datasets else common.dataset_from_args(args)
    if n_cams not in refine_data["refined"]:
        q, t, _stats = refine_poses_windowed(
            dataset.images, *dataset.camera_poses(), dataset.rig.camera,
            device="cpu")
        refine_data["refined"][n_cams] = camera_to_body_poses(dataset.rig,
                                                              q, t)
    qb, tb = refine_data["refined"][n_cams]
    assert np.abs(tb - refine_data["noisy"]).max() > 0.1  # BA moved it
    if datasets:
        datasets = [dc.replace(d, quats_G_B=qb, trans_G_B=tb)
                    for d in datasets]
    dataset = dc.replace(dataset, quats_G_B=qb, trans_G_B=tb)
    run = getattr(batch, "run_dsm" if cli == "main_dsm"
                  else "run_ortho_backward_grid")
    want = run(dataset, common.pipeline_config_from_args(args),
               datasets=datasets, device="cpu")[0]
    got, _geom = load_layers(npz)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name].numpy(),
                                      err_msg=name)


def test_main_refine_poses_matches_jax(tmp_path, monkeypatch, capsys):
    """``tests/test_cli.py::test_cli_refine_poses``'s dataset and argv: the
    port's CLI parses them to JAX's namespace and writes poses within
    5e-3 m (the BA parity bar) of JAX's, and prints JAX's line."""
    from aerial_mapper_tpu.cli import common as jcommon
    from aerial_mapper_tpu.cli import main_make_synthetic_dataset
    from aerial_mapper_tpu.cli import main_refine_poses as jax_cli
    from aerial_mapper_tpu.io.poses import PoseFormat, load_poses
    from aerial_mapper_tpu_torch.cli import main_refine_poses

    d = str(tmp_path / "ds")
    main_make_synthetic_dataset.main([
        "--output_directory", d, "--num_images", "6",
        "--image_width", "96", "--image_height", "64",
        "--focal_length", "96", "--altitude", "454", "--spacing", "5",
    ])
    argv = ["--data_directory", d, "--num_corners", "64",
            "--ba_iterations", "3"]
    seen, parse = [], jcommon.parse

    def spy(p, a):
        seen.append(parse(p, a))
        return seen[-1]

    monkeypatch.setattr(jcommon, "parse", spy)
    jax_cli.main(argv + ["--output_poses", str(tmp_path / "jax.txt")])
    jax_line = capsys.readouterr().out.splitlines()[-1]
    monkeypatch.undo()
    assert vars(seen[0]) == vars(main_refine_poses.parse_args(
        argv + ["--output_poses", str(tmp_path / "jax.txt")]))
    main_refine_poses.main(argv + ["--output_poses",
                                   str(tmp_path / "port.txt")],
                           device="cpu")
    port_line = capsys.readouterr().out.splitlines()[-1]
    assert port_line == jax_line.replace("jax.txt", "port.txt")
    qj, tj, _ = load_poses(str(tmp_path / "jax.txt"), PoseFormat.STANDARD)
    qt, tt, _ = load_poses(str(tmp_path / "port.txt"), PoseFormat.STANDARD)
    assert len(tt) == 6
    np.testing.assert_allclose(tt, tj, atol=5e-3, rtol=0)
    np.testing.assert_allclose(qt, qj, atol=1e-4, rtol=0)
    assert abs(float(tt[0][2]) - 454.0) < 1.0


def test_cli_dsm_refine_poses_recovers_accuracy(tmp_path, rng):
    """The port's twin of ``tests/test_cli.py``'s test of the same name:
    ``--refine_poses`` recovers most of the DSM accuracy lost to a noisy
    pose prior (0.5 m), RMSE at most half the noisy one and below 2 m."""
    from aerial_mapper_tpu_torch.cli import (
        main_dsm,
        main_make_synthetic_dataset,
    )
    from aerial_mapper_tpu_torch.io.geotiff import read_geotiff
    from aerial_mapper_tpu_torch.io.poses import load_poses
    from aerial_mapper_tpu_torch.io.poses import (
        save_poses_standard as port_save_poses,
    )
    from aerial_mapper_tpu_torch.synth.scene import SyntheticScene

    d = str(tmp_path / "refine_ds")
    main_make_synthetic_dataset.main([
        "--output_directory", d, "--num_images", "10",
        "--image_width", "320", "--image_height", "240",
        "--focal_length", "320", "--altitude", "514", "--spacing", "6",
        "--relief_amplitude", "5",
    ], device="cpu")
    quats, trans, _ = load_poses(os.path.join(d, "opt_poses.txt"))
    noisy = trans.copy()
    noisy[1:] += rng.normal(scale=0.5, size=(len(trans) - 1, 3))
    port_save_poses(os.path.join(d, "noisy_poses.txt"), quats, noisy)
    scene = SyntheticScene(base_elevation=414.0, relief_amplitude=5.0)

    def dsm_rmse(extra):
        tif = os.path.join(d, f"dsm_rp_{len(extra)}.tif")
        main_dsm.main(
            ["--data_directory", d, "--filename_poses", "noisy_poses.txt",
             "--center_easting", "30", "--center_northing", "0",
             "--delta_easting", "60", "--delta_northing", "50",
             "--resolution", "0.5", "--dense_pcl_use_every_nth_image", "1",
             "--num_disparities", "48", "--output_geotiff", tif] + extra,
            device="cpu")
        band, geo, _ = read_geotiff(tif)
        west, north, res = geo
        h, w = band.shape
        ce = west + (np.arange(w) + 0.5) * res
        cn = north - (np.arange(h) + 0.5) * res
        truth = scene.height(
            torch.as_tensor(ce[None, :].repeat(h, 0), dtype=torch.float32),
            torch.as_tensor(cn[:, None].repeat(w, 1),
                            dtype=torch.float32)).numpy()
        cov = np.isfinite(band)
        assert cov.mean() > 0.2
        return float(np.sqrt(np.mean((band[cov] - truth[cov]) ** 2)))

    rmse_noisy = dsm_rmse([])
    rmse_refined = dsm_rmse(["--refine_poses"])
    assert rmse_refined < rmse_noisy * 0.5, \
        f"{rmse_noisy:.2f} -> {rmse_refined:.2f}"
    assert rmse_refined < 2.0


def test_refine_poses_unset_returns_the_dataset():
    args = type("Args", (), {"refine_poses": False})()
    marker = object()
    assert common.maybe_refine_poses(marker, args) is marker
    assert common.maybe_refine_datasets([marker], args) == [marker]
    assert common.maybe_refine_datasets(None, args) is None


DEVICE_CLIS = ["main_dense_pcl", "main_dsm", "main_ortho_backward_grid",
               "main_ortho_backward_grid_incremental",
               "main_ortho_forward_homography", "main_ortho_from_pcl",
               "main_make_synthetic_dataset", "main_refine_poses"]


@pytest.mark.parametrize("cli", DEVICE_CLIS)
def test_cli_needs_cuda_unless_cpu_is_asked(data, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    mod = importlib.import_module(f"aerial_mapper_tpu_torch.cli.{cli}")
    argv = (["--output_directory", str(tmp_path)]
            if cli == "main_make_synthetic_dataset"
            else ["--data_directory", data["gray"], "--image_extension",
                  ".pgm"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    assert not os.listdir(tmp_path)  # it raised before writing anything


ALL_CLIS = DEVICE_CLIS + ["main_generate_pix4d_geofile",
                          "main_convert_simulation", "main_google_maps"]


def test_every_cli_runs_as_a_module():
    """``python -m aerial_mapper_tpu_torch.cli.<name> --help`` exits 0 for
    every CLI, and a mapping CLI run without a card raises the CUDA error
    (one interpreter: runpy runs each module as ``__main__``)."""
    script = f"""
import runpy, sys
for name in {ALL_CLIS!r}:
    sys.argv = [name, "--help"]
    try:
        runpy.run_module("aerial_mapper_tpu_torch.cli." + name,
                         run_name="__main__", alter_sys=True)
    except SystemExit as e:
        assert e.code == 0, (name, e.code)
    else:
        raise AssertionError(name + " --help did not exit")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stdout[-2000:] + r.stderr[-2000:]
    if torch.cuda.is_available():
        return
    r = subprocess.run(
        [sys.executable, "-m", "aerial_mapper_tpu_torch.cli.main_dsm",
         "--data_directory", "/nonexistent"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "CUDA" in r.stderr, r.stderr[-2000:]


def test_flag_parsing_matches_jax():
    """gflags booleans, the prefixes and --kernel_family parse to the same
    namespace in both packages."""
    from aerial_mapper_tpu.cli import common as jcommon

    argv = ["--data_directory", "/x", "--use_SGM=false",
            "--adaptive_interpolation=false", "--kernel_family", "pallas",
            "--prefix_images", "a=true", "--geotiff_overviews", "2"]
    jp, tp = jcommon.base_parser("t"), common.base_parser("t")
    for mod, p in ((jcommon, jp), (common, tp)):
        mod.add_grid_flags(p)
        mod.add_stereo_flags(p)
        mod.add_dsm_flags(p)
        mod.add_refine_poses_flag(p)
        mod.add_multicam_flag(p)
        mod.add_reference_compat_flags(p)
    assert vars(jp.parse_args(jcommon.expand_flagfiles(argv))) == \
        vars(tp.parse_args(common.expand_flagfiles(argv)))
    for prefix in ("backward_grid_", "forward_homography_",
                   "ortho_from_pcl_"):
        raw = [f"--{prefix}use_BM=false", f"--{prefix}resolution=0.5",
               "--v=0", f"--{prefix}x=true"]
        assert jcommon.strip_flag_prefix(raw, prefix) == \
            common.strip_flag_prefix(raw, prefix)
    with pytest.raises(SystemExit):
        tp.parse_args(["--data_directory", "/x", "--geotiff_overviews",
                       "Auto"])
