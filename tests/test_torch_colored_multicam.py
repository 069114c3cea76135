"""Colored frames on a two-camera rig: the port's drivers against the JAX
package on the CPU, and ``chip_smoke.py`` phase 16's color checks.

The rig and survey of ``tests/test_multicam.py`` (camera 0 nadir, camera 1
pitched 25 degrees north, both ``SQCAM``: 224x168; 8 body poses; 32
disparities; a 42x64 map at 1 m), rendered in RGB by the JAX synth and
quantized to uint8 as a camera stores them. Both packages read the same
numpy frames. JAX runs its "xla" switches on one device
(``auto_shard=False``), the port the same family with ``device="cpu"``.
The packed layer (``colored_ortho``) is compared as int32 bits; the other
layers at the bars of ``tests/test_torch_batch.py``
(``assert_layers_close``). The port's sharded runs (8 logical CPU shards,
its "pallas" switches) must equal its one-device runs bit for bit.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aerial_mapper_tpu.camera.rig import CameraRig as JRig
from aerial_mapper_tpu.geo.se3 import matrix_to_quat
from aerial_mapper_tpu.io.poses import _quat_from_matrix_np
from aerial_mapper_tpu.pipeline import batch as jbatch
from aerial_mapper_tpu.pipeline.dataset import Dataset as JDataset
from aerial_mapper_tpu.pipeline.incremental import (
    run_incremental as jax_run_incremental,
)
from aerial_mapper_tpu.synth import make_survey_poses, render_image
from aerial_mapper_tpu_torch.image.color import rgb_to_gray
from aerial_mapper_tpu_torch.parallel import mesh as pmesh
from aerial_mapper_tpu_torch.pipeline import batch as tbatch
from aerial_mapper_tpu_torch.pipeline.incremental import run_incremental
from test_multicam import SCENE, SQCAM, TILT_DEG, _config
from test_torch_batch import host
from test_torch_incremental import assert_bit_equal, assert_layers_close
from test_torch_parallel_batch import port_config, port_dataset

torch.set_num_threads(2)

N_POSES = 8
EVERY = 2  # the incremental driver's update cadence

_CACHE = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _tilt():
    th = np.deg2rad(TILT_DEG)
    return np.array([[1.0, 0.0, 0.0],
                     [0.0, np.cos(th), -np.sin(th)],
                     [0.0, np.sin(th), np.cos(th)]])


def jax_datasets():
    """One JAX Dataset per rig camera: uint8 [168, 224, 3] frames of each
    camera's true pose T_G_B * T_B_Cj over one body trajectory."""
    def make():
        rots = (np.eye(3), _tilt())
        rig = JRig(cameras=(SQCAM, SQCAM),
                   T_C_B_quats=np.stack([_quat_from_matrix_np(R.T)
                                         for R in rots]),
                   T_C_B_trans=np.zeros((2, 3)))
        Rs, ts = make_survey_poses(N_POSES, altitude=514.0, spacing=6.0)
        quats = np.asarray(matrix_to_quat(jnp.asarray(Rs)), np.float64)
        out = []
        for j, R_B_C in enumerate(rots):
            frames = [np.clip(np.round(np.asarray(render_image(
                SCENE, SQCAM, jnp.asarray(R @ R_B_C, jnp.float32),
                jnp.asarray(t, jnp.float32), color=True))), 0, 255)
                .astype(np.uint8) for R, t in zip(Rs, ts)]
            out.append(JDataset(rig=rig.select(j), quats_G_B=quats,
                                trans_G_B=np.asarray(ts, np.float64),
                                images=frames))
        return out

    return _cached("jax_datasets", make)


def port_datasets(gray_twin=False):
    """The port's Datasets over the same numpy frames; with ``gray_twin``
    each frame is ``rgb_to_gray`` of its RGB as float32 [H, W]: the frames
    the colored run's stereo matches."""
    tds = [port_dataset(d) for d in jax_datasets()]
    if gray_twin:
        tds = [dc.replace(d, images=[
            rgb_to_gray(torch.from_numpy(im).float()).numpy()
            for im in d.images]) for d in tds]
    return tds


def configs(colored=True):
    """(JAX config, the port's twin): ``tests/test_multicam.py``'s, on
    one device, with ``colored_ortho``."""
    jcfg = _config()
    jcfg = dc.replace(jcfg, auto_shard=False, ortho_backward=dc.replace(
        jcfg.ortho_backward, colored_ortho=colored))
    return jcfg, port_config(jcfg)


def pallas(tcfg, **kw):
    """The port's config on its hand-kernel switches (their plain
    versions on the CPU), as ``chip_smoke.py`` runs them on the card."""
    return dc.replace(
        tcfg, bm=dc.replace(tcfg.bm, kernel="pallas"),
        dsm=dc.replace(tcfg.dsm, idw_kernel="pallas"),
        ortho_backward=dc.replace(tcfg.ortho_backward,
                                  score_kernel="pallas"), **kw)


def run(driver, pkg, cfg, datasets):
    if driver == "batch":
        fn = jbatch.run_ortho_backward_grid if pkg == "jax" else \
            tbatch.run_ortho_backward_grid
        kw = {}
    else:
        fn = jax_run_incremental if pkg == "jax" else run_incremental
        kw = dict(update_every_nth=EVERY)
    if pkg != "jax":
        kw["device"] = "cpu"
    return fn(datasets[0], cfg, datasets=datasets, **kw)[0]


def port_run(driver, colored=True):
    """The port's one-device run on the colored frames (``colored``) or
    on their gray twins with ``colored_ortho`` off."""
    def go():
        _j, tcfg = configs(colored)
        return run(driver, "port", tcfg, port_datasets(not colored))

    return _cached(("port", driver, colored), go)


def assert_packed_matches(ref, out):
    """The packed layers as int32 bits: equal on every cell where both
    maps picked the same winner (its texel), and on >= 99.5 % of the
    cells either textures (``assert_layers_close``'s share)."""
    a = np.asarray(ref["colored_ortho"]).view(np.int32)
    b = np.asarray(out["colored_ortho"]).view(np.int32)
    ia, ib = ref["observation_index"], out["observation_index"]
    same = np.isfinite(ia) & (ia == ib)
    assert same.sum() > 0.5 * same.size
    np.testing.assert_array_equal(a[same], b[same])
    seen = np.isfinite(ia) | np.isfinite(ib)
    assert (a[seen] == b[seen]).mean() > 0.995


@pytest.mark.parametrize("driver", ["batch", "incremental"])
def test_colored_multicam_matches_jax(driver):
    """colored x multicam, ``run_ortho_backward_grid(datasets=...)`` and
    ``run_incremental(datasets=...)``: the port against JAX, the packed
    layer bit for bit where the winners agree; camera 1 wins cells under
    global ids (>= the first stream's length) and the fused DSM covers
    more than camera 0's."""
    jcfg, _t = configs()
    ref = host(run(driver, "jax", jcfg, jax_datasets()))
    out = host(port_run(driver))
    assert set(out) == set(ref)
    assert_layers_close(ref, out, "colored_ortho")
    assert_packed_matches(ref, out)
    ids = out["observation_index"]
    assert (ids[np.isfinite(ids)] >= N_POSES).any()
    assert (ids[np.isfinite(ids)] < 2 * N_POSES).all()
    _j, tcfg = configs()
    alone = host(run(driver, "port", tcfg, port_datasets()[:1]))
    assert np.isfinite(out["elevation"]).sum() > \
        1.2 * np.isfinite(alone["elevation"]).sum()


@pytest.mark.parametrize("driver", ["batch", "incremental"])
def test_colored_multicam_sharded_equals_one_device(driver, monkeypatch):
    """The colored two-camera run on 8 logical CPU shards (the sharded
    incremental driver's interleaved ring and banded passes, the batch
    driver's ring stereo and culled band gathers of [N, H, W, 3] frames)
    equals its one-device run: the packed layer as int32 bits, the others
    bit for bit (NaN-aware)."""
    _j, tcfg = configs()
    tds = port_datasets()
    one = run(driver, "port", pallas(tcfg), tds)
    monkeypatch.setattr(
        pmesh, "default_devices",
        lambda device_type="cuda": [torch.device(device_type)] * 8)
    kw = dict(check_every=2) if driver == "incremental" else {}
    sharded = (run_incremental(tds[0], pallas(tcfg, auto_shard=True),
                               update_every_nth=EVERY, datasets=tds,
                               device="cpu", **kw)[0]
               if driver == "incremental" else
               tbatch.run_ortho_backward_grid(
                   tds[0], pallas(tcfg, auto_shard=True), datasets=tds,
                   device="cpu")[0])
    assert chip_smoke.packed_equal(sharded["colored_ortho"],
                                   one["colored_ortho"])
    assert_bit_equal(sharded, one)


@pytest.mark.parametrize("control", [None, *chip_smoke.PACKED_CONTROLS])
@pytest.mark.parametrize("driver", ["batch", "incremental"])
def test_phase16_color_checks(driver, control):
    """Phase 16's checks on the colored run and its gray twin: the layers
    that do not hold the texture are bit-equal, the luma of the unpacked
    colored ortho equals the gray ortho on every textured cell, and the
    packed layer equals itself as bits. Each control (blue dropped; the
    layer through x * 0.5 * 2.0) must fail both the luma and the bits
    check, and pass ``torch.allclose``, which cannot see the colors."""
    col, gray = port_run(driver), port_run(driver, colored=False)
    assert chip_smoke.bit_equal_maps(col, gray, keys=(
        "elevation", "elevation_angle", "observation_index",
        "num_observations"))
    textured = torch.isfinite(gray["observation_index"])
    assert textured.float().mean() > 0.5
    packed = col["colored_ortho"]
    if control is not None:
        packed = chip_smoke.PACKED_CONTROLS[control](packed)
    bad, n = chip_smoke.luma_mismatch(packed, gray["ortho"], textured)
    assert n == int(textured.sum())
    if control is None:
        assert bad == 0
        assert chip_smoke.packed_equal(packed, col["colored_ortho"])
    else:
        assert bad > 0.01 * n, (control, bad, n)
        assert not chip_smoke.packed_equal(packed, col["colored_ortho"])
        assert torch.allclose(packed.nan_to_num(), col["colored_ortho"]
                              .nan_to_num())
