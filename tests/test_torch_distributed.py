"""The port's mesh across processes (``aerial_mapper_tpu_torch/parallel``
on ``torch.distributed``): two Gloo processes on the CPU, each holding two
logical CPU shards (``parallel/mesh.py::default_devices`` patched to
``["cpu"] * 2``), a ``file://`` rendezvous in a fresh directory.

One pair of worker processes runs every case once per module (this file
run as a script: ``python tests/test_torch_distributed.py RANK DIR``), and
each case is held to the port's one-process mesh of four CPU shards on the
same inputs:

- every collective and both halo exchanges, on a (pairs, tiles) = (1, 4)
  and a (2, 2) mesh: bit for bit, each rank's shards; another rank's
  entries are None;
- the twins of ``tests/test_distributed.py``'s three tests, at their
  sizes (its cameras, scene, geometry and configs): ``sharded_dsm_update``,
  ``sharded_map_step`` and ``run_incremental`` with ``check_every=1``:
  bit for bit against the port's one-process run, and against the JAX
  single-device composition on the same inputs at the bars of
  ``tests/test_torch_parallel.py`` / ``tests/test_torch_incremental_sharded
  .py`` (IDW values rtol 1e-6 / atol 1e-4 with the same finite cells; the
  maps at ``assert_layers_close``);
- ``sharded_bundle_adjust`` on an ``obs`` axis across the processes: bit
  for bit against the one-process mesh;
- the failures: ``gather_row_bands_to_host`` is None on rank 1, ranks with
  unequal device counts raise, a rank that never joins makes
  ``initialize_distributed`` raise within its timeout.

Every wait has a limit: the workers' process group 120 s, the workers
themselves 300 s.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script, the worker imports the port
    sys.path.insert(0, ROOT)

from aerial_mapper_tpu_torch import config as tc  # noqa: E402
from aerial_mapper_tpu_torch.ba.bundle_adjust import (  # noqa: E402
    BAProblem,
    BAState,
    sharded_bundle_adjust,
)
from aerial_mapper_tpu_torch.camera.models import Camera  # noqa: E402
from aerial_mapper_tpu_torch.camera.rig import CameraRig  # noqa: E402
from aerial_mapper_tpu_torch.mapgrid.grid import (  # noqa: E402
    MapGeometry,
    create_map_state,
)
from aerial_mapper_tpu_torch.parallel import collectives as cl  # noqa: E402
from aerial_mapper_tpu_torch.parallel import distributed as tdist  # noqa
from aerial_mapper_tpu_torch.parallel import halo as thalo  # noqa: E402
from aerial_mapper_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from aerial_mapper_tpu_torch.parallel import sharded as tsh  # noqa: E402
from aerial_mapper_tpu_torch.pipeline.dataset import Dataset  # noqa: E402
from aerial_mapper_tpu_torch.pipeline.incremental import (  # noqa: E402
    run_incremental,
)

torch.set_num_threads(2)

WORLD = 2
SHARDS_PER_RANK = 2
GROUP_TIMEOUT_S = 120.0
WORKER_TIMEOUT_S = 300.0

# tests/test_distributed.py's sizes
CAM = (64.0, 64.0, 32.0, 24.0, 64, 48)
DSM_GEOM = (0.0, 0.0, 1.0, 32, 40)
STEP_GEOM = (8.0, 0.0, 1.0, 32, 32)
DSM_CFG = dict(interpolation_radius_sq=2.0)
STEP_DSM_CFG = dict(interpolation_radius_sq=2.0, bin_capacity=8)
INC_GRID = dict(center_easting=8.0, center_northing=0.0,
                delta_easting=32.0, delta_northing=30.0, resolution=1.0)
STEP_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
COLLECTIVE_MESHES = {"1x4/tiles": ((1, 4), "tiles"),
                     "2x2/pairs": ((2, 2), "pairs"),
                     "2x2/pairs+tiles": ((2, 2), ("pairs", "tiles"))}
COLLECTIVES = ("each", "replicate", "scatter", "concat", "ppermute", "psum",
               "psum_int", "pmin", "pmax", "all_gather", "all_gather_bool",
               "all_to_all", "run_psum_programs", "halo_exchange_rows",
               "halo_exchange_extended_0", "halo_exchange_extended_1")


# ---- the cases, run alike by the workers and the one-process mesh ----

def _per_shard(mesh, arr):
    """``arr`` [mesh.size, ...] as a sharded value: shard f holds arr[f]
    (only this rank's shards are filled)."""
    flat = ("pairs", "tiles")
    return cl.each(mesh, lambda f, x: x[0],
                   cl.scatter(mesh, torch.as_tensor(arr), flat))


def collective_case(name, mesh, axes):
    """A sharded list (or, for concat, one tensor) from collective
    ``name`` over ``axes`` on seeded inputs."""
    n = mesh.size
    k = cl.axis_size(mesh, axes)
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.normal(size=(n, 4, 6)).astype(np.float32) * 1e3
    x[:, 0, 0] = np.nan  # NaN rides every exchange and every reduction
    xs = _per_shard(mesh, x)
    if name == "each":
        return cl.each(mesh, lambda f, t: t * 2.0 + f, xs)
    if name == "replicate":
        return cl.replicate(mesh, torch.as_tensor(x[0]))
    if name == "scatter":
        return cl.scatter(mesh, torch.as_tensor(x.reshape(n * 4, 6)), axes)
    if name == "concat":
        return cl.concat(mesh, xs, axes, dim=1)
    if name == "ppermute":
        return cl.ppermute(mesh, xs, axes,
                           [(i, (i + 1) % k) for i in range(k - 1)])
    if name == "psum":
        return cl.psum(mesh, xs, axes)
    if name == "psum_int":
        ints = rng.integers(-2 ** 40, 2 ** 40, size=(n, 3))
        return cl.psum(mesh, _per_shard(mesh, ints), axes)
    if name == "pmin":
        return cl.pmin(mesh, xs, axes)
    if name == "pmax":
        return cl.pmax(mesh, xs, axes)
    if name == "all_gather":
        return cl.all_gather(mesh, xs, axes, dim=1)
    if name == "all_gather_bool":
        return cl.all_gather(mesh, _per_shard(mesh, x > 0), axes)
    if name == "all_to_all":
        return cl.all_to_all(mesh, xs, axes, split_dim=0, concat_dim=1)
    if name == "run_psum_programs":
        def program(t):
            total = yield t
            again = yield total * t
            return again - total

        return cl.run_psum_programs(
            mesh, cl.each(mesh, lambda f, t: program(t), xs), axes)
    if name == "halo_exchange_rows":
        return thalo.halo_exchange_rows(mesh, xs, 1, axes)
    if name.startswith("halo_exchange_extended_"):
        axis = int(name[-1])
        ext = x.reshape(n, 2, 12) if axis == 1 else x.reshape(n, 12, 2)
        return thalo.halo_exchange_extended(mesh, _per_shard(mesh, ext), 2,
                                            axes, axis=axis)
    raise KeyError(name)


def _cam():
    return Camera(*CAM)


def dsm_case(mesh, inputs):
    """``sharded_dsm_update`` on the JAX test's 5000 points; the map as
    rank 0 gathers it (None on rank 1) and as every rank unshards it."""
    geom = MapGeometry(*DSM_GEOM)
    layers = tsh.shard_layers(create_map_state(geom, device="cpu"), mesh)
    elev = tsh.sharded_dsm_update(
        layers["elevation"], torch.as_tensor(inputs["dsm_pts"]),
        torch.ones(inputs["dsm_pts"].shape[0], dtype=torch.bool), geom,
        tc.DsmConfig(**DSM_CFG), mesh)
    return (tdist.gather_row_bands_to_host(elev, mesh),
            tsh.unshard_layers({"e": elev}, mesh)["e"].numpy())


def step_case(mesh, inputs):
    """``sharded_map_step`` on the JAX test's 5 frames (4 pairs) with the
    replicated images: (the whole map on this rank, overflow, routed)."""
    geom = MapGeometry(*STEP_GEOM)
    cam = _cam()
    ring = tsh.prepare_ring_pair_operands(
        cam.K, inputs["step_Rs"], inputs["step_ts"], inputs["step_images"],
        device="cpu")
    banded = tsh.replicated_band_images(
        inputs["step_quats"], inputs["step_ts"].astype(np.float32),
        inputs["step_images"], device="cpu")
    out, diag = tsh.sharded_map_step(
        tsh.shard_layers(create_map_state(geom, device="cpu"), mesh), ring,
        banded, geom, cam, tc.DsmConfig(**STEP_DSM_CFG),
        tc.OrthoBackwardGridConfig(cell_chunk=256), mesh,
        bm_cfg=tc.BlockMatchingConfig(num_disparities=16))
    layers = {k: v.numpy() for k, v in tsh.unshard_layers(out, mesh).items()}
    return layers, int(diag.overflow), diag.routed.numpy()


def inc_dataset(inputs):
    rig = CameraRig(cameras=(_cam(),),
                    T_C_B_quats=np.array([[1.0, 0.0, 0.0, 0.0]]),
                    T_C_B_trans=np.zeros((1, 3)))
    return Dataset(rig=rig, quats_G_B=inputs["inc_quats"],
                   trans_G_B=inputs["inc_ts"],
                   images=list(inputs["inc_images"]))


def inc_config(**kw):
    return tc.PipelineConfig(
        grid=tc.GridMapConfig(**INC_GRID),
        stereo=tc.StereoConfig(use_every_nth_image=1),
        bm=tc.BlockMatchingConfig(num_disparities=16),
        dsm=tc.DsmConfig(**STEP_DSM_CFG), **kw)


def inc_case(inputs):
    """``run_incremental`` updated every 2nd frame with ``check_every=1``
    over the mesh the driver builds: (map, on_update payloads)."""
    payloads = {}
    layers, _g = run_incremental(
        inc_dataset(inputs), inc_config(), update_every_nth=2,
        check_every=1, device="cpu",
        on_update=lambda i, ls, g: payloads.update({i: ls}))
    return {k: v.numpy() for k, v in layers.items()}, payloads


def ba_case(mesh, inputs):
    state = BAState(*(inputs[f"ba_state_{k}"] for k in BAState._fields))
    prob = BAProblem(*(inputs[f"ba_prob_{k}"] for k in BAProblem._fields))
    out = sharded_bundle_adjust(state, prob, _cam_ba(inputs),
                                tc.BundleAdjustmentConfig(max_iterations=8),
                                mesh, axis_name="obs")
    return {k: getattr(out, k).numpy() for k in BAState._fields}


def _cam_ba(inputs):
    return Camera(*inputs["ba_cam"][:4].tolist(),
                  *map(int, inputs["ba_cam"][4:]))


def mesh_of(shape, axes=("pairs", "tiles"), devices=None, processes=None):
    if devices is None:
        devices = ["cpu"] * int(np.prod(shape))
    return pmesh.make_mesh(axes, shape=shape, devices=devices,
                           processes=processes)


# ---- the worker: one rank of the pair ----

def _worker(rank: int, work: str) -> None:
    """Join the group, run every case on this rank's two logical shards
    and write ``rank{rank}.npz`` (each local shard's result)."""
    tdist.initialize_distributed(
        f"file://{work}/rendezvous", num_processes=WORLD, process_id=rank,
        backend="gloo", timeout_s=GROUP_TIMEOUT_S)
    pmesh.default_devices = \
        lambda device_type="cuda": [torch.device("cpu")] * SHARDS_PER_RANK
    devices, processes = pmesh.mesh_devices("cpu")
    assert processes == [0, 0, 1, 1], processes
    inputs = dict(np.load(os.path.join(work, "inputs.npz")))
    out = {}

    def keep(tag, value):
        if isinstance(value, torch.Tensor):
            out[tag] = value.numpy()
            return
        out[f"{tag}#remote"] = np.array(
            [f for f, v in enumerate(value) if v is None])
        for f, v in enumerate(value):
            if v is not None:
                out[f"{tag}#{f}"] = v.numpy()

    for tag, (shape, axes) in COLLECTIVE_MESHES.items():
        mesh = mesh_of(shape, devices=devices, processes=processes)
        for name in COLLECTIVES:
            keep(f"{name}@{tag}", collective_case(name, mesh, axes))

    tiles = mesh_of((4,), ("tiles",), devices, processes)
    gathered, whole = dsm_case(tiles, inputs)
    out["dsm_whole"] = whole
    out["dsm_gathered_is_none"] = np.array(gathered is None)
    if gathered is not None:
        out["dsm_gathered"] = gathered

    for tag, shape in STEP_MESHES.items():
        layers, overflow, routed = step_case(
            mesh_of(shape, devices=devices, processes=processes), inputs)
        out.update({f"step{tag}/{k}": v for k, v in layers.items()})
        out[f"step{tag}#overflow"] = np.array(overflow)
        out[f"step{tag}#routed"] = routed

    layers, payloads = inc_case(inputs)
    out.update({f"inc/{k}": v for k, v in layers.items()})
    for i, ls in payloads.items():
        out.update({f"incpay{i}/{k}": v for k, v in ls.items()})
        out[f"incpay{i}#numpy"] = np.array(
            all(isinstance(v, np.ndarray) for v in ls.values()))

    ba = ba_case(mesh_of((4,), ("obs",), devices, processes), inputs)
    out.update({f"ba/{k}": v for k, v in ba.items()})

    # the batch drivers' auto_shard refuses a mesh across processes
    from aerial_mapper_tpu_torch.pipeline.batch import _auto_mesh

    try:
        _auto_mesh(tc.PipelineConfig(), torch.device("cpu"))
        out["batch_refused"] = np.array(False)
    except NotImplementedError:
        out["batch_refused"] = np.array(True)

    # ranks that hold unequal device counts: both raise
    pmesh.default_devices = \
        lambda device_type="cuda": [torch.device("cpu")] * (rank + 1)
    try:
        pmesh.mesh_devices("cpu")
        out["unequal_raised"] = np.array(False)
    except RuntimeError as e:
        out["unequal_raised"] = np.array("different device counts" in str(e))
    out["traffic_bytes"] = np.array(cl.traffic["bytes"])
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


# ---- the parent: inputs, the worker pair, the references ----

def _inputs():
    """The JAX test's inputs as numpy (rendered with the JAX synth), and
    a padded BA problem."""
    import jax.numpy as jnp

    from aerial_mapper_tpu.camera.models import Camera as JCam
    from aerial_mapper_tpu.geo.se3 import matrix_to_quat
    from aerial_mapper_tpu.synth import (
        SyntheticScene,
        make_survey_poses,
        render_image,
    )
    from test_torch_ba import _padded_problem

    cam = JCam(*CAM)
    scene = SyntheticScene(base_elevation=414.0, relief_amplitude=3.0)

    def survey(n):
        Rs, ts = make_survey_poses(n, altitude=474.0, spacing=4.0)
        images = np.stack([np.asarray(render_image(
            scene, cam, jnp.asarray(R, jnp.float32),
            jnp.asarray(t, jnp.float32))) for R, t in zip(Rs, ts)])
        quats = np.asarray(matrix_to_quat(jnp.asarray(Rs, jnp.float32)))
        return np.asarray(Rs), np.asarray(ts), quats, images

    pts = np.random.RandomState(0).uniform(-20, 20, (5000, 3)) \
        .astype(np.float32)
    pts[:, 2] = 414.0
    out = {"dsm_pts": pts}
    for tag, n in (("step", 5), ("inc", 6)):
        Rs, ts, quats, images = survey(n)
        out.update({f"{tag}_Rs": Rs, f"{tag}_ts": ts, f"{tag}_quats": quats,
                    f"{tag}_images": images})
    out["inc_quats"] = out["inc_quats"].astype(np.float64)
    state0, problem, _ts_true = _padded_problem(np.random.default_rng(42), 4)
    from test_ba import CAM as BA_CAM

    out["ba_cam"] = np.array(BA_CAM[:6], np.float64)
    out.update({f"ba_state_{k}": np.asarray(getattr(state0, k))
                for k in BAState._fields})
    out.update({f"ba_prob_{k}": np.asarray(getattr(problem, k))
                for k in BAProblem._fields})
    return out


def _spawn(work, ranks, timeout):
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), work], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in ranks]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    return procs, outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's], seconds): the worker pair
    run once for the module."""
    work = str(tmp_path_factory.mktemp("dist"))
    inputs = _inputs()
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    t0 = time.perf_counter()
    procs, outs = _spawn(work, range(WORLD), WORKER_TIMEOUT_S)
    assert all(p.returncode == 0 for p in procs), "\n".join(
        o[-4000:] for o in outs)
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
             for r in range(WORLD)]
    return inputs, ranks, time.perf_counter() - t0


def _local_of(rank):
    return list(range(rank * SHARDS_PER_RANK, (rank + 1) * SHARDS_PER_RANK))


def _equal(a, b, tag):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, tag
    if a.dtype.kind == "f":  # bit for bit, NaNs included
        a, b = a.view(np.uint32 if a.itemsize == 4 else np.uint64), \
            b.view(np.uint32 if b.itemsize == 4 else np.uint64)
    np.testing.assert_array_equal(a, b, err_msg=tag)


@pytest.mark.parametrize("tag", list(COLLECTIVE_MESHES))
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_across_processes_bit_equal(run, name, tag):
    """Each rank's shards of the collective equal the one-process mesh's,
    bit for bit; another rank's entries are None."""
    _inputs_, ranks, _s = run
    shape, axes = COLLECTIVE_MESHES[tag]
    ref = collective_case(name, mesh_of(shape), axes)
    key = f"{name}@{tag}"
    for r, res in enumerate(ranks):
        if isinstance(ref, torch.Tensor):  # concat: the whole, every rank
            _equal(res[key], ref.numpy(), key)
            continue
        mine = _local_of(r)
        assert sorted(res[f"{key}#remote"].tolist()) == \
            [f for f in range(4) if f not in mine]
        for f in mine:
            _equal(res[f"{key}#{f}"], ref[f].numpy(), f"{key} shard {f}")


def test_sharded_dsm_across_processes(run):
    """Twin of ``test_two_process_distributed_dsm``: the DSM gathered on
    rank 0 (None on rank 1) and unsharded on every rank equals the
    one-process mesh bit for bit and JAX's single-device DSM at the IDW
    bars; the JAX test's coverage and mean."""
    import jax.numpy as jnp

    from aerial_mapper_tpu.config import DsmConfig as JDsm
    from aerial_mapper_tpu.dsm import update_elevation_layer as jax_update
    from aerial_mapper_tpu.mapgrid import MapGeometry as JGeom
    from aerial_mapper_tpu.mapgrid import create_map_state as jax_state

    inputs, ranks, _s = run
    _g, ref = dsm_case(mesh_of((4,), ("tiles",)), inputs)
    assert not ranks[0]["dsm_gathered_is_none"]
    assert ranks[1]["dsm_gathered_is_none"]
    assert "dsm_gathered" not in ranks[1]
    _equal(ranks[0]["dsm_gathered"], ref, "rank 0 gathered")
    for r in range(WORLD):
        _equal(ranks[r]["dsm_whole"], ref, f"rank {r} unsharded")
    pts = inputs["dsm_pts"]
    jax_ref = np.asarray(jax_update(
        dict(jax_state(JGeom(*DSM_GEOM)).layers), jnp.asarray(pts),
        jnp.ones(pts.shape[0], bool), JGeom(*DSM_GEOM),
        JDsm(**DSM_CFG))["elevation"])
    np.testing.assert_array_equal(np.isfinite(ref), np.isfinite(jax_ref))
    np.testing.assert_allclose(ref, jax_ref, rtol=1e-6, atol=1e-4,
                               equal_nan=True)
    assert np.isfinite(ref).mean() > 0.9
    assert abs(np.nanmean(ref) - 414.0) < 1e-3


def _jax_step_single(inputs):
    """The JAX single-device composition of ``test_two_process_fused_map
    _step``: pairs one per pass, DSM, backward grid."""
    import jax.numpy as jnp

    from aerial_mapper_tpu.camera.models import Camera as JCam
    from aerial_mapper_tpu.config import BlockMatchingConfig as JBM
    from aerial_mapper_tpu.config import DsmConfig as JDsm
    from aerial_mapper_tpu.config import OrthoBackwardGridConfig as JOrtho
    from aerial_mapper_tpu.dsm import update_elevation_layer as jax_update
    from aerial_mapper_tpu.mapgrid import MapGeometry as JGeom
    from aerial_mapper_tpu.mapgrid import create_map_state as jax_state
    from aerial_mapper_tpu.ortho import backward_grid_update as jax_bg
    from aerial_mapper_tpu.stereo.batched import (
        prepare_pair_operands,
        process_pairs_batched,
    )

    cam, geom = JCam(*CAM), JGeom(*STEP_GEOM)
    images = jnp.asarray(inputs["step_images"])
    pts, _i, valid = process_pairs_batched(
        prepare_pair_operands(cam.K, inputs["step_Rs"], inputs["step_ts"],
                              list(images)),
        cam, matcher="bm", bm_cfg=JBM(num_disparities=16), batch_chunk=1)
    layers = jax_update(dict(jax_state(geom).layers), pts.reshape(-1, 3),
                        valid.reshape(-1), geom, JDsm(**STEP_DSM_CFG))
    layers = jax_bg(layers, jnp.asarray(inputs["step_quats"]),
                    jnp.asarray(inputs["step_ts"], jnp.float32), images,
                    geom, cam, JOrtho(cell_chunk=256))
    return {k: np.asarray(v) for k, v in layers.items()}


@pytest.mark.parametrize("tag", list(STEP_MESHES))
def test_sharded_map_step_across_processes(run, tag):
    """Twin of ``test_two_process_fused_map_step``, on (pairs, tiles) =
    (1, 4) (tiles cross the processes) and (2, 2) (pairs cross them):
    every rank's map equals the one-process mesh bit for bit, overflow 0,
    the same routed counts, and JAX's single-device composition at the
    step bars."""
    from test_torch_incremental import assert_layers_close

    inputs, ranks, _s = run
    ref, overflow, routed = step_case(mesh_of(STEP_MESHES[tag]), inputs)
    assert overflow == 0
    for r, res in enumerate(ranks):
        for k, v in ref.items():
            _equal(res[f"step{tag}/{k}"], v, f"rank {r} {k}")
        assert int(res[f"step{tag}#overflow"]) == 0
        np.testing.assert_array_equal(res[f"step{tag}#routed"], routed)
    assert np.isfinite(ref["elevation"]).mean() > 0.3
    assert_layers_close(_jax_step_single(inputs), ref)


def test_incremental_driver_across_processes(run):
    """Twin of ``test_two_process_incremental_driver``: ``run_incremental``
    with ``auto_shard`` over 2 processes x 2 shards (``check_every=1``:
    one validation window per update, culled after the first) returns on
    every rank the map of the port's one-process sharded run and of its
    ``auto_shard=False`` run bit for bit, and JAX's single-device map at
    the layer bars; every deferred payload is host numpy on every rank and
    equals the one-process payload."""
    from unittest import mock

    from aerial_mapper_tpu.pipeline.incremental import (
        run_incremental as jax_run_incremental,
    )
    from test_torch_incremental import assert_layers_close
    from test_torch_parallel_batch import host

    inputs, ranks, _s = run
    with mock.patch.object(pmesh, "default_devices",
                           lambda device_type="cuda":
                           [torch.device(device_type)] * 4):
        ref, payloads = inc_case(inputs)
    single, _g = run_incremental(
        inc_dataset(inputs), inc_config(auto_shard=False),
        update_every_nth=2, device="cpu")
    for k, v in single.items():
        _equal(ref[k], v.numpy(), f"one-process sharded {k}")
    for r, res in enumerate(ranks):
        for k, v in ref.items():
            _equal(res[f"inc/{k}"], v, f"rank {r} {k}")
        assert sorted(k for k in res if k.endswith("#numpy")) == sorted(
            f"incpay{i}#numpy" for i in payloads)
        for i, ls in payloads.items():
            assert bool(res[f"incpay{i}#numpy"])
            for k, v in ls.items():
                _equal(res[f"incpay{i}/{k}"], v, f"rank {r} payload {i}")
    assert np.isfinite(ref["elevation"]).mean() > 0.3

    from aerial_mapper_tpu import config as jc
    from aerial_mapper_tpu.camera.models import Camera as JCam
    from aerial_mapper_tpu.camera.rig import CameraRig as JRig
    from aerial_mapper_tpu.pipeline.dataset import Dataset as JDataset

    jrig = JRig(cameras=(JCam(*CAM),),
                T_C_B_quats=np.array([[1.0, 0.0, 0.0, 0.0]]),
                T_C_B_trans=np.zeros((1, 3)))
    jds = JDataset(rig=jrig, quats_G_B=inputs["inc_quats"],
                   trans_G_B=inputs["inc_ts"],
                   images=list(inputs["inc_images"]))
    jcfg = jc.PipelineConfig(
        grid=jc.GridMapConfig(**INC_GRID),
        stereo=jc.StereoConfig(use_every_nth_image=1),
        bm=jc.BlockMatchingConfig(num_disparities=16),
        dsm=jc.DsmConfig(**STEP_DSM_CFG), auto_shard=False)
    jax_map, _g = jax_run_incremental(jds, jcfg, update_every_nth=2)
    assert_layers_close(host(jax_map), ref)


def test_sharded_bundle_adjust_across_processes(run):
    """``sharded_bundle_adjust`` with its ``obs`` axis across the two
    processes returns on every rank the one-process mesh's state, bit for
    bit."""
    inputs, ranks, _s = run
    ref = ba_case(mesh_of((4,), ("obs",)), inputs)
    for r, res in enumerate(ranks):
        for k, v in ref.items():
            _equal(res[f"ba/{k}"], v, f"rank {r} {k}")


def test_helpers_match_jax():
    """``pad_to_multiple`` and ``shard_sequence_indices`` against JAX's;
    ``process_count`` / ``process_index`` / ``is_rank0`` without a group;
    no group and no launcher environment: ``initialize_distributed`` is a
    no-op that returns False."""
    from aerial_mapper_tpu.parallel import distributed as jdist

    for n in range(0, 23):
        for k in (1, 2, 3, 4, 8):
            assert tdist.pad_to_multiple(n, k) == jdist.pad_to_multiple(n, k)
            for s in range(k):
                assert list(tdist.shard_sequence_indices(n, k, s)) == \
                    list(jdist.shard_sequence_indices(n, k, s))
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    assert tdist.is_rank0()
    assert not torch.distributed.is_initialized()
    with pytest.MonkeyPatch.context() as mp:
        for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
            mp.delenv(k, raising=False)
        assert tdist.initialize_distributed() is False
        mp.setenv("WORLD_SIZE", "1")
        assert tdist.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert pmesh.mesh_devices("cpu") == ([torch.device("cpu")], None)


def test_unequal_device_counts_raise(run):
    """Ranks whose ``default_devices`` hold 1 and 2 devices: both raise."""
    _inputs_, ranks, _s = run
    assert all(bool(res["unequal_raised"]) for res in ranks)


def test_batch_auto_shard_refused_across_processes(run):
    """Under the group the batch drivers' mesh raises instead of running
    the one-process branches."""
    _inputs_, ranks, _s = run
    assert all(bool(res["batch_refused"]) for res in ranks)


def test_band_image_operands_fills_only_the_given_tiles(run):
    """``tiles=`` (a rank's own bands): those bands equal the full cull's,
    every other band holds only padding slots, the capacity is the whole
    cull's."""
    inputs, _ranks, _s = run
    geom = MapGeometry(8.0, 0.0, 1.0, 400, 32)  # the outer bands see none
    args = (geom, 4, inputs["step_quats"], inputs["step_ts"],
            inputs["step_images"], _cam())
    kw = dict(elev_min=405.0, elev_max=425.0, device="cpu")
    full = tsh.band_image_operands(*args, **kw)
    part = tsh.band_image_operands(*args, tiles=[2, 3], **kw)
    assert (full.ids >= 0).sum(dim=1).min() < full.ids.shape[1]  # culled
    for a, b in zip(full, part):
        assert a.shape == b.shape
        assert torch.equal(a[2:], b[2:])
    assert (part.ids[:2] == -1).all() and (part.images[:2] == 0).all()
    assert (part.ts[:2, :, 2] == 1.0e9).all()


def test_exchanges_go_through_the_group(run):
    """Every rank sent blocks through the process group."""
    _inputs_, ranks, _s = run
    assert all(int(res["traffic_bytes"]) > 0 for res in ranks)


def test_rank_that_never_joins_raises_within_timeout(tmp_path):
    """Rank 0 of 2 alone: ``initialize_distributed`` raises after its
    3 s timeout instead of waiting, or going on as one process."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from aerial_mapper_tpu_torch.parallel.distributed import "
        "initialize_distributed\n"
        "t0 = time.perf_counter()\n"
        "try:\n"
        f"    initialize_distributed('file://{tmp_path}/rdv', "
        "num_processes=2, process_id=0, backend='gloo', timeout_s=3)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', time.perf_counter() - t0, str(e)[:80])\n"
        "else:\n"
        "    print('JOINED')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("RAISED"), r.stdout + r.stderr
    assert float(r.stdout.split()[1]) < 60.0


def test_address_needs_process_count_and_id():
    with pytest.raises(ValueError, match="num_processes"):
        tdist.initialize_distributed("localhost:1", backend="gloo")
    assert not torch.distributed.is_initialized()


def test_default_backend_needs_cuda(tmp_path, monkeypatch):
    """``backend=None`` is NCCL: without CUDA it raises before any
    rendezvous instead of going on over Gloo on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.initialize_distributed(f"file://{tmp_path}/rdv",
                                     num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()


def test_all_to_all_rejects_an_uneven_split():
    """A length that does not split into one block per member raises."""
    mesh = mesh_of((1, 4))
    xs = [torch.zeros(6) for _ in range(4)]
    with pytest.raises(ValueError, match="does not split into 4 blocks"):
        cl.all_to_all(mesh, xs, "tiles")


def test_mesh_processes_checked():
    """A mesh across processes needs a group and one rank per device."""
    with pytest.raises(RuntimeError, match="no torch.distributed group"):
        mesh_of((4,), ("tiles",), processes=[0, 0, 1, 1])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
