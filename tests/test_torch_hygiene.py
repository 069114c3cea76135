"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import os
import subprocess
import sys

import pytest
import torch

from aerial_mapper_tpu_torch import resolve_device

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import aerial_mapper_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "aerial_mapper_tpu"
             or m.startswith("aerial_mapper_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
for name in ("aerial_mapper_tpu_torch.native",
             "aerial_mapper_tpu_torch.io.native_loader",
             "aerial_mapper_tpu_torch.pipeline.incremental",
             "aerial_mapper_tpu_torch.parallel.distributed"):
    assert name in names, name
assert "torch.distributed" in sys.modules
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_imports_without_yaml_and_pil():
    """Every port module (and chip_smoke.py's imports) loads without
    PyYAML and Pillow: the rig YAML and PGM/PPM frames need neither, and
    only a JPEG or PNG file (the report, the preview) needs Pillow
    (``tests/test_torch_io_formats.py`` reads and writes a dataset with
    both blocked)."""
    blocked = 'import sys\nsys.modules["yaml"] = None\n' \
        'sys.modules["PIL"] = None\n'
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", blocked + _IMPORT_ALL],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "aerial_mapper_tpu." not in src


def test_bench_torch_imports_no_jax():
    """``bench_torch.py``, the port's benchmark, and the tools that run it
    name no JAX in their source; the benchmark, imported and building its
    workload at a tiny size, loads neither JAX nor the JAX package."""
    for name in ("bench_torch.py", "tools/bench_controls.py",
                 "tools/bench_spread.py"):
        with open(os.path.join(ROOT, name)) as f:
            src = f.read()
        assert "import jax" not in src and "aerial_mapper_tpu." not in src, \
            name
    code = (
        "import sys, torch, bench_torch as bt\n"
        "cam, scene = bt.bench_camera_scene(32, 24)\n"
        "Rs, ts = bt.bench_poses(4)\n"
        "bt.render_frames(cam, scene, Rs, ts, torch.device('cpu'))\n"
        "bt.stream_config(*bt.bench_configs())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'aerial_mapper_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_four_card_smoke_needs_four_cards():
    """``tools/four_card_smoke.py`` names no JAX in its source, and where
    fewer than four cards are visible it exits 2 and prints no result."""
    path = os.path.join(ROOT, "tools", "four_card_smoke.py")
    with open(path) as f:
        src = f.read()
    assert "import jax" not in src and "aerial_mapper_tpu." not in src
    if torch.cuda.is_available() and torch.cuda.device_count() == 4:
        pytest.skip("four cards are present: the script runs on them")
    r = subprocess.run([sys.executable, path], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2, r.stderr
    assert r.stdout == ""


def test_entry_point_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    from aerial_mapper_tpu_torch.pipeline.step import map_step

    with pytest.raises(RuntimeError, match="CUDA"):
        map_step({}, None, None, None, None, None, None, None, None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    from aerial_mapper_tpu_torch.pipeline.incremental import run_incremental
    from aerial_mapper_tpu_torch.utils.timing import StageTimer

    with pytest.raises(RuntimeError, match="CUDA"):
        run_incremental(None, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        StageTimer()
    assert resolve_device("cpu") == torch.device("cpu")
