#!/usr/bin/env python3
"""Time one checkout's score kernel (``csrc/score.cu``) on one NVIDIA GPU at
``chip_smoke.py``'s bench and survey shapes, for A/B runs across commits.

    python3 tools/score_ab.py [TREE]

TREE (default: this checkout) is the root of a checkout whose
``aerial_mapper_tpu_torch`` is imported and whose kernels are built; the
inputs always come from this checkout's ``chip_smoke.py``, so two trees
are timed on the same cells and cameras. ``grid_shape`` is passed where the
tree's ``score_pass_cuda`` takes it. Prints one JSON line per shape: the
events' time of one call (``ms``) and the kernel alone (``device_ms``,
torch.profiler), with a digest of the outputs (equal digests: equal
results). Without CUDA it exits 2.
"""

import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    if not torch.cuda.is_available():
        print("score_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from aerial_mapper_tpu_torch import _build
    from aerial_mapper_tpu_torch.ortho.cuda_score import score_pass_cuda

    _build.load()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    takes_grid = "grid_shape" in inspect.signature(score_pass_cuda).parameters
    cam, scene = smoke.bench_camera_scene()
    shapes = (("bench", smoke.bench_poses, smoke.MAP_CELLS, 20),
              ("survey", smoke.survey_poses, smoke.SURVEY_CELLS, 10))
    for tag, poses, side, reps in shapes:
        cells, bank, grid_shape = smoke.score_input(scene, *poses(), side, dev)
        kw = dict(grid_shape=grid_shape) if takes_grid else {}

        def call():
            return score_pass_cuda(cells, bank, cam, **kw)

        digest = hashlib.sha256()
        for t in call():
            digest.update(t.cpu().numpy().tobytes())
        print(json.dumps(dict(
            tree=tree, shape=tag, cells=cells.shape[0],
            cameras=bank.shape[0], grid_shape=takes_grid,
            ms=smoke.cuda_ms(call, reps=reps),
            device_ms=smoke.device_ms(call, "score_kernel", reps=reps),
            digest=digest.hexdigest()[:16], smi=smi)), flush=True)
        del cells, bank
    return 0


if __name__ == "__main__":
    sys.exit(main())
