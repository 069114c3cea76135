#!/usr/bin/env python3
"""Time one checkout's two BM entries (``csrc/bm.cu``) on one NVIDIA GPU at
``chip_smoke.py``'s bench shape, for A/B runs across commits.

    python3 tools/bm_ab.py [TREE]

The inputs are this checkout's: the 35 rectified bench pairs of
``chip_smoke.build_workload`` (752x480, 80 disparities), prefiltered with
the integer-cost quantization and without it, built with this checkout's
package before TREE (default: this checkout) is imported and its kernels
built, so two trees are timed on the same bytes. The integer entry runs at
block 15 (its guard admits blocks up to 21 at the default cap), the float
entry at blocks 15 and 25. Prints one JSON line per case: the events' time
of one call (``ms``), the kernel alone (``device_ms``, torch.profiler) and
a digest of the five maps (equal digests: equal results). Without CUDA it
exits 2.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "aerial_mapper_tpu_torch"
# (entry, block): the integer entry at the bench block, the float entry at
# the bench block and at 25, where the integer guard sends the default cap
CASES = (("int", 15), ("float", 15), ("float", 25))


def bench_inputs(smoke, dev):
    """This checkout's bench pairs, prefiltered both ways, on ``dev``, and
    the config's first disparity."""
    from aerial_mapper_tpu_torch.config import BlockMatchingConfig
    from aerial_mapper_tpu_torch.stereo.cuda_bm import prefilter_pair
    from aerial_mapper_tpu_torch.stereo.rectify import _rectify_image

    ops = smoke.build_workload(dev)["ops"]
    rect1 = _rectify_image(ops.image1, ops.T1_inv)
    rect2 = _rectify_image(ops.image2, ops.T2_inv)
    out = {}
    for entry, integer_costs in (("int", True), ("float", False)):
        cfg = BlockMatchingConfig(num_disparities=smoke.NUM_DISP,
                                  kernel="pallas",
                                  integer_costs=integer_costs)
        out[entry] = prefilter_pair(rect1, rect2, cfg)
    torch.cuda.synchronize()
    return out, cfg.min_disparity


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    if not torch.cuda.is_available():
        print("bm_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    inputs, min_disp = bench_inputs(smoke, dev)
    # from here on the package is TREE's
    for name in [m for m in sys.modules
                 if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, tree)
    from aerial_mapper_tpu_torch import _build
    from aerial_mapper_tpu_torch.stereo.cuda_bm import bm_scan

    _build.load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for entry, block in CASES:
        lf, rf = inputs[entry]

        def call():
            return bm_scan(lf, rf, smoke.NUM_DISP, min_disp, block,
                           integer_costs=entry == "int")

        digest = hashlib.sha256()
        for t in call():
            digest.update(t.cpu().numpy().tobytes())
        print(json.dumps(dict(
            tree=tree, entry=entry, block=block, shape=list(lf.shape),
            ms=smoke.cuda_ms(call, reps=10),
            device_ms=smoke.device_ms(call, f"bm_scan_{entry}_kernel",
                                      reps=10),
            digest=digest.hexdigest()[:16], smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
