#!/usr/bin/env python3
"""Time variants of SGM's cost kernel at the SGBM step's shape, to find what
holds it: each variant is the kernel's source with a few text edits, built
by its own ``nvcc`` into a temporary directory and launched through its C
entry ``amt_sgm_cost_launch`` on one CUDA card. No variant is part of the
package; most are deliberately wrong and only timed.

    python3 tools/sgm_cost_variants.py [--source FILE] [--variants A,B,...]
                                       [--shapes D/MIN_DISP/K,...]

``--source`` is a ``sgm_cost.cu`` (default: the package's); ``base`` is the
source unchanged. Variants of the package's kernel: ``no_store`` (no bulk
store), ``no_compute`` (no vertical or horizontal step: staging, barriers
and stores alone), ``no_horizontal``, ``no_bt`` (the right interval read as
the left one), ``no_vertical_sums`` and ``no_barrier``. Variants of the
kernel this one replaced (pass its source, e.g. ``git show
<commit>:aerial_mapper_tpu_torch/csrc/sgm_cost.cu``): ``old_no_divide`` (a
product for ``__fdiv_rn``), ``old_one_vsum_read`` (each output reads one
vertical sum and adds it K - 1 times) and ``old_unrolled`` (the row loop
unrolled by K, the ring slots renamed). Images are x-Sobel noise of 35
pairs of 480 x 752 (seed 0); each line of output is one JSON object with
the variant, the shape, whether the volume equals the plain version's
(``sgm_cost_volume_plain``), and its time from CUDA events and from
``torch.profiler`` (``chip_smoke.cuda_ms`` / ``device_ms``), beside the
card's name and power limit. Needs one CUDA card and ``nvcc``.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = os.path.join(ROOT, "aerial_mapper_tpu_torch", "csrc", "sgm_cost.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared")

_BARRIER = """                   : "memory");
    unsafe |= __syncthreads_or(unsafe_staged);"""
_OLD_RING = """#pragma unroll
        for (int i = 0; i < K - 1; ++i) ring[j][i] = ring[j][i + 1];
        ring[j][K - 1] = fminf(d_lr, d_rl);
        if (ready) {
          float v = ring[j][0];
#pragma unroll
          for (int i = 1; i < K; ++i) v = __fadd_rn(v, ring[j][i]);"""
_OLD_TAIL = """    // no barrier here: the next row's staging writes only l_* and r_*,
    // which every thread finished reading before the barrier above, and
    // the barrier after that staging keeps its vsum writes behind these
    // reads
  }
}"""
# name: [(text, replacement[, count]), ...]: each text found count times
# (once by default), every match replaced
VARIANTS = {
    "base": [],
    "no_store": [(
        "if (tid == 0) bulk_store(gp, sv, (unsigned)seg_n * 4u);",
        "if (tid == 0 && seg_n < 0) bulk_store(gp, sv, (unsigned)seg_n * 4u);",
    )],
    "no_compute": [
        ("    if (t < nrows)\n      vertical<K, E, 0>",
         "    if (t < 0)\n      vertical<K, E, 0>"),
        ("      for (int r = tid; r < nruns; r += NT) {",
         "      for (int r = tid; r < 0; r += NT) {"),
    ],
    "no_horizontal": [("      for (int r = tid; r < nruns; r += NT) {",
                       "      for (int r = tid; r < 0; r += NT) {")],
    "no_bt": [("cur[rbase - j * G]", "L", 2)],
    "no_vertical_sums": [(
        "          for (int i = 1; i < K; ++i)\n"
        "            v = __fadd_rn(v, ring[j][(U + 1 + i) % K]);\n", "", 2)],
    "no_barrier": [(_BARRIER, _BARRIER.replace(
        "unsafe |= __syncthreads_or(unsafe_staged);",
        "unsafe |= unsafe_staged;"))],
    "old_no_divide": [(
        "if (K > 1) v = __fdiv_rn(v, (float)(K * K));",
        "if (K > 1) v = __fmul_rn(v, 1.0f / (float)(K * K));",
    )],
    "old_one_vsum_read": [(
        "          float v = vsum[o][lane];\n#pragma unroll\n"
        "          for (int i = 1; i < K; ++i) v = __fadd_rn(v, "
        "vsum[o + i][lane]);",
        "          const float x = vsum[o][lane];\n          float v = x;\n"
        "#pragma unroll\n"
        "          for (int i = 1; i < K; ++i) v = __fadd_rn(v, x);",
    )],
    "old_unrolled": [
        ("  for (int t = 0; t < nrows; ++t) {\n",
         "  for (int t0 = 0; t0 < nrows; t0 += K) {\n#pragma unroll\n"
         "  for (int u = 0; u < K; ++u) {\n    const int t = t0 + u;\n"
         "    if (t >= nrows) break;\n"),
        (_OLD_RING, _OLD_RING.replace(
            "#pragma unroll\n        for (int i = 0; i < K - 1; ++i) "
            "ring[j][i] = ring[j][i + 1];\n        ring[j][K - 1] = ",
            "        ring[j][u] = ").replace(
            "float v = ring[j][0];", "float v = ring[j][(u + 1) % K];").replace(
            "v = __fadd_rn(v, ring[j][i]);",
            "v = __fadd_rn(v, ring[j][(u + 1 + i) % K]);")),
        (_OLD_TAIL, "  }\n  }\n}"),
    ],
}


def variant_source(src: str, name: str) -> str:
    for text, new, *count in VARIANTS[name]:
        if src.count(text) != (count[0] if count else 1):
            raise SystemExit(f"variant {name}: its edit does not apply to "
                             f"this source ({src.count(text)} matches)")
        src = src.replace(text, new)
    return src


def build(names, src, tmp):
    """{name: the variant's launcher}, all nvcc processes at once."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name in names:
        cu = os.path.join(tmp, name + ".cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, name))
        so = os.path.join(tmp, name + ".so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *FLAGS, cu, "-o", so], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "sgm_cost_kernelILi9E" in line:
                used = [x.strip() for x in lines[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                print(json.dumps({"variant": name, "K": 9, "ptxas": used}),
                      flush=True)
        fn = ctypes.CDLL(so).amt_sgm_cost_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=SOURCE)
    ap.add_argument("--variants", default="base")
    ap.add_argument("--shapes", default="80/1/9",
                    help="D/min_disp/K of each timed volume")
    args = ap.parse_args()
    import torch

    from chip_smoke import cuda_ms, device_ms
    from aerial_mapper_tpu_torch.stereo import matching as tm

    if not torch.cuda.is_available():
        print("sgm_cost_variants: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    with open(args.source) as f:
        src = f.read()
    names = args.variants.split(",")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(names, src, tmp)
        g = torch.Generator(device=dev).manual_seed(0)
        b, h, w = 35, 480, 752
        left = torch.rand((b, h, w), generator=g, device=dev) * 255
        right = torch.roll(left, -6, dims=-1) + torch.rand(
            (b, h, w), generator=g, device=dev) * 4
        lf = tm._xsobel_prefilter(left, 35.0)
        rf = tm._xsobel_prefilter(right, 35.0)
        stream = torch.cuda.current_stream().cuda_stream
        for shape in args.shapes.split(","):
            d, md, k = (int(x) for x in shape.split("/"))
            ref = tm.sgm_cost_volume_plain(lf, rf, d, md, k)
            out = torch.empty_like(ref)
            for name, fn in fns.items():
                def run():
                    err = fn(lf.data_ptr(), rf.data_ptr(), out.data_ptr(), b,
                             h, w, d, md, k, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                run()
                torch.cuda.synchronize()
                print(json.dumps({
                    "variant": name, "D": d, "min_disp": md, "K": k,
                    "equal": bool(torch.equal(out, ref)),
                    "ms": cuda_ms(run, reps=10),
                    "device_ms": device_ms(run, "sgm_cost", reps=5),
                    "card": card}), flush=True)
            del ref, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
