#!/usr/bin/env python3
"""Check on the card that ``csrc/sgm_cost.cu``'s division by K^2 rounds like
the IEEE divide ``__fdiv_rn`` for every float32 input: ``div_run<K>``, a
product by the rounded reciprocal and one FMA residual step where a run's
sums lie in its range, ``__fdiv_rn`` elsewhere.

    python3 tools/sgm_div_check.py

For each window K = 2 .. 15 (the kernel's instantiations that divide) it
runs ``div_run<K>`` on a run of copies of x, and ``div_k2<K>`` alone where
the kernel takes it without a test (x = +0 or in [2^-98, 2^118), the window
sums of safe staged image values), and compares each quotient with
``__fdiv_rn(x, K * K)`` bit for bit on all 2^32 float32 bit patterns (two
NaNs count as equal), and prints one JSON line per K with the patterns that
differ. Exits 1 if any differs. Builds
its check kernel with ``nvcc`` (which includes the kernel's source, so the
check reads the division the kernel compiles) into a temporary directory;
needs one CUDA card.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "aerial_mapper_tpu_torch", "csrc", "sgm_cost.cu")

CHECK = r"""
#include "%s"
#include <cstdio>

namespace {
template <int K>
__global__ void div_check(unsigned long long* bad) {
  const unsigned long long n = 1ull << 32;
  unsigned long long mine = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)i);
    float v[RUN];
    for (int j = 0; j < RUN; ++j) v[j] = x;
    div_run<K>(v);
    const float a = v[0];
    const float b = __fdiv_rn(x, (float)(K * K));
    const bool same = __float_as_uint(a) == __float_as_uint(b) ||
                      (a != a && b != b);
    // div_k2 alone where the kernel takes it unchecked: +0 and [2^-98,
    // 2^118), the window sums of safe staged values
    const unsigned u = (unsigned)i;
    const bool safe_sum = u == 0 || (u >= 0x0E800000u && u < 0x7A800000u);
    const float f = div_k2<K>(x);
    const bool fast_same = !safe_sum || __float_as_uint(f) == __float_as_uint(b);
    mine += same && fast_same ? 0 : 1;
  }
  if (mine) atomicAdd(bad, mine);
}

template <int K>
int run(unsigned long long* bad) {
  div_check<K><<<132 * 16, 256>>>(bad);
  return (int)cudaDeviceSynchronize();
}
}  // namespace

extern "C" int check_k(int k, unsigned long long* out) {
  unsigned long long* bad;
  if (cudaMalloc(&bad, sizeof(*bad)) != cudaSuccess) return -1;
  cudaMemset(bad, 0, sizeof(*bad));
  int err;
  switch (k) {
    case 2: err = run<2>(bad); break;
    case 3: err = run<3>(bad); break;
    case 4: err = run<4>(bad); break;
    case 5: err = run<5>(bad); break;
    case 6: err = run<6>(bad); break;
    case 7: err = run<7>(bad); break;
    case 8: err = run<8>(bad); break;
    case 9: err = run<9>(bad); break;
    case 10: err = run<10>(bad); break;
    case 11: err = run<11>(bad); break;
    case 12: err = run<12>(bad); break;
    case 13: err = run<13>(bad); break;
    case 14: err = run<14>(bad); break;
    case 15: err = run<15>(bad); break;
    default: err = -2;
  }
  cudaMemcpy(out, bad, sizeof(*bad), cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return err;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "div_check.cu")
        lib = os.path.join(tmp, "libdiv_check.so")
        with open(src, "w") as f:
            f.write(CHECK % SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                        src, "-o", lib], check=True)
        fn = ctypes.CDLL(lib).check_k
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        failed = False
        for k in range(2, 16):
            bad = ctypes.c_ulonglong(0)
            err = fn(k, ctypes.byref(bad))
            print(json.dumps({"K": k, "divisor": k * k, "patterns": 2 ** 32,
                              "differ": bad.value, "cuda_error": err}),
                  flush=True)
            failed |= err != 0 or bad.value != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
