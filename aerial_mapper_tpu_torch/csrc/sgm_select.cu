// SGM's post-filters on the aggregated [B, H, W, D] float32 volume, read in
// place (D innermost, no relayout): winner-take-all with the sub-pixel step,
// the uniqueness test and the left-right check.
//
// Replaces no Pallas kernel: the JAX package runs these as XLA reductions
// (stereo/matching.py::_wta_subpixel, _uniqueness_mask,
// _lr_consistency_mask), which the port first ran as PyTorch ops over
// strided views of the volume, each materialising volume-sized temporaries.
// Plain versions: those functions themselves, on the volume's [..., D, H, W]
// view (stereo/matching.py::sgm_wta_plain, sgm_uniqueness_plain,
// sgm_lr_check_plain); the kernels are bit-equal to them on finite volumes.
//
//   wta:        best = the first d of the minimum (torch.argmin's rule),
//               c0 = that minimum, cm / cp = cost at best -+ 1 (clamped),
//               denom = (cm - 2 c0) + cp,
//               delta = |denom| > 1e-9 ? (cm - cp) / (2 denom) : 0, clamped
//               to [-0.5, 0.5] and 0 at best = 0 or D-1,
//               disp = (best + delta) + min_disp;
//   uniqueness: runner = min(1e9, min over |d - best| > 1 of cost);
//               valid = runner > c0 * factor, factor = float32(1 + ratio /
//               100) (every pixel valid where ratio < 0);
//   lr check:   colmin(v, x) = min over d of cost[v, x + min_disp + d, d],
//               1e9 where that column is past the image (the padded right
//               view's entries take part in the min); pixel (v, u) with
//               u_r = u - min_disp - best passes iff u_r >= 0 and, for some
//               |off| <= max_diff with best + off in [0, D) and u + off in
//               [0, W), cost[v, u + off, best + off] == colmin(v, u_r).
// The sub-pixel step is __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so
// nvcc cannot contract it into FMAs; min and compares are exact in any
// order.
//
// What bounds them on the H100: bytes. Each kernel reads the volume at most
// once (4 x B x H x W x D bytes) and writes per-pixel outputs. The design:
// in wta and uniqueness a warp takes 4 neighbouring pixels, each pixel's D
// contiguous values across the lanes (d = lane + 32 j, so each load is 128
// coalesced bytes), issues all of their loads before it reduces any (the
// loads of a warp overlap), reduces each pixel with __reduce_min_sync on
// order-keeping keys (the minimum, then the first d that holds it; the
// values at best -+ 1 come by shuffles from the lanes' registers) and writes
// the 4 pixels' results from 4 lanes at once. The lr check gives each image
// row one block and reads the row's contiguous W x D run once, 16 coalesced
// bytes a thread (skipping the float4s whose entries all lie left of the
// right view); each entry (w, d) it reads goes by a shared-memory atomicMin
// on its order-keeping key into the minimum of its right-view column
// x = w - min_disp - d, and, where d = best[w - off] + off for some
// |off| <= max_diff (the row's best staged in shared memory), into the
// minimum of pixel w - off's candidates. Every candidate of pixel u lies on
// the diagonal of its column u_r, so some candidate equals colmin(u_r) iff
// their minimum does: after one barrier each pixel compares two keys, with
// no second read of the volume. The keys of -0 and +0 are made equal (a
// float compare calls them equal). The row's three [W] arrays take 12 bytes
// a column of dynamic shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;            // warps per block (wta, uniqueness)
constexpr int PPW = 4;              // pixels per warp (wta, uniqueness)
constexpr int MAX_CHUNKS = 8;       // D <= 256 (wta, uniqueness)
constexpr int LR_THREADS = 256;     // threads per image row (lr check)
constexpr size_t LR_SMEM_MAX = 227 * 1024;  // the lr check's [3][W] keys
constexpr float BIG = 1.0e9f;       // matching.py's _BIG
constexpr unsigned FULL = 0xffffffffu;

// floats as unsigned keys in the same order (negatives below positives), so
// that one __reduce_min_sync takes a warp's minimum
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

__device__ __forceinline__ float warp_min(float v) {
  return key_float(__reduce_min_sync(FULL, order_key(v)));
}

// the warp's PPW pixels' D-vectors, d = 32 j + lane in x[i][j], all loads
// issued before any is used
template <int NCH>
__device__ __forceinline__ void load_pixels(const float* cost, long long p0,
                                            long long npix, int D, int lane,
                                            float (&x)[PPW][NCH]) {
#pragma unroll
  for (int i = 0; i < PPW; ++i)
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int d = 32 * j + lane;
      x[i][j] = p0 + i < npix && d < D ? cost[(p0 + i) * D + d] : 0.0f;
    }
}

template <int NCH>
__global__ void __launch_bounds__(WARPS * 32)
sgm_wta_kernel(const float* __restrict__ cost, float* __restrict__ disp,
               float* __restrict__ c0_out, long long* __restrict__ best_out,
               long long npix, int D, int min_disp) {
  const int lane = threadIdx.x & 31;
  const long long p0 =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * PPW;
  if (p0 >= npix) return;  // the whole warp leaves together
  float x[PPW][NCH];
  load_pixels<NCH>(cost, p0, npix, D, lane, x);
  float disp_i = 0.0f, c0_i = 0.0f;  // lane i keeps pixel i's results
  int best_i = 0;
#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    // the warp's minimum, then the first d that holds it
    unsigned key = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      if (32 * j + lane < D) key = min(key, order_key(x[i][j]));
    const float v = key_float(__reduce_min_sync(FULL, key));
    unsigned first = 0xffffffffu;
#pragma unroll
    for (int j = NCH - 1; j >= 0; --j)
      if (32 * j + lane < D && x[i][j] == v) first = 32 * j + lane;
    const int idx = (int)__reduce_min_sync(FULL, first);
    // cost at best -+ 1 (clamped), from the registers of the lanes that
    // hold them
    const int dm = idx > 0 ? idx - 1 : 0;
    const int dp = idx < D - 1 ? idx + 1 : D - 1;
    float xm = 0.0f, xp = 0.0f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (j == dm >> 5) xm = x[i][j];
      if (j == dp >> 5) xp = x[i][j];
    }
    const float cm = __shfl_sync(FULL, xm, dm & 31);
    const float cp = __shfl_sync(FULL, xp, dp & 31);
    const float denom = __fadd_rn(__fsub_rn(cm, __fmul_rn(2.0f, v)), cp);
    float delta = 0.0f;
    if (fabsf(denom) > 1e-9f)
      delta = __fdiv_rn(__fsub_rn(cm, cp), __fmul_rn(2.0f, denom));
    delta = fminf(fmaxf(delta, -0.5f), 0.5f);
    const bool interior = idx > 0 && idx < D - 1;
    if (lane == i) {
      disp_i = __fadd_rn(__fadd_rn((float)idx, interior ? delta : 0.0f),
                         (float)min_disp);
      c0_i = v;
      best_i = idx;
    }
  }
  if (lane < PPW && p0 + lane < npix) {
    disp[p0 + lane] = disp_i;
    c0_out[p0 + lane] = c0_i;
    best_out[p0 + lane] = best_i;
  }
}

template <int NCH>
__global__ void __launch_bounds__(WARPS * 32)
sgm_uniqueness_kernel(const float* __restrict__ cost,
                      const long long* __restrict__ best,
                      const float* __restrict__ c0,
                      unsigned char* __restrict__ valid, long long npix,
                      int D, int off, float factor) {
  const int lane = threadIdx.x & 31;
  const long long p0 =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * PPW;
  if (p0 >= npix) return;
  const bool mine = lane < PPW && p0 + lane < npix;
  if (off) {  // ratio < 0: the test is disabled
    if (mine) valid[p0 + lane] = 1;
    return;
  }
  float x[PPW][NCH];
  load_pixels<NCH>(cost, p0, npix, D, lane, x);
  long long b[PPW];
#pragma unroll
  for (int i = 0; i < PPW; ++i) b[i] = p0 + i < npix ? best[p0 + i] : 0;
  bool ok = false;  // lane i keeps pixel i's
#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    float runner = BIG;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int d = 32 * j + lane;
      if (d < D && (d - b[i] > 1 || b[i] - d > 1))
        runner = fminf(runner, x[i][j]);
    }
    runner = warp_min(runner);
    if (lane == i && p0 + i < npix)
      ok = runner > __fmul_rn(c0[p0 + i], factor);
  }
  if (mine) valid[p0 + lane] = ok ? 1 : 0;
}

// the key of a cost entry: -0 as +0, so that equal floats have equal keys
__device__ __forceinline__ unsigned entry_key(float f) {
  return order_key(__fadd_rn(f, 0.0f));
}

// entry (w, d) of the row with key k: into its right-view column's minimum
// and, where it is a candidate of pixel w - off, into that pixel's
__device__ __forceinline__ void lr_visit(unsigned* colmin, unsigned* candmin,
                                         const int* bst, int w, int d,
                                         unsigned k, int W, int min_disp,
                                         int max_diff) {
  const int x = w - min_disp - d;
  if (x >= 0) atomicMin(&colmin[x], k);
  for (int off = -max_diff; off <= max_diff; ++off) {
    const int u = w - off;
    if (u >= 0 && u < W && bst[u] + off == d) atomicMin(&candmin[u], k);
  }
}

__global__ void __launch_bounds__(LR_THREADS)
sgm_lr_kernel(const float* __restrict__ cost,
              const long long* __restrict__ best,
              unsigned char* __restrict__ valid, int W, int D, int min_disp,
              int max_diff, int vec) {
  extern __shared__ unsigned lr_smem[];
  unsigned* colmin = lr_smem;                           // [W] keys
  unsigned* candmin = lr_smem + W;                      // [W] keys
  int* bst = reinterpret_cast<int*>(lr_smem + 2 * W);   // [W] best
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;  // b * H + v
  const float* c = cost + row * W * D;
  const unsigned pad_key = order_key(BIG);  // the padded right view
  const unsigned inf_key = order_key(__int_as_float(0x7f800000));
  for (int x = tid; x < W; x += LR_THREADS) {
    colmin[x] = x + min_disp + D - 1 >= W ? pad_key : inf_key;
    candmin[x] = 0xffffffffu;  // no candidate: above every column minimum
    bst[x] = (int)best[row * W + x];
  }
  __syncthreads();
  if (vec) {
    // D % 4 == 0 and the row 16-byte aligned: the 4 entries of a float4
    // share w, and the first has the largest x; 4 float4s in flight
    constexpr int U = 4;
    const int n4 = W * D / 4;
    const float4* c4 = reinterpret_cast<const float4*>(c);
    int w = 4 * tid / D, d = 4 * tid % D;
    const int sw = 4 * LR_THREADS / D, sd = 4 * LR_THREADS % D;
    for (int i0 = tid; i0 < n4; i0 += U * LR_THREADS) {
      float4 v[U];
      int ws[U], ds[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        ws[k] = w;
        ds[k] = d;
        const bool need = i0 + k * LR_THREADS < n4 && w - min_disp - d >= 0;
        v[k] = need ? __ldg(c4 + i0 + k * LR_THREADS)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        w += sw;
        d += sd;
        if (d >= D) {
          d -= D;
          ++w;
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (i0 + k * LR_THREADS >= n4 || ws[k] - min_disp - ds[k] < 0)
          continue;
        const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          lr_visit(colmin, candmin, bst, ws[k], ds[k] + j, entry_key(e[j]),
                   W, min_disp, max_diff);
      }
    }
  } else {
    const int n = W * D;
    int w = tid / D, d = tid % D;
    const int sw = LR_THREADS / D, sd = LR_THREADS % D;
    for (int i = tid; i < n; i += LR_THREADS) {
      if (w - min_disp - d >= 0)
        lr_visit(colmin, candmin, bst, w, d, entry_key(__ldg(c + i)), W,
                 min_disp, max_diff);
      w += sw;
      d += sd;
      if (d >= D) {
        d -= D;
        ++w;
      }
    }
  }
  __syncthreads();
  for (int u = tid; u < W; u += LR_THREADS) {
    const int u_r = u - min_disp - bst[u];
    valid[row * W + u] = u_r >= 0 && candmin[u] == colmin[u_r] ? 1 : 0;
  }
}

template <int NCH>
cudaError_t launch_wta(const float* cost, float* disp, float* c0,
                       long long* best, long long npix, int D, int min_disp,
                       cudaStream_t stream, unsigned blocks) {
  sgm_wta_kernel<NCH><<<blocks, WARPS * 32, 0, stream>>>(
      cost, disp, c0, best, npix, D, min_disp);
  return cudaGetLastError();
}

template <int NCH>
cudaError_t launch_uniqueness(const float* cost, const long long* best,
                              const float* c0, unsigned char* valid,
                              long long npix, int D, int off, float factor,
                              cudaStream_t stream, unsigned blocks) {
  sgm_uniqueness_kernel<NCH><<<blocks, WARPS * 32, 0, stream>>>(
      cost, best, c0, valid, npix, D, off, factor);
  return cudaGetLastError();
}

// blocks of WARPS warps of PPW pixels, or 0 where the launch is refused
unsigned pixel_blocks(long long npix, int D) {
  if (D < 1 || D > 32 * MAX_CHUNKS || npix < 1) return 0;
  const long long blocks = (npix + WARPS * PPW - 1) / (WARPS * PPW);
  return blocks > 0x7fffffffLL ? 0 : (unsigned)blocks;
}

}  // namespace

extern "C" int amt_sgm_wta_launch(const float* cost, float* disp, float* c0,
                                  long long* best, long long npix, int D,
                                  int min_disp, void* stream) {
  const unsigned n = pixel_blocks(npix, D);
  if (n == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define WTA(NCH) launch_wta<NCH>(cost, disp, c0, best, npix, D, min_disp, s, n)
  switch ((D + 31) / 32) {
    case 1: return (int)WTA(1);
    case 2: return (int)WTA(2);
    case 3: return (int)WTA(3);
    case 4: return (int)WTA(4);
    case 5: return (int)WTA(5);
    case 6: return (int)WTA(6);
    case 7: return (int)WTA(7);
    default: return (int)WTA(8);
  }
#undef WTA
}

extern "C" int amt_sgm_uniqueness_launch(const float* cost,
                                         const long long* best,
                                         const float* c0,
                                         unsigned char* valid, long long npix,
                                         int D, int off, float factor,
                                         void* stream) {
  const unsigned n = pixel_blocks(npix, D);
  if (n == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define UNIQ(NCH) \
  launch_uniqueness<NCH>(cost, best, c0, valid, npix, D, off, factor, s, n)
  switch ((D + 31) / 32) {
    case 1: return (int)UNIQ(1);
    case 2: return (int)UNIQ(2);
    case 3: return (int)UNIQ(3);
    case 4: return (int)UNIQ(4);
    case 5: return (int)UNIQ(5);
    case 6: return (int)UNIQ(6);
    case 7: return (int)UNIQ(7);
    default: return (int)UNIQ(8);
  }
#undef UNIQ
}

extern "C" int amt_sgm_lr_launch(const float* cost, const long long* best,
                                 unsigned char* valid, int rows, int W, int D,
                                 int min_disp, int max_diff, void* stream) {
  const size_t smem = (size_t)W * 3 * sizeof(unsigned);
  if (D < 1 || rows < 1 || W < 1 || min_disp < 0 || max_diff < 0 ||
      smem > LR_SMEM_MAX || (long long)W * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int vec = D % 4 == 0 && ((uintptr_t)cost & 15) == 0;
  cudaError_t err = cudaFuncSetAttribute(
      sgm_lr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgm_lr_kernel<<<rows, LR_THREADS, smem, (cudaStream_t)stream>>>(
      cost, best, valid, W, D, min_disp, max_diff, vec);
  return (int)cudaGetLastError();
}
