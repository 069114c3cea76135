// Grid-binned inverse-distance-weighted rasterization: the windowed pass.
//
// Replaces the Pallas kernel aerial_mapper_tpu/dsm/pallas_idw.py::_idw_kernel
// (wrapper binned_idw_pallas). Inputs are the K-slot binned arrays de / dn /
// payload [K, H, W] (each point's offset from its owning cell's center, and
// its value), the per-cell point count [H, W] and the static circular window
// offset list [M, 2]. Per output cell: pass 1 takes the nearest squared
// distance over the window and turns it into an effective radius with the
// closed-form adaptive ladder; pass 2 sums 1/d^2 weights strictly inside
// that radius, with the exact-match shortcut (d^2 <= 1e-12: the first
// offset, then the first slot, wins).
//
// What bounds it on the H100: instructions. The inputs are ~17 MB at bench
// scale (K = 8, 414 x 414 cells, M = 109 offsets) and fit the 50 MB L2, but
// each occupied slot is visited once per window offset in each pass, ~8
// instructions in pass 1 and ~28 in pass 2 (1/d^2 and the weighted sums).
// One thread per cell (the first design) ran each cell as one long chain
// with ~41 warps per SM. This design:
//  - splits each cell's window across G = 8 consecutive lanes of a warp
//    (4 cells per warp, 32 cells of one map row per block). In round t,
//    lane g takes offset t * G + g: the round's G offsets are neighbours in
//    the row-major offset list, so a warp's loads of one slot fall on a few
//    neighbouring columns of one or two rows. No shared buffer of partials,
//    so the L1 keeps its room for the inputs;
//  - pass 1 keeps each of its offsets' slot minimum in registers (windows
//    of up to G * RMAX = 128 offsets); the cell's minimum is exact in any
//    order, a shuffle reduction over its G lanes, then the same ladder in
//    every lane;
//  - pass 2 visits only the offsets with a slot strictly inside r_eff,
//    listed in offset order (shared memory, uint16 per entry). Any other
//    offset has partials +0, +0 and no exact slot, and adding +0 leaves num
//    and den as they were (they start at +0 and never become -0). At bench
//    scale r_eff is mostly radius_sq = 2 m^2 against the window's 7 m^2, so
//    about a third of the offsets remain;
//  - pass 2 forms, per visited offset, exactly the first design's partials
//    (pnum and pden summed over the slots in slot order, and the first exact
//    slot). After each round the cell's lanes add the round's G partials to
//    num and den in list order through shuffles, each lane keeping the same
//    sums: the same additions in the same order as one thread walking all
//    offsets. The exact value is that of the lowest lane with an exact slot
//    in the first round that has one;
//  - reads only slots [0, min(count, K)). bin_points fills those and leaves
//    the rest at de = dn = 1e9, payload 0: such a slot's d^2 (~2e18) never
//    lowers a minimum (which starts at 1e9) and never passes d2 < r_eff
//    (r_eff <= max_radius_sq), so its weight is 0 and adding 0 * 0 leaves
//    every partial as it was. Out-of-map cells count 0;
//  - takes (oi - hw) * res and (oj - hw) * res once per offset and block,
//    into a shared table, not once per pass and slot.
// Without the adaptive ladder, or with a larger window, pass 2 visits every
// offset (the same loop, no list).
//
// Exactness against the plain version (dsm/idw.py::binned_idw): the
// arithmetic is written with __fmul_rn / __fadd_rn so nvcc cannot contract
// it into FMAs, and pass 2 recomputes each d^2 with the same operations as
// pass 1; 1/d^2 is __frcp_rn, the correctly rounded reciprocal, the same
// float as the plain version's correctly rounded 1 / d^2; the ladder uses
// logf / powf / ceilf in the op order of pallas_idw.py:80-89. The library
// must be built without --use_fast_math, or the d2 < r_eff knife edges move.
#include <cuda_runtime.h>

namespace {

constexpr float FAR = 1.0e9f;
constexpr float EXACT_EPS = 1.0e-12f;
constexpr int G = 8;                  // lanes per cell, consecutive
constexpr int WARPS = 8;              // warps per block
constexpr int CELLS = WARPS * 32 / G; // cells per block, a run of one row
constexpr int RMAX = 16;              // rounds whose minima stay in registers
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned GMASK = (1u << G) - 1;

// keep: adaptive, and the window has at most G * RMAX offsets, so pass 1
// keeps each offset's slot minimum in registers and pass 2 visits only the
// offsets with a slot strictly inside r_eff.
template <bool keep>
__global__ void __launch_bounds__(32 * WARPS)
idw_kernel(const float* __restrict__ de, const float* __restrict__ dn,
           const float* __restrict__ pl, const int* __restrict__ count,
           const int* __restrict__ offs, int M, float* __restrict__ values,
           unsigned char* __restrict__ hit, int K, int H, int W, int hw,
           float res, float radius_sq, int adaptive, float growth,
           float log_growth, float max_r2_tol) {
  extern __shared__ float4 otab[];  // [M] (di, dj as int bits, di*res, dj*res)
  // [CELLS][M] with keep: each cell's pass-2 offsets, in offset order
  unsigned short* need_list = reinterpret_cast<unsigned short*>(otab + M);
  const int tid = threadIdx.x;
  for (int o = tid; o < M; o += 32 * WARPS) {
    const int di = offs[2 * o] - hw, dj = offs[2 * o + 1] - hw;
    otab[o] = make_float4(__int_as_float(di), __int_as_float(dj),
                          __fmul_rn((float)di, res),
                          __fmul_rn((float)dj, res));
  }
  __syncthreads();

  const int lane = tid & 31;
  const int g = lane & (G - 1);      // this lane's offset in each round
  const int base = lane & ~(G - 1);  // the cell's first lane
  const int cell = tid / G;
  const int i = blockIdx.y, j = blockIdx.x * CELLS + cell;
  const bool active = j < W;
  const size_t plane = (size_t)H * W;
  const int rounds = (M + G - 1) / G;  // the same in every lane

  // the cell's nearest squared distance over the slots of offset o
  auto offset_min = [&](int o) {
    float m = FAR;
    if (!active || o >= M) return m;
    const float4 f = otab[o];
    const int si = i + __float_as_int(f.x), sj = j + __float_as_int(f.y);
    if (si < 0 || si >= H || sj < 0 || sj >= W) return m;
    const size_t c = (size_t)si * W + sj;
    const int n = min(count[c], K);
    for (int k = 0; k < n; ++k) {
      const float e = __fadd_rn(de[k * plane + c], f.w);
      const float nn = __fsub_rn(dn[k * plane + c], f.z);
      m = fminf(m, __fadd_rn(__fmul_rn(e, e), __fmul_rn(nn, nn)));
    }
    return m;
  };

  float r_eff = radius_sq;
  float omin[keep ? RMAX : 1];
  if (adaptive) {
    float d2min = FAR;
    if constexpr (keep) {
#pragma unroll
      for (int t = 0; t < RMAX; ++t) {
        omin[t] = t < rounds ? offset_min(t * G + g) : FAR;
        d2min = fminf(d2min, omin[t]);
      }
    } else {
      for (int t = 0; t < rounds; ++t) {
        d2min = fminf(d2min, offset_min(t * G + g));
      }
    }
    for (int m = 1; m < G; m <<= 1) {
      d2min = fminf(d2min, __shfl_xor_sync(FULL, d2min, m));
    }
    // smallest radius_sq * growth^k strictly greater than d2min
    const float ratio = fmaxf(__fdiv_rn(d2min, radius_sq), 1e-30f);
    float kk = ceilf(__fdiv_rn(logf(ratio), log_growth));
    if (__fmul_rn(radius_sq, powf(growth, kk)) <= d2min) kk = kk + 1.0f;
    kk = fmaxf(kk, 0.0f);
    r_eff = __fmul_rn(radius_sq, powf(growth, kk));
    if (d2min < radius_sq) r_eff = radius_sq;
    if (!(r_eff <= max_r2_tol)) r_eff = 0.0f;  // empty neighbour set
  }

  // The offsets pass 2 visits, in offset order. An offset whose slots all
  // lie at d^2 >= r_eff has partials +0, +0 and no exact slot, and adding
  // +0 leaves num and den as they were, so with keep it is left out.
  int n_visit = M;
  unsigned short* list = need_list + cell * M;
  if constexpr (keep) {
    n_visit = 0;
#pragma unroll
    for (int t = 0; t < RMAX; ++t) {
      const bool need = omin[t] < r_eff;
      const unsigned m = (__ballot_sync(FULL, need) >> base) & GMASK;
      if (need) list[n_visit + __popc(m & ((1u << g) - 1))] = t * G + g;
      n_visit += __popc(m);
    }
    __syncwarp();
  }
  const int rounds2 = (__reduce_max_sync(FULL, n_visit) + G - 1) / G;

  float num = 0.0f, den = 0.0f, exact_val = 0.0f;
  bool exact_hit = false;
  for (int t = 0; t < rounds2; ++t) {
    const int idx = t * G + g;
    float pnum = 0.0f, pden = 0.0f, first = 0.0f;
    bool any_exact = false;
    if (active && idx < n_visit) {
      const float4 f = otab[keep ? list[idx] : idx];
      const int si = i + __float_as_int(f.x), sj = j + __float_as_int(f.y);
      if (si >= 0 && si < H && sj >= 0 && sj < W) {
        const size_t c = (size_t)si * W + sj;
        const int n = min(count[c], K);
        for (int k = 0; k < n; ++k) {
          const float p = pl[k * plane + c];
          const float e = __fadd_rn(de[k * plane + c], f.w);
          const float nn = __fsub_rn(dn[k * plane + c], f.z);
          const float d2 = __fadd_rn(__fmul_rn(e, e), __fmul_rn(nn, nn));
          const bool in_r = d2 < r_eff;
          const bool is_exact = in_r && d2 <= EXACT_EPS;
          const float wgt = (in_r && !is_exact)
                                ? __frcp_rn(fmaxf(d2, EXACT_EPS))
                                : 0.0f;
          pnum = __fadd_rn(pnum, __fmul_rn(wgt, p));
          pden = __fadd_rn(pden, wgt);
          if (is_exact && !any_exact) {
            any_exact = true;
            first = p;
          }
        }
      }
    }
    // the round's partials, added in visiting order (lane base + q holds
    // entry t * G + q); entries past n_visit add +0
#pragma unroll
    for (int q = 0; q < G; ++q) {
      num = __fadd_rn(num, __shfl_sync(FULL, pnum, base + q));
      den = __fadd_rn(den, __shfl_sync(FULL, pden, base + q));
    }
    const unsigned exact_lanes =
        (__ballot_sync(FULL, any_exact) >> base) & GMASK;
    const float v = __shfl_sync(
        FULL, first, base + (exact_lanes ? __ffs(exact_lanes) - 1 : 0));
    if (!exact_hit && exact_lanes) exact_val = v;
    exact_hit = exact_hit || exact_lanes;
  }

  if (!active || g != 0) return;
  const size_t out = (size_t)i * W + j;
  hit[out] = (den > 0.0f || exact_hit) ? 1 : 0;
  values[out] = exact_hit ? exact_val
                          : __fdiv_rn(num, den > 0.0f ? den : 1.0f);
}

}  // namespace

extern "C" int amt_idw_launch(const float* de, const float* dn,
                              const float* pl, const int* count,
                              const int* offs, int M, float* values,
                              unsigned char* hit, int K, int H, int W, int hw,
                              float res, float radius_sq, int adaptive,
                              float growth, float log_growth,
                              float max_r2_tol, void* stream) {
  const bool keep = adaptive && (M + G - 1) / G <= RMAX;
  auto kernel = keep ? idw_kernel<true> : idw_kernel<false>;
  const size_t smem = (size_t)M * sizeof(float4) +
                      (keep ? (size_t)CELLS * M * sizeof(unsigned short) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + CELLS - 1) / CELLS, H);
  kernel<<<grid, 32 * WARPS, smem, (cudaStream_t)stream>>>(
      de, dn, pl, count, offs, M, values, hit, K, H, W, hw, res, radius_sq,
      adaptive, growth, log_growth, max_r2_tol);
  return (int)cudaGetLastError();
}
