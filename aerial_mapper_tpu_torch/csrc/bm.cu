// Fused SAD block matching: the running-state scan over disparities.
//
// Replaces the Pallas kernel aerial_mapper_tpu/stereo/pallas_bm.py::_bm_kernel
// (wrapper block_matching_disparity_pallas). For every pixel of every pair
// it streams d over num_disp: the absolute difference (AD) of the x-Sobel-
// prefiltered left image against the right image shifted by min_disp + d,
// a (2r+1)^2 box sum of the AD, the border mask u >= d + min_disp, and the
// running state (best cost, its index, the costs at index -1 / +1, and a
// runner-up outside +-1). Five [B, H, W] maps come out; the sub-pixel step,
// uniqueness, texture and speckle stay PyTorch ops (stereo/cuda_bm.py).
// The cost volume never reaches device memory.
//
// What bounds it on the H100: operations, not bytes. It reads two [B, H, W]
// float images and writes five maps (~0.35 GB at 35 x 480 x 752), but does
// num_disp x (AD + window sum + state update) per pixel (80 disparities:
// 1.01e9 (pixel, disparity) pairs at bench shape). Two entries:
//
// bm_scan_int_kernel, the integer path (use_integer_costs: every value is an
// integer in 0..2*cap <= 255 and every window sum is below 2^15). Window
// sums are exact in any order there, so it uses O(1) running sums per
// (pixel, disparity) instead of the (2r+1)-fold re-reads. A block owns a
// TH x TW output tile (32 x 64) and keeps the tile's images with their halos
// in shared memory as bytes. It walks d in chunks of WARPS (8) disparities,
// three barrier-separated stages per chunk, each with fixed strides (no
// integer division or remainder in any loop):
//   A. warp w = disparity d0 + w, lane = halo column: each lane slides a
//      vertical window down the tile's rows (add the entering row's AD,
//      subtract the leaving row's) and stores the column sums as uint16.
//      The kernel is a template on r, instantiated for r = 0..63 (blocks
//      1..127, all that the integer guard admits), so the walk is unrolled
//      and the last 2r+1 ADs stay in registers: the leaving AD is read
//      back, not recomputed, 2 byte loads and 1 store per step;
//   B. warp = disparity, lane = output row: each lane slides the horizontal
//      window along its row, overwriting the column sums with the costs in
//      place (one step behind, so no value is overwritten before it is
//      read);
//   C. each thread owns 4 x 2 pixels and updates their running state in
//      registers, in increasing d, in the order runner, cp, cm, bestd, best
//      (pallas_bm.py:105-117): the runner-up and cp depend on that order,
//      so the scan stays sequential in d. Strict < keeps ties at the lowest
//      d. The state is int32 (costs are exact integers; 1e9 is exact in
//      float32), so the float maps equal the plain version bit for bit.
// Per (pixel, disparity) that is ~1.5 AD evaluations at r = 7 (x 1.22 for
// the column halo), 2 shared loads for the row slide and 1 for the scan.
// The row-slide pitch is 2 mod 4 halfwords, so stage B's lanes (one row
// each) hit 32 different banks. 50.7 KB of shared memory per 256-thread
// block at r = 7, D = 80, and at most 85 registers up to r = 10, so 3
// blocks (24 warps) share an SM.
//
// bm_scan_float_kernel, the float path (integer_costs=False, or a cap or
// block too large for the integer guard): the values are not integers, so
// a window sum rounds by its order. The plain version and the Pallas kernel
// fold each column top-down over 2r+1 rows, then each row left to right
// over 2r+1 column sums (pallas_bm.py:72-83); a sliding sum (add the
// entering value, subtract the leaving one) would round differently and
// break bit-equality. So the least work is one in-order fold per direction:
// 2r adds each per (pixel, disparity), which cannot be fused (no multiply)
// and are a dependent chain per output. What bounds it is operations: 4r + 9
// per (pixel, disparity) (2 for the AD, 2r + 2r folds, 1 border mask, 6 for
// the state), 0.86 ms at block 25 at bench shape and 67 TFLOP/s. It takes
// the integer kernel's shape (the same TH x TW tile, WARPS disparities per
// chunk, fixed strides), in float and with rings in place of running sums:
//   A. warp = disparity, lane = halo column: each lane walks down the
//      rows, computing each AD once into a register ring of the last 2r+1,
//      and emits column sum v as ((ad[v] + ad[v+1]) + ...) + ad[v+2r]; a
//      lane whose column reads a 0-filled right pixel takes its own walk
//      (AD = left), so no AD pays for a select;
//   B. the same warp (a __syncwarp, not a barrier: it reads only its own
//      column sums), lane = output row: a register ring of the last 2r+1
//      column sums along the row, cost x the left-to-right fold, written
//      over column sum x; the float row pitch is odd, so the 32 lanes (one
//      row each) hit 32 different banks;
//   C. as the integer kernel's, with float state, unrolled over the chunk.
// The strips load with asynchronous copies (cp.async), so a thread's loads
// are all in flight at once. Two barriers per chunk of 8 disparities (the
// wide variant makes two per disparity), one AD evaluation per halo pixel
// and disparity, one shared load per step of each ring. A template on r
// (0..FR_MAX, blocks 1..55) keeps the ring indices constant. Shared memory
// is float: ~124 KB at r = 7, D = 80, one 256-thread block per SM. Above
// FR_MAX, or where the ring kernel's shared memory would not fit, the
// wrapper launches the wide variant (bm_scan_float_wide_kernel: per d the
// whole AD tile, then each fold re-read from shared memory, flat indices)
// chosen by r and num_disp before the launch; it takes blocks up to 89 at
// D = 80.
//
// Edge semantics of every kernel here (pallas_bm.py:97-101, 169-170):
//  - an out-of-range right pixel is 0-filled, so AD = left there;
//  - the AD, not the image, is edge-replicated horizontally: a halo column
//    left of 0 or right of W-1 takes the AD of column 0 or W-1 (computed
//    from clamped coordinates, never from a neighbour tile's pixels);
//  - rows are edge-replicated (clamped row index), which commutes with AD.
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr float BIG = 1.0e9f;
constexpr int IBIG = 1000000000;  // BIG as an int: exact in float32

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------- integer

constexpr int TH = 32;           // output rows per block (one per lane in B)
constexpr int TW = 64;           // output columns per block
constexpr int WARPS = 8;         // warps per block = disparities per chunk
constexpr int PY = TH / WARPS;   // pixels per thread along v in stage C
constexpr int PX = TW / 32;      // pixels per thread along u in stage C
// block 127: the largest block use_integer_costs admits (pre_filter_cap 1)
constexpr int MAX_R = 63;

// the row-slide pitch in halfwords: >= the halo'd width aw, 2 mod 4
__host__ __device__ constexpr int pitch_of(int aw) {
  return aw + (6 - aw % 4) % 4;
}

// One instantiation per radius R, so the ring of the last 2R+1 ADs has
// constant indices and stays in registers. 3 blocks of 256 threads per SM
// up to R = 10 (at most 85 registers a thread), fewer for larger windows.
template <int R>
__global__ void __launch_bounds__(32 * WARPS,
                                  R <= 10 ? 3 : (R <= 20 ? 2 : 1))
bm_scan_int_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
                   float* __restrict__ best_o, int* __restrict__ bestd_o,
                   float* __restrict__ cm_o, float* __restrict__ cp_o,
                   float* __restrict__ runner_o, int H, int W, int num_disp,
                   int min_disp) {
  constexpr int K = 2 * R + 1;           // window side
  constexpr int AH = TH + 2 * R;         // image rows with halo
  constexpr int AW = TW + 2 * R;         // image columns with halo
  constexpr int PITCH = pitch_of(AW);
  extern __shared__ unsigned short cs[];  // [WARPS][TH][PITCH] sums / costs
  const int RW = AW + num_disp - 1;       // right columns
  unsigned char* sl =
      reinterpret_cast<unsigned char*>(cs + WARPS * TH * PITCH);
  unsigned char* sr = sl + AH * AW;       // [AH][RW]

  const int lane = threadIdx.x, wid = threadIdx.y;
  const size_t plane = (size_t)H * W;
  const float* L = lf + blockIdx.z * plane;
  const float* Rt = rf + blockIdx.z * plane;
  const int v0 = blockIdx.y * TH;
  const int u0 = blockIdx.x * TW;
  // sr[ti][c] holds right column rb + c; the AD at clamped column uc and
  // shift s reads c = uc - (u0 - R) + (num_disp - 1 - d), always in range
  const int rb = u0 - R - (num_disp - 1) - min_disp;
  for (int ti = wid; ti < AH; ti += WARPS) {
    const size_t row = (size_t)clampi(v0 - R + ti, 0, H - 1) * W;
    for (int j = lane; j < AW; j += 32) {
      sl[ti * AW + j] = (unsigned char)__float2uint_rn(
          L[row + clampi(u0 - R + j, 0, W - 1)]);
    }
    for (int c = lane; c < RW; c += 32) {
      const int uu = rb + c;
      sr[ti * RW + c] = (uu >= 0 && uu < W)
                            ? (unsigned char)__float2uint_rn(Rt[row + uu])
                            : (unsigned char)0;
    }
  }
  __syncthreads();

  int best[PY][PX], bestd[PY][PX], cm[PY][PX], cp[PY][PX], prev[PY][PX],
      runner[PY][PX];
#pragma unroll
  for (int py = 0; py < PY; ++py) {
#pragma unroll
    for (int px = 0; px < PX; ++px) {
      best[py][px] = cm[py][px] = cp[py][px] = prev[py][px] = IBIG;
      runner[py][px] = IBIG;
      bestd[py][px] = -2;
    }
  }

  for (int d0 = 0; d0 < num_disp; d0 += WARPS) {
    const int dc = min(WARPS, num_disp - d0);
    unsigned short* cw = cs + wid * TH * PITCH;  // this warp's disparity
    // A. vertical window sums: lane = halo column, sliding down the rows.
    // The walk is unrolled, so every ring index is a constant: the last K
    // ADs stay in registers and the leaving row's AD is read back, not
    // recomputed (only rows 0..TH-2 ever leave, so at most TH-1 stay live)
    if (wid < dc) {
      const int d = d0 + wid;
      const int s = d + min_disp;
#pragma unroll 1
      for (int j = lane; j < AW; j += 32) {
        const int uc = clampi(u0 - R + j, 0, W - 1);
        const bool shifted = uc >= s;  // else the right pixel is 0-filled
        const unsigned char* lc = sl + j;
        const unsigned char* rc = sr + (uc - (u0 - R) + (num_disp - 1 - d));
        int ad[K];
        int acc = 0;
#pragma unroll
        for (int ti = 0; ti < K; ++ti) {
          const int l = lc[ti * AW];
          ad[ti] = shifted ? abs(l - (int)rc[ti * RW]) : l;
          acc += ad[ti];
        }
        cw[j] = (unsigned short)acc;
#pragma unroll
        for (int v = 1; v < TH; ++v) {
          const int ti = v + K - 1;  // entering row; row v - 1 leaves
          const int li = lc[ti * AW];
          const int ai = shifted ? abs(li - (int)rc[ti * RW]) : li;
          acc += ai - ad[(v - 1) % K];
          ad[(v - 1) % K] = ai;
          cw[v * PITCH + j] = (unsigned short)acc;
        }
      }
    }
    __syncthreads();
    // B. horizontal window sums: lane = output row, sliding along the row;
    // cost u is written over column sum u after column sum u is read
    if (wid < dc) {
      unsigned short* row = cw + lane * PITCH;
      int acc = 0;
#pragma unroll
      for (int o = 0; o < K; ++o) acc += row[o];
      for (int u = 1; u < TW; ++u) {
        const int leaving = row[u - 1];
        const int entering = row[u + 2 * R];
        row[u - 1] = (unsigned short)acc;  // cost at u - 1
        acc += entering - leaving;
      }
      row[TW - 1] = (unsigned short)acc;
    }
    __syncthreads();
    // C. the running state, in increasing d
    for (int dd = 0; dd < dc; ++dd) {
      const int d = d0 + dd;
      const int s = d + min_disp;
      const unsigned short* cd = cs + dd * TH * PITCH;
#pragma unroll
      for (int py = 0; py < PY; ++py) {
#pragma unroll
        for (int px = 0; px < PX; ++px) {
          const int v = wid + py * WARPS, u = lane + px * 32;
          int cost = cd[v * PITCH + u];
          if (u0 + u < s) cost = IBIG;
          // update order of pallas_bm.py:106-117: runner, cp, cm, bestd, best
          const bool is_better = cost < best[py][px];
          const bool away = abs(bestd[py][px] - d) > 1;
          runner[py][px] = min(runner[py][px],
                               is_better ? (away ? best[py][px] : IBIG)
                                         : (away ? cost : IBIG));
          if (d == bestd[py][px] + 1) cp[py][px] = cost;
          if (is_better) {
            cm[py][px] = prev[py][px];
            bestd[py][px] = d;
          }
          best[py][px] = min(best[py][px], cost);
          prev[py][px] = cost;
        }
      }
    }
    __syncthreads();  // the next chunk's stage A overwrites cs
  }

#pragma unroll
  for (int py = 0; py < PY; ++py) {
#pragma unroll
    for (int px = 0; px < PX; ++px) {
      const int ov = v0 + wid + py * WARPS, ou = u0 + lane + px * 32;
      if (ov < H && ou < W) {
        const size_t o = blockIdx.z * plane + (size_t)ov * W + ou;
        best_o[o] = (float)best[py][px];
        bestd_o[o] = bestd[py][px];
        cm_o[o] = (float)cm[py][px];
        cp_o[o] = (float)cp[py][px];
        runner_o[o] = (float)runner[py][px];
      }
    }
  }
}

using IntKernel = void (*)(const float*, const float*, float*, int*, float*,
                           float*, float*, int, int, int, int);

// bm_scan_int_kernel<0> .. <MAX_R>, indexed by the radius
template <int... Rs>
const IntKernel* int_kernels(std::integer_sequence<int, Rs...>) {
  static const IntKernel table[] = {bm_scan_int_kernel<Rs>...};
  return table;
}

// ------------------------------------------------------------------ float

constexpr int FTH = 32;            // output rows per block (one per lane in B)
constexpr int FTW = 64;            // output columns per block
constexpr int FWARPS = 8;          // warps per block = disparities per chunk
constexpr int FPY = FTH / FWARPS;  // pixels per thread along v in stage C
constexpr int FPX = FTW / 32;      // pixels per thread along u in stage C
// the ring kernel's largest radius: its shared memory at 80 disparities
// fits the 227 KB a block may have up to r = 27 (block 55)
constexpr int FR_MAX = 27;
static_assert(FTH == 32, "stage B runs one lane per output row");
static_assert(FTW % 32 == 0 && FTH % FWARPS == 0, "stage C's pixel map");

// the float row pitch in words: >= the halo'd width aw, odd, so stage B's
// lanes (one row each) hit 32 different banks
__host__ __device__ constexpr int fpitch_of(int aw) { return aw | 1; }

// 4-byte asynchronous copy from global to shared memory; src_bytes = 0
// writes a zero without reading src
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// One instantiation per radius R, so both rings of the last 2R+1 values
// have constant indices and stay in registers. One 256-thread block per SM
// (~124 KB of shared memory at R = 7, D = 80).
template <int R>
__global__ void __launch_bounds__(32 * FWARPS, 1)
bm_scan_float_kernel(const float* __restrict__ lf,
                     const float* __restrict__ rf, float* __restrict__ best_o,
                     int* __restrict__ bestd_o, float* __restrict__ cm_o,
                     float* __restrict__ cp_o, float* __restrict__ runner_o,
                     int H, int W, int num_disp, int min_disp) {
  constexpr int K = 2 * R + 1;          // window side
  constexpr int AH = FTH + 2 * R;       // image rows with halo
  constexpr int AW = FTW + 2 * R;       // image columns with halo
  constexpr int PITCH = fpitch_of(AW);
  extern __shared__ float fsm[];
  float* cs = fsm;                      // [FWARPS][FTH][PITCH] sums / costs
  float* sl = cs + FWARPS * FTH * PITCH;  // [AH][AW] left, clamped coords
  float* sr = sl + AH * AW;             // [AH][RW] right, 0 outside image
  const int RW = AW + num_disp - 1;

  const int lane = threadIdx.x, wid = threadIdx.y;
  const size_t plane = (size_t)H * W;
  const float* L = lf + blockIdx.z * plane;
  const float* Rt = rf + blockIdx.z * plane;
  const int v0 = blockIdx.y * FTH;
  const int u0 = blockIdx.x * FTW;
  // sr[ti][c] holds right column rb + c; the AD at clamped column uc and
  // shift s reads c = uc - (u0 - R) + (num_disp - 1 - d), always in range
  const int rb = u0 - R - (num_disp - 1) - min_disp;
  // asynchronous copies: every thread's loads are in flight at once
  for (int ti = wid; ti < AH; ti += FWARPS) {
    const float* lrow = L + (size_t)clampi(v0 - R + ti, 0, H - 1) * W;
    const float* rrow = Rt + (lrow - L);
    for (int j = lane; j < AW; j += 32) {
      cp_async4(sl + ti * AW + j, lrow + clampi(u0 - R + j, 0, W - 1), 4);
    }
    for (int c = lane; c < RW; c += 32) {
      const int uu = rb + c;
      const bool in = uu >= 0 && uu < W;
      cp_async4(sr + ti * RW + c, rrow + (in ? uu : 0), in ? 4 : 0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float best[FPY][FPX], cm[FPY][FPX], cp[FPY][FPX], prev[FPY][FPX],
      runner[FPY][FPX];
  int bestd[FPY][FPX];
#pragma unroll
  for (int py = 0; py < FPY; ++py) {
#pragma unroll
    for (int px = 0; px < FPX; ++px) {
      best[py][px] = cm[py][px] = cp[py][px] = prev[py][px] = BIG;
      runner[py][px] = BIG;
      bestd[py][px] = -2;
    }
  }

  for (int d0 = 0; d0 < num_disp; d0 += FWARPS) {
    const int dc = min(FWARPS, num_disp - d0);
    float* cw = cs + wid * FTH * PITCH;  // this warp's disparity
    if (wid < dc) {
      const int d = d0 + wid;
      const int s = d + min_disp;
      // A. vertical folds: lane = halo column, walking down the rows. Each
      // AD is computed once into a ring of the last K; column sum v is the
      // top-down fold ((ad[v] + ad[v+1]) + ...) + ad[v+2R], the plain
      // version's order (the walk is unrolled: every ring index is constant)
#pragma unroll 1
      for (int j = lane; j < AW; j += 32) {
        const int uc = clampi(u0 - R + j, 0, W - 1);
        const bool shifted = uc >= s;  // else the right pixel is 0-filled
        const float* lc = sl + j;
        const float* rc = sr + (uc - (u0 - R) + (num_disp - 1 - d));
        auto walk = [&](auto ad_of) {
          float ad[K];
#pragma unroll
          for (int ti = 0; ti < AH; ++ti) {
            ad[ti % K] = ad_of(ti);
            if (ti >= 2 * R) {
              const int v = ti - 2 * R;
              float acc = ad[v % K];
#pragma unroll
              for (int o = 1; o < K; ++o) acc += ad[(v + o) % K];
              cw[v * PITCH + j] = acc;
            }
          }
        };
        // one walk per case, so no AD pays for a select
        if (shifted) {
          walk([&](int ti) { return fabsf(lc[ti * AW] - rc[ti * RW]); });
        } else {
          walk([&](int ti) { return lc[ti * AW]; });
        }
      }
      // stage B reads only this warp's column sums
      __syncwarp();
      // B. horizontal folds: lane = output row, walking along it with a
      // ring of the last K column sums; cost x is the left-to-right fold,
      // written over column sum x once every sum it needs has been read
      float* row = cw + lane * PITCH;
      float ring[K];
#pragma unroll
      for (int o = 0; o < 2 * R; ++o) ring[o] = row[o];
#pragma unroll
      for (int x = 0; x < FTW; ++x) {
        ring[(x + 2 * R) % K] = row[x + 2 * R];
        float acc = ring[x % K];
#pragma unroll
        for (int o = 1; o < K; ++o) acc += ring[(x + o) % K];
        row[x] = acc;
      }
    }
    __syncthreads();
    // C. the running state, in increasing d (unrolled over the chunk)
#pragma unroll
    for (int dd = 0; dd < FWARPS; ++dd) {
      if (dd >= dc) break;
      const int d = d0 + dd;
      const int ulim = d + min_disp - u0;  // tile columns u < ulim: masked
      const float* cd = cs + dd * FTH * PITCH;
#pragma unroll
      for (int py = 0; py < FPY; ++py) {
#pragma unroll
        for (int px = 0; px < FPX; ++px) {
          const int v = wid + py * FWARPS, u = lane + px * 32;
          float cost = cd[v * PITCH + u];
          if (u < ulim) cost = BIG;
          // update order of pallas_bm.py:106-117: runner, cp, cm, bestd,
          // best. Where the winner lies more than 1 from d the runner-up
          // takes the loser of (best, cost); elsewhere min(runner, BIG) is
          // the runner itself (it starts at BIG and only falls)
          const bool is_better = cost < best[py][px];
          const int t = bestd[py][px] - d;
          if ((unsigned)(t + 1) > 2u) {
            runner[py][px] =
                fminf(runner[py][px], is_better ? best[py][px] : cost);
          }
          if (t == -1) cp[py][px] = cost;
          if (is_better) {
            cm[py][px] = prev[py][px];
            bestd[py][px] = d;
          }
          best[py][px] = fminf(best[py][px], cost);
          prev[py][px] = cost;
        }
      }
    }
    __syncthreads();  // the next chunk's stage A overwrites cs
  }

#pragma unroll
  for (int py = 0; py < FPY; ++py) {
#pragma unroll
    for (int px = 0; px < FPX; ++px) {
      const int ov = v0 + wid + py * FWARPS, ou = u0 + lane + px * 32;
      if (ov < H && ou < W) {
        const size_t o = blockIdx.z * plane + (size_t)ov * W + ou;
        best_o[o] = best[py][px];
        bestd_o[o] = bestd[py][px];
        cm_o[o] = cm[py][px];
        cp_o[o] = cp[py][px];
        runner_o[o] = runner[py][px];
      }
    }
  }
}

// bm_scan_float_kernel<0> .. <FR_MAX>, indexed by the radius
template <int... Rs>
const IntKernel* float_kernels(std::integer_sequence<int, Rs...>) {
  static const IntKernel table[] = {bm_scan_float_kernel<Rs>...};
  return table;
}

// The wide variant, for radii above FR_MAX: smaller tiles, so its shared
// memory grows more slowly with r, and folds that re-read shared memory.
// Per d it rebuilds the AD tile of a WTH x WTW tile, sums each column's
// 2r+1 rows, then each pixel's 2r+1 columns, left to right (the same
// order, so the same bits).
constexpr int WTH = 16;  // output rows per block
constexpr int WTW = 64;  // output columns per block (blockDim = WTW x WTH)

__global__ void __launch_bounds__(WTH * WTW)
bm_scan_float_wide_kernel(const float* __restrict__ lf,
                          const float* __restrict__ rf,
                          float* __restrict__ best_o,
                          int* __restrict__ bestd_o,
                          float* __restrict__ cm_o, float* __restrict__ cp_o,
                          float* __restrict__ runner_o, int H, int W,
                          int num_disp, int min_disp, int r) {
  extern __shared__ float smem[];
  const int K = 2 * r + 1;
  const int AH = WTH + 2 * r;          // AD tile rows (with halo)
  const int AW = WTW + 2 * r;          // AD tile columns (with halo)
  const int RW = AW + num_disp - 1;    // right tile columns
  float* sl = smem;                    // [AH][AW] left, clamped coords
  float* sr = sl + AH * AW;            // [AH][RW] right, 0 outside image
  float* sad = sr + AH * RW;           // [AH][AW] AD at the current d
  float* scs = sad + AH * AW;          // [WTH][AW] vertical window sums

  const size_t plane = (size_t)H * W;
  const float* L = lf + blockIdx.z * plane;
  const float* R = rf + blockIdx.z * plane;
  const int v0 = blockIdx.y * WTH;
  const int u0 = blockIdx.x * WTW;
  const int tid = threadIdx.y * WTW + threadIdx.x;
  const int nthr = WTH * WTW;

  for (int i = tid; i < AH * AW; i += nthr) {
    const int ti = i / AW, tj = i % AW;
    const int vv = clampi(v0 - r + ti, 0, H - 1);
    const int uu = clampi(u0 - r + tj, 0, W - 1);
    sl[i] = L[(size_t)vv * W + uu];
  }
  const int rb = u0 - r - (num_disp - 1) - min_disp;
  for (int i = tid; i < AH * RW; i += nthr) {
    const int ti = i / RW, tj = i % RW;
    const int vv = clampi(v0 - r + ti, 0, H - 1);
    const int uu = rb + tj;
    sr[i] = (uu >= 0 && uu < W) ? R[(size_t)vv * W + uu] : 0.0f;
  }
  __syncthreads();

  const int ov = v0 + threadIdx.y;
  const int ou = u0 + threadIdx.x;
  float best = BIG, cm = BIG, cp = BIG, prev = BIG, runner = BIG;
  int bestd = -2;

  for (int d = 0; d < num_disp; ++d) {
    const int s = d + min_disp;
    for (int i = tid; i < AH * AW; i += nthr) {
      const int ti = i / AW, tj = i % AW;
      const int uc = clampi(u0 - r + tj, 0, W - 1);
      const float l = sl[i];
      float a = l;  // 0-filled right pixel: the AD is the left value
      if (uc >= s) {
        a = fabsf(l - sr[ti * RW + uc - (u0 - r) + (num_disp - 1 - d)]);
      }
      sad[i] = a;
    }
    __syncthreads();
    for (int i = tid; i < WTH * AW; i += nthr) {
      const int ti = i / AW, tj = i % AW;
      float acc = sad[ti * AW + tj];
      for (int o = 1; o < K; ++o) acc += sad[(ti + o) * AW + tj];
      scs[i] = acc;
    }
    __syncthreads();
    // the next iteration writes sad before its first barrier and scs only
    // after it, so this read of scs needs no barrier of its own
    const float* row = scs + threadIdx.y * AW + threadIdx.x;
    float cost = row[0];
    for (int o = 1; o < K; ++o) cost += row[o];
    if (ou < s) cost = BIG;

    // update order of pallas_bm.py:106-117: runner, cp, cm, bestd, best
    const bool is_better = cost < best;
    const bool away = abs(bestd - d) > 1;
    runner = is_better ? fminf(runner, away ? best : BIG)
                       : fminf(runner, away ? cost : BIG);
    if (d == bestd + 1) cp = cost;
    if (is_better) {
      cm = prev;
      bestd = d;
    }
    best = fminf(best, cost);
    prev = cost;
  }

  if (ov < H && ou < W) {
    const size_t o = blockIdx.z * plane + (size_t)ov * W + ou;
    best_o[o] = best;
    bestd_o[o] = bestd;
    cm_o[o] = cm;
    cp_o[o] = cp;
    runner_o[o] = runner;
  }
}

// Raise a kernel's dynamic shared-memory cap when it needs more than 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int amt_bm_int_launch(const float* lf, const float* rf,
                                 float* best, int* bestd, float* cm,
                                 float* cp, float* runner, int B, int H,
                                 int W, int num_disp, int min_disp, int r,
                                 void* stream) {
  if (r < 0 || r > MAX_R) return (int)cudaErrorInvalidValue;
  const IntKernel kernel =
      int_kernels(std::make_integer_sequence<int, MAX_R + 1>())[r];
  const int AH = TH + 2 * r, AW = TW + 2 * r, RW = AW + num_disp - 1;
  const size_t smem = sizeof(unsigned short) * WARPS * TH * pitch_of(AW) +
                      (size_t)AH * AW + (size_t)AH * RW;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(32, WARPS);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      lf, rf, best, bestd, cm, cp, runner, H, W, num_disp, min_disp);
  return (int)cudaGetLastError();
}

extern "C" int amt_bm_float_launch(const float* lf, const float* rf,
                                   float* best, int* bestd, float* cm,
                                   float* cp, float* runner, int B, int H,
                                   int W, int num_disp, int min_disp, int r,
                                   void* stream) {
  if (r < 0 || r > FR_MAX) return (int)cudaErrorInvalidValue;
  const IntKernel kernel =
      float_kernels(std::make_integer_sequence<int, FR_MAX + 1>())[r];
  const int AH = FTH + 2 * r, AW = FTW + 2 * r, RW = AW + num_disp - 1;
  const size_t smem =
      sizeof(float) * ((size_t)FWARPS * FTH * fpitch_of(AW) +
                       (size_t)AH * AW + (size_t)AH * RW);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(32, FWARPS);
  dim3 grid((W + FTW - 1) / FTW, (H + FTH - 1) / FTH, B);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      lf, rf, best, bestd, cm, cp, runner, H, W, num_disp, min_disp);
  return (int)cudaGetLastError();
}

extern "C" int amt_bm_float_wide_launch(const float* lf, const float* rf,
                                        float* best, int* bestd, float* cm,
                                        float* cp, float* runner, int B,
                                        int H, int W, int num_disp,
                                        int min_disp, int r, void* stream) {
  const int AH = WTH + 2 * r, AW = WTW + 2 * r, RW = AW + num_disp - 1;
  const size_t smem = sizeof(float) * ((size_t)2 * AH * AW +
                                       (size_t)AH * RW + (size_t)WTH * AW);
  const cudaError_t e = allow_smem(bm_scan_float_wide_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(WTW, WTH);
  dim3 grid((W + WTW - 1) / WTW, (H + WTH - 1) / WTH, B);
  bm_scan_float_wide_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      lf, rf, best, bestd, cm, cp, runner, H, W, num_disp, min_disp, r);
  return (int)cudaGetLastError();
}
