// SGM matching cost: Birchfield-Tomasi on the x-Sobel images, block mean,
// border planes at 1e4, written once as the [B, H, W, D] volume.
//
// Replaces no Pallas kernel: the JAX package builds this volume with XLA ops
// (stereo/matching.py::_bt_cost, _box_filter, _border_mask, the copy to D
// last), which the port first ran as ~15 PyTorch passes over a 4 GB volume.
// Plain version, the same arithmetic in the same order:
// stereo/matching.py::sgm_cost_volume_plain. Per (b, h, w, d), with
// q(c) = c - min_disp - d:
//   BT(y, c, d) = min(max(l - rmax, rmin - l, 0), max(r - lmax, lmin - r, 0))
//     l, lmin, lmax: the left image at (y, c) and the min / max of it and its
//       half-samples 0.5 (l + l[c-1]), 0.5 (l + l[c+1]) (edge-replicated);
//     r, rmin, rmax: the same of the right image at (y, q(c)); all three read
//       0 where q(c) < 0 (the shifted image's fill);
//   V(h, c, d) = sum of BT(clamp(h - r + i), c, d) over i = 0 .. K-1, rows
//     top to bottom (r = K / 2; rows clamped to [0, H-1]);
//   out = (sum of V(h, clamp(w - r + j), d) over j = 0 .. K-1, left to
//     right) / (K * K), or 1e4 where w - min_disp - d < 0.
// The clamps act on the cost plane (the plain version edge-pads the BT
// volume), not on the images. Adds and the division are __fadd_rn /
// __fdiv_rn, so nvcc can neither reassociate nor contract them: the output
// is bit-equal to the plain version, whose window sums are shifted-slice
// adds in the same order.
//
// What bounds it on the H100: bytes, one volume written (4 x B x H x W x D;
// the images are ~1 % of it). The design: a block owns a strip of TW = 32
// output columns, TH output rows and 32 disparities (one per lane, so each
// warp writes 128 contiguous bytes of a pixel's D-vector). It walks down its
// rows: per image row it stages the row's left intervals over the strip's
// columns and halo and the right intervals over the columns those reach
// into shared memory (the next row's pixels are loaded into registers while
// this row is summed, so the walk does not wait on device memory), computes
// BT once per (halo column, d) and keeps the last K BT rows of each of its
// columns in registers (a ring, K a template parameter), so the vertical sum
// is K register adds; the vertical sums go to shared memory and each output
// takes its K horizontal neighbours from there. BT is computed
// (TW + K - 1) / TW x (TH + K - 1) / TH times per output, not K^2 times.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;        // output columns of a strip
constexpr int TH = 64;        // output rows of a block
constexpr int NW = 16;        // warps per block
constexpr int RIGHT0 = 256;   // first thread that stages right columns
constexpr int KMAX = 15;      // largest window (one instantiation per K)
constexpr float BORDER_COST = 1.0e4f;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// an image row's pixel at column q and its two neighbours (edge-replicated)
struct Px {
  float prev, v, next;
};

__device__ __forceinline__ Px load_px(const float* row, int q, int W) {
  return {row[q > 0 ? q - 1 : 0], row[q], row[q < W - 1 ? q + 1 : W - 1]};
}

// the pixel's Birchfield-Tomasi interval from its half-samples
__device__ __forceinline__ void interval(Px p, float* v, float* mn,
                                         float* mx) {
  const float lo = __fmul_rn(0.5f, __fadd_rn(p.v, p.prev));
  const float hi = __fmul_rn(0.5f, __fadd_rn(p.v, p.next));
  *v = p.v;
  *mn = fminf(fminf(lo, hi), p.v);
  *mx = fmaxf(fmaxf(lo, hi), p.v);
}

template <int K>
__global__ void __launch_bounds__(NW * 32)
sgm_cost_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
                float* __restrict__ out, int H, int W, int D, int min_disp,
                int chunks) {
  constexpr int R = K / 2;
  constexpr int S = TW + K - 1;      // halo columns of the strip
  constexpr int SR = S + 31;         // right-image columns they reach
  constexpr int CPW = (S + NW - 1) / NW;  // halo columns per warp
  constexpr int OPW = TW / NW;            // output columns per warp
  static_assert(S <= RIGHT0 && RIGHT0 + SR <= NW * 32, "staging threads");
  __shared__ float l_v[S], l_mn[S], l_mx[S];
  __shared__ float r_v[SR], r_mn[SR], r_mx[SR];
  __shared__ float vsum[S][32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z / chunks;
  const int d0 = (blockIdx.z % chunks) * 32;
  const int d = d0 + lane;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int rows = min(TH, H - h0);
  const size_t img = (size_t)H * W;
  const float* L = lf + b * img;
  const float* Rt = rf + b * img;
  // clamped cost-plane column of halo column 0; right column of (s, lane) is
  // cc(s) - min_disp - d, stored at cc(s) - cc0 + 31 - lane
  const int cc0 = clampi(w0 - R, 0, W - 1);
  const int qbase = cc0 - min_disp - d0 - 31;
  // the column this thread stages each row: left halo column tid, or right
  // column tid - RIGHT0 (0 where it is left of the image)
  const bool stage_l = tid < S;
  const bool stage_r = tid >= RIGHT0 && tid < RIGHT0 + SR;
  const int sq = stage_l ? clampi(w0 - R + tid, 0, W - 1)
                         : qbase + (tid - RIGHT0);
  const bool stage_q = stage_l || (stage_r && sq >= 0 && sq < W);
  const int nrows = rows + K - 1;

  // the next row's pixels, loaded one row ahead (during this row's sums)
  const float* src = stage_l ? L : Rt;
  Px next = {0.0f, 0.0f, 0.0f};
  if (stage_q) next = load_px(src + (size_t)clampi(h0 - R, 0, H - 1) * W,
                              sq, W);

  float ring[CPW][K];
#pragma unroll
  for (int j = 0; j < CPW; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) ring[j][i] = 0.0f;

  for (int t = 0; t < nrows; ++t) {
    if (stage_l) {
      interval(next, &l_v[tid], &l_mn[tid], &l_mx[tid]);
    } else if (stage_r) {
      const int s = tid - RIGHT0;
      if (stage_q) {
        interval(next, &r_v[s], &r_mn[s], &r_mx[s]);
      } else {
        r_v[s] = 0.0f;
        r_mn[s] = 0.0f;
        r_mx[s] = 0.0f;
      }
    }
    __syncthreads();  // the row is staged
    if (t + 1 < nrows && stage_q)
      next = load_px(src + (size_t)clampi(h0 - R + t + 1, 0, H - 1) * W, sq,
                     W);

    const bool ready = t >= K - 1;  // the ring holds output row h0 + t - K + 1
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const int s = warp + j * NW;
      if (s < S) {
        const int cc = clampi(w0 - R + s, 0, W - 1);
        const int qi = cc - cc0 + 31 - lane;
        const float l = l_v[s], lmn = l_mn[s], lmx = l_mx[s];
        const float r = r_v[qi], rmn = r_mn[qi], rmx = r_mx[qi];
        const float d_lr = fmaxf(fmaxf(__fsub_rn(l, rmx), __fsub_rn(rmn, l)),
                                 0.0f);
        const float d_rl = fmaxf(fmaxf(__fsub_rn(r, lmx), __fsub_rn(lmn, r)),
                                 0.0f);
#pragma unroll
        for (int i = 0; i < K - 1; ++i) ring[j][i] = ring[j][i + 1];
        ring[j][K - 1] = fminf(d_lr, d_rl);
        if (ready) {
          float v = ring[j][0];
#pragma unroll
          for (int i = 1; i < K; ++i) v = __fadd_rn(v, ring[j][i]);
          vsum[s][lane] = v;
        }
      }
    }
    __syncthreads();  // vsum is complete; the staged row may be rewritten
    if (!ready) continue;

    const int h = h0 + t - (K - 1);
    if (d < D) {
#pragma unroll
      for (int j = 0; j < OPW; ++j) {
        const int o = warp + j * NW;
        const int w = w0 + o;
        if (w < W) {
          float v = vsum[o][lane];
#pragma unroll
          for (int i = 1; i < K; ++i) v = __fadd_rn(v, vsum[o + i][lane]);
          if (K > 1) v = __fdiv_rn(v, (float)(K * K));
          out[(((size_t)b * H + h) * W + w) * D + d] =
              w - min_disp - d >= 0 ? v : BORDER_COST;
        }
      }
    }
    // no barrier here: the next row's staging writes only l_* and r_*,
    // which every thread finished reading before the barrier above, and
    // the barrier after that staging keeps its vsum writes behind these
    // reads
  }
}

template <int K>
cudaError_t launch(const float* lf, const float* rf, float* out, int B, int H,
                   int W, int D, int min_disp, cudaStream_t stream) {
  const int chunks = (D + 31) / 32;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * chunks);
  sgm_cost_kernel<K><<<grid, NW * 32, 0, stream>>>(lf, rf, out, H, W, D,
                                                   min_disp, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int amt_sgm_cost_launch(const float* lf, const float* rf,
                                   float* out, int B, int H, int W, int D,
                                   int min_disp, int block, void* stream) {
  if (D < 1 || B < 1 || H < 1 || W < 1 || min_disp < 0 || block < 1 ||
      block > KMAX || (long long)B * ((D + 31) / 32) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (block) {
    case 1: return (int)launch<1>(lf, rf, out, B, H, W, D, min_disp, s);
    case 2: return (int)launch<2>(lf, rf, out, B, H, W, D, min_disp, s);
    case 3: return (int)launch<3>(lf, rf, out, B, H, W, D, min_disp, s);
    case 4: return (int)launch<4>(lf, rf, out, B, H, W, D, min_disp, s);
    case 5: return (int)launch<5>(lf, rf, out, B, H, W, D, min_disp, s);
    case 6: return (int)launch<6>(lf, rf, out, B, H, W, D, min_disp, s);
    case 7: return (int)launch<7>(lf, rf, out, B, H, W, D, min_disp, s);
    case 8: return (int)launch<8>(lf, rf, out, B, H, W, D, min_disp, s);
    case 9: return (int)launch<9>(lf, rf, out, B, H, W, D, min_disp, s);
    case 10: return (int)launch<10>(lf, rf, out, B, H, W, D, min_disp, s);
    case 11: return (int)launch<11>(lf, rf, out, B, H, W, D, min_disp, s);
    case 12: return (int)launch<12>(lf, rf, out, B, H, W, D, min_disp, s);
    case 13: return (int)launch<13>(lf, rf, out, B, H, W, D, min_disp, s);
    case 14: return (int)launch<14>(lf, rf, out, B, H, W, D, min_disp, s);
    default: return (int)launch<15>(lf, rf, out, B, H, W, D, min_disp, s);
  }
}
