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
// volume), not on the images. Adds are __fadd_rn, so nvcc can neither
// reassociate nor contract them, and the division is correctly rounded
// (div_k2 below): the output is bit-equal to the plain version, whose window
// sums are shifted-slice adds in the same order.
//
// What bounds it on the H100: bytes, one volume written (4 x B x H x W x D;
// the images are ~1 % of it). The adds that the order fixes (2 (K - 1) per
// output) and BT make it instruction-heavy, so the design keeps every
// instruction it can off each output. A block owns a strip of TW output
// columns for a chunk of DC disparities (all of D unless that does not fit)
// and walks down TH output rows, one barrier per image row:
// - Every lane live: a thread owns one halo column s of the strip (S =
//   TW + K - 1 of them) and E disparities g, g + G, ..., so it loads its
//   column's left interval once a row and one right interval per entry;
//   the S x G owners hold all DC disparities. G and TW are chosen at launch
//   so that S x G fills the block (D = 80, K = 9: E = 8, G = 10, TW = 40,
//   480 threads, every entry live).
// - Vertical sums from a register ring: each thread keeps the last K BT rows
//   of its entries in registers. The ring slot of a row, t % K, picks one
//   of K compile-time copies of the vertical step, so the ring is indexed by
//   constants and never moves; where every entry of a thread is live the
//   copy has no branch and its E add chains interleave.
// - Horizontal sums from a thread's own run: a thread takes 8 consecutive
//   output columns of one disparity and reads the K + 7 vertical sums they
//   need with float4 loads from a [disparity][column] tile, whose row pitch
//   (an odd multiple of 4 floats) keeps a quarter-warp's float4s on distinct
//   banks.
// - Exact division without a divide: q = x * (1 / K^2) corrected by one FMA
//   residual step (Markstein), correctly rounded like __fdiv_rn wherever
//   the sums lie in [2^-100, 2^120) or are +0. A block whose staged image
//   values are all safe (safe_value) takes it for every sum; any other
//   tests each run of 8 and takes a straight-line exact path where that
//   fails. An IEEE divide per output costs ~1.4 ms of the SGBM step's
//   volume on the H100 (its reciprocal unit runs at 1/8 of the FP32 rate).
// - Asynchronous row stores: each finished output row segment is staged in
//   shared memory as the contiguous [TW, D] run it is in the volume and
//   written with one Hopper bulk copy (cp.async.bulk, 1-D, no tensor map),
//   double-buffered, so the store overlaps the next row's sums. A segment
//   that is not 16-byte aligned, or a chunk of D, goes out with plain
//   coalesced stores.
// - The image rows: each row's left intervals over the strip's halo columns
//   and the right intervals over the columns they reach are staged as
//   float4 (value, min, max) once per row, double-buffered, from registers
//   loaded one row ahead. Within a row's barrier interval the block stages
//   row t + 1, takes the vertical sums of row t and the horizontal sums of
//   the row before; the vertical sums are double-buffered.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTMAX = 512;     // most threads of a block
constexpr int TH = 192;        // output rows of a block
constexpr int TWMAX = 64;      // most output columns of a strip
constexpr int DCMAX = 256;     // most disparities of a block
constexpr int RUN = 8;         // output columns of a horizontal run
constexpr int NSEG = 2;        // output row segments (bulk stores in flight)
constexpr int KMAX = 15;       // largest window (one instantiation per K)
constexpr int SMEM_MAX = 227 * 1024;
constexpr float BORDER_COST = 1.0e4f;

// ring entries per thread: at most 72 registers of ring
__host__ __device__ constexpr int ring_entries(int k) {
  return 72 / k < 16 ? 72 / k : 16;
}

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

// the pixel's Birchfield-Tomasi interval from its half-samples: (v, min, max)
__device__ __forceinline__ float4 interval(Px p) {
  const float lo = __fmul_rn(0.5f, __fadd_rn(p.v, p.prev));
  const float hi = __fmul_rn(0.5f, __fadd_rn(p.v, p.next));
  return make_float4(p.v, fminf(fminf(lo, hi), p.v), fmaxf(fmaxf(lo, hi), p.v),
                     0.0f);
}

// a staged value that keeps every window sum in div_k2's range: +0 or in
// [2^-75, 2^110]. Differences of such values are +0 (never -0) or at least
// 2^-98 (both are multiples of 2^-98) and at most 2^110, so BT is too, and
// a sum of K^2 <= 225 of them is +0 or in [2^-98, 2^118).
__device__ __forceinline__ bool safe_value(float f) {
  const unsigned u = __float_as_uint(f);
  return u == 0 || u - 0x1A000000u <= 0x5C800000u;
}

// x / K^2 correctly rounded for x in [2^-100, 2^120): q0 = RN(x r) with
// r = RN(1 / K^2) is within an ulp of the quotient, the residual x - q0 K^2
// is exact in one FMA, and RN(q0 + residual r) is the rounded quotient
// (Markstein's theorem; every step stays normal in that range)
template <int K>
__device__ __forceinline__ float div_k2(float x) {
  constexpr float c = (float)(K * K);
  constexpr float r = 1.0f / c;
  const float q0 = __fmul_rn(x, r);
  const float res = __fmaf_rn(-q0, c, x);
  return __fmaf_rn(res, r, q0);
}

// x / K^2 correctly rounded for every float32 x, in straight-line code (an
// IEEE divide would bring a subroutine call into the loop, whose register
// constraints cost more than the divides): the sign apart; infinities and
// NaN by a product; large and small x scaled by 2^-64 / 2^64 into div_k2's
// range, exact where the quotient stays normal; subnormal quotients as the
// integer m / K^2 rounded to nearest even, x = m 2^-149
template <int K>
__device__ __forceinline__ float div_k2_any(float x) {
  constexpr unsigned kk = K * K;
  constexpr float c = (float)kk;
  const float a = fabsf(x);
  if (!(a <= 3.40282347e38f)) return x * (1.0f / c);
  float q;
  if (a >= 0x1p120f) {
    q = div_k2<K>(a * 0x1p-64f) * 0x1p64f;
  } else if (a >= 0x1p-100f) {
    q = div_k2<K>(a);
  } else if (a >= c * 0x1p-126f) {
    q = div_k2<K>(a * 0x1p64f) * 0x1p-64f;
  } else {
    const unsigned m = (unsigned)(a * 0x1p100f * 0x1p49f);
    unsigned qi = m / kk;
    const unsigned rem2 = 2 * (m - qi * kk);
    if (rem2 > kk || (rem2 == kk && (qi & 1))) ++qi;
    q = (float)qi * 0x1p-149f;
  }
  return copysignf(q, x);
}

// a run's RUN window sums divided by K^2, each correctly rounded: div_k2
// where all of them are +0 (exact in it too; flat image regions give many)
// or lie in its range (one test on their bits: negatives, -0 and NaN fail
// it as large unsigned), else div_k2_any. tools/sgm_div_check.py checks
// both branches and div_k2 alone against __fdiv_rn on all 2^32 inputs.
template <int K>
__device__ __forceinline__ void div_run(float (&v)[RUN]) {
  unsigned lo = 0xffffffffu, hi = 0;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const unsigned u = __float_as_uint(v[i]);
    const unsigned w = u ? u : 0x3f800000u;  // +0 as 1.0f
    lo = min(lo, w);
    hi = max(hi, w);
  }
  if (lo >= 0x0D800000u && hi < 0x7B800000u) {
#pragma unroll
    for (int i = 0; i < RUN; ++i) v[i] = div_k2<K>(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < RUN; ++i) v[i] = div_k2_any<K>(v[i]);
  }
}

__device__ __forceinline__ void bulk_store(float* g, const float* s,
                                           unsigned bytes) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(g),
      "r"(sa), "r"(bytes)
      : "memory");
}

// the launch's tiling, shared by the host and the kernel
struct Tiling {
  int tw, dc, g, sp;            // strip columns, disparities, disparity
                                // groups, vt row pitch
  int threads;                  // block size: the S x g ring owners and the
                                // stagers, in whole warps
  int strips, rowblocks, chunks;
  size_t smem;                  // dynamic shared memory bytes
};

// the vertical step of one image row with the ring slot U = t % K (U a
// template parameter, so the ring is indexed by constants and stays in
// registers): BT of this thread's entries (its halo column against the
// right intervals of its disparities), into slot U, and from the row K - 1
// on their sums over the ring, the oldest row first, into the vt tile
template <int K, int E, int U>
__device__ __forceinline__ void vertical(int u, float (&ring)[E][K],
                                         const float4* cur, float* vdst,
                                         int s, int rbase, int G, int vbase,
                                         int vstep, int nlive, bool ready) {
  if constexpr (U < K) {
    if (u != U) {
      vertical<K, E, U + 1>(u, ring, cur, vdst, s, rbase, G, vbase, vstep,
                            nlive, ready);
      return;
    }
    const float4 L = cur[s];
    if (nlive == E) {  // every entry live: no branch, the E chains interleave
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float4 Rr = cur[rbase - j * G];
        const float d_lr =
            fmaxf(fmaxf(__fsub_rn(L.x, Rr.z), __fsub_rn(Rr.y, L.x)), 0.0f);
        const float d_rl =
            fmaxf(fmaxf(__fsub_rn(Rr.x, L.z), __fsub_rn(L.y, Rr.x)), 0.0f);
        ring[j][U] = fminf(d_lr, d_rl);
      }
      if (ready) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          float v = ring[j][(U + 1) % K];
#pragma unroll
          for (int i = 1; i < K; ++i)
            v = __fadd_rn(v, ring[j][(U + 1 + i) % K]);
          vdst[vbase + j * vstep] = v;
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j < nlive) {
        const float4 Rr = cur[rbase - j * G];
        const float d_lr =
            fmaxf(fmaxf(__fsub_rn(L.x, Rr.z), __fsub_rn(Rr.y, L.x)), 0.0f);
        const float d_rl =
            fmaxf(fmaxf(__fsub_rn(Rr.x, L.z), __fsub_rn(L.y, Rr.x)), 0.0f);
        ring[j][U] = fminf(d_lr, d_rl);
        if (ready) {
          float v = ring[j][(U + 1) % K];
#pragma unroll
          for (int i = 1; i < K; ++i)
            v = __fadd_rn(v, ring[j][(U + 1 + i) % K]);
          vdst[vbase + j * vstep] = v;
        }
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(NTMAX, 1)
sgm_cost_kernel(const float* __restrict__ lf, const float* __restrict__ rf,
                float* __restrict__ out, int H, int W, int D, int min_disp,
                Tiling tl) {
  constexpr int R = K / 2;
  constexpr int E = ring_entries(K);
  constexpr int NV4 = (K + RUN - 1 + 3) / 4;  // float4s of a run's sums
  extern __shared__ __align__(128) float smem[];

  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int TW = tl.tw, DC = tl.dc, G = tl.g, SP = tl.sp;
  const int S = TW + K - 1;
  int bx = blockIdx.x;
  const int strip = bx % tl.strips;
  bx /= tl.strips;
  const int rb = bx % tl.rowblocks;
  bx /= tl.rowblocks;
  const int chunk = bx % tl.chunks;
  const int b = bx / tl.chunks;
  const int w0 = strip * TW, h0 = rb * TH, d0 = chunk * DC;
  const int dc = min(DC, D - d0);
  const int rows = min(TH, H - h0);
  const int twv = min(TW, W - w0);
  const int RS = S + dc - 1;  // right columns the strip reaches
  const int IB = S + RS;      // float4 intervals of a staged row

  float4* ib = reinterpret_cast<float4*>(smem);  // [2][IB]
  float* vt = smem + 2 * 4 * IB;                 // [2][DC][SP]
  float* seg = vt + 2 * DC * SP;                 // [NSEG][TW * dc]

  // this thread's ring entries: halo column s = tid % S and disparities
  // dd = g + j G, g = tid / S, j < nlive; the right interval of entry j is
  // rbase - j G, its vertical-sum slot vbase + j G SP
  const int cc0 = clampi(w0 - R, 0, W - 1);
  const int s = tid % S, g = tid / S;
  const int nlive = g < G && g < dc ? (dc - g + G - 1) / G : 0;
  const int rbase = S + clampi(w0 - R + s, 0, W - 1) - cc0 + dc - 1 - g;
  const int vbase = g * SP + s, vstep = G * SP;

  // the interval this thread stages each row: left halo column tid, or the
  // right column tid - S (0 where it is left of the image)
  const bool st_l = tid < S;
  const bool st_r = !st_l && tid < IB;
  const int sq = st_l ? clampi(w0 - R + tid, 0, W - 1)
                      : cc0 - min_disp - d0 - (dc - 1) + (tid - S);
  const bool st_q = st_l || (st_r && sq >= 0 && sq < W);
  const float* img = (st_l ? lf : rf) + (size_t)b * H * W;
  const int nrows = rows + K - 1;
  auto image_row = [&](int t) {
    return img + (size_t)clampi(h0 - R + t, 0, H - 1) * W;
  };
  // whether a value this thread staged so far is not safe_value
  bool unsafe_staged = false;
  auto stage = [&](int p, Px px) {
    if (st_l || st_r) {
      const float4 f = st_q ? interval(px) : make_float4(0.f, 0.f, 0.f, 0.f);
      unsafe_staged |= !(safe_value(f.x) && safe_value(f.y) &&
                         safe_value(f.z));
      ib[p * IB + tid] = f;
    }
  };

  // this thread's first horizontal run (disparity hd, column group hg) and
  // the step to its next (NT runs on)
  const int nruns = (twv + RUN - 1) / RUN * dc;
  const int hd0 = tid % dc, hg0 = tid / dc;
  const int sd = NT % dc, sg = NT / dc;

  // the output row segment: contiguous in the volume when dc == D
  const bool whole = dc == D;
  const int seg_n = twv * dc;
  auto seg_global = [&](int h) {
    return out + (((size_t)b * H + h) * W + w0) * D + d0;
  };

  Px nx = {0.0f, 0.0f, 0.0f};
  if (st_q) nx = load_px(image_row(0), sq, W);
  stage(0, nx);
  if (nrows > 1 && st_q) nx = load_px(image_row(1), sq, W);
  // whether the block staged a value that is not safe_value, up to the row
  // staged before the last barrier: the rows a window sum reads were staged
  // two barriers before its division
  bool unsafe = __syncthreads_or(unsafe_staged);

  float ring[E][K];
#pragma unroll
  for (int j = 0; j < E; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i) ring[j][i] = 0.0f;

  // iteration t: stage row t + 1, vertical sums of row t, horizontal sums
  // of output row t - K (from iteration t - 1's vertical sums), barrier,
  // store output row t - K
  for (int t = 0, u = 0; t <= nrows; ++t, u = u + 1 == K ? 0 : u + 1) {
    if (t + 1 < nrows) {
      stage((t + 1) & 1, nx);
      if (t + 2 < nrows && st_q) nx = load_px(image_row(t + 2), sq, W);
    }
    if (t < nrows)
      vertical<K, E, 0>(u, ring, ib + (t & 1) * IB, vt + (t & 1) * DC * SP,
                        s, rbase, G, vbase, vstep, nlive, t >= K - 1);
    if (t >= K) {
      const float* vsrc = vt + ((t - 1) & 1) * DC * SP;
      float* sdst = seg + (t - K) % NSEG * TW * DC;
      int hd = hd0, hg = hg0;
      for (int r = tid; r < nruns; r += NT) {
        const float4* p =
            reinterpret_cast<const float4*>(vsrc + hd * SP + hg * RUN);
        float x[4 * NV4];
#pragma unroll
        for (int q = 0; q < NV4; ++q) {
          const float4 f = p[q];
          x[4 * q] = f.x;
          x[4 * q + 1] = f.y;
          x[4 * q + 2] = f.z;
          x[4 * q + 3] = f.w;
        }
        float v[RUN];
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
          v[i] = x[i];
#pragma unroll
          for (int j = 1; j < K; ++j) v[i] = __fadd_rn(v[i], x[i + j]);
        }
        if (K > 1) {
          if (unsafe) {
            div_run<K>(v);
          } else {
#pragma unroll
            for (int i = 0; i < RUN; ++i) v[i] = div_k2<K>(v[i]);
          }
        }
        const int o0 = hg * RUN;
        const int edge = w0 + o0 - min_disp - (d0 + hd);  // w - min_disp - d
        float* dst = sdst + o0 * dc + hd;
        if (o0 + RUN <= twv && edge >= 0) {  // inside the image and the view
#pragma unroll
          for (int i = 0; i < RUN; ++i) dst[i * dc] = v[i];
        } else {
#pragma unroll
          for (int i = 0; i < RUN; ++i)
            if (o0 + i < twv) dst[i * dc] = edge + i >= 0 ? v[i] : BORDER_COST;
        }
        hd += sd;
        hg += sg;
        if (hd >= dc) {
          hd -= dc;
          ++hg;
        }
      }
      // the segment's writes before the bulk copy's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    // the segment written next iteration was stored NSEG - 1 rows ago: its
    // bulk copy has finished reading it before anyone passes this barrier
    // (the NSEG - 2 later ones may still be reading theirs)
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(NSEG - 2)
                   : "memory");
    unsafe |= __syncthreads_or(unsafe_staged);
    if (t >= K) {
      const float* sv = seg + (t - K) % NSEG * TW * DC;
      float* gp = seg_global(h0 + t - K);
      if (whole && (((uintptr_t)gp) & 15) == 0 && (seg_n & 3) == 0) {
        if (tid == 0) bulk_store(gp, sv, (unsigned)seg_n * 4u);
      } else if (whole) {
        for (int i = tid; i < seg_n; i += NT) gp[i] = sv[i];
      } else {
        for (int i = tid; i < seg_n; i += NT) {
          const int o = i / dc;
          gp[(size_t)o * D + (i - o * dc)] = sv[i];
        }
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the tiling of a launch at window K, or tw = 0 where it does not fit
template <int K>
Tiling tiling(int H, int W, int D) {
  constexpr int E = ring_entries(K);
  constexpr int NV4 = (K + RUN - 1 + 3) / 4;
  Tiling tl{};
  // all of D where groups of E disparities fit beside a strip of RUN
  // columns, else the largest chunk (a multiple of 4) that does
  const int most = E * (NTMAX / (RUN + K - 1));
  tl.dc = D <= DCMAX && D <= most ? D : (most < DCMAX ? most : DCMAX) & ~3;
  tl.g = (tl.dc + E - 1) / E;
  tl.tw = (NTMAX / tl.g - (K - 1)) & ~(RUN - 1);
  if (tl.tw > TWMAX) tl.tw = TWMAX;
  const int S = tl.tw + K - 1;
  const int ib = S + S + tl.dc - 1;
  const int owners = S * tl.g;
  tl.threads = ((owners > ib ? owners : ib) + 31) & ~31;
  // the pitch covers the halo and a run's float4 reads; an odd multiple of 4
  int sp = S > tl.tw - RUN + 4 * NV4 ? S : tl.tw - RUN + 4 * NV4;
  sp = (sp + 3) & ~3;
  if ((sp & 7) == 0) sp += 4;
  tl.sp = sp;
  tl.strips = (W + tl.tw - 1) / tl.tw;
  tl.rowblocks = (H + TH - 1) / TH;
  tl.chunks = (D + tl.dc - 1) / tl.dc;
  tl.smem = sizeof(float) * (2 * 4 * (size_t)ib + 2 * (size_t)tl.dc * sp +
                             NSEG * (size_t)tl.tw * tl.dc);
  if (tl.tw < RUN || tl.threads > NTMAX || tl.smem > SMEM_MAX) tl.tw = 0;
  return tl;
}

template <int K>
cudaError_t launch(const float* lf, const float* rf, float* out, int B, int H,
                   int W, int D, int min_disp, cudaStream_t stream) {
  const Tiling tl = tiling<K>(H, W, D);
  const long long blocks =
      (long long)tl.strips * tl.rowblocks * tl.chunks * B;
  if (tl.tw == 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sgm_cost_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tl.smem);
  if (err != cudaSuccess) return err;
  sgm_cost_kernel<K><<<(unsigned)blocks, tl.threads, tl.smem, stream>>>(
      lf, rf, out, H, W, D, min_disp, tl);
  return cudaGetLastError();
}

}  // namespace

extern "C" int amt_sgm_cost_launch(const float* lf, const float* rf,
                                   float* out, int B, int H, int W, int D,
                                   int min_disp, int block, void* stream) {
  if (D < 1 || B < 1 || H < 1 || W < 1 || min_disp < 0 || block < 1 ||
      block > KMAX)
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
