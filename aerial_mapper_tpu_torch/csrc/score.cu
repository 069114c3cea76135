// Best-angle score pass of backward-grid ortho.
//
// Replaces the Pallas kernel aerial_mapper_tpu/ortho/pallas_score.py::
// _score_kernel (wrapper score_pass_pallas). Per map cell against every
// camera of the bank, in camera-index order: camera-frame xyz, pinhole
// projection with a safe z, visibility (in front, inside the image, finite),
// the ranking key q = z^2 / max(|p|^2, 1e-18), the first maximum of q
// (strict >, so ties go to the lowest index, ortho-backward-grid.cc:90), the
// winner's pixel (u, v), and the number of cameras that see the cell.
// Invisible cells return best = N (one past the last camera), q = -inf,
// u = v = 0, n_vis = 0; the caller clamps best before any gather.
//
// What bounds it on the H100: the visible (cell, camera) pairs, then bytes.
// It reads 12 bytes per cell and writes 20. A visible pair needs its
// projection and its rank exactly (~40 float operations, three divisions);
// an invisible one can be rejected by geometry. A survey map is far larger
// than one camera's footprint, so most pairs are invisible: at bench scale
// about a third of the 160000 x 249 pairs are visible, on a 1 km survey of
// 825 images about 12 of 825 per cell.
//
// Design. A block owns a 16 x 16 tile of map cells (grid_shape given) or a
// run of 256 consecutive cells (without it), one thread per cell.
//  1. The block reduces its tile's box: min and max of easting, northing and
//     elevation over the cells with no NaN coordinate. A NaN coordinate
//     makes x, y and z NaN, and z > 1e-6 is false for NaN, so such a cell is
//     never visible (a cell the DSM has not reached has a NaN elevation); it
//     stays out of the box and skips the camera walk. A tile with an
//     infinite coordinate keeps every camera; a tile with no cell left
//     keeps none.
//  2. Exact per-tile camera cull, in double precision, 256 cameras at a
//     time (one per thread). A pair is visible only if z > 1e-6 and
//     0 <= u < W, 0 <= v < H. For z > 0 each image-edge test is a linear
//     function of the world point p: fx x + cx z >= 0, (W - cx) z - fx x > 0,
//     and the same in y with fy, cy, H. The block takes each function's
//     maximum over the box (value at the centre plus sum |coef| * half-width)
//     and drops the camera if any maximum is below -margin.
//  3. The kept cameras are compacted in ascending index order into shared
//     memory (a block-wide ballot and prefix count), and every thread walks
//     that list with the plain version's arithmetic in its order.
//
// The margin. u32 = 2^-24 is float32's unit roundoff, gamma_n = n u32 /
// (1 - n u32). The kernel computes x^ = ((ce r0 + cn r1) + el r2) - r9 in
// float32; by the standard dot-product bound |x^ - x| <= gamma_4 S_x, with
// S_x = |r0| A_e + |r1| A_n + |r2| A_z + |r9| and A the largest |coordinate|
// of the box; the same for y^ and z^. Underflow adds at most 2^-149 per
// operation, covered by EPS_ABS = 2^-120. So E = G4 S + EPS_ABS with
// G4 = 6 u32 bounds each error.
//  - z^ > 1e-6 gives z > 1e-6 - E_z: margin E_z.
//  - u^ = fl(fl(fx fl(x^ / z^)) + cx). Rounding is monotone and a sum of two
//    floats is exact when it underflows, so u^ >= 0 and u^ < W hold for
//    s = fl(fx fl(x^ / z^)) + cx itself, and s = fx (x^/z^)(1 + t) + cx
//    (+ underflow) with |t| <= gamma_2. Multiplied by z^ > 0:
//    fx x^ + cx z^ >= -|fx x^| gamma_2, then fx x + cx z >=
//    -(|fx| (G2 M_x + E_x) + |cx| E_z + (|fx| + 1) M_z EPS_ABS), where
//    G2 = 3 u32 bounds gamma_2 and M = |centre value| + radius + E bounds
//    |x^| over the box. The upper edge has |W - cx| in place of |cx|.
//  - The test itself runs in double with rounding below 2^-50 of the
//    magnitudes S involved; G4 and G2 carry 2 u32 and 1 u32 more than
//    gamma_4 and gamma_2 need, which covers it.
// At UTM-sized coordinates (easting ~5e5 m, northing ~5e6 m) E_x is a few
// decimetres: a few pixels of margin at 100 m, against a 16-cell tile.
//
// Why each skip is exact. A dropped camera would give every cell of the tile
// qm = -inf and vis = false: -inf > best_q is false and n_vis + 0.0 is
// n_vis (it starts at +0 and only grows), so all five outputs are unchanged,
// and a cell no camera sees keeps best = N. In the walk, z <= 1e-6 (or NaN)
// is invisible whatever u and v are, so both divisions are skipped; u out of
// [0, W) skips the v division; q is computed only for a visible pair. For
// z > 1e-6 the plain version's safe z is z itself, and 0 <= u < W implies u
// is finite, so the isfinite tests are implied.
//
// Exactness against the plain version (ortho/backward_grid.py::_score_pass):
// the per-pair arithmetic uses __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc
// cannot contract the 3-term rotation into FMAs and flip near-ties; the op
// order is that of pallas_score.py:57-76. The cull uses __dmul_rn /
// __dadd_rn in the order of ortho/cuda_score.py::tile_camera_mask_plain.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_H = 16;  // cells per tile with a grid shape
constexpr int TILE_W = 16;
constexpr int RUN = 256;    // consecutive cells per block without one
constexpr int CAMS = THREADS;  // cameras per cull chunk, one per thread
constexpr int WARPS = THREADS / 32;
// 5 blocks (40 warps) per SM: 48 registers, and the cull's doubles spill a
// few words. At 3 or 4 blocks (80, 64 registers) or 6 (40) both shapes ran
// slower on the H100; 92 registers, unbounded, give 2 blocks.
constexpr int MIN_BLOCKS = 5;
static_assert(TILE_H * TILE_W == THREADS && RUN == THREADS, "one cell each");

constexpr double U32 = 5.9604644775390625e-08;  // 2^-24
constexpr double G4 = 6.0 * U32;
constexpr double G2 = 3.0 * U32;
constexpr double EPS_ABS = 7.52316384526264005e-37;  // 2^-120
constexpr double Z_MIN = (double)1e-6f;

__device__ __forceinline__ double dm(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double da(double a, double b) {
  return __dadd_rn(a, b);
}

// The tile's box: centre, half-width and largest |value| of easting,
// northing and elevation.
struct Box {
  double c[3], h[3], a[3];
};

// Whether one image-edge function L = p * x_k + q * z may reach -margin
// over the box (k = 0 for x, 1 for y; f the focal length of that axis).
__device__ __forceinline__ bool edge_may_hold(
    const double* r, const Box& b, const double* cv, const double* e,
    const double* m, int k, double p, double q, double f) {
  const double lc = da(dm(p, cv[k]), dm(q, cv[2]));
  const double lr = da(
      da(dm(fabs(da(dm(p, r[3 * k]), dm(q, r[6]))), b.h[0]),
         dm(fabs(da(dm(p, r[3 * k + 1]), dm(q, r[7]))), b.h[1])),
      dm(fabs(da(dm(p, r[3 * k + 2]), dm(q, r[8]))), b.h[2]));
  const double margin =
      da(da(dm(fabs(f), da(dm(G2, m[k]), e[k])), dm(fabs(q), e[2])),
         dm(da(fabs(f), 1.0), dm(m[2], EPS_ABS)));
  return !(da(lc, lr) < -margin);
}

// Whether camera r (12 floats: R_cw row-major, then R_cw t) may see a cell
// of the box; false only if no cell of it can be visible (see the note).
__device__ bool camera_may_see(const float* rf, const Box& b, float fx,
                               float fy, float cx, float cy, float width,
                               float height) {
  double r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = rf[i];
  double cv[3], rad[3], e[3], m[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double* a = r + 3 * k;
    cv[k] = da(da(da(dm(a[0], b.c[0]), dm(a[1], b.c[1])), dm(a[2], b.c[2])),
               -r[9 + k]);
    rad[k] = da(da(dm(fabs(a[0]), b.h[0]), dm(fabs(a[1]), b.h[1])),
                dm(fabs(a[2]), b.h[2]));
    const double s =
        da(da(da(dm(fabs(a[0]), b.a[0]), dm(fabs(a[1]), b.a[1])),
              dm(fabs(a[2]), b.a[2])),
           fabs(r[9 + k]));
    e[k] = da(dm(G4, s), EPS_ABS);
    m[k] = da(da(fabs(cv[k]), rad[k]), e[k]);
  }
  // z > 1e-6 somewhere in the box: max z = centre + radius
  if (da(da(cv[2], rad[2]), -Z_MIN) < -e[2]) return false;
  const double dfx = fx, dfy = fy, dcx = cx, dcy = cy;
  return edge_may_hold(r, b, cv, e, m, 0, dfx, dcx, dfx) &&
         edge_may_hold(r, b, cv, e, m, 0, -dfx, da(width, -dcx), dfx) &&
         edge_may_hold(r, b, cv, e, m, 1, dfy, dcy, dfy) &&
         edge_may_hold(r, b, cv, e, m, 1, -dfy, da(height, -dcy), dfy);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
score_kernel(const float* __restrict__ cells, const float4* __restrict__ bank,
             int N, int gh, int gw, int th, int tw, float fx, float fy,
             float cx, float cy, float width, float height,
             int* __restrict__ best_o, float* __restrict__ q_o,
             float* __restrict__ u_o, float* __restrict__ v_o,
             float* __restrict__ nvis_o) {
  __shared__ float4 sb[CAMS * 3];  // kept cameras, 12 floats each
  __shared__ int si[CAMS];         // and their indices
  __shared__ float sred[WARPS][6];
  __shared__ int sflag[WARPS][2];
  __shared__ int swarp[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y * th + tid / tw;
  const int col = blockIdx.x * tw + tid % tw;
  const bool in = row < gh && col < gw;
  const size_t t = (size_t)row * gw + col;
  float ce = NAN, cn = NAN, el = NAN;
  if (in) {
    ce = cells[3 * t];
    cn = cells[3 * t + 1];
    el = cells[3 * t + 2];
  }
  const bool valid = !isnan(ce) && !isnan(cn) && !isnan(el);
  const bool inf = valid && (isinf(ce) || isinf(cn) || isinf(el));

  // ---- 1. the tile's box over its cells without NaN ----
  float lo[3] = {ce, cn, el}, hi[3] = {ce, cn, el};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (!valid) {
      lo[k] = INFINITY;
      hi[k] = -INFINITY;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
      hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
    }
  }
  const int any_valid = __any_sync(0xffffffffu, valid);
  const int any_inf = __any_sync(0xffffffffu, inf);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sred[warp][k] = lo[k];
      sred[warp][3 + k] = hi[k];
    }
    sflag[warp][0] = any_valid;
    sflag[warp][1] = any_inf;
  }
  __syncthreads();
  bool tile_valid = false, tile_inf = false;
  Box b;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float l = INFINITY, h = -INFINITY;
    for (int w = 0; w < WARPS; ++w) {
      l = fminf(l, sred[w][k]);
      h = fmaxf(h, sred[w][3 + k]);
    }
    const double dl = l, dh = h;
    b.c[k] = dm(da(dl, dh), 0.5);
    b.h[k] = dm(da(dh, -dl), 0.5);
    b.a[k] = fmax(fabs(dl), fabs(dh));
  }
  for (int w = 0; w < WARPS; ++w) {
    tile_valid |= sflag[w][0] != 0;
    tile_inf |= sflag[w][1] != 0;
  }

  float bq = -INFINITY, bu = 0.0f, bv = 0.0f, nvis = 0.0f;
  int bi = N;
  for (int c0 = 0; c0 < N; c0 += CAMS) {
    // ---- 2. cull this chunk of cameras for the tile ----
    const int nc = min(CAMS, N - c0);
    bool keep = false;
    float4 r4[3];
    if (tid < nc && tile_valid) {
#pragma unroll
      for (int i = 0; i < 3; ++i) r4[i] = bank[(size_t)(c0 + tid) * 3 + i];
      keep = tile_inf ||
             camera_may_see(reinterpret_cast<const float*>(r4), b, fx, fy,
                            cx, cy, width, height);
    }
    // ---- 3. compact the kept ones in index order ----
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) swarp[warp] = __popc(mask);
    __syncthreads();  // also: the previous chunk's walk is over
    int base = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int n = swarp[w];
      base += w < warp ? n : 0;
      total += n;
    }
    if (keep) {
      const int pos = base + __popc(mask & ((1u << lane) - 1u));
#pragma unroll
      for (int i = 0; i < 3; ++i) sb[pos * 3 + i] = r4[i];
      si[pos] = c0 + tid;
    }
    __syncthreads();
    if (!(in && valid)) continue;
    // ---- 4. walk the kept cameras: the plain version's arithmetic ----
    for (int c = 0; c < total; ++c) {
      const float4 a = sb[c * 3], bb = sb[c * 3 + 1], cc = sb[c * 3 + 2];
      // r0..r11 = a.xyzw, bb.xyzw, cc.xyzw
      const float z = __fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(ce, bb.z), __fmul_rn(cn, bb.w)),
                    __fmul_rn(el, cc.x)), cc.w);
      if (!(z > 1e-6f)) continue;  // invisible: no division needed
      const float x = __fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(ce, a.x), __fmul_rn(cn, a.y)),
                    __fmul_rn(el, a.z)), cc.y);
      const float u = __fadd_rn(__fmul_rn(fx, __fdiv_rn(x, z)), cx);
      if (!(u >= 0.0f && u < width)) continue;
      const float y = __fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(ce, a.w), __fmul_rn(cn, bb.x)),
                    __fmul_rn(el, bb.y)), cc.z);
      const float v = __fadd_rn(__fmul_rn(fy, __fdiv_rn(y, z)), cy);
      if (!(v >= 0.0f && v < height)) continue;
      const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                 __fmul_rn(z, z));
      const float q = __fdiv_rn(__fmul_rn(z, z), fmaxf(n2, 1e-18f));
      if (q > bq) {
        bq = q;
        bi = si[c];
        bu = u;
        bv = v;
      }
      nvis = __fadd_rn(nvis, 1.0f);
    }
  }
  if (in) {
    best_o[t] = bi;
    q_o[t] = bq;
    u_o[t] = bu;
    v_o[t] = bv;
    nvis_o[t] = nvis;
  }
}

}  // namespace

// gh > 0: cells are a row-major gh x gw grid, one 16 x 16 tile per block;
// gh <= 0: runs of 256 consecutive cells.
extern "C" int amt_score_launch(const float* cells, const float* bank, int T,
                                int N, int gh, int gw, float fx, float fy,
                                float cx, float cy, float width, float height,
                                int* best, float* q, float* u, float* v,
                                float* n_vis, void* stream) {
  int th = TILE_H, tw = TILE_W;
  if (gh <= 0) {
    gh = 1;
    gw = T;
    th = 1;
    tw = RUN;
  }
  dim3 grid((gw + tw - 1) / tw, (gh + th - 1) / th);
  score_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cells, reinterpret_cast<const float4*>(bank), N, gh, gw, th, tw, fx, fy,
      cx, cy, width, height, best, q, u, v, n_vis);
  return (int)cudaGetLastError();
}
