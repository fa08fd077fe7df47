// Z-buffer rasterizer for Hopper (sm_90a): one per-chunk body behind two
// entry points, merged through 64-bit depth/face keys.
//
// Replaces both TPU kernels of pix2pose_tpu/ops/rasterizer_pallas.py, which
// share the per-chunk body _chunk_body:
//   p2p_rasterize_binned      <- _binned_kernel (K1), driven there by
//                                rasterize_pallas_binned through a (tile,
//                                chunk) work list of static capacity
//                                (_build_pairs);
//   p2p_rasterize_exhaustive  <- _kernel (K2), driven there by
//                                rasterize_pallas over every (tile, chunk)
//                                grid step with a chunk-bbox skip.
//
// What it computes. Per pixel (u, v) and hypothesis p, over faces in their
// spatially sorted order: barycentrics a = ca_u*u + ca_v*v + ca_0, b
// likewise, c = (1 - a) - b; coverage a >= 0 && b >= 0 && c >= 0;
// interpolated 1/z = cz_u*u + cz_v*v + cz_0. It keeps the MAX 1/z (> 0;
// the first face in sorted order wins a tie) and records the winning
// sorted-face id and a, b. The 9 per-face coefficients and the per-chunk
// screen bounds come from the host set-up (rasterizer_cuda.py:_sorted_tris).
//
// What bounds it on this card. The inputs need few coverage tests (about
// one per pixel a face's screen bbox holds) and move little: the bytes-side
// bound is the coefficients read once and 16 bytes per pixel written once.
// What cost the time in the first design (one CTA per 8x32 tile walking
// every chunk) was (1) load imbalance: a small on-screen mesh put every
// chunk on the ~60 CTAs whose tiles its bbox touches, each walking its
// whole chunk list alone; (2) shared-memory loads: 9 scalar loads per face
// served one pixel; (3) every CTA read every chunk's bounds, empty tiles
// included; (4) each ~1-pixel face was tested against all 256 pixels of
// the tile. After the redesign, about half of a call's device time is the
// raster and the rest memory traffic that grows with the frame, not the
// mesh: clearing the (P, H, W) keys, and the finalize reading them and
// writing the four outputs (PERF.md).
//
// What the design does about it.
//   - Order-free merge. A candidate is the key
//       (float_bits(1/z) << 32) | (0xFFFFFFFF - sorted_face_id),
//     and a pixel keeps the largest key through atomicMax on a (P, H, W)
//     u64 buffer. Positive floats order like their bits, so the largest
//     key holds the largest 1/z and, on an exact tie, the smallest face
//     id: what the strict '>' over the ascending walk gives. Key 0 is
//     background. So one tile's chunks may be split across CTAs in any
//     order. A CTA reduces its own candidates in registers (strict '>',
//     ascending faces) and makes one atomic per pixel it covered.
//   - K1: a (tile, chunk) work list built on the device. One CTA per
//     (chunk, hypothesis) turns the chunk's bounds into a clipped tile span
//     (the off-screen and empty rules of _build_pairs, at this file's tile
//     size) and counts it; the last CTA to finish takes the exclusive
//     prefix sum. A persistent grid (the SM count times the CTAs one SM
//     holds) strides over the item count read from device memory, and
//     decodes item i to its chunk by binary search in the prefix sums, as
//     _build_pairs does with searchsorted. No host sync, no capacity,
//     nothing dropped, and no CTA reads a chunk that misses its tile.
//   - K2: the exhaustive grid split along the chunk axis, as the TPU's
//     (tv, tu, kc) grid is: one CTA per (tile, block of 32 chunks,
//     hypothesis). One warp tests the block's 32 chunk bounds at once and
//     a ballot gives the chunks to rasterize.
//   - The shared body (chunk_pass). The build kernel gives each face a
//     cull box (one float4): the region where the coefficients' exact
//     barycentrics lie within the rounding bound of the loop's float
//     arithmetic, widened by 1 pixel, so no pixel the loop would cover
//     lies outside it. A chunk's boxes and its coefficient rows, as they
//     lie in `packed`, are staged with 16-byte cp.async copies,
//     double-buffered. Faces are ~1 px on the main path, so a tile-wide
//     test of every face wastes nearly all its work: a face whose box holds
//     at most 64 of the tile's pixel centers is walked by one thread over
//     those pixels, each covered pixel's key merged into the tile's keys
//     in shared memory (atomicMax). Larger faces, found by a ballot, take
//     the tile-wide path: each thread owns 4 pixels along u (one
//     coefficient load serves all four), and a warp (a 4x32 sub-tile)
//     skips a face whose box misses it.
//   - A finalize kernel decodes each key into izb and fidx and recomputes
//     a, b from the winning face's coefficients with the loop's arithmetic,
//     so all four outputs are bit-identical to one ascending walk.
// Per call: one memset (keys and the build's done counter), then the build,
// raster and finalize kernels.
//
// Exactness. The coverage and depth arithmetic is written with
// __fmul_rn/__fadd_rn/__fsub_rn (and the file is built with -fmad=false),
// so no multiply-add is contracted: a pixel on a face edge decides
// coverage exactly as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileU = 32;  // tile width, pixels (KERNEL_TILE_U in Python)
constexpr int kTileV = 16;  // tile height, pixels (KERNEL_TILE_V)
constexpr int kPx = 4;            // consecutive u pixels per thread
constexpr int kThreads = kTileU * kTileV / kPx;  // 128
constexpr int kLanesPerRow = kTileU / kPx;        // 8
constexpr int kWarpRows = 32 / kLanesPerRow;      // 4 rows per warp
constexpr int kChunk = 128;       // faces per chunk
constexpr int kBlockChunks = 32;  // K2: chunks per CTA (one ballot)
constexpr int kTilePx = kTileU * kTileV;   // 512
constexpr int kSmallPx = 64;      // most tile pixels a small face's box holds
constexpr int kScanPer = 8;       // counts per thread in the build's prefix sum
constexpr float kInvTileU = 1.0f / kTileU;  // exact: powers of two
constexpr float kInvTileV = 1.0f / kTileV;
constexpr double kCullMargin = 1.0;         // pixels

static_assert(kThreads == kChunk, "one thread per face of a chunk");
static_assert(kWarpRows * kLanesPerRow == 32, "a warp holds whole rows");

typedef unsigned long long u64;

__device__ __forceinline__ float affine(float cu, float cv, float c0,
                                        float pu, float pv) {
  return __fadd_rn(__fadd_rn(__fmul_rn(cu, pu), __fmul_rn(cv, pv)), c0);
}

__device__ __forceinline__ int tiles(int n, int t) { return (n + t - 1) / t; }

// The tiles a chunk's bounds (v_min, v_max, u_min, u_max) touch, clipped to
// the frame: nv x nu tiles from (tv0, tu0); nv = nu = 0 when the chunk is
// off-screen or empty (_build_pairs's rules). NaN bounds fail every
// comparison and so count as off-screen.
struct Span {
  int tv0, tu0, nv, nu;
};

__device__ __forceinline__ Span chunk_span(float4 bd, int h, int w) {
  Span s = {0, 0, 0, 0};
  const bool on = bd.y >= 0.0f && bd.x <= static_cast<float>(h - 1) &&
                  bd.w >= 0.0f && bd.z <= static_cast<float>(w - 1) &&
                  bd.x <= bd.y;
  if (!on) return s;
  const float mv = static_cast<float>(tiles(h, kTileV) - 1);
  const float mu = static_cast<float>(tiles(w, kTileU) - 1);
  auto tile = [](float x, float inv, float last) {
    return static_cast<int>(fminf(fmaxf(floorf(x * inv), 0.f), last));
  };
  const int tv0 = tile(bd.x, kInvTileV, mv), tv1 = tile(bd.y, kInvTileV, mv);
  const int tu0 = tile(bd.z, kInvTileU, mu), tu1 = tile(bd.w, kInvTileU, mu);
  s.tv0 = tv0;
  s.tu0 = tu0;
  s.nv = tv1 - tv0 + 1;
  s.nu = tu1 - tu0 + 1;
  return s;
}

// The cull box (u_min, u_max, v_min, v_max) of one face. The loop's float
// a differs from the exact a of the same coefficients by at most
// 3u(|ca_u u| + |ca_v v|) + u|ca_0| (u = 2^-24) at any pixel of the frame;
// da is more than twice that, and likewise db, and dc for c = (1 - a) - b.
// A pixel the loop covers thus lies in the triangle a >= -da, b >= -db,
// a + b <= 1 + dc, whose corners are solved here in double. Faces with
// constant barycentrics cover everywhere or nowhere; a singular or
// non-finite system gets the whole plane (no cull).
__device__ float4 cull_box(const float* c, int h, int w) {
  const float inf = __int_as_float(0x7f800000);
  const float4 everywhere = make_float4(-inf, inf, -inf, inf);
  const float4 nowhere = make_float4(inf, -inf, inf, -inf);
  const double au = c[0], av = c[1], a0 = c[2];
  const double bu = c[3], bv = c[4], b0 = c[5];
  if (c[0] == 0.f && c[1] == 0.f && c[3] == 0.f && c[4] == 0.f) {
    const float cc = __fsub_rn(__fsub_rn(1.0f, c[2]), c[5]);
    return (c[2] >= 0.f && c[5] >= 0.f && cc >= 0.f) ? everywhere : nowhere;
  }
  const double det = au * bv - av * bu;
  if (!(det != 0.0) || !isfinite(det)) return everywhere;
  const double um = w - 1, vm = h - 1;
  const double eps = 1.0 / (1 << 23);
  const double da =
      4.0 * eps * (fabs(au) * um + fabs(av) * vm + fabs(a0)) + 1e-30;
  const double db =
      4.0 * eps * (fabs(bu) * um + fabs(bv) * vm + fabs(b0)) + 1e-30;
  const double dc = da + db + 8.0 * eps;
  const double ca[3] = {-da, 1.0 + dc + db, -da};
  const double cb[3] = {-db, -db, 1.0 + dc + da};
  double u0 = 1e300, u1 = -1e300, v0 = 1e300, v1 = -1e300;
  const double inv = 1.0 / det;
  for (int k = 0; k < 3; ++k) {
    const double ra = ca[k] - a0, rb = cb[k] - b0;
    const double u = (ra * bv - av * rb) * inv;
    const double v = (au * rb - ra * bu) * inv;
    u0 = fmin(u0, u);
    u1 = fmax(u1, u);
    v0 = fmin(v0, v);
    v1 = fmax(v1, v);
  }
  if (!(isfinite(u0) && isfinite(u1) && isfinite(v0) && isfinite(v1)))
    return everywhere;
  return make_float4(__double2float_rd(u0 - kCullMargin),
                     __double2float_ru(u1 + kCullMargin),
                     __double2float_rd(v0 - kCullMargin),
                     __double2float_ru(v1 + kCullMargin));
}

// Build: one CTA per (chunk, hypothesis), one thread per face. Writes each
// face's cull box and, with `with_list`, the chunk's tile count; the last
// CTA to finish writes the exclusive prefix sum of the counts over
// (hypothesis, chunk), with the total last.
__global__ void __launch_bounds__(kChunk)
build_kernel(const float* __restrict__ packed,  // (P, 9, Fp)
             const float4* __restrict__ bounds, // (P, nc)
             float4* __restrict__ boxes,        // (P, Fp)
             int* __restrict__ counts,          // (P * nc)
             int* __restrict__ offsets,         // (P * nc + 1)
             unsigned* __restrict__ done, int fp, int nc, int h, int w,
             int with_list) {
  const int p = blockIdx.y;
  const int chunk = blockIdx.x;
  const int f = chunk * kChunk + threadIdx.x;
  const float* pk = packed + static_cast<size_t>(p) * 9 * fp + f;
  float c[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) c[r] = pk[static_cast<size_t>(r) * fp];
  boxes[static_cast<size_t>(p) * fp + f] = cull_box(c, h, w);
  if (!with_list) return;

  __shared__ bool last;
  __shared__ int warp_sum[kChunk / 32];
  if (threadIdx.x == 0) {
    const Span s = chunk_span(bounds[p * nc + chunk], h, w);
    counts[p * nc + chunk] = s.nv * s.nu;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n = gridDim.y * nc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += kChunk * kScanPer) {
    const int i0 = base + threadIdx.x * kScanPer;
    int x[kScanPer];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      x[j] = i0 + j < n ? __ldcg(counts + i0 + j) : 0;
      sum += x[j];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int run = carry + incl - sum, total = 0;
#pragma unroll
    for (int k = 0; k < kChunk / 32; ++k) {
      run += k < warp ? warp_sum[k] : 0;
      total += warp_sum[k];
    }
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      if (i0 + j < n) offsets[i0 + j] = run;
      run += x[j];
    }
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[n] = carry;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One chunk in shared memory: its 128 cull boxes (2 KB) and its 9 x 128
// coefficients (4.6 KB), rows as they lie in `packed`.
struct Staged {
  float4 box[kChunk];
  float coef[9][kChunk];
};

// Stage chunk `chunk` of hypothesis `p` with 16-byte cp.async copies.
__device__ __forceinline__ void stage(Staged& dst, const float4* boxes,
                                      const float* packed, int p, int chunk,
                                      int fp) {
  const size_t f0 = static_cast<size_t>(chunk) * kChunk;
  cp_async16(&dst.box[threadIdx.x],
             boxes + static_cast<size_t>(p) * fp + f0 + threadIdx.x);
  const float* pk = packed + static_cast<size_t>(p) * 9 * fp + f0;
  constexpr int kQuads = kChunk / 4;
#pragma unroll
  for (int i = threadIdx.x; i < 9 * kQuads; i += kThreads) {
    const int r = i / kQuads;
    const int q = i - r * kQuads;
    cp_async16(&dst.coef[r][4 * q], pk + static_cast<size_t>(r) * fp + 4 * q);
  }
}

// The pixels one thread owns in a tile, and its warp's sub-tile.
struct Pixels {
  float pu0, pv;            // first pixel (u along the row)
  float wu0, wu1, wv0, wv1; // the warp's sub-tile, inclusive
  float tv0f, tu0f;         // the tile's first row and column
  int u0, v;
  int local;                // tile-local index of the first pixel
};

__device__ __forceinline__ Pixels tile_pixels(int tv, int tu) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = warp * kWarpRows + lane / kLanesPerRow;
  const int col = (lane % kLanesPerRow) * kPx;
  Pixels px;
  px.u0 = tu * kTileU + col;
  px.v = tv * kTileV + row;
  px.local = row * kTileU + col;
  px.pu0 = static_cast<float>(px.u0);
  px.pv = static_cast<float>(px.v);
  px.tu0f = static_cast<float>(tu * kTileU);
  px.tv0f = static_cast<float>(tv * kTileV);
  px.wu0 = px.tu0f;
  px.wu1 = px.wu0 + (kTileU - 1);
  px.wv0 = px.tv0f + static_cast<float>(warp * kWarpRows);
  px.wv1 = px.wv0 + (kWarpRows - 1);
  return px;
}

__device__ __forceinline__ u64 make_key(float iz, int fid) {
  return (static_cast<u64>(__float_as_uint(iz)) << 32) |
         static_cast<u64>(0xFFFFFFFFu - static_cast<unsigned>(fid));
}

// Shared state of one raster CTA: the staged chunks, the tile's keys from
// small faces, and which faces of the chunk take the tile-wide path.
struct RasterSmem {
  Staged buf[2];
  u64 keys[kTilePx];
  unsigned wide[kChunk / 32];
};

// The per-chunk body (_chunk_body), called by all threads of the CTA.
// A face whose cull box holds at most kSmallPx pixel centers of the tile
// is small: its thread walks those pixels and merges each covered one's
// key into the tile's shared keys (atomicMax). The other faces, in
// ascending order, go against every warp whose sub-tile their box meets
// (a warp-uniform branch): each thread tests its kPx pixels and keeps the
// running max of 1/z under a strict '>' in registers. Both paths use the
// same arithmetic, and the keys make their merge order-free.
__device__ __forceinline__ void chunk_pass(const Staged& s,
                                           int fbase, const Pixels& px,
                                           float (&best)[kPx],
                                           int (&bid)[kPx], RasterSmem& sm) {
  const int t = threadIdx.x;
  const float4 bx = s.box[t];
  const float u_lo = fmaxf(ceilf(bx.x), px.tu0f);
  const float u_hi = fminf(floorf(bx.y), px.tu0f + (kTileU - 1));
  const float v_lo = fmaxf(ceilf(bx.z), px.tv0f);
  const float v_hi = fminf(floorf(bx.w), px.tv0f + (kTileV - 1));
  bool wide = false;
  if (u_lo <= u_hi && v_lo <= v_hi) {
    const int nu = static_cast<int>(u_hi - u_lo) + 1;
    const int nv = static_cast<int>(v_hi - v_lo) + 1;
    if (nu * nv > kSmallPx) {
      wide = true;
    } else {
      const float ca_u = s.coef[0][t], ca_v = s.coef[1][t], ca_0 = s.coef[2][t];
      const float cb_u = s.coef[3][t], cb_v = s.coef[4][t], cb_0 = s.coef[5][t];
      const float cz_u = s.coef[6][t], cz_v = s.coef[7][t], cz_0 = s.coef[8][t];
      const int base = static_cast<int>(v_lo - px.tv0f) * kTileU +
                       static_cast<int>(u_lo - px.tu0f);
      for (int dv = 0; dv < nv; ++dv) {
        const float pv = v_lo + static_cast<float>(dv);
        for (int du = 0; du < nu; ++du) {
          const float pu = u_lo + static_cast<float>(du);
          const float a = affine(ca_u, ca_v, ca_0, pu, pv);
          const float b = affine(cb_u, cb_v, cb_0, pu, pv);
          const float c = __fsub_rn(__fsub_rn(1.0f, a), b);
          const float izi = affine(cz_u, cz_v, cz_0, pu, pv);
          if (a >= 0.0f && b >= 0.0f && c >= 0.0f && izi > 0.0f)
            atomicMax(&sm.keys[base + dv * kTileU + du],
                      make_key(izi, fbase + t));
        }
      }
    }
  }
  const unsigned m = __ballot_sync(0xffffffffu, wide);
  if ((t & 31) == 0) sm.wide[t >> 5] = m;
  __syncthreads();
#pragma unroll 1
  for (int j = 0; j < kChunk / 32; ++j) {
    unsigned mj = sm.wide[j];
    while (mj) {
      const int f = j * 32 + __ffs(mj) - 1;
      mj &= mj - 1;
      const float4 fb = s.box[f];
      if (fb.y < px.wu0 || fb.x > px.wu1 || fb.w < px.wv0 || fb.z > px.wv1)
        continue;
      const float ca_u = s.coef[0][f], ca_v = s.coef[1][f], ca_0 = s.coef[2][f];
      const float cb_u = s.coef[3][f], cb_v = s.coef[4][f], cb_0 = s.coef[5][f];
      const float cz_u = s.coef[6][f], cz_v = s.coef[7][f], cz_0 = s.coef[8][f];
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const float pu = px.pu0 + static_cast<float>(k);
        const float a = affine(ca_u, ca_v, ca_0, pu, px.pv);
        const float b = affine(cb_u, cb_v, cb_0, pu, px.pv);
        const float c = __fsub_rn(__fsub_rn(1.0f, a), b);
        const bool cover = (a >= 0.0f) && (b >= 0.0f) && (c >= 0.0f);
        const float izi = affine(cz_u, cz_v, cz_0, pu, px.pv);
        const float cand = cover ? izi : -1.0f;
        if (cand > best[k]) {
          best[k] = cand;
          bid[k] = fbase + f;
        }
      }
    }
  }
}

// Start a tile: no candidate in registers, the thread's shared keys 0.
__device__ __forceinline__ void clear_tile(const Pixels& px, float (&best)[kPx],
                                           int (&bid)[kPx], RasterSmem& sm) {
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    best[k] = 0.0f;
    bid[k] = -1;
    sm.keys[px.local + k] = 0;
  }
}

// One atomicMax per covered pixel of the thread (none for background), of
// the larger of its register and shared keys. Called after a barrier that
// follows the last chunk_pass of the tile.
__device__ __forceinline__ void flush(u64* __restrict__ keys, const Pixels& px,
                                      const float (&best)[kPx],
                                      const int (&bid)[kPx],
                                      const RasterSmem& sm, int h, int w) {
  if (px.v >= h) return;
  u64* row = keys + static_cast<size_t>(px.v) * w;
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    u64 key = sm.keys[px.local + k];
    if (best[k] > 0.0f) {
      const u64 reg = make_key(best[k], bid[k]);
      key = reg > key ? reg : key;
    }
    if (key != 0 && px.u0 + k < w) atomicMax(row + px.u0 + k, key);
  }
}

// K1's raster: a persistent grid over the (tile, chunk) items.
__global__ void __launch_bounds__(kThreads)
binned_raster(const float* __restrict__ packed,
              const float4* __restrict__ boxes,
              const float4* __restrict__ bounds,
              const int* __restrict__ offsets, u64* __restrict__ keys,
              int n_hyp, int fp, int nc, int h, int w) {
  __shared__ __align__(16) RasterSmem sm;
  const int n_g = n_hyp * nc;
  const int total = offsets[n_g];
  int item = blockIdx.x;
  if (item >= total) return;

  // item -> (flat chunk g = p * nc + chunk, tile): the last g whose
  // prefix sum is <= item, then the item's rank within g's span
  auto decode = [&](int i, int& g, int& tv, int& tu) {
    int lo = 0, hi = n_g - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (offsets[mid] <= i) lo = mid; else hi = mid - 1;
    }
    g = lo;
    const Span s = chunk_span(bounds[g], h, w);
    const int k = i - offsets[g];
    tv = s.tv0 + k / s.nu;
    tu = s.tu0 + k % s.nu;
  };
  auto stage_item = [&](Staged& dst, int g) {
    const int p = g / nc;
    stage(dst, boxes, packed, p, g - p * nc, fp);
  };

  int g, tv, tu;
  decode(item, g, tv, tu);
  stage_item(sm.buf[0], g);
  cp_async_commit();
  for (int s = 0;; s ^= 1) {
    const int nxt = item + gridDim.x;
    int g2 = 0, tv2 = 0, tu2 = 0;
    if (nxt < total) {
      decode(nxt, g2, tv2, tu2);
      stage_item(sm.buf[s ^ 1], g2);
    }
    cp_async_commit();
    const int p = g / nc;
    const Pixels px = tile_pixels(tv, tu);
    float best[kPx];
    int bid[kPx];
    clear_tile(px, best, bid, sm);
    cp_async_wait_prev();
    __syncthreads();
    chunk_pass(sm.buf[s], (g - p * nc) * kChunk, px, best, bid, sm);
    flush(keys + static_cast<size_t>(p) * h * w, px, best, bid, sm, h, w);
    if (nxt >= total) break;
    __syncthreads();  // buf[s] and the wide masks are free again
    item = nxt;
    g = g2;
    tv = tv2;
    tu = tu2;
  }
}

// K2's raster: one CTA per (tile, block of 32 chunks, hypothesis).
__global__ void __launch_bounds__(kThreads)
exhaustive_raster(const float* __restrict__ packed,
                  const float4* __restrict__ boxes,
                  const float4* __restrict__ bounds, u64* __restrict__ keys,
                  int fp, int nc, int h, int w) {
  __shared__ __align__(16) RasterSmem sm;
  __shared__ unsigned mask_s;
  const int n_tu = tiles(w, kTileU);
  const int tv = blockIdx.x / n_tu;
  const int tu = blockIdx.x - tv * n_tu;
  const int c0 = blockIdx.y * kBlockChunks;
  const int p = blockIdx.z;
  if (threadIdx.x < 32) {
    const int chunk = c0 + threadIdx.x;
    bool hit = false;
    if (chunk < nc) {
      const Span s = chunk_span(bounds[p * nc + chunk], h, w);
      hit = tv >= s.tv0 && tv < s.tv0 + s.nv && tu >= s.tu0 &&
            tu < s.tu0 + s.nu;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (threadIdx.x == 0) mask_s = m;
  }
  __syncthreads();
  unsigned m = mask_s;
  if (m == 0) return;

  int chunk = c0 + __ffs(m) - 1;
  m &= m - 1;
  stage(sm.buf[0], boxes, packed, p, chunk, fp);
  cp_async_commit();
  const Pixels px = tile_pixels(tv, tu);
  float best[kPx];
  int bid[kPx];
  clear_tile(px, best, bid, sm);
  for (int s = 0;; s ^= 1) {
    int next = -1;
    if (m) {
      next = c0 + __ffs(m) - 1;
      m &= m - 1;
      stage(sm.buf[s ^ 1], boxes, packed, p, next, fp);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    chunk_pass(sm.buf[s], chunk * kChunk, px, best, bid, sm);
    if (next < 0) break;
    __syncthreads();
    chunk = next;
  }
  flush(keys + static_cast<size_t>(p) * h * w, px, best, bid, sm, h, w);
}

// Decode each key into izb and fidx, and recompute a, b from the winning
// face's coefficients with the loop's arithmetic.
__global__ void __launch_bounds__(256)
finalize_kernel(const u64* __restrict__ keys, const float* __restrict__ packed,
                float* __restrict__ izb, int* __restrict__ fidx,
                float* __restrict__ a_out, float* __restrict__ b_out, int fp,
                int h, int w, size_t n) {
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const u64 key = keys[o];
  if (key == 0) {
    izb[o] = 0.0f;
    fidx[o] = -1;
    a_out[o] = 0.0f;
    b_out[o] = 0.0f;
    return;
  }
  const size_t hw = static_cast<size_t>(h) * w;
  const size_t p = o / hw;
  const int r = static_cast<int>(o - p * hw);
  const int v = r / w;
  const int u = r - v * w;
  const int fid = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
  const float* pk = packed + p * 9 * fp + fid;
  const float pu = static_cast<float>(u);
  const float pv = static_cast<float>(v);
  izb[o] = __uint_as_float(static_cast<unsigned>(key >> 32));
  fidx[o] = fid;
  a_out[o] = affine(pk[0], pk[fp], pk[2 * fp], pu, pv);
  b_out[o] = affine(pk[3 * fp], pk[4 * fp], pk[5 * fp], pu, pv);
}

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// Scratch layout: keys (P*H*W u64, then the build's done counter), cull
// boxes, per-chunk counts, prefix sums.
struct Scratch {
  u64* keys;
  unsigned* done;
  float4* boxes;
  int* counts;
  int* offsets;
  size_t key_bytes;
};

size_t scratch_bytes(int n_hyp, int fp, int nc, int h, int w, Scratch* out,
                     void* base) {
  const size_t n_px = static_cast<size_t>(n_hyp) * h * w;
  const size_t key_bytes = (n_px + 1) * sizeof(u64);
  const size_t box_bytes = static_cast<size_t>(n_hyp) * fp * sizeof(float4);
  const size_t cnt_bytes = static_cast<size_t>(n_hyp) * nc * sizeof(int);
  const size_t off_bytes = (static_cast<size_t>(n_hyp) * nc + 1) * sizeof(int);
  const size_t o_box = align256(key_bytes);
  const size_t o_cnt = o_box + align256(box_bytes);
  const size_t o_off = o_cnt + align256(cnt_bytes);
  if (out) {
    char* b = static_cast<char*>(base);
    out->keys = reinterpret_cast<u64*>(b);
    out->done = reinterpret_cast<unsigned*>(b + n_px * sizeof(u64));
    out->boxes = reinterpret_cast<float4*>(b + o_box);
    out->counts = reinterpret_cast<int*>(b + o_cnt);
    out->offsets = reinterpret_cast<int*>(b + o_off);
    out->key_bytes = key_bytes;
  }
  return o_off + align256(off_bytes);
}

int clear_and_build(const float* packed, const float* bounds, Scratch& sc,
                    int n_hyp, int fp, int nc, int h, int w, int with_list,
                    cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(sc.keys, 0, sc.key_bytes, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  build_kernel<<<dim3(nc, n_hyp), kChunk, 0, st>>>(
      packed, reinterpret_cast<const float4*>(bounds), sc.boxes, sc.counts,
      sc.offsets, sc.done, fp, nc, h, w, with_list);
  return static_cast<int>(cudaGetLastError());
}

int finalize(const float* packed, Scratch& sc, float* izb, int* fidx,
             float* a, float* b, int n_hyp, int fp, int h, int w,
             cudaStream_t st) {
  const size_t n = static_cast<size_t>(n_hyp) * h * w;
  finalize_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      sc.keys, packed, izb, fidx, a, b, fp, h, w, n);
  return static_cast<int>(cudaGetLastError());
}

// K1's persistent grid: the SM count times the CTAs one SM holds.
int binned_grid() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, binned_raster,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// Every entry launches on `stream` and returns cudaGetLastError() (0 =
// launched). They allocate nothing and do not synchronize: `scratch` is a
// device buffer of p2p_scratch_bytes(...) bytes from the caller.
extern "C" size_t p2p_scratch_bytes(int n_hyp, int fp, int n_chunks, int h,
                                    int w) {
  return scratch_bytes(n_hyp, fp, n_chunks, h, w, nullptr, nullptr);
}

// K1: any frame size.
extern "C" int p2p_rasterize_binned(const float* packed, const float* bounds,
                                    float* izb, int* fidx, float* a,
                                    float* b, void* scratch, int n_hyp,
                                    int fp, int n_chunks, int h, int w,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch sc;
  scratch_bytes(n_hyp, fp, n_chunks, h, w, &sc, scratch);
  int err = clear_and_build(packed, bounds, sc, n_hyp, fp, n_chunks, h, w, 1,
                            st);
  if (err) return err;
  const int grid = binned_grid();
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  binned_raster<<<grid, kThreads, 0, st>>>(
      packed, sc.boxes, reinterpret_cast<const float4*>(bounds), sc.offsets,
      sc.keys, n_hyp, fp, n_chunks, h, w);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return finalize(packed, sc, izb, fidx, a, b, n_hyp, fp, h, w, st);
}

// K2's contract: h % 16 == 0 and w % 128 == 0 (the TPU kernel's tile), else
// cudaErrorInvalidValue and nothing is launched. Same outputs as K1.
extern "C" int p2p_rasterize_exhaustive(const float* packed,
                                        const float* bounds, float* izb,
                                        int* fidx, float* a, float* b,
                                        void* scratch, int n_hyp, int fp,
                                        int n_chunks, int h, int w,
                                        void* stream) {
  if (h % 16 != 0 || w % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch sc;
  scratch_bytes(n_hyp, fp, n_chunks, h, w, &sc, scratch);
  int err = clear_and_build(packed, bounds, sc, n_hyp, fp, n_chunks, h, w, 0,
                            st);
  if (err) return err;
  const dim3 grid((h / kTileV) * (w / kTileU),
                  (n_chunks + kBlockChunks - 1) / kBlockChunks, n_hyp);
  exhaustive_raster<<<grid, kThreads, 0, st>>>(
      packed, sc.boxes, reinterpret_cast<const float4*>(bounds), sc.keys, fp,
      n_chunks, h, w);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return finalize(packed, sc, izb, fidx, a, b, n_hyp, fp, h, w, st);
}

// K1's work list alone: the build kernel's prefix sums over (hypothesis,
// chunk), copied to `offsets` (P * n_chunks + 1 int32, the total last).
extern "C" int p2p_build_worklist(const float* packed, const float* bounds,
                                  int* offsets, void* scratch, int n_hyp,
                                  int fp, int n_chunks, int h, int w,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch sc;
  scratch_bytes(n_hyp, fp, n_chunks, h, w, &sc, scratch);
  const int err = clear_and_build(packed, bounds, sc, n_hyp, fp, n_chunks, h,
                                  w, 1, st);
  if (err) return err;
  return static_cast<int>(cudaMemcpyAsync(
      offsets, sc.offsets,
      (static_cast<size_t>(n_hyp) * n_chunks + 1) * sizeof(int),
      cudaMemcpyDeviceToDevice, st));
}
