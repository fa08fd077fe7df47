// Z-buffer rasterizer for Hopper (sm_90a): one per-pixel loop behind two
// entry points.
//
// Replaces both TPU kernels of pix2pose_tpu/ops/rasterizer_pallas.py, which
// share the per-chunk body _chunk_body:
//   p2p_rasterize_binned      <- _binned_kernel (K1), driven there by
//                                rasterize_pallas_binned through a (tile,
//                                chunk) work list of static capacity;
//   p2p_rasterize_exhaustive  <- _kernel (K2), driven there by
//                                rasterize_pallas over every (tile, chunk)
//                                grid step with a chunk-bbox skip.
// Why one loop serves both: with no capacity, the two TPU host functions
// compute one function (the binned one equals the exhaustive one whenever
// its work list does not overflow), and the walk below is the exhaustive
// walk with the bbox skip: every CTA reads every chunk's bounds and skips
// chunks that miss its tile. The exhaustive entry keeps K2's contract
// (frames that tile by 16x128); the binned entry takes any frame size.
//
// What it computes. Per pixel (u, v) and hypothesis p, over faces walked in
// their spatially sorted order: barycentrics a = ca_u*u + ca_v*v + ca_0,
// b likewise, c = (1 - a) - b; coverage a >= 0 && b >= 0 && c >= 0;
// interpolated 1/z = cz_u*u + cz_v*v + cz_0. It keeps the MAX 1/z under a
// strict '>' (no division in the loop; the first face in sorted order wins
// a tie) and records the winning sorted-face id and a, b. The 9 per-face
// coefficients and the per-chunk screen bounds are computed host side in
// torch (rasterizer_cuda.py:_sorted_tris), so this file holds only the
// per-pixel loop.
//
// What bounds it on this card. One coverage test per (pixel, face) of
// every 128-face chunk whose screen bbox overlaps the pixel's tile:
// 6 multiplies, 8 adds or subtracts, 4 compares (three for coverage, one
// for depth) and a select per test, 18 operations, all from registers and
// broadcast shared-memory reads. Memory traffic is the 4.6 KB of
// coefficients per surviving chunk per CTA and 16 bytes of output per
// pixel. Neither the issue time of these tests nor that traffic accounts
// for the measured time (PERF.md); a CTA whose tile is crossed by many
// chunks walks them alone, so a small on-screen mesh loads few CTAs.
//
// What the design does about it. One CTA per (8x32 pixel tile,
// hypothesis), one thread per pixel, the running max carried in registers
// for the whole face loop, so nothing but the final tile is written. Small
// tiles make the chunk-bbox skip prune more pairs, and there is no work
// list, so no capacity and no overflow. Each surviving chunk's 9x128
// coefficients are staged in shared memory once and read by all 256
// threads as broadcasts. No atomics and no cross-CTA state.
//
// Exactness. The coverage and depth arithmetic is written with
// __fmul_rn/__fadd_rn/__fsub_rn (and the file is built with -fmad=false),
// so no multiply-add is contracted: a pixel on a face edge decides
// coverage exactly as the plain PyTorch version does.

#include <cuda_runtime.h>

namespace {

constexpr int kTileU = 32;
constexpr int kTileV = 8;
constexpr int kChunk = 128;
constexpr int kThreads = kTileU * kTileV;

__device__ __forceinline__ float affine(float cu, float cv, float c0,
                                        float pu, float pv) {
  return __fadd_rn(__fadd_rn(__fmul_rn(cu, pu), __fmul_rn(cv, pv)), c0);
}

__global__ void __launch_bounds__(kThreads)
zbuffer_kernel(const float* __restrict__ packed,   // (P, 9, Fp)
                      const float* __restrict__ bounds,   // (P, nc, 4)
                      float* __restrict__ izb_out,        // (P, H, W)
                      int* __restrict__ fidx_out,
                      float* __restrict__ a_out,
                      float* __restrict__ b_out,
                      int fp, int n_chunks, int h, int w) {
  __shared__ float coef[9][kChunk];

  const int p = blockIdx.z;
  const int tu0 = blockIdx.x * kTileU;
  const int tv0 = blockIdx.y * kTileV;
  const int u = tu0 + threadIdx.x;
  const int v = tv0 + threadIdx.y;
  const int tid = threadIdx.y * kTileU + threadIdx.x;
  const float pu = static_cast<float>(u);
  const float pv = static_cast<float>(v);
  const float t_v0 = static_cast<float>(tv0);
  const float t_v1 = static_cast<float>(tv0 + kTileV - 1);
  const float t_u0 = static_cast<float>(tu0);
  const float t_u1 = static_cast<float>(tu0 + kTileU - 1);
  const float* pk = packed + static_cast<size_t>(p) * 9 * fp;
  const float* bd = bounds + static_cast<size_t>(p) * n_chunks * 4;

  float izbuf = 0.0f;  // interpolated 1/z; 0 = background
  float abuf = 0.0f;
  float bbuf = 0.0f;
  int fbuf = -1;

  for (int kc = 0; kc < n_chunks; ++kc) {
    // every thread reads the same bounds, so this branch is CTA-uniform
    // and the barriers below are reached by all threads or none
    const float4 bb = reinterpret_cast<const float4*>(bd)[kc];
    if (!(bb.y >= t_v0 && bb.x <= t_v1 && bb.w >= t_u0 && bb.z <= t_u1))
      continue;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < 9 * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int f = i - r * kChunk;
      coef[r][f] = pk[static_cast<size_t>(r) * fp + kc * kChunk + f];
    }
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < kChunk; ++f) {
      const float a = affine(coef[0][f], coef[1][f], coef[2][f], pu, pv);
      const float b = affine(coef[3][f], coef[4][f], coef[5][f], pu, pv);
      const float c = __fsub_rn(__fsub_rn(1.0f, a), b);
      const bool cover = (a >= 0.0f) && (b >= 0.0f) && (c >= 0.0f);
      const float izi = affine(coef[6][f], coef[7][f], coef[8][f], pu, pv);
      const float cand = cover ? izi : -1.0f;
      if (cand > izbuf) {
        izbuf = cand;
        fbuf = kc * kChunk + f;
        abuf = a;
        bbuf = b;
      }
    }
  }
  if (u < w && v < h) {
    const size_t o = (static_cast<size_t>(p) * h + v) * w + u;
    izb_out[o] = izbuf;
    fidx_out[o] = fbuf;
    a_out[o] = abuf;
    b_out[o] = bbuf;
  }
}

int launch(const float* packed, const float* bounds, float* izb, int* fidx,
           float* a, float* b, int n_hyp, int fp, int n_chunks, int h, int w,
           void* stream) {
  const dim3 block(kTileU, kTileV, 1);
  const dim3 grid((w + kTileU - 1) / kTileU, (h + kTileV - 1) / kTileV,
                  n_hyp);
  zbuffer_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, bounds, izb, fidx, a, b, fp, n_chunks, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() (0 =
// launched). They allocate nothing and do not synchronize.
extern "C" int p2p_rasterize_binned(const float* packed, const float* bounds,
                                    float* izb, int* fidx, float* a,
                                    float* b, int n_hyp, int fp,
                                    int n_chunks, int h, int w,
                                    void* stream) {
  return launch(packed, bounds, izb, fidx, a, b, n_hyp, fp, n_chunks, h, w,
                stream);
}

// K2's contract: h % 16 == 0 and w % 128 == 0 (the TPU kernel's tile), else
// cudaErrorInvalidValue and nothing is launched. Same outputs otherwise.
extern "C" int p2p_rasterize_exhaustive(const float* packed,
                                        const float* bounds, float* izb,
                                        int* fidx, float* a, float* b,
                                        int n_hyp, int fp, int n_chunks,
                                        int h, int w, void* stream) {
  if (h % 16 != 0 || w % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(packed, bounds, izb, fidx, a, b, n_hyp, fp, n_chunks, h, w,
                stream);
}
