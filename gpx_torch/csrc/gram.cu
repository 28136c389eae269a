// Gram matrix for Hopper (sm_90a): K = k(r2(x1, x2)) (+ nugget I).
//
// Replaces the TPU kernel gpx/ops/pallas_gram.py::pallas_gram (_pg,
// _gram_kernel): each tile of K is built in one pass, with squared
// distances and kernel algebra in registers and the nugget fused in.
//
// Bound: bytes. The kernel writes n * m floats (1 GiB at N = 16,384: 0.321
// ms at 3.35 TB/s) and reads only the O(N D) coordinates; the families'
// arithmetic (one to three SFU operations an entry) hides under the
// writes. Design:
// - Persistent blocks: as many blocks of 256 threads as the card holds
//   resident, each loading the term table once and walking 32 x 128
//   output tiles in a fixed order (blockIdx.x, + gridDim.x, ...; row-major
//   over the tiles, so the blocks in flight write neighbouring tiles).
// - Each thread computes 4 rows (warp + 8 r) x 4 consecutive columns and
//   writes each row's 4 entries with one 16-byte store; a warp writes 512
//   contiguous bytes of a row. (Streaming stores, st.global.cs, ran no
//   faster on the card: PERF.md.)
// - An edge path of 4-byte stores covers the row and column tails, and
//   every tile when m or ldo is not a multiple of 4 or the output is not
//   16-byte aligned.
// - Coordinates: for D <= GPX_GRAM_L1_D (8) read through L1 (the row's
//   value is one broadcast load a warp); wider D staged in shared memory
//   in chunks of 8 dimensions per tile, so any D works.
// - Distances are broadcast differences at every D, summed over the
//   dimensions in order (exact at coincident points, so White's r2 == 0
//   fires, and K bitwise symmetric); the caller centres x; the symmetric
//   diagonal is forced to r2 = 0 and takes the nugget. The kernel is read
//   from the term table (terms.cuh): a sum of products of SE, White,
//   Matern (half-integer nu), RQ and Periodic leaves, each family
//   evaluated over the thread's 16 entries under one switch.
#include <stdint.h>

#include "grid.cuh"
#include "terms.cuh"

using namespace gpx;

namespace {

constexpr int GR = 32;        // tile rows: 8 warps x 4
constexpr int GC = 128;       // tile columns: 32 lanes x 4
constexpr int GDC = 8;        // coordinates staged per pass
constexpr int GTHREADS = 256;

// The widest D read through L1; wider D is staged. On an H100 the L1
// path ran faster than the staged one at D = 9 and slower at D = 12 and
// 20 (PERF.md); -DGPX_GRAM_L1_D=64 forces it, for chip_smoke.py
// --kernel-times.
#ifndef GPX_GRAM_L1_D
#define GPX_GRAM_L1_D 8
#endif

template <bool STAGED>
__global__ void __launch_bounds__(GTHREADS, STAGED ? 2 : 3)
gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
            int n, int m, int d, const int* __restrict__ table, int n_terms,
            const float* __restrict__ params, int n_params, float nugget,
            int symmetric, float* __restrict__ out, int64_t ldo, int vec) {
  __shared__ float xs1[STAGED ? GR : 1][GDC + 1];
  __shared__ float xs2[STAGED ? GC : 1][GDC + 1];
  __shared__ TermSmem ts;
  load_terms(table, n_terms, params, n_params, ts);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntc = (m + GC - 1) / GC;
  const int64_t tiles = (int64_t)((n + GR - 1) / GR) * ntc;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int i0 = (int)(tile / ntc) * GR, j0 = (int)(tile % ntc) * GC;
    const int jc = j0 + 4 * lane;  // the thread's first column
    float r2[16];                  // entry (r, c): row i0 + warp + 8 r
#pragma unroll
    for (int e = 0; e < 16; ++e) r2[e] = 0.0f;
    if (!STAGED) {
      for (int e = 0; e < d; ++e) {
        float xj[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          xj[c] = jc + c < m ? __ldg(x2 + (int64_t)(jc + c) * d + e) : 0.0f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + warp + 8 * r;
          const float xi = i < n ? __ldg(x1 + (int64_t)i * d + e) : 0.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float diff = xi - xj[c];
            r2[4 * r + c] = fmaf(diff, diff, r2[4 * r + c]);
          }
        }
      }
    } else {
      for (int d0 = 0; d0 < d; d0 += GDC) {
        __syncthreads();  // the last pass's reads are done
        for (int e = threadIdx.x; e < (GR + GC) * GDC; e += GTHREADS) {
          const int row = e / GDC, c = e % GDC, gd = d0 + c;
          if (row < GR) {
            const int i = i0 + row;
            xs1[row][c] = (gd < d && i < n) ? x1[(int64_t)i * d + gd] : 0.0f;
          } else {
            const int j = j0 + row - GR;
            xs2[row - GR][c] = (gd < d && j < m) ? x2[(int64_t)j * d + gd] : 0.0f;
          }
        }
        __syncthreads();
#pragma unroll
        for (int cc = 0; cc < GDC; ++cc) {
          float xj[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) xj[c] = xs2[4 * lane + c][cc];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float xi = xs1[warp + 8 * r][cc];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float diff = xi - xj[c];
              r2[4 * r + c] = fmaf(diff, diff, r2[4 * r + c]);
            }
          }
        }
      }
    }
    if (symmetric) {  // a guard: x_i - x_i is already exactly 0, so this
                      // changes no bit (a build without it passes every check)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i0 + warp + 8 * r == jc + c) r2[4 * r + c] = 0.0f;
    }
    float k[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) k[e] = 0.0f;
    kernel_values(ts, n_terms, r2, k);
    const bool full = vec && i0 + GR <= n && j0 + GC <= m;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + warp + 8 * r;
      if (symmetric) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i == jc + c) k[4 * r + c] += nugget;
      }
      float* row = out + (int64_t)i * ldo + jc;
      if (full) {
        *reinterpret_cast<float4*>(row) =
            make_float4(k[4 * r], k[4 * r + 1], k[4 * r + 2], k[4 * r + 3]);
      } else if (i < n) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (jc + c < m) row[c] = k[4 * r + c];
      }
    }
  }
}

// One launch on the persistent grid (grid.cuh)
template <bool STAGED>
int launch(const float* x1, const float* x2, int n, int m, int d,
           const int* table, int n_terms, const float* params, int n_params,
           float nugget, int symmetric, float* out, int64_t ldo, int vec,
           cudaStream_t st) {
  auto kern = gram_kernel<STAGED>;
  const int64_t tiles = (int64_t)((n + GR - 1) / GR) * ((m + GC - 1) / GC);
  int grid = 0;
  const cudaError_t e = resident_grid(kern, GTHREADS, 0, tiles, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, GTHREADS, 0, st>>>(x1, x2, n, m, d, table, n_terms, params,
                                  n_params, nugget, symmetric, out, ldo, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gpx_gram(const float* x1, const float* x2, int n, int m, int d,
             const int* table, int n_terms, const float* params, int n_params,
             float nugget, int symmetric, float* out, int64_t ldo,
             void* stream) {
  if (n_terms < 1 || n_terms > GPX_MAX_TERMS ||
      n_params > GPX_TERM_PARAMS * GPX_MAX_TERMS)
    return (int)cudaErrorInvalidValue;
  if (n < 1 || m < 1) return (int)cudaSuccess;
  const int vec = ((uintptr_t)out & 15) == 0 && (ldo & 3) == 0;
  auto go = d <= GPX_GRAM_L1_D ? &launch<false> : &launch<true>;
  return go(x1, x2, n, m, d, table, n_terms, params, n_params, nugget,
            symmetric, out, ldo, vec, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
