// Matrix-free Gram products for Hopper (sm_90a), K never stored:
//     gram_matvec:  out = (K(x, x) + nugget I) V
//     cross_matvec: out = K(x1, x2) V
// with K = k(r2) read from the term table (terms.cuh): a sum of products of
// SE, White, Matern (half-integer nu), RQ and Periodic leaves.
//
// Replaces the TPU kernels gpx/ops/pallas_matvec.py::gram_matvec
// (_matvec_kernel) and ::cross_matvec (_cross_kernel), which rebuild
// (1024, 1024) Gram tiles in VMEM and multiply them into the right-hand
// sides on the MXU at HIGHEST precision.
//
// Bound: operations. Each Gram entry costs its kernel algebra (the
// distance, a square root for Matern and Periodic, one exponential per
// term and a logarithm per RQ term on the SFU, the sum of products) and R
// FMAs, while the bytes moved are O(N (D + R)). At the iterative path's
// widths (R <= 16) the algebra is most of the work.
//
// Design: one thread per output row, a block of 128 rows, and a chunk of
// RC columns of V per block (a power of two up to 32, from R; wider V
// takes gridDim.z chunks and rebuilds the entries once per chunk). The
// block walks its range of x2 in tiles of 32 points, staging the tile's
// coordinates (8 dimensions per pass, so any D works) and its (32, RC)
// slice of V in shared memory. Each thread forms its 32 entries k(r2) in
// registers (the family switch once per term, outside the loop over the
// 32 entries; a product's factors entry by entry through shared memory)
// and FMAs them into RC float sums; each tile's sums are added
// to double accumulators, as tile_core.cuh adds its k-slices (one running
// float sum over all N columns would carry N-fold rounding). Distances
// are broadcast differences at every D, exact at coincident points, so
// White's r2 == 0 fires at duplicates (D > 8 included). The symmetric
// product forces r2 = 0 on the global diagonal i == j and adds the nugget
// there; the cross product has neither. Ragged tiles are masked: points
// past the range read V as 0.
//
// When the row blocks and column chunks alone make too few blocks to fill
// the card (R = 1, small N), the column range is split across gridDim.y
// blocks, each writing double partials, and a second kernel sums the
// splits in a fixed order: one result per output, no atomics, so the
// result does not depend on the schedule.
#include <stdint.h>

#include "terms.cuh"

using namespace gpx;

constexpr int MV_ROWS = 128;   // rows per block, one per thread
constexpr int MV_TC = 32;      // points of x2 per tile
constexpr int MV_DC = 8;       // coordinates staged per pass
constexpr int MV_MAX_RC = 32;  // columns of V per block
constexpr int MV_MIN_SPLIT = 256;  // fewest points of x2 per split

// At least 3 blocks of 128 threads an SM (2 at RC = 32): ptxas's own
// target, set by the shared staging, would cap the wide instances at 128
// registers, where they spill
template <int RC>
__global__ void __launch_bounds__(MV_ROWS, RC >= 32 ? 2 : 3)
matvec_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
              int n1, int n2, int d, const float* __restrict__ v, int64_t ldv,
              int r, const int* __restrict__ table, int n_terms,
              const float* __restrict__ params, int n_params, float nugget,
              int symmetric, int split_cols, double* __restrict__ partials) {
  __shared__ float xs[MV_TC][MV_DC];
  __shared__ __align__(16) float vs[MV_TC][RC];
  __shared__ float stage[2 * MV_TC][MV_ROWS];  // products, entry by entry
  __shared__ TermSmem ts;
  load_terms(table, n_terms, params, n_params, ts);

  const int tid = threadIdx.x;
  const int i = blockIdx.x * MV_ROWS + tid;
  const bool row_ok = i < n1;
  const int q0 = blockIdx.z * RC;
  const int j_lo = blockIdx.y * split_cols;
  const int j_hi = min(n2, j_lo + split_cols);

  double acc[RC];
#pragma unroll
  for (int q = 0; q < RC; ++q) acc[q] = 0.0;

  for (int j0 = j_lo; j0 < j_hi; j0 += MV_TC) {
    __syncthreads();  // every reader of the previous tile is done
    for (int e = tid; e < MV_TC * RC; e += MV_ROWS) {
      const int c = e / RC, q = e % RC;
      const int gj = j0 + c, gq = q0 + q;
      vs[c][q] = (gj < j_hi && gq < r) ? v[(int64_t)gj * ldv + gq] : 0.0f;
    }
    float r2[MV_TC];
#pragma unroll
    for (int c = 0; c < MV_TC; ++c) r2[c] = 0.0f;
    for (int d0 = 0; d0 < d; d0 += MV_DC) {
      const int kd = min(MV_DC, d - d0);
      if (d0 > 0) __syncthreads();  // readers of the previous pass are done
      for (int e = tid; e < MV_TC * kd; e += MV_ROWS) {
        const int c = e / kd, k = e % kd, gj = j0 + c;
        xs[c][k] = gj < j_hi ? x2[(int64_t)gj * d + d0 + k] : 0.0f;
      }
      __syncthreads();
      for (int k = 0; k < kd; ++k) {
        const float xk = row_ok ? x1[(int64_t)i * d + d0 + k] : 0.0f;
#pragma unroll
        for (int c = 0; c < MV_TC; ++c) {
          const float diff = xk - xs[c][k];
          r2[c] = fmaf(diff, diff, r2[c]);
        }
      }
    }
    const int jd = i - j0;  // the tile column on the global diagonal
    if (symmetric) {
#pragma unroll
      for (int c = 0; c < MV_TC; ++c)
        if (c == jd) r2[c] = 0.0f;
    }
    float kv[MV_TC];
#pragma unroll
    for (int c = 0; c < MV_TC; ++c) kv[c] = 0.0f;
    kernel_values<MV_TC, true>(ts, n_terms, r2, kv, &stage[0][tid], MV_ROWS);
    if (symmetric) {
#pragma unroll
      for (int c = 0; c < MV_TC; ++c)
        if (c == jd) kv[c] += nugget;
    }
    float part[RC];
#pragma unroll
    for (int q = 0; q < RC; ++q) part[q] = 0.0f;
#pragma unroll
    for (int c = 0; c < MV_TC; ++c) {
#pragma unroll
      for (int q = 0; q < RC; ++q) part[q] = fmaf(kv[c], vs[c][q], part[q]);
    }
#pragma unroll
    for (int q = 0; q < RC; ++q) acc[q] += (double)part[q];
  }

  if (!row_ok) return;
  double* out = partials + ((int64_t)blockIdx.y * n1 + i) * r;
#pragma unroll
  for (int q = 0; q < RC; ++q)
    if (q0 + q < r) out[q0 + q] = acc[q];
}

// out[i, q] = sum over the splits, in split order, of partials[s, i, q]
__global__ void matvec_reduce_kernel(const double* __restrict__ partials,
                                     int splits, int64_t count, int r,
                                     float* __restrict__ out, int64_t ldo) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  double s = 0.0;
  for (int k = 0; k < splits; ++k) s += partials[(int64_t)k * count + idx];
  out[(idx / r) * ldo + idx % r] = (float)s;
}

struct Plan {
  int rc, chunks, splits, split_cols;
};

static Plan plan(int n1, int n2, int r) {
  Plan p;
  p.rc = 1;
  while (p.rc < r && p.rc < MV_MAX_RC) p.rc *= 2;
  p.chunks = (r + p.rc - 1) / p.rc;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int64_t blocks = (int64_t)((n1 + MV_ROWS - 1) / MV_ROWS) * p.chunks;
  const int64_t want = 8LL * sms;  // a few waves of 128-thread blocks
  int64_t splits = (want + blocks - 1) / blocks;
  const int64_t most = (n2 + MV_MIN_SPLIT - 1) / MV_MIN_SPLIT;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  // whole tiles per split, so that only the last split holds a ragged tile
  const int64_t tiles = (n2 + MV_TC - 1) / MV_TC;
  const int64_t per = (tiles + splits - 1) / splits;
  p.split_cols = (int)(per * MV_TC);
  p.splits = (int)((n2 + p.split_cols - 1) / p.split_cols);
  return p;
}

template <int RC>
static void launch(const Plan& p, const float* x1, const float* x2, int n1,
                   int n2, int d, const float* v, int64_t ldv, int r,
                   const int* table, int n_terms, const float* params,
                   int n_params, float nugget, int symmetric,
                   double* partials, cudaStream_t stream) {
  dim3 grid((n1 + MV_ROWS - 1) / MV_ROWS, p.splits, p.chunks);
  matvec_kernel<RC><<<grid, MV_ROWS, 0, stream>>>(
      x1, x2, n1, n2, d, v, ldv, r, table, n_terms, params, n_params, nugget,
      symmetric, p.split_cols, partials);
}

extern "C" {

// The number of column splits gpx_matvec uses for these sizes: the caller
// allocates `partials` as (splits, n1, r) doubles.
int gpx_matvec_splits(int n1, int n2, int r) {
  if (n1 < 1 || n2 < 1 || r < 1) return 0;
  return plan(n1, n2, r).splits;
}

int gpx_matvec(const float* x1, const float* x2, int n1, int n2, int d,
               const float* v, int64_t ldv, int r, const int* table,
               int n_terms, const float* params, int n_params, float nugget,
               int symmetric, double* partials, float* out, int64_t ldo,
               void* stream) {
  if (n1 < 1 || n2 < 1 || r < 1 || d < 1 || n_terms < 1 ||
      n_terms > GPX_MAX_TERMS || n_params > GPX_TERM_PARAMS * GPX_MAX_TERMS)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(n1, n2, r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.rc) {
#define GPX_MV_CASE(RC)                                                     \
  case RC:                                                                  \
    launch<RC>(p, x1, x2, n1, n2, d, v, ldv, r, table, n_terms, params,    \
               n_params, nugget, symmetric, partials, s);                   \
    break;
    GPX_MV_CASE(1)
    GPX_MV_CASE(2)
    GPX_MV_CASE(4)
    GPX_MV_CASE(8)
    GPX_MV_CASE(16)
    GPX_MV_CASE(32)
#undef GPX_MV_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t count = (int64_t)n1 * r;
  const int threads = 256;
  matvec_reduce_kernel<<<(unsigned)((count + threads - 1) / threads), threads,
                         0, s>>>(partials, p.splits, count, r, out, ldo);
  return (int)cudaGetLastError();
}

}  // extern "C"
