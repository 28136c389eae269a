// Gram matrix for Hopper (sm_90a): K = k(r2(x1, x2)) (+ nugget I).
//
// Replaces the TPU kernel gpx/ops/pallas_gram.py::pallas_gram (_pg,
// _gram_kernel): each tile of K is built in one pass, with squared
// distances and kernel algebra in registers and the nugget fused in.
//
// Bound: bytes. The kernel writes n * m floats (1 GiB at N = 16,384) and
// reads only the O(N D) coordinates, so its floor is the write at the
// card's memory rate. Design: one 32 x 32 output tile per block of 32 x 8
// threads, four rows per thread; a warp writes 32 consecutive floats of a
// row (128-byte stores). Coordinates are staged in shared memory in chunks
// of 8 dimensions, so any D works. Distances are broadcast differences at
// every D (exact at coincident points, so White's r2 == 0 fires), the
// caller centres x, and the symmetric diagonal is forced to r2 = 0. The
// kernel is read from the term table (terms.cuh): a sum of products of
// SE, White, Matern (half-integer nu), RQ and Periodic leaves, each family
// evaluated over the thread's four entries under one switch.
#include <stdint.h>

#include "terms.cuh"

using namespace gpx;

constexpr int GT = 32;   // tile edge
constexpr int GDC = 8;   // coordinates staged per pass

__global__ void __launch_bounds__(256)
gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
            int n, int m, int d, const int* __restrict__ table, int n_terms,
            const float* __restrict__ params, int n_params, float nugget,
            int symmetric, float* __restrict__ out, int64_t ldo) {
  __shared__ float xs1[GT][GDC + 1];
  __shared__ float xs2[GT][GDC + 1];
  __shared__ TermSmem ts;
  load_terms(table, n_terms, params, n_params, ts);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * GT + tx;
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  float r2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int d0 = 0; d0 < d; d0 += GDC) {
    for (int e = tid; e < GT * GDC; e += 256) {
      const int row = e / GDC, c = e % GDC, gd = d0 + c;
      const bool ok = gd < d;
      xs1[row][c] = (ok && i0 + row < n) ? x1[(int64_t)(i0 + row) * d + gd] : 0.0f;
      xs2[row][c] = (ok && j0 + row < m) ? x2[(int64_t)(j0 + row) * d + gd] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < GDC; ++c) {
      const float xj = xs2[tx][c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float diff = xs1[ty + 8 * r][c] - xj;
        r2[r] = fmaf(diff, diff, r2[r]);
      }
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  float k[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (symmetric && i0 + ty + 8 * r == j) r2[r] = 0.0f;
  kernel_values(ts, n_terms, r2, k);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 8 * r;
    if (i >= n || j >= m) continue;
    if (symmetric && i == j) k[r] += nugget;
    out[(int64_t)i * ldo + j] = k[r];
  }
}

extern "C" {

int gpx_gram(const float* x1, const float* x2, int n, int m, int d,
             const int* table, int n_terms, const float* params, int n_params,
             float nugget, int symmetric, float* out, int64_t ldo,
             void* stream) {
  if (n_terms < 1 || n_terms > GPX_MAX_TERMS ||
      n_params > GPX_TERM_PARAMS * GPX_MAX_TERMS)
    return (int)cudaErrorInvalidValue;
  dim3 grid((m + GT - 1) / GT, (n + GT - 1) / GT);
  dim3 block(GT, 8);
  gram_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, n, m, d, table, n_terms, params, n_params, nugget, symmetric,
      out, ldo);
  return (int)cudaGetLastError();
}

}  // extern "C"
