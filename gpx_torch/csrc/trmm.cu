// trmm and syrk_lower for Hopper (sm_90a), FP32 SIMT.
//
// Replaces the TPU kernels gpx/ops/pallas_trmm.py::trmm (with its active-
// tile schedule _schedule) and gpx/ops/pallas_trmm.py::syrk_lower, the
// O(N^3) building blocks of the Cholesky-and-inverse recursion
// (gpx_torch/ops/cuda_chol.py::chol_inv).
//
// trmm, L lower triangular (n x n) with exact zeros above its diagonal:
//   mode 0 right_lower   C (m x n) = B L     k-range of tile column j0: [j0, n)
//   mode 1 left_lower    C (n x m) = L B     k-range of tile row i0: [0, i0 + 64)
//   mode 2 right_lower_t C (m x n) = B L^T   k-range of tile column j0: [0, j0 + 64)
// so the zero tiles of L are never read. `sign` = -1 writes -C (the `neg`
// epilogue). syrk_lower: C = A0 - B B^T (B n x k) on the lower-triangle
// 64x64 tiles only; tiles above the diagonal are never written, so a
// caller's buffer keeps what it held there. C may alias A0 element for
// element (each element is read and written by the same thread).
//
// Bound: operations (2 m n k FLOPs at FP32 FMA rate; the triangle halves
// them for trmm). Design: the shared 64x64x16 tile core (tile_core.cuh),
// one block per output tile, the triangular k-range cut per tile; every
// operand is a (pointer, leading dimension) view, so the recursion updates
// its L and M buffers in place without copies.
#include "tile_core.cuh"

using namespace gpx;

template <bool B_T>
__global__ void __launch_bounds__(THREADS)
trmm_kernel(const float* __restrict__ A, int64_t lda,
            const float* __restrict__ B, int64_t ldb,
            float* __restrict__ C, int64_t ldc,
            int M, int N, int K, int mode, float sign) {
  __shared__ TileSmem sm;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  int k_lo = 0, k_hi = K;
  if (mode == 0) k_lo = j0;
  else if (mode == 1) k_hi = min(i0 + BM, K);
  else k_hi = min(j0 + BN, K);
  float acc[4][4];
  tile_product<false, B_T>(A, lda, B, ldb, i0, j0, k_lo, k_hi, M, N, acc,
                           sm);
  const int tx = tile_tx(), ty = tile_ty();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < N) C[(int64_t)i * ldc + j] = sign * acc[r][c];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
syrk_lower_kernel(const float* A0, int64_t lda0,
                  const float* __restrict__ B, int64_t ldb,
                  float* C, int64_t ldc, int n, int k) {
  __shared__ TileSmem sm;
  int bi, bj;
  lower_tile(blockIdx.x, bi, bj);
  const int i0 = bi * BM, j0 = bj * BN;
  float acc[4][4];
  tile_product<false, true>(B, ldb, B, ldb, i0, j0, 0, k, n, n, acc, sm);
  const int tx = tile_tx(), ty = tile_ty();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < n)
        C[(int64_t)i * ldc + j] = A0[(int64_t)i * lda0 + j] - acc[r][c];
    }
  }
}

extern "C" {

// C = op(A, B) for trmm `mode`; A is the left operand (B in the right
// modes, L in left_lower), B the right one. M x N output, K contraction.
int gpx_trmm(const float* A, int64_t lda, const float* B, int64_t ldb,
             float* C, int64_t ldc, int M, int N, int K, int mode, float sign,
             void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 2)
    trmm_kernel<true><<<grid, THREADS, 0, s>>>(A, lda, B, ldb, C, ldc, M, N,
                                               K, mode, sign);
  else
    trmm_kernel<false><<<grid, THREADS, 0, s>>>(A, lda, B, ldb, C, ldc, M, N,
                                                K, mode, sign);
  return (int)cudaGetLastError();
}

int gpx_syrk_lower(const float* A0, int64_t lda0, const float* B, int64_t ldb,
                   float* C, int64_t ldc, int n, int k, void* stream) {
  const int nb = (n + BM - 1) / BM;
  const int tiles = nb * (nb + 1) / 2;
  syrk_lower_kernel<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A0, lda0, B, ldb, C, ldc, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
