// The FP32 SIMT tile-product core of logml_probe_grad.cu (the s-deep
// products of the probe estimate), the 4 x 4 thread layout of a 64 x 64
// tile that grad_epilogue.cuh reads, and lower_tile. trmm.cu and
// logml_grad.cu run on the 3xTF32 tensor-core core (mma_tf32.cuh).
//
// A block of 256 threads computes one 64x64 output tile
//     acc(i, j) = sum_{k in [k_lo, k_hi)} opA(i, k) * opB(k, j)
// staging 16-deep k-slices of both operands through shared memory, with a
// 4x4 register micro-tile per thread. Each operand is a row-major matrix
// with a leading dimension; A_T / B_T read it transposed
// (opA(i, k) = A[k * lda + i], opB(k, j) = B[j * ldb + k]). Loads are
// masked at the ragged edges (rows >= m_lim, cols >= n_lim, k >= k_hi read
// as 0). Each 16-deep slice is summed in float and the slices in double:
// with one running float sum per entry the bench case missed the f32
// envelope (PERF.md).
//
// Bound: operations (FP32 FMA on the CUDA cores, 67 TFLOP/s peak on an
// H100 SXM). The design keeps each operand element read from shared memory
// for 4 FMAs and coalesces the global loads along the contiguous dimension
// of each layout.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpx {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;

struct TileSmem {
  float a[BK][BM + PAD];
  float b[BK][BN + PAD];
};

// thread (tx, ty) owns rows ty + 16 r and columns tx + 16 c, r, c < 4
__device__ __forceinline__ int tile_tx() { return threadIdx.x % 16; }
__device__ __forceinline__ int tile_ty() { return threadIdx.x / 16; }

template <bool A_T, bool B_T>
__device__ void tile_product(const float* __restrict__ A, int64_t lda,
                             const float* __restrict__ B, int64_t ldb,
                             int i0, int j0, int k_lo, int k_hi,
                             int m_lim, int n_lim, float (&acc)[4][4],
                             TileSmem& sm) {
  const int tid = threadIdx.x;
  const int tx = tile_tx();
  const int ty = tile_ty();
  double sum[4][4];
  float part[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sum[r][c] = 0.0;
      part[r][c] = 0.0f;
    }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / THREADS; ++q) {
      const int e = tid + q * THREADS;
      int ii, kk;
      if (A_T) { ii = e % BM; kk = e / BM; }  // contiguous along i
      else     { kk = e % BK; ii = e / BK; }  // contiguous along k
      const int gi = i0 + ii, gk = k0 + kk;
      float v = 0.0f;
      if (gi < m_lim && gk < k_hi)
        v = A_T ? A[(int64_t)gk * lda + gi] : A[(int64_t)gi * lda + gk];
      sm.a[kk][ii] = v;
    }
#pragma unroll
    for (int q = 0; q < (BN * BK) / THREADS; ++q) {
      const int e = tid + q * THREADS;
      int jj, kk;
      if (B_T) { kk = e % BK; jj = e / BK; }  // contiguous along k
      else     { jj = e % BN; kk = e / BN; }  // contiguous along j
      const int gj = j0 + jj, gk = k0 + kk;
      float v = 0.0f;
      if (gj < n_lim && gk < k_hi)
        v = B_T ? B[(int64_t)gj * ldb + gk] : B[(int64_t)gk * ldb + gj];
      sm.b[kk][jj] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sm.a[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = sm.b[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[r][c] = fmaf(a[r], b[c], part[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sum[r][c] += (double)part[r][c];
        part[r][c] = 0.0f;
      }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[r][c] = (float)sum[r][c];
}

// (i, j) of the t-th lower-triangle tile, i >= j, in row order
__device__ __forceinline__ void lower_tile(int t, int& i, int& j) {
  i = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  j = t - i * (i + 1) / 2;
}

}  // namespace gpx
