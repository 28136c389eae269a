// trmm and syrk_lower for Hopper (sm_90a), 3xTF32 on the tensor cores.
//
// Replaces the TPU kernels gpx/ops/pallas_trmm.py::trmm (with its active-
// tile schedule _schedule) and gpx/ops/pallas_trmm.py::syrk_lower, the
// O(N^3) building blocks of the Cholesky-and-inverse recursion
// (gpx_torch/ops/cuda_chol.py::chol_inv).
//
// trmm, L lower triangular (n x n) with exact zeros above its diagonal:
//   mode 0 right_lower   C (m x n) = B L     k-range of tile column j0: [j0, n)
//   mode 1 left_lower    C (n x m) = L B     k-range of tile row i0: [0, i0 + BM)
//   mode 2 right_lower_t C (m x n) = B L^T   k-range of tile column j0: [0, j0 + BN)
// so the zero tiles of L are never read. `sign` = -1 writes -C (the `neg`
// epilogue). syrk_lower: C = A0 - B B^T (B n x k), written element by
// element where i >= j only; every other element of C keeps what it held.
// C may alias A0 element for element (each element is read and written by
// the same thread).
//
// fast (gpx's trmm(fast=True), _dot_bf16x2): the right operand B is
// rounded to TF32 and the left one kept whole, two MMAs a step
// (mma_tf32.cuh, PASSES = 2). Only chol_inv's outermost M21 takes it, in
// modes 0 and 1 (right operand N-major), so only those instances exist;
// syrk_lower and mode 2 stay 3-pass.
//
// Bound on an H100 SXM: operations. At 8192^2 trmm does n^3 useful FLOPs
// (the triangle halves 2 n^3) and syrk_lower n^2 k. In 3xTF32 that is
// 3 n^3 tensor-core FLOPs at 494.7 TFLOP/s dense TF32: 3.33 ms; the same
// work as FP32 FMAs on the CUDA cores (67 TFLOP/s) takes 8.205 ms.
//
// Design:
// - Precision and the k loop: the shared 3xTF32 core (mma_tf32.cuh; gpx's
//   bf16x3 split, _dot_bf16x3, becomes 3xTF32): hi/lo split in registers,
//   lo*hi + hi*lo + hi*hi small terms first, the truncating tensor-core
//   accumulator (measured: 4 ulps of bias over a 64-deep sum of positive
//   terms) folded every 64 k into a per-entry float-float sum. The SIMT
//   core before it summed 16-deep float slices in double, since one
//   running f32 sum per entry missed the bench envelope (PERF.md).
//   Folding the fragment rows at staggered k steps ran no faster once
//   nothing spilled, and biased the hybrid logML by 0.25 (PERF.md):
//   every accumulator folds at the same k.
// - Operations: mma.sync rather than wgmma, because wgmma takes TF32 only
//   K-major from shared memory, and the B operand here is N-major in two
//   modes (L in right_lower, B in left_lower); mma.sync reads fragments
//   through the threads, so one core serves all four operand layouts.
// - Bytes: a ring of STAGES cp.async stages keeps loads in flight under the
//   MMAs: 16-byte copies where the view is aligned (base and leading
//   dimension), else the same kernel instantiated with masked 4-byte
//   copies, both zero-filled past the ragged edges. 128 x 128 block tiles
//   (8 warps of 64 x 32) read each operand element from device memory once
//   per 128 outputs; products with fewer than 12 waves of them (h <= 4096
//   in the recursion) take 64 x 64 tiles (4 warps), whose finer tail wins.
// - Order: trmm's grid starts the tiles with the longest k-range first.
//   No split-K and no atomics: a call is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"   // gpx::tf32: Tile, the cp.async ring, the k loop
#include "tile_core.cuh"  // gpx::lower_tile

namespace {

using namespace gpx::tf32;

struct Args {
  const float* a;  int64_t lda;    // left operand, K-contiguous (m x k)
  const float* b;  int64_t ldb;    // right operand: (n x k) if K-major, else (k x n)
  float* c;        int64_t ldc;
  const float* a0; int64_t lda0;   // syrk_lower's A0
  int m, n, k, mode, tiles_m, tiles_n;
  float sign;
};

// One output tile per block. SYRK: C = A0 - a a^T on i >= j (b is a);
// else trmm `mode`. B_KMAJOR: the right operand is read as b[j * ldb + k].
template <class T, bool B_KMAJOR, bool SYRK, bool VEC, int PASSES>
__global__ void __launch_bounds__(T::THREADS, 1) product_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  int bi, bj;
  if (SYRK) {
    gpx::lower_tile(blockIdx.x, bi, bj);
  } else if (p.mode == 0) {   // longest k-range: the first tile columns
    bj = (int)blockIdx.x / p.tiles_m;
    bi = (int)blockIdx.x % p.tiles_m;
  } else if (p.mode == 1) {   // the last tile rows
    bi = p.tiles_m - 1 - (int)blockIdx.x / p.tiles_n;
    bj = (int)blockIdx.x % p.tiles_n;
  } else {                    // the last tile columns
    bj = p.tiles_n - 1 - (int)blockIdx.x / p.tiles_m;
    bi = (int)blockIdx.x % p.tiles_m;
  }
  const int i0 = bi * T::BM, j0 = bj * T::BN;
  int k_lo = 0, k_hi = p.k;
  if (!SYRK) {
    if (p.mode == 0) k_lo = j0;
    else if (p.mode == 1) k_hi = min(i0 + T::BM, p.k);
    else k_hi = min(j0 + T::BN, p.k);
  }

  auto load = [&](int stage, int k0) {
    float* as = smem + stage * T::STAGE_FLOATS;
    float* bs = as + T::A_FLOATS;
    load_kmajor<T, T::BM, VEC>(as, p.a, p.lda, i0, p.m, k0, k_hi);
    if (B_KMAJOR)
      load_kmajor<T, T::BN, VEC>(bs, p.b, p.ldb, j0, p.n, k0, k_hi);
    else
      load_nmajor<T, VEC>(bs, p.b, p.ldb, k0, k_hi, j0, p.n);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / T::WN) * T::MI * 16;  // warp's first row in the tile
  const int wc = (warp % T::WN) * T::NI * 8;   // and first column

  float acc[T::MI][T::NI][4], sum[T::MI][T::NI][4];
  mainloop<T, false, B_KMAJOR, false, PASSES>(smem, load, k_lo, k_hi, wr, wc,
                                              acc, sum);

  // fragment element q of (mi, ni): row g + 8 (q / 2), column 2 t + q % 2
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + wr + mi * 16 + g + 8 * (q >> 1);
        const int j = j0 + wc + ni * 8 + 2 * t + (q & 1);
        if (i >= p.m || j >= p.n) continue;
        const float v = __fadd_rn(sum[mi][ni][q], acc[mi][ni][q]);
        if (SYRK) {
          if (i >= j)
            p.c[(int64_t)i * p.ldc + j] = p.a0[(int64_t)i * p.lda0 + j] - v;
        } else {
          p.c[(int64_t)i * p.ldc + j] = p.sign * v;
        }
      }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <class T, bool B_KMAJOR, bool SYRK, bool VEC, int PASSES>
int launch_vec(const Args& p, cudaStream_t s) {
  static bool attr = false;
  auto kern = product_kernel<T, B_KMAJOR, SYRK, VEC, PASSES>;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int blocks = SYRK ? p.tiles_m * (p.tiles_m + 1) / 2
                          : p.tiles_m * p.tiles_n;
  kern<<<blocks, T::THREADS, T::SMEM_BYTES, s>>>(p);
  return (int)cudaGetLastError();
}

template <class T, bool B_KMAJOR, bool SYRK, int PASSES = 3>
int launch(Args p, bool vec, cudaStream_t s) {
  p.tiles_m = (p.m + T::BM - 1) / T::BM;
  p.tiles_n = (p.n + T::BN - 1) / T::BN;
  return vec ? launch_vec<T, B_KMAJOR, SYRK, true, PASSES>(p, s)
             : launch_vec<T, B_KMAJOR, SYRK, false, PASSES>(p, s);
}

// 128-wide tiles from 12 waves of them on; below that the 64-wide tiles'
// finer tail wins (measured at 2048^2 ... 8192^2 on an H100)
bool big_tiles(int m, int n, bool tri) {
  const int64_t tm = (m + Big::BM - 1) / Big::BM;
  const int64_t tn = (n + Big::BN - 1) / Big::BN;
  return (tri ? tm * (tm + 1) / 2 : tm * tn) >= 12 * sm_count();
}

}  // namespace

extern "C" {

// C = op(A, B) for trmm `mode`; A is the left operand (B in the right
// modes, L in left_lower), B the right one. M x N output, K contraction.
// fast != 0 rounds B to TF32 (modes 0 and 1 only).
int gpx_trmm(const float* A, int64_t lda, const float* B, int64_t ldb,
             float* C, int64_t ldc, int M, int N, int K, int mode, float sign,
             int fast, void* stream) {
  const Args p{A, lda, B, ldb, C, ldc, nullptr, 0, M, N, K, mode, 0, 0, sign};
  const bool vec = aligned(A, lda) && aligned(B, ldb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool big = big_tiles(M, N, false);
  if (fast) {
    if (mode == 2) return (int)cudaErrorInvalidValue;
    return big ? launch<Big, false, false, 2>(p, vec, s)
               : launch<Small, false, false, 2>(p, vec, s);
  }
  if (mode == 2)
    return big ? launch<Big, true, false>(p, vec, s)
               : launch<Small, true, false>(p, vec, s);
  return big ? launch<Big, false, false>(p, vec, s)
             : launch<Small, false, false>(p, vec, s);
}

int gpx_syrk_lower(const float* A0, int64_t lda0, const float* B, int64_t ldb,
                   float* C, int64_t ldc, int n, int k, void* stream) {
  const Args p{B, ldb, B, ldb, C, ldc, A0, lda0, n, n, k, 0, 0, 0, 1.0f};
  const bool vec = aligned(B, ldb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return big_tiles(n, n, true) ? launch<Big, true, true>(p, vec, s)
                               : launch<Small, true, true>(p, vec, s);
}

}  // extern "C"
