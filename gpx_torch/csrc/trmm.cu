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
// Bound on an H100 SXM: operations. At 8192^2 trmm does n^3 useful FLOPs
// (the triangle halves 2 n^3) and syrk_lower n^2 k. In 3xTF32 that is
// 3 n^3 tensor-core FLOPs at 494.7 TFLOP/s dense TF32: 3.33 ms; the same
// work as FP32 FMAs on the CUDA cores (67 TFLOP/s) takes 8.205 ms.
//
// Design:
// - Precision (gpx's bf16x3 split, _dot_bf16x3, becomes 3xTF32): each f32
//   operand x is split in registers into hi = rna_tf32(x) and
//   lo = rna_tf32(x - hi), and each product is accumulated as
//   lo*hi + hi*lo + hi*hi, small terms first, by
//   mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. The dropped terms are
//   2^-22 of the product. The tensor core's f32 accumulation truncates
//   (measured: 4 ulps of bias over a 64-deep sum of positive terms), so the
//   accumulator holds one slab of 64 k, then every accumulator of the block
//   folds into a per-entry float-float sum by an exact TwoSum whose error
//   term seeds the next slab: the SIMT core before it summed 16-deep float
//   slices in double, since one running f32 sum per entry missed the bench
//   envelope (PERF.md, PR 1). Folding the fragment rows at staggered k
//   steps ran no faster once nothing spilled, and biased the hybrid logML
//   by 0.25 (PERF.md, PR 4): every accumulator folds at the same k.
// - Operations: mma.sync rather than wgmma, because wgmma takes TF32 only
//   K-major from shared memory, and the B operand here is N-major in two
//   modes (L in right_lower, B in left_lower); mma.sync reads fragments
//   through the threads, so one core serves all four operand layouts.
//   Fragments pair physical k = 2t, 2t + 1 with the MMA's k = t, t + 4, so
//   a K-major fragment is one 8-byte shared load; the row paddings make
//   every fragment read free of bank conflicts.
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

#include "tile_core.cuh"  // gpx::lower_tile

namespace {

constexpr int BK = 32;          // k-tile depth
constexpr int STAGES = 4;       // cp.async ring
constexpr int SLAB_TILES = 2;   // k-tiles per fold: SLAB = 64
constexpr int KPAD = 8;         // K-major rows hold BK + 8 floats
constexpr int NPAD = 4;         // N-major rows hold BN + 4 floats

template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = BM / WM / 16;  // m16 fragments per warp
  static constexpr int NI = BN / WN / 8;   // n8 fragments per warp
  static constexpr int KS = BK + KPAD;     // K-major row stride
  static constexpr int NS = BN + NPAD;     // N-major row stride
  static constexpr int A_FLOATS = BM * KS;
  static constexpr int B_FLOATS = (BN * KS > BK * NS) ? BN * KS : BK * NS;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
};
using Big = Tile<128, 128, 2, 4>;   // 163,840 bytes of ring
using Small = Tile<64, 64, 2, 2>;   // 81,920 bytes of ring

struct Args {
  const float* a;  int64_t lda;    // left operand, K-contiguous (m x k)
  const float* b;  int64_t ldb;    // right operand: (n x k) if K-major, else (k x n)
  float* c;        int64_t ldc;
  const float* a0; int64_t lda0;   // syrk_lower's A0
  int m, n, k, mode, tiles_m, tiles_n;
  float sign;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows x BK block at (r0, k0) of a K-contiguous matrix into rows of KS
// floats; rows >= r_lim and k >= k_hi read as zero
template <class T, int ROWS, bool VEC>
__device__ __forceinline__ void load_kmajor(float* s, const float* g,
                                            int64_t ld, int r0, int r_lim,
                                            int k0, int k_hi) {
  constexpr int CH = BK / 4;
  static_assert((ROWS * CH) % T::THREADS == 0, "uneven 16-byte copies");
  static_assert((ROWS * BK) % T::THREADS == 0, "uneven 4-byte copies");
  if (VEC) {
#pragma unroll
    for (int q = 0; q < ROWS * CH / T::THREADS; ++q) {
      const int c = threadIdx.x + q * T::THREADS;
      const int r = c / CH, kk = (c % CH) * 4;
      const int gr = r0 + r, gk = k0 + kk;
      const int n = gr < r_lim ? min(max(k_hi - gk, 0), 4) : 0;
      cp_async16(s + r * T::KS + kk, n ? g + (int64_t)gr * ld + gk : g, 4 * n);
    }
  } else {  // rolled: unrolled, the 16 addresses spill the 128-wide tile
#pragma unroll 1
    for (int q = 0; q < ROWS * BK / T::THREADS; ++q) {
      const int e = threadIdx.x + q * T::THREADS;
      const int r = e / BK, kk = e % BK;
      const int gr = r0 + r, gk = k0 + kk;
      const bool ok = gr < r_lim && gk < k_hi;
      cp_async4(s + r * T::KS + kk, ok ? g + (int64_t)gr * ld + gk : g,
                ok ? 4 : 0);
    }
  }
}

// BK x BN block at (k0, n0) of an N-contiguous (k x n) matrix into rows of
// NS floats; k >= k_hi and columns >= n_lim read as zero
template <class T, bool VEC>
__device__ __forceinline__ void load_nmajor(float* s, const float* g,
                                            int64_t ld, int k0, int k_hi,
                                            int n0, int n_lim) {
  constexpr int CH = T::BN / 4;
  static_assert((BK * CH) % T::THREADS == 0, "uneven 16-byte copies");
  static_assert((BK * T::BN) % T::THREADS == 0, "uneven 4-byte copies");
  if (VEC) {
#pragma unroll
    for (int q = 0; q < BK * CH / T::THREADS; ++q) {
      const int c = threadIdx.x + q * T::THREADS;
      const int kk = c / CH, nn = (c % CH) * 4;
      const int gk = k0 + kk, gn = n0 + nn;
      const int n = gk < k_hi ? min(max(n_lim - gn, 0), 4) : 0;
      cp_async16(s + kk * T::NS + nn, n ? g + (int64_t)gk * ld + gn : g, 4 * n);
    }
  } else {
#pragma unroll 1
    for (int q = 0; q < BK * T::BN / T::THREADS; ++q) {
      const int e = threadIdx.x + q * T::THREADS;
      const int kk = e / T::BN, nn = e % T::BN;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool ok = gk < k_hi && gn < n_lim;
      cp_async4(s + kk * T::NS + nn, ok ? g + (int64_t)gk * ld + gn : g,
                ok ? 4 : 0);
    }
  }
}

// x = hi + lo + O(2^-22 x), both rounded to TF32 to nearest, ties away
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float r = __fsub_rn(x, __uint_as_float(hi));  // exact
  lo = (__float_as_uint(r) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s + a = s' + a' exactly (Knuth's TwoSum); a' seeds the next slab
__device__ __forceinline__ void fold(float& s, float& a) {
  const float t = __fadd_rn(s, a);
  const float bb = __fsub_rn(t, s);
  a = __fadd_rn(__fsub_rn(s, __fsub_rn(t, bb)), __fsub_rn(a, bb));
  s = t;
}

// One output tile per block. SYRK: C = A0 - a a^T on i >= j (b is a);
// else trmm `mode`. B_KMAJOR: the right operand is read as b[j * ldb + k].
template <class T, bool B_KMAJOR, bool SYRK, bool VEC>
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
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = sum[mi][ni][q] = 0.0f;

  const int nkt = (k_hi - k_lo + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load(s, k_lo + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nkt) load(nxt % STAGES, k_lo + nxt * BK);
    cp_async_commit();

    const float* as = smem + (kt % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + T::A_FLOATS;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      uint32_t bh[T::NI][2], bl[T::NI][2];
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        float x0, x1;
        if (B_KMAJOR) {
          const float2 u = *reinterpret_cast<const float2*>(
              bs + (wc + ni * 8 + g) * T::KS + ks * 8 + 2 * t);
          x0 = u.x;
          x1 = u.y;
        } else {
          const float* q = bs + (ks * 8 + 2 * t) * T::NS + wc + ni * 8 + g;
          x0 = q[0];
          x1 = q[T::NS];
        }
        split(x0, bh[ni][0], bl[ni][0]);
        split(x1, bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        uint32_t ah[4], al[4];
        const float* q = as + (wr + mi * 16 + g) * T::KS + ks * 8 + 2 * t;
        const float2 u = *reinterpret_cast<const float2*>(q);
        const float2 v = *reinterpret_cast<const float2*>(q + 8 * T::KS);
        split(u.x, ah[0], al[0]);
        split(v.x, ah[1], al[1]);
        split(u.y, ah[2], al[2]);
        split(v.y, ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) mma(acc[mi][ni], al, bh[ni]);
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) mma(acc[mi][ni], ah, bl[ni]);
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) mma(acc[mi][ni], ah, bh[ni]);
      }
    }
    if ((kt + 1) % SLAB_TILES == 0) {
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) fold(sum[mi][ni][q], acc[mi][ni][q]);
    }
  }
  cp_async_wait<0>();

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

template <class T, bool B_KMAJOR, bool SYRK, bool VEC>
int launch_vec(const Args& p, cudaStream_t s) {
  static bool attr = false;
  auto kern = product_kernel<T, B_KMAJOR, SYRK, VEC>;
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

template <class T, bool B_KMAJOR, bool SYRK>
int launch(Args p, bool vec, cudaStream_t s) {
  p.tiles_m = (p.m + T::BM - 1) / T::BM;
  p.tiles_n = (p.n + T::BN - 1) / T::BN;
  return vec ? launch_vec<T, B_KMAJOR, SYRK, true>(p, s)
             : launch_vec<T, B_KMAJOR, SYRK, false>(p, s);
}

// 16-byte copies need a 16-byte aligned base and a leading dimension that
// is a multiple of 4 floats
bool aligned(const float* x, int64_t ld) {
  return ((uintptr_t)x & 15) == 0 && (ld & 3) == 0;
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
int gpx_trmm(const float* A, int64_t lda, const float* B, int64_t ldb,
             float* C, int64_t ldc, int M, int N, int K, int mode, float sign,
             void* stream) {
  const Args p{A, lda, B, ldb, C, ldc, nullptr, 0, M, N, K, mode, 0, 0, sign};
  const bool vec = aligned(A, lda) && aligned(B, ldb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool big = big_tiles(M, N, false);
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
