// The 3xTF32 tensor-core core of Hopper (sm_90a) shared by trmm.cu (trmm,
// syrk_lower) and logml_grad.cu (the K^-1 tiles of the fused gradient).
//
// One block computes one BM x BN output tile
//     acc(i, j) = sum_{k in [k_lo, k_hi)} opA(i, k) opB(k, j)
// over a ring of STAGES cp.async stages of BK-deep k-tiles:
// - A is K-major (opA(i, k) = a[i * lda + k]) or M-major
//   (opA(i, k) = a[k * lda + i]); B is K-major (opB(k, j) = b[j * ldb + k])
//   or N-major (opB(k, j) = b[k * ldb + j]). K-major blocks are staged as
//   rows of KS floats, M- and N-major ones as rows of NS floats; the
//   paddings make every fragment read free of bank conflicts.
// - Each f32 operand x is split in registers into hi = rna_tf32(x) and
//   lo = rna_tf32(x - hi), and each product is accumulated as
//   lo*hi + hi*lo + hi*hi, small terms first, by
//   mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32; the dropped terms are
//   2^-22 of the product.
// - PASSES = 2 (the fast leg, gpx's _dot_bf16x2): A keeps its split and B
//   only its hi part, lo*hi + hi*hi, so each product is A times B rounded
//   to TF32 (2^-11 relative) at two MMAs per step instead of three.
// - The tensor core's f32 accumulation truncates, so the accumulator holds
//   one slab of SLAB_TILES * BK = 64 k, then every accumulator of the block
//   folds into a per-entry float-float sum by an exact TwoSum whose error
//   term seeds the next slab. The entry is sum + acc, rounded once.
// - STEP_ROUND: the three MMAs of each 8-deep k step go into a fresh
//   register, which a rounded f32 add takes into the accumulator, so a
//   step truncates against its own 8-term partial and not the slab's
//   running sum, whose bias over a sum of positive terms measures ~4 f32
//   ulps of the sum (PERF.md). The gradient needs it for tr(K^-1), held to
//   4 ulps of itself: without it that check read 0.80 of its limit at
//   n = 4096 on an H100, with it 0.17, for 12% more time.
// Fragments pair physical k = 2t, 2t + 1 with the MMA's k = t, t + 4, so a
// K-major fragment is one 8-byte shared load.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpx {
namespace tf32 {

constexpr int BK = 32;          // k-tile depth
constexpr int STAGES = 4;       // cp.async ring
constexpr int SLAB_TILES = 2;   // k-tiles per fold: SLAB = 64
constexpr int KPAD = 8;         // K-major rows hold BK + 8 floats
constexpr int NPAD = 4;         // M- and N-major rows hold BN + 4 floats

template <int BM_, int BN_, int WM_, int WN_, int STAGES_ = STAGES>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;  // the ring's depth
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = BM / WM / 16;  // m16 fragments per warp
  static constexpr int NI = BN / WN / 8;   // n8 fragments per warp
  static constexpr int KS = BK + KPAD;     // K-major row stride
  static constexpr int NS = BN + NPAD;     // M- and N-major row stride
  static constexpr int A_FLOATS = BM * KS;
  static constexpr int B_FLOATS = (BN * KS > BK * NS) ? BN * KS : BK * NS;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;  // the ring
};
using Big = Tile<128, 128, 2, 4>;   // 163,840 bytes of ring
using Small = Tile<64, 64, 2, 2>;   // 81,920 bytes of ring

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
// NS floats; k >= k_hi and columns >= n_lim read as zero. An M-major A
// block is the same copy where BM == BN.
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

// The A fragment (hi and lo) of rows row0 .. row0 + 15 at k-step ks of a
// staged K-major block
template <class T>
__device__ __forceinline__ void frag_a_kmajor(const float* as, int row0,
                                              int ks, uint32_t (&ah)[4],
                                              uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* q = as + (row0 + g) * T::KS + ks * 8 + 2 * t;
  const float2 u = *reinterpret_cast<const float2*>(q);
  const float2 v = *reinterpret_cast<const float2*>(q + 8 * T::KS);
  split(u.x, ah[0], al[0]);
  split(v.x, ah[1], al[1]);
  split(u.y, ah[2], al[2]);
  split(v.y, ah[3], al[3]);
}

// the same from a staged M-major block (rows of NS floats, one per k)
template <class T>
__device__ __forceinline__ void frag_a_mmajor(const float* as, int row0,
                                              int ks, uint32_t (&ah)[4],
                                              uint32_t (&al)[4]) {
  static_assert(T::BM == T::BN, "an M-major block is staged as an N-major one");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* q = as + (ks * 8 + 2 * t) * T::NS + row0 + g;
  split(q[0], ah[0], al[0]);
  split(q[8], ah[1], al[1]);
  split(q[T::NS], ah[2], al[2]);
  split(q[T::NS + 8], ah[3], al[3]);
}

// One 8-deep k step of fragment row mi into d: lo*hi + hi*lo + hi*hi
// (PASSES = 3) or lo*hi + hi*hi with B's lo dropped (PASSES = 2), small
// terms first
template <class T, int PASSES>
__device__ __forceinline__ void step_mmas(float (&d)[T::NI][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&bh)[T::NI][2],
                                          const uint32_t (&bl)[T::NI][2]) {
  static_assert(PASSES == 2 || PASSES == 3, "2 or 3 passes");
#pragma unroll
  for (int ni = 0; ni < T::NI; ++ni) mma(d[ni], al, bh[ni]);
  if (PASSES == 3) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) mma(d[ni], ah, bl[ni]);
  }
#pragma unroll
  for (int ni = 0; ni < T::NI; ++ni) mma(d[ni], ah, bh[ni]);
}

// The ring's first STAGES - 1 k-tiles of [k_lo, k_hi), one commit group
// each (empty past the range): mainloop's prologue, or, with PRIMED, the
// caller's, issued ahead (a persistent block primes its next tile before
// the current tile's epilogue).
template <class T, class Load>
__device__ __forceinline__ void prime(Load&& load, int k_lo, int k_hi) {
  const int nkt = (k_hi - k_lo + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nkt) load(s, k_lo + s * BK);
    cp_async_commit();
  }
}

// The k loop of one block tile over [k_lo, k_hi): the ring, the MMAs and
// the slab folds. `load(stage, k0)` issues the copies of the k-tile at k0
// into ring stage `stage`; the A block of a stage comes first, its B block
// A_FLOATS later. (wr, wc) is the warp's first row and column in the tile.
// PRIMED: the caller has run prime() for this range. On return every copy
// has landed; the entry of fragment element q of (mi, ni), row wr + 16 mi
// + g + 8 (q / 2), column wc + 8 ni + 2 t + q % 2, is sum + acc.
template <class T, bool A_MMAJOR, bool B_KMAJOR, bool STEP_ROUND, int PASSES,
          bool PRIMED = false, class Load>
__device__ __forceinline__ void mainloop(const float* smem, Load&& load,
                                         int k_lo, int k_hi, int wr, int wc,
                                         float (&acc)[T::MI][T::NI][4],
                                         float (&sum)[T::MI][T::NI][4]) {
  constexpr int STAGES = T::STAGES;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = sum[mi][ni][q] = 0.0f;

  const int nkt = (k_hi - k_lo + BK - 1) / BK;
  if (!PRIMED) prime<T>(load, k_lo, k_hi);
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
        // with PASSES = 2 the lo parts are never read: no registers, no ops
        split(x0, bh[ni][0], bl[ni][0]);
        split(x1, bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        uint32_t ah[4], al[4];
        if (A_MMAJOR)
          frag_a_mmajor<T>(as, wr + mi * 16, ks, ah, al);
        else
          frag_a_kmajor<T>(as, wr + mi * 16, ks, ah, al);
        if (STEP_ROUND) {
          float st[T::NI][4] = {};
          step_mmas<T, PASSES>(st, ah, al, bh, bl);
#pragma unroll
          for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[mi][ni][q] = __fadd_rn(acc[mi][ni][q], st[ni][q]);
        } else {
          step_mmas<T, PASSES>(acc[mi], ah, al, bh, bl);
        }
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
}

// 16-byte copies need a 16-byte aligned base and a leading dimension that
// is a multiple of 4 floats
inline bool aligned(const float* x, int64_t ld) {
  return ((uintptr_t)x & 15) == 0 && (ld & 3) == 0;
}

}  // namespace tf32
}  // namespace gpx
