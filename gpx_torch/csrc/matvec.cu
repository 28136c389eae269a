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
// Bound: operations, on three units at once. Each Gram entry costs its
// distance and term algebra on the CUDA cores (FP32) and one or more
// special-function operations (an exponential per term, a square root for
// Matern and Periodic, a logarithm for RQ); the product costs
// 4 x 2 N1 N2 R TF32 operations on the tensor cores (below). The bytes
// moved are O(N (D + R)). At the iterative path's widths (R = 9) the
// entries' algebra sets the pace, at R = 256 (fit_iterative's variance
// blocks) the product.
//
// Design. A block of 8 warps owns 128 rows of x1 and a chunk of RC = 8 NI
// columns of V (NI = 1 or 2 n8 tiles; R > 16 takes gridDim.z chunks of 16:
// wider chunks' accumulators spill at two blocks per SM), and walks its
// range of x2 in tiles of 64 points:
// - K in registers, straight into the A fragment. Each warp owns 16 rows.
//   For every 8-deep k step of mma.sync.m16n8k8 (TF32 in, f32 out), thread
//   (g, t) = (lane / 4, lane % 4) forms the four entries of its A fragment,
//   rows g and g + 8, points t and t + 4: r2 by broadcast differences in
//   FP32 (exact at coincident points at every D, so White fires there), on
//   the symmetric product r2 = 0 and the nugget on the global diagonal,
//   k(r2) from the term table, then hi/lo by mma_tf32.cuh's split. K never
//   passes through shared or device memory.
// - The term table's constants (amplitude, -log2(e) / l^2, 1 / period,
//   Matern's polynomial coefficients, ...) are formed once per block in
//   shared memory; an entry costs a multiply and one ex2.approx per term
//   (the Gram and gradient kernels keep terms.cuh's device functions). The
//   family switch runs once per term over 16 entries (half a tile); a
//   product's factors multiply in place in registers. The table and its
//   constants are sized from the tree at launch (28 floats of shared
//   memory for SE + White, 15 KB at 256 rows: two blocks an SM still fit).
// - V through a ring of 4 cp.async stages: each stage holds the tile's
//   (64, RC) slice of V and, for D <= 16, the tile's coordinates, so x_j
//   comes from shared memory (x_i too: the block's rows are staged once);
//   wider D reads both through L1. Each staged slice of V is split into
//   TF32 hi/lo once by the block, into fragment order (one 16-byte shared
//   load per n8 tile and k step), not once per warp; the split of
//   tile kt + 1 fills a second buffer while tile kt is multiplied, so one
//   barrier a tile serves the ring and the split.
// - The product at HIGHEST, as gpx's, which CG needs (the operator must
//   act like an f32 matrix): K and V split into TF32 hi + lo, and four
//   products, small ones first: lo*lo + lo*hi + hi*lo + hi*hi. The usual
//   3xTF32 drops lo*lo: on an H100 (chip_smoke.py, phase 4) it moved the
//   iterative logML's h gradient 0.447 from the same estimator in float64
//   at N = 32,768 (seed 0; limit 0.5) and 1.057 from the dense logML
//   (limit 0.80), where the four products move it 0.14-0.15 and 0.23-0.62
//   over three seeds and the FP32 kernel they replace moved it 0.04-0.06;
//   six products of three-part splits moved the sigma gradient 0.049
//   (seed 1; limit 0.045).
// - The tensor core's f32 accumulation truncates, so each k step's four
//   MMAs go into a fresh fragment and a rounded add takes it into the
//   accumulator (truncating onto the running sum shrinks it by up to an
//   ulp of its own size at every MMA); every 64 k (each tile) an exact
//   TwoSum folds the accumulator into a float-float sum whose high part
//   waits in shared memory (in registers it would cost a block per SM).
// - Column splits: when the row blocks and column chunks alone fill the
//   card poorly (cross_matvec's 1024 rows, R = 1), the range of x2 is split
//   over gridDim.y blocks in whole 64-point tiles, each writing double
//   partials, and a second kernel sums the splits in a fixed order. No
//   atomics: a repeated call gives the same bits.
#include <stdint.h>

#include "mma_tf32.cuh"
#include "terms.cuh"

using namespace gpx;
using gpx::tf32::cp_async4;
using gpx::tf32::cp_async_commit;
using gpx::tf32::cp_async_wait;
using gpx::tf32::fold;
using gpx::tf32::mma;
using gpx::tf32::split;

constexpr int MV_WARPS = 8;
constexpr int MV_THREADS = 32 * MV_WARPS;
constexpr int MV_ROWS = 16 * MV_WARPS;  // rows per block, 16 per warp
constexpr int MV_BK = 64;  // points of x2 per tile (8 k steps), per fold,
                           // and the grain of the column splits
constexpr int MV_STAGES = 4;            // cp.async ring
constexpr int MV_MIN_SPLIT = 256;       // fewest points of x2 per split
constexpr int MV_DMAX = 16;             // widest D staged in shared memory
constexpr int MV_VPAD = 8;              // staged rows of V hold RC + 8 floats
constexpr int MV_MAX_NI = 2;            // n8 tiles per block: 16 columns
constexpr int MV_TC = 8;                // constants per term

constexpr double MV_LOG2E = 1.4426950408889634;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The matvec's families: `prep` forms a term's constants c[0 .. MV_TC) from
// its hyperparameters once per block (in double, rounded once), `value`
// is k(r2) from them.

// SE (h, s): h 2^(r2 c1), c1 = -log2(e) / s^2
struct MvSE {
  static __device__ void prep(const float* p, int, float* c) {
    c[0] = p[0];
    c[1] = (float)(-MV_LOG2E / ((double)p[1] * (double)p[1]));
  }
  static __device__ __forceinline__ float value(const float* c, int,
                                                float r2) {
    return c[0] * ex2(c[1] * r2);
  }
};

// White (s): s [r2 == 0]
struct MvWhite {
  static __device__ void prep(const float* p, int, float* c) { c[0] = p[0]; }
  static __device__ __forceinline__ float value(const float* c, int,
                                                float r2) {
    return r2 == 0.0f ? c[0] : 0.0f;
  }
};

// Matern (sigma, l), nu = p + 1/2: sigma P_p(s) e^-s, s = c1 d, c1 =
// sqrt(2p + 1) / l, with terms.cuh's recurrence P_k = P_{k-1} + s^2 P_{k-2}
// c_k, c_k = 1 / ((2k - 1)(2k - 3)) held in c[2 .. 7] for k <= 7
struct MvMatern {
  static __device__ void prep(const float* p, int aux, float* c) {
    c[0] = p[0];
    c[1] = (float)(sqrt(2.0 * aux + 1.0) / (double)p[1]);
    for (int k = 2; k < MV_TC; ++k)
      c[k] = (float)(1.0 / (double)((2 * k - 1) * (2 * k - 3)));
  }
  static __device__ __forceinline__ float value(const float* c, int aux,
                                                float r2) {
    const float s = c[1] * sqrt_approx(r2);
    const float s2 = s * s;
    float a = 1.0f, b = 1.0f + s;
    for (int k = 2; k <= aux; ++k) {
      const float ck = k < MV_TC
                           ? c[k]
                           : __frcp_rn((float)((2 * k - 1) * (2 * k - 3)));
      const float nb = fmaf(s2 * ck, a, b);
      a = b;
      b = nb;
    }
    const float pp = aux == 0 ? 1.0f : b;
    return c[0] * pp * ex2((float)(-MV_LOG2E) * s);
  }
};

// RationalQuadratic (h, alpha, l): h 2^(c2 log1p(c1 r2)), c1 = 1 / (2 alpha
// l^2), c2 = -alpha log2(e)
struct MvRQ {
  static __device__ void prep(const float* p, int, float* c) {
    c[0] = p[0];
    c[1] = (float)(1.0 / (2.0 * (double)p[1] * (double)p[2] * (double)p[2]));
    c[2] = (float)(-(double)p[1] * MV_LOG2E);
  }
  static __device__ __forceinline__ float value(const float* c, int,
                                                float r2) {
    return c[0] * ex2(c[2] * log1pf(c[1] * r2));
  }
};

// Periodic (h, period, l): h 2^(c2 sin^2(pi d c1)), c1 = 1 / period, c2 =
// -2 log2(e) / l^2; sinpif reduces its argument exactly in f32
struct MvPeriodic {
  static __device__ void prep(const float* p, int, float* c) {
    c[0] = p[0];
    c[1] = (float)(1.0 / (double)p[1]);
    c[2] = (float)(-2.0 * MV_LOG2E / ((double)p[2] * (double)p[2]));
  }
  static __device__ __forceinline__ float value(const float* c, int,
                                                float r2) {
    const float sn = sinpif(sqrtf(r2) * c[1]);
    return c[0] * ex2(c[2] * (sn * sn));
  }
};

template <class F>
__device__ __forceinline__ void mv_family(int type, const F& f) {
  switch (type) {
    case TERM_SE: f(MvSE()); break;
    case TERM_WHITE: f(MvWhite()); break;
    case TERM_MATERN: f(MvMatern()); break;
    case TERM_RQ: f(MvRQ()); break;
    default: f(MvPeriodic()); break;
  }
}

struct MvPrep {
  const float* p;
  int aux;
  float* c;
  template <class Fam>
  __device__ __forceinline__ void operator()(Fam) const {
    Fam::prep(p, aux, c);
  }
};

// A lone term's values over N entries, added into `out`
template <int N>
struct MvLone {
  const float* c;
  int aux;
  const float (&r2)[N];
  float (&out)[N];
  template <class Fam>
  __device__ __forceinline__ void operator()(Fam) const {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] += Fam::value(c, aux, r2[e]);
  }
};

// A product's factor over N entries, into the running product `pr` (set by
// the first factor)
template <int N>
struct MvFactor {
  const float* c;
  int aux;
  bool first;
  const float (&r2)[N];
  float (&pr)[N];
  template <class Fam>
  __device__ __forceinline__ void operator()(Fam) const {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float v = Fam::value(c, aux, r2[e]);
      pr[e] = first ? v : pr[e] * v;
    }
  }
};

// k(r2) of one term, the family switch per call
__device__ __forceinline__ float mv_value(int type, const float* c, int aux,
                                          float r2) {
  switch (type) {
    case TERM_SE: return MvSE::value(c, aux, r2);
    case TERM_WHITE: return MvWhite::value(c, aux, r2);
    case TERM_MATERN: return MvMatern::value(c, aux, r2);
    case TERM_RQ: return MvRQ::value(c, aux, r2);
    default: return MvPeriodic::value(c, aux, r2);
  }
}

// out[e] = K(r2[e]) = sum_g prod_{t in g} k_t(r2[e]), each product formed
// left to right, as the JAX package's Product forms it. A product that
// comes first (Product + White, the usual form) is formed in `out`
// itself; a later one entry by entry, the switch per factor and entry, so
// that no instance holds a second array of N registers for it.
template <int N>
__device__ __forceinline__ void mv_values(const TermSmem& ts,
                                          const float (*tc)[MV_TC],
                                          int n_terms, const float (&r2)[N],
                                          float (&out)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = 0.0f;
  for (int t = 0; t < n_terms; ++t) {
    const int end = ts.end(t);
    if (ts.first(t) != t) continue;
    if (end == t + 1) {
      mv_family(ts.type(t), MvLone<N>{tc[t], ts.aux(t), r2, out});
    } else if (t == 0) {
      for (int u = t; u < end; ++u)
        mv_family(ts.type(u), MvFactor<N>{tc[u], ts.aux(u), u == t, r2, out});
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float v = mv_value(ts.type(t), tc[t], ts.aux(t), r2[e]);
        for (int u = t + 1; u < end; ++u)
          v *= mv_value(ts.type(u), tc[u], ts.aux(u), r2[e]);
        out[e] += v;
      }
    }
  }
}

// Dynamic shared memory of an instance: the two split V tiles (hi/lo in
// fragment order), the float-float sums' high parts, the term table's
// constants (MV_TC floats a row) and the table itself (terms.cuh), the ring
// (V slices of RC + 8 floats a row, then the tile's coordinates as [D][64]
// when staged), and the block's rows of x1 as [D][128] when staged. The
// table's part is sized from the tree at launch; what comes before it has
// a fixed size, so the constants sit at a fixed offset.
__host__ __device__ constexpr int mv_fixed_floats(int ni) {
  return 4 * MV_BK * 8 * ni + 4 * ni * MV_THREADS;
}
__host__ __device__ constexpr int mv_table_floats(int n_terms, int n_params) {
  return MV_TC * n_terms + term_smem_bytes(n_terms, n_params) / 4;
}
static size_t mv_smem(int ni, int ds, int table_floats) {
  const int rc = 8 * ni;
  return 4 * ((size_t)mv_fixed_floats(ni) + (size_t)table_floats +
              (size_t)MV_STAGES * (MV_BK * (rc + MV_VPAD) + ds * MV_BK) +
              (size_t)ds * MV_ROWS);
}
constexpr int MV_TABLE_MAX =
    mv_table_floats(GPX_MAX_TERMS, GPX_TERM_PARAMS * GPX_MAX_TERMS);

// One tile of 64 points at j0 (of the block's range [.., j_hi)) into ring
// stage `stg`: V's (64, RC) slice at column q0, and with XSM the points'
// coordinates as [D][64]. Rows past j_hi and columns past r read as zero.
template <int NI, bool XSM>
__device__ __forceinline__ void mv_load(float* stg, const float* v,
                                        int64_t ldv, int r, int q0,
                                        const float* x2, int d, int j0,
                                        int j_hi) {
  constexpr int RC = 8 * NI, VS = RC + MV_VPAD;
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < MV_BK * RC / MV_THREADS; ++q) {
    const int e = tid + q * MV_THREADS;
    const int jj = e / RC, qq = e % RC;
    const int gj = j0 + jj, gq = q0 + qq;
    const bool ok = gj < j_hi && gq < r;
    cp_async4(stg + jj * VS + qq, ok ? v + (int64_t)gj * ldv + gq : v,
              ok ? 4 : 0);
  }
  if (XSM) {  // the last warps copy, as the first split V
    float* xs = stg + MV_BK * VS;
    for (int e = MV_THREADS - 1 - tid; e < MV_BK * d; e += MV_THREADS) {
      const int jj = e % MV_BK, k = e / MV_BK;
      const bool ok = j0 + jj < j_hi;
      cp_async4(xs + e, ok ? x2 + (int64_t)(j0 + jj) * d + k : x2, ok ? 4 : 0);
    }
  }
}

// XSM: D <= MV_DMAX, coordinates staged in shared memory. One launch per
// (row block, split, column chunk).
template <int NI, bool XSM>
__global__ void __launch_bounds__(MV_THREADS, XSM ? 2 : 1)
matvec_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
              int n1, int n2, int d, const float* __restrict__ v, int64_t ldv,
              int r, const int* __restrict__ table, int n_terms,
              const float* __restrict__ params, int n_params, float nugget,
              int symmetric, int split_cols, double* __restrict__ partials) {
  constexpr int RC = 8 * NI, VS = RC + MV_VPAD;
  constexpr int SPE = 4;  // k steps per evaluation: 16 entries a thread
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  uint4* sbw = reinterpret_cast<uint4*>(smem);
  // the float-float sums' high parts wait in shared memory between folds
  // ([4 NI][MV_THREADS]): in registers they would cost a block per SM
  float* sum = smem + 4 * MV_BK * RC;
  float(*tc)[MV_TC] =
      reinterpret_cast<float(*)[MV_TC]>(smem + mv_fixed_floats(NI));
  const TermSmem ts =
      load_terms(table, n_terms, params, n_params,
                 reinterpret_cast<int4*>(smem + mv_fixed_floats(NI) +
                                         MV_TC * n_terms));
  for (int u = tid; u < n_terms; u += MV_THREADS)
    mv_family(ts.type(u), MvPrep{ts.par(u), ts.aux(u), tc[u]});

  const int ds = XSM ? d : 0;
  float* ring = smem + mv_fixed_floats(NI) + mv_table_floats(n_terms, n_params);
  const int stage_floats = MV_BK * VS + ds * MV_BK;
  float* x1s = ring + MV_STAGES * stage_floats;

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * MV_ROWS;
  const int wr = i0 + 16 * warp;  // the warp's first row
  const int q0 = blockIdx.z * RC;
  const int j_lo = blockIdx.y * split_cols;
  const int j_hi = min(n2, j_lo + split_cols);

  if (XSM) {  // the block's rows, [D][128]; rows past n1 read as zero
    for (int e = tid; e < MV_ROWS * d; e += MV_THREADS) {
      const int rr = e % MV_ROWS, k = e / MV_ROWS;
      x1s[e] = i0 + rr < n1 ? x1[(int64_t)(i0 + rr) * d + k] : 0.0f;
    }
  }

  const int nkt = (j_hi - j_lo + MV_BK - 1) / MV_BK;
#pragma unroll
  for (int s = 0; s < MV_STAGES - 1; ++s) {
    if (s < nkt)
      mv_load<NI, XSM>(ring + s * stage_floats, v, ldv, r, q0, x2, d,
                       j_lo + s * MV_BK, j_hi);
    cp_async_commit();
  }

  float acc[NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[ni][q] = 0.0f;
      sum[(4 * ni + q) * MV_THREADS + tid] = 0.0f;
    }

  // V's slice of a staged tile in TF32 hi/lo, in B-fragment order: item
  // (s, n, tt) holds {hi, hi, lo, lo} of V at points 8 s + tt and
  // 8 s + tt + 4, column n. Two buffers: tile kt + 1 is split while tile
  // kt is multiplied, so one barrier a tile serves both.
  constexpr int SBN = MV_BK / 2 * RC;  // items per split tile
  auto split_tile = [&](const float* st, uint4* dst) {
    for (int e = tid; e < SBN; e += MV_THREADS) {
      const int tt = e & 3, n = (e >> 2) % RC, s = (e >> 2) / RC;
      const float* col = st + (8 * s + tt) * VS + n;
      uint32_t h0, l0, h1, l1;
      split(col[0], h0, l0);
      split(col[4 * VS], h1, l1);
      dst[e] = make_uint4(h0, h1, l0, l1);
    }
  };
  cp_async_wait<MV_STAGES - 2>();
  __syncthreads();
  split_tile(ring, sbw);
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<MV_STAGES - 3>();
    __syncthreads();  // tile kt split, tile kt + 1 landed, tile kt - 1 done
    const int nxt = kt + MV_STAGES - 1;
    if (nxt < nkt)
      mv_load<NI, XSM>(ring + (nxt % MV_STAGES) * stage_floats, v, ldv, r,
                       q0, x2, d, j_lo + nxt * MV_BK, j_hi);
    cp_async_commit();
    if (kt + 1 < nkt)
      split_tile(ring + ((kt + 1) % MV_STAGES) * stage_floats,
                 sbw + ((kt + 1) & 1) * SBN);
    const float* stg = ring + (kt % MV_STAGES) * stage_floats;
    const uint4* sb = sbw + (kt & 1) * SBN;

    // The thread's entries, SPE k steps (half a tile) at a time: e =
    // 4 s + 2 h + m is row wr + g + 8 m and point j0 + 8 (s0 + s) + t + 4 h,
    // the A fragment's element 2 h + m of k step s0 + s
    const int j0 = j_lo + kt * MV_BK;
    const bool diag = symmetric && j0 < wr + 16 && wr < j0 + MV_BK;
#pragma unroll
    for (int s0 = 0; s0 < MV_BK / 8; s0 += SPE) {
      float r2[4 * SPE];
#pragma unroll
      for (int e = 0; e < 4 * SPE; ++e) r2[e] = 0.0f;
      for (int k = 0; k < d; ++k) {
        float a[2];
        if (XSM) {
          a[0] = x1s[k * MV_ROWS + 16 * warp + g];
          a[1] = x1s[k * MV_ROWS + 16 * warp + g + 8];
        } else {
          a[0] = wr + g < n1 ? __ldg(x1 + (int64_t)(wr + g) * d + k) : 0.0f;
          a[1] = wr + g + 8 < n1 ? __ldg(x1 + (int64_t)(wr + g + 8) * d + k)
                                 : 0.0f;
        }
#pragma unroll
        for (int s = 0; s < SPE; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jl = 8 * (s0 + s) + t + 4 * h;
            float b;
            if (XSM)
              b = stg[MV_BK * VS + k * MV_BK + jl];
            else
              b = j0 + jl < j_hi ? __ldg(x2 + (int64_t)(j0 + jl) * d + k)
                                 : 0.0f;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const float df = a[m] - b;
              r2[4 * s + 2 * h + m] = fmaf(df, df, r2[4 * s + 2 * h + m]);
            }
          }
      }
      // the global diagonal i == j, where the tile meets the warp's rows:
      // r2 = 0 there, and the nugget on k(0)
      if (diag) {
#pragma unroll
        for (int e = 0; e < 4 * SPE; ++e)
          if (wr + g + 8 * (e & 1) == j0 + 8 * (s0 + e / 4) + t + 4 * ((e >> 1) & 1))
            r2[e] = 0.0f;
      }
      float kv[4 * SPE];
      mv_values(ts, tc, n_terms, r2, kv);
      if (diag) {
#pragma unroll
        for (int e = 0; e < 4 * SPE; ++e)
          if (wr + g + 8 * (e & 1) == j0 + 8 * (s0 + e / 4) + t + 4 * ((e >> 1) & 1))
            kv[e] += nugget;
      }

#pragma unroll
      for (int s = 0; s < SPE; ++s) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split(kv[4 * s + q], ah[q], al[q]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint4 f = sb[((s0 + s) * RC + ni * 8 + g) * 4 + t];
          const uint32_t bh[2] = {f.x, f.y}, bl[2] = {f.z, f.w};
          // the step's four MMAs into a fresh fragment, so that their
          // truncation is against the step's 8-term partial, then a
          // rounded add into the accumulator
          float st[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma(st, al, bl);
          mma(st, al, bh);
          mma(st, ah, bl);
          mma(st, ah, bh);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[ni][q] = __fadd_rn(acc[ni][q], st[q]);
        }
        // the next step's fragments load after these MMAs: hoisted, they
        // would hold registers that the 128-register target lacks
        asm volatile("" ::: "memory");
      }
    }
    {  // fold: every 64 k
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float hi = sum[(4 * ni + q) * MV_THREADS + tid];
          fold(hi, acc[ni][q]);
          sum[(4 * ni + q) * MV_THREADS + tid] = hi;
        }
    }
  }
  cp_async_wait<0>();

  // fragment element q of n8 tile ni: row wr + g + 8 (q / 2), column
  // q0 + 8 ni + 2 t + q % 2
  double* out = partials + (int64_t)blockIdx.y * n1 * r;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = wr + g + 8 * (q >> 1), c = q0 + 8 * ni + 2 * t + (q & 1);
      if (i < n1 && c < r)
        out[(int64_t)i * r + c] =
            (double)sum[(4 * ni + q) * MV_THREADS + tid] + (double)acc[ni][q];
    }
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

using MvKernel = void (*)(const float*, const float*, int, int, int,
                          const float*, int64_t, int, const int*, int,
                          const float*, int, float, int, int, double*);

template <int NI, bool XSM>
static MvKernel instance() {
  static bool ready = false;
  if (!ready) {  // dynamic shared memory past 48 KB needs the opt-in
    cudaFuncSetAttribute(matvec_kernel<NI, XSM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)mv_smem(NI, XSM ? MV_DMAX : 0, MV_TABLE_MAX));
    ready = true;
  }
  return matvec_kernel<NI, XSM>;
}

static MvKernel pick(int ni, bool xsm) {
  switch (ni) {
    case 1: return xsm ? instance<1, true>() : instance<1, false>();
    default: return xsm ? instance<2, true>() : instance<2, false>();
  }
}

struct Plan {
  MvKernel fn;
  int ni, chunks, splits, split_cols;
  size_t smem;
};

// The instance, and the column splits: the fewest that fill the card's
// resident blocks best (waves of whole blocks), in whole 64-point tiles of
// at least MV_MIN_SPLIT points
static Plan plan(int n1, int n2, int r, int d, int n_terms, int n_params) {
  Plan p;
  p.ni = r <= 8 ? 1 : MV_MAX_NI;
  p.chunks = (r + 8 * p.ni - 1) / (8 * p.ni);
  const bool xsm = d <= MV_DMAX;
  p.fn = pick(p.ni, xsm);
  p.smem = mv_smem(p.ni, xsm ? d : 0, mv_table_floats(n_terms, n_params));
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.fn, MV_THREADS,
                                                    p.smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const int64_t cap = (int64_t)sms * per_sm;
  const int64_t blocks = (int64_t)((n1 + MV_ROWS - 1) / MV_ROWS) * p.chunks;
  const int64_t tiles = (n2 + MV_BK - 1) / MV_BK;
  int64_t most = n2 / MV_MIN_SPLIT;
  if (most > 64) most = 64;
  if (most < 1) most = 1;
  int64_t best_per = tiles;
  double best = -1.0;
  for (int64_t s = 1; s <= most; ++s) {
    const int64_t per = (tiles + s - 1) / s;
    const int64_t total = blocks * ((tiles + per - 1) / per);
    const int64_t waves = (total + cap - 1) / cap;
    const double fill = (double)total / (double)(waves * cap);
    if (fill > best + 0.02) {
      best = fill;
      best_per = per;
    }
  }
  p.split_cols = (int)(best_per * MV_BK);
  p.splits = (int)((n2 + p.split_cols - 1) / p.split_cols);
  return p;
}

extern "C" {

// The number of column splits gpx_matvec uses for these sizes and this
// term table: the caller allocates `partials` as (splits, n1, r) doubles.
int gpx_matvec_splits(int n1, int n2, int r, int d, int n_terms,
                      int n_params) {
  if (n1 < 1 || n2 < 1 || r < 1 || d < 1) return 0;
  return plan(n1, n2, r, d, n_terms, n_params).splits;
}

int gpx_matvec(const float* x1, const float* x2, int n1, int n2, int d,
               const float* v, int64_t ldv, int r, const int* table,
               int n_terms, const float* params, int n_params, float nugget,
               int symmetric, double* partials, float* out, int64_t ldo,
               void* stream) {
  if (n1 < 1 || n2 < 1 || r < 1 || d < 1 || n_terms < 1 ||
      n_terms > GPX_MAX_TERMS || n_params > GPX_TERM_PARAMS * GPX_MAX_TERMS)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(n1, n2, r, d, n_terms, n_params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n1 + MV_ROWS - 1) / MV_ROWS, p.splits, p.chunks);
  p.fn<<<grid, MV_THREADS, p.smem, s>>>(
      x1, x2, n1, n2, d, v, ldv, r, table, n_terms, params, n_params, nugget,
      symmetric, p.split_cols, partials);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t count = (int64_t)n1 * r;
  const int threads = 256;
  matvec_reduce_kernel<<<(unsigned)((count + threads - 1) / threads), threads,
                         0, s>>>(partials, p.splits, count, r, out, ldo);
  return (int)cudaGetLastError();
}

}  // extern "C"
