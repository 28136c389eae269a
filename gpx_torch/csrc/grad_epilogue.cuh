// The epilogue of the two logML gradient kernels (logml_grad.cu: the exact
// K^-1 tile from L^-1; logml_probe_grad.cu: its probe estimate), and the
// pass that sums their per-block partials.
//
// For one lower-triangle 64 x 64 tile (i >= j) with `kinv` the (exact or
// estimated) K^-1 tile in the tile core's register layout, the epilogue
// recomputes r2 from x, forms W = 0.5 (alpha alpha^T - K^-1) with weights 2
// below the diagonal, 1 on it and 0 above, and contracts it with dK/dtheta
// of every term-table hyperparameter (terms.cuh; a factor of a product
// times the product of the other factors, formed from them and not by
// division, since a White factor is exactly 0 off the diagonal). It also
// forms the logdet-correction traces tr(W_hat K), with K evaluated without
// the nugget, and tr(W_hat). With ARD, x holds the scaled coordinates
// u = x / ell and D more outputs follow: sdot_e = sum W dK/dr2 (u_ie -
// u_je)^2, from which the caller forms the lengthscale gradients. Each of
// the n_params + 2 (+ D) outputs goes to a sink: BlockSink adds the
// block's sum into the tile's partial (logml_grad.cu), WarpSink adds each
// warp's share into a per-warp sum in double that the block keeps across
// its tiles (logml_probe_grad.cu). Both add: a leaf that appears in several
// products of the term table's expansion repeats its offset, and its
// products' shares of one output arrive one after another, in row order. The sink's Acc is the type of each thread's
// gradient sums: float for BlockSink; double for WarpSink, whose estimate
// of W is noisy, so each gradient sums terms ~1e8 times its value (h at
// the hybrid's bench case), and float sums there missed by 5x the 1e-2
// relative limit on an H100 (PERF.md).
#pragma once

#include "terms.cuh"
#include "tile_core.cuh"

namespace gpx {

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  __syncthreads();
  return s;  // valid in thread 0
}

// The block's sum of v, added by thread 0 into part[o], which thread 0
// zeroed before the tile: every thread of the block calls it, in the same
// order. 0 + sum is sum exactly (-0 becomes +0, which the double sum of the
// partials, started at +0, cannot tell apart), so an output sent once
// reaches the result with the bits a plain store gave it
struct BlockSink {
  using Acc = float;
  float* red;
  float* part;
  __device__ __forceinline__ void operator()(int o, float v) const {
    const float sum = block_sum(v, red);
    if (threadIdx.x == 0) part[o] += sum;
  }
};

// The warp's sum of v in double, added by lane 0 into
// wacc[warp * WACC_STRIDE + o]: no barrier, a fixed order
constexpr int WACC_STRIDE = 128;  // outputs, at most
struct WarpSink {
  using Acc = double;
  double* wacc;
  __device__ __forceinline__ void operator()(int o, double v) const {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_down_sync(0xffffffffu, v, m);
    if (threadIdx.x % 32 == 0) wacc[(threadIdx.x / 32) * WACC_STRIDE + o] += v;
  }
};

// s + a b, rounded once, in the sum's type
__device__ __forceinline__ float acc_fma(float a, float b, float s) {
  return fmaf(a, b, s);
}
__device__ __forceinline__ double acc_fma(float a, float b, double s) {
  return fma((double)a, (double)b, s);
}

// oth *= k_u(r2) over row R of the thread's 4 x 4 entries
template <int R>
struct RowFactor {
  const float* p;
  int aux;
  const float (&r2)[4][4];
  float (&oth)[4];
  template <class Fam>
  __device__ __forceinline__ void operator()(Fam) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) oth[c] *= Fam::value(p, aux, r2[R][c]);
  }
};

// One entry of one term's contractions, `o` the product of the term's
// other factors: s[q] += W dK/dtheta_q (dK/dtheta_q = o dk_t/dtheta_q),
// *wkp += W o dk_t/dr2 (ARD; the entry's slot of shared memory), and at the
// product's first factor tkw += W_hat K's share, wk k_t o
template <class Fam, bool ARD, class Acc>
__device__ __forceinline__ void entry_grads(const float* p, int aux,
                                            bool first, float r2, float wr,
                                            float wk, float o, Acc (&s)[3],
                                            float* wkp, float& tkw) {
  float v, g[3], kp;
  Fam::grads(p, aux, r2, v, g, kp);
  const float w = wr * o;
  s[0] = acc_fma(w, g[0], s[0]);
  s[1] = acc_fma(w, g[1], s[1]);
  s[2] = acc_fma(w, g[2], s[2]);
  if (ARD) *wkp = fmaf(w, kp, *wkp);
  if (first) tkw = fmaf(wk, v * o, tkw);
}

// entry (r, c)'s slot of the ARD sums W dK/dr2: 16 per thread, at stride
// THREADS from the thread's own
__device__ __forceinline__ float* wkp_slot(float* wkp, int r, int c) {
  return wkp + (4 * r + c) * THREADS;
}

// Term t's contractions over row R of the thread's entries, `oth` the
// row's product of t's other factors
template <bool ARD, int R, class Acc>
struct FactorGrads {
  const float* p;
  int aux;
  bool first;
  const float (&r2)[4][4];
  const float (&wr)[4][4];
  const float (&wk)[4][4];
  const float (&oth)[4];
  Acc (&s)[3];
  float* wkp;
  float& tkw;
  template <class Fam>
  __device__ __forceinline__ void operator()(Fam) const {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      entry_grads<Fam, ARD, Acc>(p, aux, first, r2[R][c], wr[R][c],
                                 wk[R][c], oth[c], s, wkp_slot(wkp, R, c),
                                 tkw);
  }
};

// Term t of the product of terms first .. end - 1 (a lone term: first = t,
// end = t + 1, o = 1), row by row from R: the other factors' product for
// one row at a time (4 registers, not 16)
template <bool ARD, class Acc, int R = 0>
__device__ __forceinline__ void product_grads(
    const TermSmem& ts, int t, int first, int end, const float (&r2)[4][4],
    const float (&wr)[4][4], const float (&wk)[4][4], Acc (&s)[3],
    float* wkp, float& tkw) {
  if constexpr (R < 4) {
    float oth[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    for (int u = first; u < end; ++u)
      if (u != t)
        with_family(ts.type(u), RowFactor<R>{ts.par(u), ts.aux(u), r2, oth});
    with_family(ts.type(t),
                FactorGrads<ARD, R, Acc>{ts.par(t), ts.aux(t), t == first, r2,
                                         wr, wk, oth, s, wkp, tkw});
    product_grads<ARD, Acc, R + 1>(ts, t, first, end, r2, wr, wk, s, wkp, tkw);
  }
}

// `sink(o, v)` takes each output o (n_params + 2 (+ d with ARD) of them)
// from every thread, in the same order; with ARD, `wkp` is 16 THREADS
// floats of shared memory (the per-entry sums W dK/dr2 across terms: in
// registers they would push the probe kernel past its 128)
template <bool ARD, class Sink>
__device__ __forceinline__ void grad_epilogue(
    const float (&kinv)[4][4], int i0, int j0, const float* __restrict__ x,
    int d, const float* __restrict__ alpha, const TermSmem& ts, int n_terms,
    int n_params, float* wkp, const Sink& sink) {
  const int tx = tile_tx(), ty = tile_ty();
  float r2[4][4], wr[4][4], wk[4][4];
  if (ARD) wkp += threadIdx.x;
  float trw = 0.0f, tkw = 0.0f;
  // r2 of the 16 entries, each summed over the dimensions in order, from
  // 8 coordinate loads a dimension
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) r2[r][c] = 0.0f;
  for (int e = 0; e < d; ++e) {
    float xj[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) xj[c] = x[(int64_t)(j0 + tx + 16 * c) * d + e];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float xi = x[(int64_t)(i0 + ty + 16 * r) * d + e];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float diff = xi - xj[c];
        r2[r][c] = fmaf(diff, diff, r2[r][c]);
      }
    }
  }
  float aj[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) aj[c] = alpha[j0 + tx + 16 * c];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    const float ai = alpha[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      const bool diag = i == j;
      const float weight = i > j ? 2.0f : (diag ? 1.0f : 0.0f);
      if (diag) r2[r][c] = 0.0f;
      wr[r][c] = 0.5f * (ai * aj[c] - kinv[r][c]) * weight;
      wk[r][c] = weight * kinv[r][c];
      if (ARD) *wkp_slot(wkp, r, c) = 0.0f;
      if (diag) trw += kinv[r][c];
    }
  }

  for (int t = 0; t < n_terms; ++t) {
    const int first = ts.first(t), end = ts.end(t);
    typename Sink::Acc s[3] = {0, 0, 0};
    product_grads<ARD, typename Sink::Acc>(ts, t, first, end, r2, wr, wk, s,
                                           wkp, tkw);
    const int arity = term_arity(ts.type(t));
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (q == arity) break;  // uniform across the block
      sink(ts.off(t) + q, s[q]);
    }
  }
  sink(n_params, tkw);
  sink(n_params + 1, trw);
  if constexpr (ARD) {  // the ARD leg: one sum per dimension
    for (int e = 0; e < d; ++e) {
      float se = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float xi = x[(int64_t)(i0 + ty + 16 * r) * d + e];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float diff = xi - x[(int64_t)(j0 + tx + 16 * c) * d + e];
          se = fmaf(*wkp_slot(wkp, r, c) * diff, diff, se);
        }
      }
      sink(n_params + 2 + e, se);
    }
  }
}

// out[o] = sum over tiles of partials[tile, o], in a fixed order, in double:
// deterministic, no atomics (static: each source builds its own library)
static __global__ void __launch_bounds__(256)
reduce_partials_kernel(const float* __restrict__ partials, int tiles,
                       int n_out, float* __restrict__ out) {
  __shared__ double red[256];
  const int o = blockIdx.x;
  double s = 0.0;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x)
    s += (double)partials[(int64_t)t * n_out + o];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = 128; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[o] = (float)red[0];
}

}  // namespace gpx
