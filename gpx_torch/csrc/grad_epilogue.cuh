// The epilogue of the two logML gradient kernels (logml_grad.cu: the exact
// K^-1 tile from L^-1; logml_probe_grad.cu: its probe estimate), and the
// pass that sums their per-block partials.
//
// For one lower-triangle 64 x 64 tile (i >= j) with `kinv` the (exact or
// estimated) K^-1 tile in the tile core's register layout, the epilogue
// recomputes r2 from x, forms W = 0.5 (alpha alpha^T - K^-1) with weights 2
// below the diagonal, 1 on it and 0 above, and contracts it with dk/dtheta
// of every term-table hyperparameter (terms.cuh). It also forms the
// logdet-correction traces tr(W_hat K), with K evaluated without the
// nugget, and tr(W_hat). Thread 0 writes the block's n_params + 2 partials.
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

// `red` holds THREADS / 32 floats of shared memory; `part` the block's row
// of n_params + 2 partials
__device__ __forceinline__ void grad_epilogue(
    const float (&kinv)[4][4], int i0, int j0, const float* __restrict__ x,
    int d, const float* __restrict__ alpha, const TermSmem& ts, int n_terms,
    int n_params, float* red, float* __restrict__ part) {
  const int tx = tile_tx(), ty = tile_ty();
  float r2[4][4], wr[4][4], wk[4][4], kval[4][4];
  float trw = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      float q = 0.0f;
      for (int e = 0; e < d; ++e) {
        const float diff = x[(int64_t)i * d + e] - x[(int64_t)j * d + e];
        q = fmaf(diff, diff, q);
      }
      const bool diag = i == j;
      const float weight = i > j ? 2.0f : (diag ? 1.0f : 0.0f);
      r2[r][c] = diag ? 0.0f : q;
      wr[r][c] = 0.5f * (alpha[i] * alpha[j] - kinv[r][c]) * weight;
      wk[r][c] = weight * kinv[r][c];
      kval[r][c] = 0.0f;
      if (diag) trw += kinv[r][c];
    }
  }

  for (int t = 0; t < n_terms; ++t) {
    const int type = ts.type[t];
    const float* p = &ts.par[ts.off[t]];
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float g0, g1;
        term_grads(type, p, r2[r][c], g0, g1);
        s0 = fmaf(wr[r][c], g0, s0);
        s1 = fmaf(wr[r][c], g1, s1);
        kval[r][c] += term_value(type, p, r2[r][c]);
      }
    s0 = block_sum(s0, red);
    if (threadIdx.x == 0) part[ts.off[t]] = s0;
    if (term_arity(type) == 2) {
      s1 = block_sum(s1, red);
      if (threadIdx.x == 0) part[ts.off[t] + 1] = s1;
    }
  }
  float tkw = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) tkw = fmaf(wk[r][c], kval[r][c], tkw);
  tkw = block_sum(tkw, red);
  trw = block_sum(trw, red);
  if (threadIdx.x == 0) {
    part[n_params] = tkw;
    part[n_params + 1] = trw;
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
