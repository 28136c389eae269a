// Fused logML gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel gpx/ops/pallas_logml_grad.py::logml_kernel_grads
// (_body) with with_correction=True, non-ARD. For every lower-triangle
// 64 x 64 tile (i >= j) of W = 0.5 (alpha alpha^T - K^-1):
//   K^-1 tile = sum_{k >= i} Li[k, i-tile]^T Li[k, j-tile]   (N^3/6 MACs)
// through the shared tile core (tile_core.cuh: A read transposed, the k
// loop inside the block, slices summed in double), then an epilogue that
// recomputes r2 from x, forms W with weights 2 below the diagonal, 1 on
// it, 0 above, and
// contracts it with dk/dtheta of every term-table hyperparameter
// (terms.cuh: explicit device functions, no autodiff). It also forms the
// logdet-correction traces tr(W_hat K) over the weighted triangle, with K
// evaluated without the nugget, and tr(W_hat).
//
// The TPU grid ran in order and added into SMEM scalars across steps. A
// CUDA grid runs in parallel, so each block writes one partial per output
// into a (tiles, n_out) buffer and a second kernel sums the partials of
// each output in a fixed order, in double: the result is deterministic,
// with no atomics.
//
// Bound: operations (N^3/3 FLOPs of the K^-1 tiles at the FP32 FMA rate;
// the epilogue is O(N^2)). Design: L^-1 is read in place, only the k >= i
// range of each tile is visited, and neither K^-1 nor W reaches memory.
#include "terms.cuh"
#include "tile_core.cuh"

using namespace gpx;

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

__global__ void __launch_bounds__(THREADS)
logml_grad_kernel(const float* __restrict__ li, int64_t ldli,
                  const float* __restrict__ x, int d,
                  const float* __restrict__ alpha, int n,
                  const int* __restrict__ table, int n_terms,
                  const float* __restrict__ params, int n_params,
                  float* __restrict__ partials) {
  __shared__ TileSmem sm;
  __shared__ TermSmem ts;
  __shared__ float red[THREADS / 32];
  load_terms(table, n_terms, params, n_params, ts);

  int bi, bj;
  lower_tile(blockIdx.x, bi, bj);
  const int i0 = bi * BM, j0 = bj * BN;
  float kinv[4][4];
  tile_product<true, false>(li, ldli, li, ldli, i0, j0, i0, n, n, n, kinv,
                            sm);

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

  const int n_out = n_params + 2;
  float* part = partials + (int64_t)blockIdx.x * n_out;
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

// out[o] = sum over tiles of partials[tile, o], in a fixed order, in double
__global__ void __launch_bounds__(256)
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

extern "C" {

// n must be a multiple of 64; partials holds (n/64)(n/64 + 1)/2 x
// (n_params + 2) floats, out n_params + 2: the gradients in params order,
// then tr(W_hat K) and tr(W_hat).
int gpx_logml_grad(const float* li, int64_t ldli, const float* x, int d,
                   const float* alpha, int n, const int* table, int n_terms,
                   const float* params, int n_params, float* partials,
                   float* out, void* stream) {
  if (n % BM || n_terms < 1 || n_terms > GPX_MAX_TERMS ||
      n_params > 2 * GPX_MAX_TERMS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n / BM;
  const int tiles = nb * (nb + 1) / 2;
  logml_grad_kernel<<<tiles, THREADS, 0, s>>>(li, ldli, x, d, alpha, n, table,
                                              n_terms, params, n_params,
                                              partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<n_params + 2, 256, 0, s>>>(partials, tiles,
                                                      n_params + 2, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
