// Fused logML gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel gpx/ops/pallas_logml_grad.py::logml_kernel_grads
// (_body) with with_correction=True, non-ARD. For every lower-triangle
// 64 x 64 tile (i >= j) of W = 0.5 (alpha alpha^T - K^-1):
//   K^-1 tile = sum_{k >= i} Li[k, i-tile]^T Li[k, j-tile]   (N^3/6 MACs)
// through the shared tile core (tile_core.cuh: A read transposed, the k
// loop inside the block, slices summed in double), then the shared epilogue
// (grad_epilogue.cuh): W, its contraction with dk/dtheta of every
// term-table hyperparameter (terms.cuh: explicit device functions, no
// autodiff), and the logdet-correction traces tr(W_hat K) and tr(W_hat).
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
#include "grad_epilogue.cuh"

using namespace gpx;

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
  grad_epilogue(kinv, i0, j0, x, d, alpha, ts, n_terms, n_params, red,
                partials + (int64_t)blockIdx.x * (n_params + 2));
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
