// Probe-estimated logML gradient (the hybrid path) for Hopper (sm_90a).
//
// Replaces the TPU kernel gpx/ops/pallas_logml_grad.py::logml_probe_grads
// (_probe_body) with with_correction=True, with and without ard. It is the
// exact
// gradient kernel (logml_grad.cu) with the N-deep K^-1 accumulation
// replaced by a Hutchinson estimate from an (n, s) probe block Z and its
// solve U = K^-1 Z: for every lower-triangle 64 x 64 tile (i >= j)
//   what = (U_i Z_j^T + Z_i U_j^T) * (0.5 / s)
// from two s-deep calls of the shared tile core (tile_core.cuh; 16-deep
// slices summed in float, the slices in double), then the shared epilogue
// (grad_epilogue.cuh) with `what` in place of the K^-1 tile. The symmetric
// form matters: the epilogue weights only the lower triangle, so each
// off-diagonal entry stands in for its mirror.
//
// As in logml_grad.cu, each block writes one partial per output and
// reduce_partials_kernel sums them in a fixed order, in double.
//
// Bound: operations, 2 N^2 s FLOPs over the lower triangle (0.51 ms at
// N = 16,384, s = 64 on an H100 SXM's 67 TFLOP/s FP32); the distinct bytes
// (2 N s floats of U and Z) are a few MB and stay in L2. Design: one block
// per tile, U and Z rows read straight from device memory through the tile
// core's shared-memory slices; neither the K^-1 estimate nor W reaches
// memory. Tensor cores (wgmma) and TMA are later work. The ARD instance
// (a template flag, D more sums) keeps its per-entry sums in 16 KB of
// shared memory, so that both instances fit two blocks an SM unspilled.
#include "grad_epilogue.cuh"

using namespace gpx;

template <bool ARD>
__global__ void __launch_bounds__(THREADS)
logml_probe_grad_kernel(const float* __restrict__ u, int64_t ldu,
                        const float* __restrict__ z, int64_t ldz, int s,
                        const float* __restrict__ x, int d,
                        const float* __restrict__ alpha, int n,
                        const int* __restrict__ table, int n_terms,
                        const float* __restrict__ params, int n_params,
                        int n_out, float* __restrict__ partials) {
  __shared__ TileSmem sm;
  __shared__ TermSmem ts;
  __shared__ float red[THREADS / 32];
  __shared__ float wkp[ARD ? 16 * THREADS : 1];  // the ARD sums, per entry
  load_terms(table, n_terms, params, n_params, ts);

  int bi, bj;
  lower_tile(blockIdx.x, bi, bj);
  const int i0 = bi * BM, j0 = bj * BN;
  float uz[4][4], zu[4][4];
  tile_product<false, true>(u, ldu, z, ldz, i0, j0, 0, s, n, n, uz, sm);
  tile_product<false, true>(z, ldz, u, ldu, i0, j0, 0, s, n, n, zu, sm);
  const float scale = 0.5f / (float)s;
  float what[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) what[r][c] = (uz[r][c] + zu[r][c]) * scale;
  grad_epilogue<ARD>(what, i0, j0, x, d, alpha, ts, n_terms, n_params, red,
                     wkp, partials + (int64_t)blockIdx.x * n_out);
}

extern "C" {

// n must be a multiple of 64 and s >= 1; u and z are (n, s) row-major with
// leading dimensions ldu, ldz; n_out = n_params + 2 (+ d with ard), at most
// 128; partials holds (n/64)(n/64 + 1)/2 x n_out floats, out n_out: the
// gradients in params order, tr(W_hat K) and tr(W_hat) of the estimate,
// then with ard sdot.
int gpx_logml_probe_grad(const float* u, int64_t ldu, const float* z,
                         int64_t ldz, int s, const float* x, int d,
                         const float* alpha, int n, const int* table,
                         int n_terms, const float* params, int n_params,
                         int ard, float* partials, float* out, void* stream) {
  const int n_out = n_params + 2 + (ard ? d : 0);
  if (n % BM || s < 1 || n_terms < 1 || n_terms > GPX_MAX_TERMS ||
      n_params > GPX_TERM_PARAMS * GPX_MAX_TERMS || n_out > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = n / BM;
  const int tiles = nb * (nb + 1) / 2;
  auto kern = ard ? &logml_probe_grad_kernel<true>
                  : &logml_probe_grad_kernel<false>;
  kern<<<tiles, THREADS, 0, st>>>(u, ldu, z, ldz, s, x, d, alpha, n, table,
                                  n_terms, params, n_params, n_out, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<n_out, 256, 0, st>>>(partials, tiles, n_out,
                                                out);
  return (int)cudaGetLastError();
}

}  // extern "C"
