// The term table: a covariance kernel as the CUDA kernels read it.
//
// `table` holds (type, offset) per term and `params` the hyperparameters in
// gpx_torch.params.leaves order; a term's parameters start at its offset.
// gpx_torch/ops/terms.py builds both and holds term_derivatives, the plain
// version of term_grads below. A later term family is one more case in
// term_value and term_grads.
#pragma once

#include <cuda_runtime.h>

#define GPX_MAX_TERMS 8

namespace gpx {

enum TermType { TERM_SE = 0, TERM_WHITE = 1 };

struct TermSmem {
  int type[GPX_MAX_TERMS];
  int off[GPX_MAX_TERMS];
  float par[2 * GPX_MAX_TERMS];
};

// Stage the table in shared memory; every thread must call it.
__device__ __forceinline__ void load_terms(const int* table, int n_terms,
                                           const float* params, int n_params,
                                           TermSmem& ts) {
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  if (tid < n_terms) {
    ts.type[tid] = table[2 * tid];
    ts.off[tid] = table[2 * tid + 1];
  }
  if (tid < n_params) ts.par[tid] = params[tid];
  __syncthreads();
}

// k(r2) of one term: SE h exp(-r2 / s^2); White s [r2 == 0]
__device__ __forceinline__ float term_value(int type, const float* p,
                                            float r2) {
  if (type == TERM_SE) return p[0] * expf(-r2 / (p[1] * p[1]));
  return r2 == 0.0f ? p[0] : 0.0f;
}

// dk/dp[0] and dk/dp[1] (0 when the term has one parameter)
__device__ __forceinline__ void term_grads(int type, const float* p, float r2,
                                           float& g0, float& g1) {
  if (type == TERM_SE) {
    const float s = p[1];
    const float e = expf(-r2 / (s * s));
    g0 = e;
    g1 = p[0] * e * 2.0f * r2 / (s * s * s);
  } else {
    g0 = r2 == 0.0f ? 1.0f : 0.0f;
    g1 = 0.0f;
  }
}

__device__ __forceinline__ int term_arity(int type) {
  return type == TERM_SE ? 2 : 1;
}

}  // namespace gpx
