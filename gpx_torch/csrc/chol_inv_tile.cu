// chol_inv_tile for Hopper (sm_90a): (L, L^-1) of one SPD leaf tile.
//
// Replaces the TPU kernel gpx/ops/pallas_chol.py::chol_inv_tile
// (_chol_inv_value / _chol_base / _tri_inv_base), which factors a 2048^2
// tile in one program under a 100 MiB VMEM limit. A Hopper block has at
// most 227 KB of shared memory, so here the torch recursion
// (gpx_torch/ops/cuda_chol.py::chol_inv) goes on down to a leaf of at most
// 128 x 128, and one CTA factors and inverts it with the tile and its
// inverse resident in dynamic shared memory (2 x 128 x 129 floats, 132 KB).
//
// Bound: latency. The leaf is t^3/3 FLOPs (0.7 MFLOP at t = 128), far
// below what one SM could do in a microsecond; its time is the t
// dependent column steps of the right-looking Cholesky (two block-wide
// barriers each) and the serial forward substitution of each inverse
// column. Design: 1024 threads share each column step (scaled pivot column
// staged once, then a 32 x 32 thread sweep of the trailing lower
// triangle); the inverse gives each thread one column, its dot products
// split over four accumulators. Only the lower triangle of the input is
// read; both outputs hold exact zeros above the diagonal. The input may
// alias the L output: the whole tile is in shared memory before any write.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int LEAF_THREADS = 1024;
constexpr int LEAF_MAX = 128;

__global__ void __launch_bounds__(LEAF_THREADS)
chol_inv_tile_kernel(const float* a, int64_t lda, float* l, int64_t ldl,
                     float* m, int64_t ldm, int t) {
  extern __shared__ float smem[];
  const int ld = t + 1;
  float* S = smem;            // t x ld: the tile, then L
  float* Mi = smem + t * ld;  // t x ld: L^-1
  float* col = Mi + t * ld;   // t: the scaled pivot column of one step
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int tx = tid % 32, ty = tid / 32, nty = nth / 32;

  for (int e = tid; e < t * t; e += nth) {
    const int i = e / t, j = e % t;
    S[i * ld + j] = (j <= i) ? a[(int64_t)i * lda + j] : 0.0f;
  }
  __syncthreads();

  // right-looking Cholesky, one column per step
  for (int k = 0; k < t; ++k) {
    const float d = sqrtf(S[k * ld + k]);
    for (int i = k + tid; i < t; i += nth)
      col[i] = (i == k) ? d : S[i * ld + k] / d;
    __syncthreads();
    for (int i = k + tid; i < t; i += nth) S[i * ld + k] = col[i];
    for (int i = k + 1 + ty; i < t; i += nty) {
      const float ci = col[i];
      for (int j = k + 1 + tx; j <= i; j += 32) S[i * ld + j] -= ci * col[j];
    }
    __syncthreads();
  }

  // L^-1 by forward substitution, one column per thread
  for (int j = tid; j < t; j += nth) {
    for (int i = 0; i < j; ++i) Mi[i * ld + j] = 0.0f;
    for (int i = j; i < t; ++i) {
      float s0 = (i == j) ? 1.0f : 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      int k = j;
      for (; k + 3 < i; k += 4) {
        s0 = fmaf(-S[i * ld + k], Mi[k * ld + j], s0);
        s1 = fmaf(-S[i * ld + k + 1], Mi[(k + 1) * ld + j], s1);
        s2 = fmaf(-S[i * ld + k + 2], Mi[(k + 2) * ld + j], s2);
        s3 = fmaf(-S[i * ld + k + 3], Mi[(k + 3) * ld + j], s3);
      }
      for (; k < i; ++k) s0 = fmaf(-S[i * ld + k], Mi[k * ld + j], s0);
      Mi[i * ld + j] = ((s0 + s1) + (s2 + s3)) / S[i * ld + i];
    }
  }
  __syncthreads();

  for (int e = tid; e < t * t; e += nth) {
    const int i = e / t, j = e % t;
    l[(int64_t)i * ldl + j] = S[i * ld + j];
    m[(int64_t)i * ldm + j] = Mi[i * ld + j];
  }
}

extern "C" {

static size_t leaf_smem(int t) {
  return (size_t)(2 * t * (t + 1) + t) * sizeof(float);
}

int gpx_chol_inv_tile(const float* a, int64_t lda, float* l, int64_t ldl,
                      float* m, int64_t ldm, int t, void* stream) {
  if (t < 1 || t > LEAF_MAX) return (int)cudaErrorInvalidValue;
  // opt in once per device to the shared memory of the largest leaf, off
  // the serial chain of leaf launches
  constexpr int MAX_DEVICES = 64;
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(chol_inv_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)leaf_smem(LEAF_MAX));
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const size_t smem = leaf_smem(t);
  chol_inv_tile_kernel<<<1, LEAF_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(a, lda, l, ldl,
                                                              m, ldm, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
