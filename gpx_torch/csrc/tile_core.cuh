// The 64 x 64 tile of the logML gradients' epilogue (grad_epilogue.cuh):
// its block of 256 threads in a 4 x 4 register layout, and lower_tile,
// the tile order of a lower triangle (trmm.cu, logml_grad.cu,
// logml_probe_grad.cu). The products themselves run on the 3xTF32
// tensor-core core (mma_tf32.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpx {

constexpr int BM = 64;
constexpr int THREADS = 256;

// thread (tx, ty) owns rows ty + 16 r and columns tx + 16 c, r, c < 4
__device__ __forceinline__ int tile_tx() { return threadIdx.x % 16; }
__device__ __forceinline__ int tile_ty() { return threadIdx.x / 16; }

// (i, j) of the t-th lower-triangle tile, i >= j, in row order
__device__ __forceinline__ void lower_tile(int t, int& i, int& j) {
  i = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  j = t - i * (i + 1) / 2;
}

}  // namespace gpx
