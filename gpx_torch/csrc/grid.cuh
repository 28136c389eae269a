// The persistent grids of gram.cu and logml_probe_grad.cu: as many blocks
// as the card holds resident, each walking its share of the tiles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpx {

// *grid = the blocks of `kern` (`threads` a block, `smem` dynamic shared
// bytes) that the card holds resident, at most `tiles`, at least 1
template <class Kernel>
inline cudaError_t resident_grid(Kernel kern, int threads, int smem,
                                 int64_t tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  const int64_t resident = (int64_t)sms * per_sm;
  *grid = (int)(resident < 1 ? 1 : (resident < tiles ? resident : tiles));
  return cudaSuccess;
}

}  // namespace gpx
