// Probe-estimated logML gradient (the hybrid path) for Hopper (sm_90a),
// 3xTF32 on the tensor cores.
//
// Replaces the TPU kernel gpx/ops/pallas_logml_grad.py::logml_probe_grads
// (_probe_body) with with_correction=True, with and without ard. It is the
// exact gradient kernel (logml_grad.cu) with the N-deep K^-1 product
// replaced by a Hutchinson estimate from an (n, s) probe block Z and its
// solve U = K^-1 Z: for every lower-triangle 64 x 64 tile (i >= j)
//   what = A_i B_j^T * (0.5 / s),  A = [U | Z], B = [Z | U]
// one 2s-deep product (k < s reads U_i and Z_j, k >= s reads Z_i and U_j,
// through the two base pointers; no concatenated copy), then the shared
// epilogue (grad_epilogue.cuh) with `what` in place of the K^-1 tile. The
// symmetric form matters: the epilogue weights only the lower triangle, so
// each off-diagonal entry stands in for its mirror.
//
// Bound on an H100 SXM: operations. The lower triangle's product is
// 3 x 2 N^2 s tensor-core FLOPs in 3xTF32 (0.208 ms at N = 16,384, s = 64
// at 494.7 TFLOP/s dense TF32; 0.417 at s = 128); one exp per SE term per
// lower entry on the SFU and the bytes (U and Z, a few MB, read from L2)
// are below it. Measured, the CUDA cores' issue sets the pace: the
// epilogue's per-entry algebra, and the hi/lo splits and step adds around
// each MMA (PERF.md).
//
// Design:
// - The product runs on the shared 3xTF32 core (mma_tf32.cuh), as the
//   exact kernel's does, at gpx's _dot_bf16x3 precision: hi/lo split in
//   registers, three mma.sync m16n8k8 a step, the slab folds every 64 k,
//   and STEP_ROUND (tr(W_hat) sums mostly positive diagonal terms) but in
//   the ARD instance, where it cost a spill. Both operands are row-major
//   (n, s), K-major, staged as rows of BK + 8 floats. Each product's depth
//   rounds up to whole 32-deep k-tiles, the tail read as zeros; Z is not
//   assumed exact in TF32 (the augmented block carries Q's columns).
// - 64 x 64 block tiles, 8 warps of 32 x 16, a 3-stage cp.async ring, at
//   most 128 registers: two blocks an SM, so one block's epilogue runs
//   beside the other's MMAs (128 x 128 tiles at the 255-register cap held
//   one block an SM, and the epilogue at 8 warps an SM ran slower than the
//   whole SIMT kernel before it).
// - Persistent blocks, as many as the card holds resident, each walking
//   the lower-triangle tiles in a fixed order (blockIdx.x, + gridDim.x,
//   ...). The finished tile is staged in its own shared memory and the
//   next tile's first two k-tiles are issued before the current tile's
//   epilogue runs, so their latency hides under it.
// - The epilogue (a call, not inlined) adds every output's warp sum into a
//   per-warp double in shared memory (WarpSink: no barrier); the block
//   writes one partial row at its end, the warps summed in a fixed order,
//   and reduce_partials_kernel sums the rows in double: deterministic, with
//   no atomics. Each thread's gradient sums and the warp sums are in
//   double: the estimate's noise makes h's terms at the hybrid's bench
//   case add up to ~1e8 times h, and in float32 the kernel missed h by 5x
//   the check's 1e-2 relative limit (PERF.md); the double sums cost a few
//   percent on an H100 and fit the 128 registers. The ARD instance (a
//   template flag, D more sums) keeps its per-entry sums in 16 KB of
//   shared memory after the staged tile.
#include "grad_epilogue.cuh"
#include "grid.cuh"
#include "mma_tf32.cuh"

// the block's shared memory: the ring, then the staged tile, then the ARD
// sums (dynamic), and the term table and per-warp output sums (static),
// at file scope so that the epilogue call reads them without arguments
extern __shared__ __align__(16) float probe_smem[];

namespace {

// 64 x 64 tiles, 8 warps of 32 x 16, a 3-stage ring: two blocks an SM
using T = gpx::tf32::Tile<64, 64, 2, 4, 3>;
constexpr int RING_FLOATS = T::SMEM_BYTES / 4;
constexpr int KTS = T::BN + 16;     // row stride of the staged tile
constexpr int KT_FLOATS = T::BM * KTS;
constexpr int WKP_FLOATS = 16 * T::THREADS;
constexpr int WARPS = T::THREADS / 32;
static_assert(T::THREADS == gpx::THREADS, "the epilogue's thread count");
static_assert(T::BM == gpx::BM && T::BN == gpx::BM, "the epilogue's tile");

__shared__ gpx::TermSmem ts;
__shared__ double wacc[WARPS * gpx::WACC_STRIDE];

template <bool ARD>
constexpr int smem_bytes() {
  return 4 * (RING_FLOATS + KT_FLOATS + (ARD ? WKP_FLOATS : 0));
}

// One tile's epilogue, its estimate read from the staged tile (row stride
// KTS), its outputs added into the per-warp sums. Not inlined: a call
// keeps its registers apart from the k loop's.
template <bool ARD>
__device__ __noinline__ void tile_epilogue(int i0, int j0,
                                           const float* __restrict__ x, int d,
                                           const float* __restrict__ alpha,
                                           int n_terms, int n_params) {
  const float* kq = probe_smem + RING_FLOATS;
  const int tx = gpx::tile_tx(), ty = gpx::tile_ty();
  float what[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) what[r][c] = kq[(ty + 16 * r) * KTS + tx + 16 * c];
  gpx::grad_epilogue<ARD>(what, i0, j0, x, d, alpha, ts, n_terms, n_params,
                          probe_smem + RING_FLOATS + KT_FLOATS,
                          gpx::WarpSink{wacc});
}

template <bool VEC, bool ARD>
__global__ void __launch_bounds__(T::THREADS, 2)
logml_probe_grad_kernel(const float* __restrict__ u, int64_t ldu,
                        const float* __restrict__ z, int64_t ldz, int s,
                        const float* __restrict__ x, int d,
                        const float* __restrict__ alpha, int n,
                        const int* __restrict__ table, int n_terms,
                        const float* __restrict__ params, int n_params,
                        int n_out, float* __restrict__ partials) {
  float* smem = probe_smem;
  for (int e = threadIdx.x; e < WARPS * gpx::WACC_STRIDE; e += T::THREADS)
    wacc[e] = 0.0;
  gpx::load_terms(table, n_terms, params, n_params, ts);  // synchronizes
  float* kt = smem + RING_FLOATS;

  const int nb = n / T::BM;
  const int tiles = nb * (nb + 1) / 2;
  // each product's depth in whole k-tiles: virtual k < kseg is U_i Z_j^T,
  // k >= kseg is Z_i U_j^T
  const int kseg = (s + gpx::tf32::BK - 1) / gpx::tf32::BK * gpx::tf32::BK;
  const float scale = 0.5f / (float)s;
  // the loads of the tile at rows i0, columns j0 (recomputed per tile, so
  // that no tile coordinates stay live across the epilogue call)
  auto loads = [&](int i0, int j0) {
    return [&, i0, j0](int stage, int k0) {
      float* as = smem + stage * T::STAGE_FLOATS;
      float* bs = as + T::A_FLOATS;
      const bool second = k0 >= kseg;
      const int kk = second ? k0 - kseg : k0;
      gpx::tf32::load_kmajor<T, T::BM, VEC>(as, second ? z : u,
                                            second ? ldz : ldu, i0, n, kk, s);
      gpx::tf32::load_kmajor<T, T::BN, VEC>(bs, second ? u : z,
                                            second ? ldu : ldz, j0, n, kk, s);
    };
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / T::WN) * T::MI * 16;  // warp's first row in the tile
  const int wc = (warp % T::WN) * T::NI * 8;   // and first column
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int bi, bj;
    gpx::lower_tile(tile, bi, bj);
    const int i0 = bi * T::BM, j0 = bj * T::BN;
    if (tile == (int)blockIdx.x) gpx::tf32::prime<T>(loads(i0, j0), 0, 2 * kseg);
    float acc[T::MI][T::NI][4], sum[T::MI][T::NI][4];
    // STEP_ROUND but with ARD (whose epilogue call leaves the k loop one
    // register short of the 128 that keeps two blocks an SM: it spilled)
    gpx::tf32::mainloop<T, false, true, !ARD, 3, true>(
        smem, loads(i0, j0), 0, 2 * kseg, wr, wc, acc, sum);
    // every warp is done with the ring and with the last epilogue's reads
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wr + mi * 16 + g + 8 * h, c = wc + ni * 8 + 2 * t;
          kt[r * KTS + c] =
              __fadd_rn(sum[mi][ni][2 * h], acc[mi][ni][2 * h]) * scale;
          kt[r * KTS + c + 1] =
              __fadd_rn(sum[mi][ni][2 * h + 1], acc[mi][ni][2 * h + 1]) *
              scale;
        }
    const int next = tile + gridDim.x;
    if (next < tiles) {  // the next tile's first k-tiles fly under the epilogue
      int ni, nj;
      gpx::lower_tile(next, ni, nj);
      gpx::tf32::prime<T>(loads(ni * T::BM, nj * T::BN), 0, 2 * kseg);
    }
    __syncthreads();
    tile_epilogue<ARD>(i0, j0, x, d, alpha, n_terms, n_params);
  }
  __syncthreads();
  if (threadIdx.x < n_out) {
    double v = 0.0;
    for (int w = 0; w < WARPS; ++w) v += wacc[w * gpx::WACC_STRIDE + threadIdx.x];
    partials[(int64_t)blockIdx.x * n_out + threadIdx.x] = (float)v;
  }
}

// One launch on the persistent grid (grid.cuh); sets the instance's
// shared-memory limit at its first launch
template <bool VEC, bool ARD>
int launch(const float* u, int64_t ldu, const float* z, int64_t ldz, int s,
           const float* x, int d, const float* alpha, int n, const int* table,
           int n_terms, const float* params, int n_params, int n_out,
           float* partials, int* grid, cudaStream_t st) {
  static bool attr = false;
  auto kern = logml_probe_grad_kernel<VEC, ARD>;
  constexpr int bytes = smem_bytes<ARD>();
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int nb = n / T::BM;
  const cudaError_t e =
      gpx::resident_grid(kern, T::THREADS, bytes, nb * (nb + 1) / 2, grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<*grid, T::THREADS, bytes, st>>>(u, ldu, z, ldz, s, x, d, alpha, n,
                                         table, n_terms, params, n_params,
                                         n_out, partials);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n must be a multiple of 64 and s >= 1; u and z are (n, s) row-major with
// leading dimensions ldu, ldz; n_out = n_params + 2 (+ d with ard), at most
// 128; partials holds (n/64)(n/64 + 1)/2 x n_out floats (a row per block
// of the persistent grid, at most one block a tile), out n_out: the
// gradients in params order, tr(W_hat K) and tr(W_hat) of the estimate,
// then with ard sdot.
int gpx_logml_probe_grad(const float* u, int64_t ldu, const float* z,
                         int64_t ldz, int s, const float* x, int d,
                         const float* alpha, int n, const int* table,
                         int n_terms, const float* params, int n_params,
                         int ard, float* partials, float* out, void* stream) {
  const int n_out = n_params + 2 + (ard ? d : 0);
  if (n % T::BM || s < 1 || n_terms < 1 || n_terms > GPX_MAX_TERMS ||
      n_params > GPX_TERM_PARAMS * GPX_MAX_TERMS || n_out > gpx::WACC_STRIDE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = gpx::tf32::aligned(u, ldu) && gpx::tf32::aligned(z, ldz);
  auto go = vec ? (ard ? &launch<true, true> : &launch<true, false>)
                : (ard ? &launch<false, true> : &launch<false, false>);
  int grid = 0;
  const int err = go(u, ldu, z, ldz, s, x, d, alpha, n, table, n_terms,
                     params, n_params, n_out, partials, &grid, st);
  if (err != cudaSuccess) return err;
  gpx::reduce_partials_kernel<<<n_out, 256, 0, st>>>(partials, grid, n_out,
                                                     out);
  return (int)cudaGetLastError();
}

}  // extern "C"
