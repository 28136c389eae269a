// Fused logML gradient for Hopper (sm_90a), 3xTF32 on the tensor cores.
//
// Replaces the TPU kernel gpx/ops/pallas_logml_grad.py::logml_kernel_grads
// (_body) with with_correction=True, with and without ard. For every
// lower-triangle
// 128 x 128 tile (i >= j) of W = 0.5 (alpha alpha^T - K^-1):
//   K^-1 tile = sum_{k >= i} Li[k, i-tile]^T Li[k, j-tile]   (N^3/6 MACs)
// then, for each of its 64 x 64 quadrants on or below the diagonal and
// inside n, the shared epilogue (grad_epilogue.cuh): W, its contraction
// with dK/dtheta of every term-table hyperparameter (terms.cuh: explicit
// device functions, no autodiff), the logdet-correction traces
// tr(W_hat K) and tr(W_hat), and with ard the per-dimension sums sdot.
//
// The TPU grid ran in order and added into SMEM scalars across steps. A
// CUDA grid runs in parallel, so each quadrant writes one partial per
// output into a (64-wide tiles, n_out) buffer and a second kernel sums the
// partials of each output in a fixed order, in double: the result is
// deterministic, with no atomics.
//
// Bound on an H100 SXM: operations. At N = 16,384 the K^-1 tiles are
// N^3 / 3 useful FLOPs: in 3xTF32, N^3 tensor-core FLOPs at 494.7 TFLOP/s
// dense TF32 take 8.89 ms; as FP32 FMAs on the CUDA cores (67 TFLOP/s)
// 21.88 ms. The epilogue is O(N^2).
//
// Design:
// - The products run on the shared 3xTF32 core (mma_tf32.cuh), as trmm's
//   do: hi/lo split in registers, three mma.sync m16n8k8 per product, the
//   truncating accumulator folded every 64 k into a float-float sum by an
//   exact TwoSum. The K^-1 entry handed to the epilogue is that sum
//   rounded once. Unlike trmm, each 8-deep step's MMAs start from zero and
//   a rounded add takes them into the accumulator (STEP_ROUND): tr(K^-1)
//   sums positive terms only, and the accumulator's truncation bias (~4
//   f32 ulps of each 64-deep slab) would put it at the edge of its 4-ulp
//   check.
// - Both operands are columns of L^-1 read in place: opA(i, k) = Li[k, i]
//   is M-major and opB(k, j) = Li[k, j] N-major, so both stage as rows of
//   BN + 4 floats along k and every fragment read is free of bank
//   conflicts; no transposed copy of L^-1 is made.
// - 128 x 128 block tiles (8 warps of 64 x 32) under a 4-stage cp.async
//   ring; only the k >= i range of each tile is read (L^-1 is lower
//   triangular). The grid runs the tile rows in order, so the longest
//   k-ranges start first. Where n = 64 (mod 128) the last tile row's lower
//   half lies past n: its loads read zeros and its quadrants are skipped.
// - The finished tile is staged through the ring's shared memory, and each
//   64 x 64 quadrant's epilogue (a call, not inlined) reads it in its 4 x 4
//   thread layout, so logml_probe_grad.cu's epilogue and the partials
//   buffer are shared; neither K^-1 nor W reaches device memory. With ard
//   (a template flag) the epilogue adds the D sums sdot.
// - The k loop runs at the 255-register cap: no instance spills (-Xptxas
//   -v), which the non-inlined epilogue and the tiles' own base pointers
//   keep so. The term table follows the ring in dynamic shared memory,
//   sized from the tree at launch (at most 4.5 KB), and the epilogue call
//   finds it there without an argument.
// - fast (gpx's logml_kernel_grads(fast=True), _dot_bf16x2 on li_j): the
//   second operand Li[k, j-tile] is rounded to TF32 and the first kept
//   whole, two MMAs a step instead of three (mma_tf32.cuh, PASSES = 2), a
//   template flag beside VEC and ARD; 2^-11 relative per product.
#include "grad_epilogue.cuh"
#include "mma_tf32.cuh"

// the block's dynamic shared memory: the ring, then the term table
extern __shared__ __align__(16) float grad_smem[];

namespace {

using T = gpx::tf32::Big;
constexpr int QUAD = gpx::BM;       // the epilogue's 64 x 64 tile
constexpr int KTS = T::BN + 16;     // row stride of the staged K^-1 tile
static_assert(T::THREADS == gpx::THREADS, "the epilogue's thread count");
static_assert(T::BM == 2 * QUAD && T::BN == 2 * QUAD, "2 x 2 quadrants");
static_assert(T::BM * KTS * 4 <= T::SMEM_BYTES, "the staged tile");
// the ARD sums' scratch follows the staged tile in the ring
constexpr int WKP_OFF = T::BM * KTS;
static_assert((WKP_OFF + 16 * T::THREADS) * 4 <= T::SMEM_BYTES, "ARD sums");
// the term table follows the ring (terms.cuh), sized at launch; at most
// 128 outputs, so at most 126 hyperparameters
constexpr int TABLE_MAX_BYTES = gpx::term_smem_bytes(GPX_MAX_TERMS, 128);

__device__ __forceinline__ gpx::TermSmem staged_terms() {
  return gpx::TermSmem{
      reinterpret_cast<const int4*>(grad_smem + T::SMEM_BYTES / 4)};
}

// One 64 x 64 quadrant's epilogue, its K^-1 tile read from the staged
// tile `kq` (row stride KTS). Not inlined: the mainloop runs at the
// 255-register cap, and an inlined epilogue changes how ptxas allocates it
// (a spill inside the k loop); as a call, its registers are its own.
template <bool ARD>
__device__ __noinline__ void quadrant_epilogue(
    const float* kq, int i0, int j0, const float* __restrict__ x, int d,
    const float* __restrict__ alpha, int n_terms, int n_params, float* red,
    float* wkp, float* __restrict__ part) {
  const int tx = gpx::tile_tx(), ty = gpx::tile_ty();
  float kinv[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) kinv[r][c] = kq[(ty + 16 * r) * KTS + tx + 16 * c];
  // the sink adds into the partials (a repeated leaf sends an output once
  // per product); only thread 0 reads or writes them
  if (threadIdx.x == 0)
    for (int o = 0; o < n_params + 2 + (ARD ? d : 0); ++o) part[o] = 0.0f;
  gpx::grad_epilogue<ARD>(kinv, i0, j0, x, d, alpha, staged_terms(), n_terms,
                          n_params, wkp, gpx::BlockSink{red, part});
}

template <bool VEC, bool ARD, int PASSES>
__global__ void __launch_bounds__(T::THREADS, 1)
logml_grad_kernel(const float* __restrict__ li, int64_t ldli,
                  const float* __restrict__ x, int d,
                  const float* __restrict__ alpha, int n,
                  const int* __restrict__ table, int n_terms,
                  const float* __restrict__ params, int n_params, int n_out,
                  float* __restrict__ partials) {
  float* smem = grad_smem;
  __shared__ float red[T::THREADS / 32];
  gpx::load_terms(table, n_terms, params, n_params,
                  reinterpret_cast<int4*>(smem + T::SMEM_BYTES / 4));

  int bi, bj;
  gpx::lower_tile(blockIdx.x, bi, bj);
  const int i0 = bi * T::BM, j0 = bj * T::BN;
  // the tiles' columns from their own base pointers (one register fewer in
  // the k loop than li with i0 and j0: at the cap, that decides a spill)
  const float* li_i = li + i0;
  const float* li_j = li + j0;
  auto load = [&](int stage, int k0) {
    float* as = smem + stage * T::STAGE_FLOATS;
    float* bs = as + T::A_FLOATS;
    gpx::tf32::load_nmajor<T, VEC>(as, li_i, ldli, k0, n, 0, n - i0);
    gpx::tf32::load_nmajor<T, VEC>(bs, li_j, ldli, k0, n, 0, n - j0);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / T::WN) * T::MI * 16;  // warp's first row in the tile
  const int wc = (warp % T::WN) * T::NI * 8;   // and first column
  float acc[T::MI][T::NI][4], sum[T::MI][T::NI][4];
  gpx::tf32::mainloop<T, true, false, true, PASSES>(smem, load, i0, n, wr,
                                                    wc, acc, sum);

  // every warp is done with the ring: stage the K^-1 tile in it
  __syncthreads();
  float* kt = smem;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + mi * 16 + g + 8 * h, c = wc + ni * 8 + 2 * t;
        kt[r * KTS + c] = __fadd_rn(sum[mi][ni][2 * h], acc[mi][ni][2 * h]);
        kt[r * KTS + c + 1] =
            __fadd_rn(sum[mi][ni][2 * h + 1], acc[mi][ni][2 * h + 1]);
      }
  __syncthreads();

  // the quadrants on or below the diagonal and inside n, each with its own
  // row of partials (the 64-wide tile order of lower_tile)
  const int nq = n / QUAD;
  for (int qi = 0; qi < 2; ++qi) {
    const int qr = 2 * bi + qi;
    if (qr >= nq) break;
    for (int qj = 0; qj < 2; ++qj) {
      const int qc = 2 * bj + qj;
      if (qc > qr) break;
      const int64_t tile = (int64_t)qr * (qr + 1) / 2 + qc;
      quadrant_epilogue<ARD>(kt + qi * QUAD * KTS + qj * QUAD, qr * QUAD,
                             qc * QUAD, x, d, alpha, n_terms, n_params, red,
                             smem + WKP_OFF, partials + tile * n_out);
    }
  }
}

template <bool VEC, bool ARD, int PASSES>
int launch(const float* li, int64_t ldli, const float* x, int d,
           const float* alpha, int n, const int* table, int n_terms,
           const float* params, int n_params, int n_out, float* partials,
           cudaStream_t s) {
  static bool attr = false;
  auto kern = logml_grad_kernel<VEC, ARD, PASSES>;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM_BYTES + TABLE_MAX_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int nb = (n + T::BM - 1) / T::BM;
  const int bytes = T::SMEM_BYTES + gpx::term_smem_bytes(n_terms, n_params);
  kern<<<nb * (nb + 1) / 2, T::THREADS, bytes, s>>>(
      li, ldli, x, d, alpha, n, table, n_terms, params, n_params, n_out,
      partials);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n must be a multiple of 64; n_out = n_params + 2 (+ d with ard), at most
// 128; partials holds (n/64)(n/64 + 1)/2 x n_out floats, out n_out: the
// gradients in params order, tr(W_hat K), tr(W_hat), then with ard sdot.
// fast != 0 rounds the second operand of each K^-1 product to TF32.
int gpx_logml_grad(const float* li, int64_t ldli, const float* x, int d,
                   const float* alpha, int n, const int* table, int n_terms,
                   const float* params, int n_params, int ard, int fast,
                   float* partials, float* out, void* stream) {
  const int n_out = n_params + 2 + (ard ? d : 0);
  if (n % QUAD || n_terms < 1 || n_terms > GPX_MAX_TERMS ||
      n_params > GPX_TERM_PARAMS * GPX_MAX_TERMS || n_out > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = gpx::tf32::aligned(li, ldli);
  decltype(&launch<true, true, 3>) go;
  if (fast)
    go = vec ? (ard ? &launch<true, true, 2> : &launch<true, false, 2>)
             : (ard ? &launch<false, true, 2> : &launch<false, false, 2>);
  else
    go = vec ? (ard ? &launch<true, true, 3> : &launch<true, false, 3>)
             : (ard ? &launch<false, true, 3> : &launch<false, false, 3>);
  const int err = go(li, ldli, x, d, alpha, n, table, n_terms, params,
                     n_params, n_out, partials, s);
  if (err != cudaSuccess) return err;
  const int nq = n / QUAD;
  gpx::reduce_partials_kernel<<<n_out, 256, 0, s>>>(
      partials, nq * (nq + 1) / 2, n_out, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
