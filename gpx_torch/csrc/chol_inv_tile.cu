// chol_inv_tile for Hopper (sm_90a): (L, L^-1) of one SPD leaf tile.
//
// Replaces the TPU kernel gpx/ops/pallas_chol.py::chol_inv_tile
// (_chol_inv_value / _chol_base / _tri_inv_base), which factors a 2048^2
// tile in one program under a 100 MiB VMEM limit. A Hopper block has at
// most 227 KB of shared memory, so here the torch recursion
// (gpx_torch/ops/cuda_chol.py::chol_inv) goes on down to a leaf of at most
// 128 x 128, and one CTA factors and inverts it with the tile and its
// inverse resident in dynamic shared memory (2 x 128 x 132 floats, 132 KB).
//
// Bound: latency. The leaf is 2 t^3 / 3 FLOPs (1.4 MFLOP at t = 128: 0.0028
// ms at one SM's share of the FP32 peak), and the leaves of chol_inv are
// serial along the diagonal, each factoring a Schur complement that
// depends on every earlier one; what counts is the length of the leaf's
// dependent chain and its barriers.
//
// Design: the tile is padded to a multiple of 32 with the identity (exact:
// the pad's factor and inverse are the identity and add exact zeros to
// every real entry) and factored in 32-wide panels, the leaf-level form of
// the JAX recursion (_chol_inv_value):
// - each diagonal block is factored by one warp in registers (lane i holds
//   row i; the pivot column is broadcast by shuffles, no block barrier;
//   rsqrt pivots refined by one Newton step)
//   and inverted by the same warp (lane j forms column j of the inverse by
//   substitution, 496 FMAs a lane where nilpotent doubling's four
//   squarings and products would take 8 x 32^3 / 32 = 8,192);
// - the panel below it is L_rp = A_rp M_pp^T and the trailing update
//   A_rq -= L_rp L_qp^T, each 32 x 32 block product taken by 64 threads
//   with a 4 x 4 register micro-tile, all blocks of a step at once;
// - the inverse's off-diagonal blocks follow by block rows as products,
//   M_pq = -M_pp (sum_{r = q}^{p - 1} L_pr M_rq), all q < p at once.
// A t = 128 leaf takes 4 warp factorizations and some 20 block-wide
// barriers, where the unblocked kernel before it took 256 barriers and a
// 128-step serial substitution per column. Only the lower triangle of the
// input is read; both outputs hold exact zeros above the diagonal. The
// input may alias the L output: the whole tile is in shared memory before
// any write. Deterministic: a repeated call, or the same tile at another
// address or leading dimension, gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LEAF_THREADS = 512;
constexpr int LEAF_MAX = 128;
constexpr int PB = 32;                        // panel width: one warp's block
constexpr int GROUP = 64;                     // threads of one block product
constexpr int GROUPS = LEAF_THREADS / GROUP;  // block products at once
constexpr int WARPS = LEAF_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(GROUPS >= (LEAF_MAX / PB) * (LEAF_MAX / PB - 1) / 2,
              "one group for each block of the largest trailing update");

// the tile padded to whole panels, and its row stride in shared memory:
// 4 (mod 32) floats, so that every block product's reads are free of bank
// conflicts and rows stay 16-byte aligned
__host__ __device__ inline int padded(int t) { return (t + PB - 1) / PB * PB; }
__host__ __device__ inline int stride(int tp) { return tp + 4; }

// Factor the 32 x 32 diagonal block at (c0, c0) of S in place (its lower
// triangle; zeros above) and write its inverse into the same block of M.
// One warp. The pivots' reciprocal roots pass from the factor to the
// inverse through S's first padding column (ld - 4), one in each row, and
// not in 32 more registers a lane, where the kernel spilled.
__device__ __forceinline__ void factor_block(float* S, float* M, int ld,
                                             int c0) {
  const int lane = threadIdx.x & 31;
  float* row = S + (c0 + lane) * ld + c0;
  float* rcp = S + ld - 4;
  float a[PB];
#pragma unroll
  for (int j = 0; j < PB; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + j);
    a[j] = j <= lane ? v.x : 0.0f;
    a[j + 1] = j + 1 <= lane ? v.y : 0.0f;
    a[j + 2] = j + 2 <= lane ? v.z : 0.0f;
    a[j + 3] = j + 3 <= lane ? v.w : 0.0f;
  }
  // right-looking, one column per step, lane i updating its row i; the
  // pivot column is scaled by rsqrt(pivot), as _chol_base scales it.
  // rsqrtf's approximation (2 ulps) takes one Newton step, and the pivot's
  // root d y one correction by its residual: each within about an ulp, as
  // IEEE sqrt and division would give, without the division's latency
#pragma unroll
  for (int k = 0; k < PB; ++k) {
    const float d = __shfl_sync(FULL, a[k], k);
    float y = rsqrtf(d);
    y = fmaf(fmaf(-0.5f * d * y, y, 0.5f), y, y);
    const float s = d * y;
    rcp[(c0 + k) * ld] = y;
    a[k] = lane == k ? fmaf(fmaf(-s, s, d), 0.5f * y, s) : a[k] * y;
#pragma unroll
    for (int j = k + 1; j < PB; ++j)
      a[j] = fmaf(-a[k], __shfl_sync(FULL, a[k], j), a[j]);
  }
#pragma unroll
  for (int j = 0; j < PB; ++j) row[j] = j <= lane ? a[j] : 0.0f;
  __syncwarp();

  // lane j forms column j of the inverse by right-looking substitution:
  // m_i = s_i / L_ii, then s_r -= L_ri m_i for r > i, with column i of L
  // read from S by every lane at once
  float s[PB], dinv[PB];
#pragma unroll
  for (int r = 0; r < PB; ++r) {
    s[r] = r == lane ? 1.0f : 0.0f;
    dinv[r] = rcp[(c0 + r) * ld];
  }
#pragma unroll
  for (int i = 0; i < PB; ++i) {
    s[i] *= dinv[i];
#pragma unroll
    for (int r = i + 1; r < PB; ++r)
      s[r] = fmaf(-S[(c0 + r) * ld + c0 + i], s[i], s[r]);
  }
#pragma unroll
  for (int i = 0; i < PB; ++i) M[(c0 + i) * ld + c0 + lane] = s[i];
}

// acc += A B^T (B_T) or A B over 32 k, A and B pointing at 32 x 32 blocks
// of row stride ld; thread u (0 .. 63) owns rows u / 8 + 8 r and columns
// u % 8 + 8 c, r, c < 4
template <bool B_T>
__device__ __forceinline__ void mac(float (&acc)[4][4], const float* A,
                                    const float* B, int ld, int u) {
  const int ri = u >> 3, ci = u & 7;
#pragma unroll 8
  for (int k = 0; k < PB; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[(ri + 8 * r) * ld + k];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = B_T ? B[(ci + 8 * c) * ld + k] : B[k * ld + ci + 8 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// C = s acc, or C -= acc (SUB), on thread u's micro-tile
template <bool SUB>
__device__ __forceinline__ void put(const float (&acc)[4][4], float* C,
                                    int ld, int u, float s) {
  const int ri = u >> 3, ci = u & 7;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float& e = C[(ri + 8 * r) * ld + ci + 8 * c];
      e = SUB ? e - acc[r][c] : s * acc[r][c];
    }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
}

__global__ void __launch_bounds__(LEAF_THREADS)
chol_inv_tile_kernel(const float* a, int64_t lda, float* l, int64_t ldl,
                     float* m, int64_t ldm, int t) {
  extern __shared__ __align__(16) float smem[];
  const int tp = padded(t), ld = stride(tp), nb = tp / PB;
  float* S = smem;            // tp x ld: the tile, then L
  float* M = smem + tp * ld;  // tp x ld: L^-1
  const int tid = threadIdx.x, grp = tid / GROUP, u = tid % GROUP;
  auto blk = [ld](float* X, int r, int c) { return X + r * PB * ld + c * PB; };

  // the lower triangle of the tile, padded with the identity: warp w takes
  // rows w + WARPS r, lane l columns l + 32 c, every load in flight at once
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < LEAF_MAX / WARPS; ++r)
#pragma unroll
    for (int c = 0; c < LEAF_MAX / PB; ++c) {
      const int i = warp + WARPS * r, j = lane + PB * c;
      if (i >= tp || j >= tp) continue;
      float v = 0.0f;
      if (j <= i) v = i < t ? a[(int64_t)i * lda + j] : (i == j ? 1.0f : 0.0f);
      S[i * ld + j] = v;
    }
  __syncthreads();

  float acc[4][4];
  for (int p = 0; p < nb; ++p) {
    if (tid < 32) factor_block(S, M, ld, p * PB);
    __syncthreads();
    const int rest = nb - 1 - p;  // block rows below the panel
    if (rest == 0) break;
    // the panel: L_rp = A_rp M_pp^T, formed before any is written back
    zero(acc);
    if (grp < rest) mac<true>(acc, blk(S, p + 1 + grp, p), blk(M, p, p), ld, u);
    __syncthreads();
    if (grp < rest) put<false>(acc, blk(S, p + 1 + grp, p), ld, u, 1.0f);
    __syncthreads();
    // the trailing update A_rq -= L_rp L_qp^T, p < q <= r
    if (grp < rest * (rest + 1) / 2) {
      int r = 0;
      while ((r + 1) * (r + 2) / 2 <= grp) ++r;
      const int q = grp - r * (r + 1) / 2;
      zero(acc);
      mac<true>(acc, blk(S, p + 1 + r, p), blk(S, p + 1 + q, p), ld, u);
      put<true>(acc, blk(S, p + 1 + r, p + 1 + q), ld, u, 1.0f);
    }
    __syncthreads();
  }

  // the inverse's off-diagonal blocks by block rows:
  // X_pq = sum_{r = q}^{p - 1} L_pr M_rq into M_pq, then M_pq = -M_pp X_pq
  for (int p = 1; p < nb; ++p) {
    const int q = grp;
    zero(acc);
    if (q < p) {
      for (int r = q; r < p; ++r)
        mac<false>(acc, blk(S, p, r), blk(M, r, q), ld, u);
      put<false>(acc, blk(M, p, q), ld, u, 1.0f);
    }
    __syncthreads();
    zero(acc);
    if (q < p) mac<false>(acc, blk(M, p, p), blk(M, p, q), ld, u);
    __syncthreads();
    if (q < p) put<false>(acc, blk(M, p, q), ld, u, -1.0f);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < LEAF_MAX / WARPS; ++r)
#pragma unroll
    for (int c = 0; c < LEAF_MAX / PB; ++c) {
      const int i = warp + WARPS * r, j = lane + PB * c;
      if (i >= t || j >= t) continue;
      const bool low = j <= i;
      l[(int64_t)i * ldl + j] = low ? S[i * ld + j] : 0.0f;
      m[(int64_t)i * ldm + j] = low ? M[i * ld + j] : 0.0f;
    }
}

size_t leaf_smem(int t) {
  const int tp = padded(t);
  return (size_t)2 * tp * stride(tp) * sizeof(float);
}

}  // namespace

extern "C" {

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
  chol_inv_tile_kernel<<<1, LEAF_THREADS, leaf_smem(t),
                         static_cast<cudaStream_t>(stream)>>>(a, lda, l, ldl,
                                                              m, ldm, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
