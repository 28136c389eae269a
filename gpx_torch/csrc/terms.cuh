// The term table: a covariance kernel as the CUDA kernels read it.
//
// The kernel is expanded into a sum of products of leaves (gpx_torch/ops/
// terms.py: every Product distributed over its Sums). `table` holds (type,
// offset, aux, group) per factor and `params` the hyperparameters in
// gpx_torch.params.leaves order, unexpanded; a factor's parameters start at
// its offset (a leaf in several products repeats it), `aux` is Matern's p
// for nu = p + 1/2, and factors with one group index are the factors of one
// product (contiguous). The kernel is sum_g prod_{t in g} k_t(r2).
// gpx_torch/ops/terms.py builds both arrays and holds term_values /
// term_derivatives / term_dr2, the plain versions of value and grads below.
//
// Each family is a struct of two device functions: `value` (k(r2)) and
// `grads` (k, dk/dtheta for up to three parameters, and dk/dr2, which the
// ARD leg reads). Hot loops call with_family once per term with a functor
// that loops over their entries, so the family switch stays out of the
// per-entry loop. Families that take d = sqrt(r2) pin dk/dr2 to 0 at
// r2 == 0, as the JAX package's safe distance does; White's r2 == 0 test
// is exact.
#pragma once

#include <cuda_runtime.h>

#define GPX_MAX_TERMS 8
#define GPX_TERM_PARAMS 3  // hyperparameters of a term, at most
#define GPX_TABLE_COLS 4   // (type, offset, aux, group)

namespace gpx {

enum TermType {
  TERM_SE = 0,
  TERM_WHITE = 1,
  TERM_MATERN = 2,
  TERM_RQ = 3,
  TERM_PERIODIC = 4
};

struct TermSmem {
  int type[GPX_MAX_TERMS];
  int off[GPX_MAX_TERMS];
  int aux[GPX_MAX_TERMS];
  int first[GPX_MAX_TERMS];  // the first term of t's product
  int end[GPX_MAX_TERMS];    // one past its last
  float par[GPX_TERM_PARAMS * GPX_MAX_TERMS];
};

// Stage the table in shared memory; every thread must call it.
__device__ __forceinline__ void load_terms(const int* table, int n_terms,
                                           const float* params, int n_params,
                                           TermSmem& ts) {
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  if (tid < n_terms) {
    const int* row = table + GPX_TABLE_COLS * tid;
    const int g = row[3];
    int a = tid, b = tid + 1;
    while (a > 0 && table[GPX_TABLE_COLS * (a - 1) + 3] == g) --a;
    while (b < n_terms && table[GPX_TABLE_COLS * b + 3] == g) ++b;
    ts.type[tid] = row[0];
    ts.off[tid] = row[1];
    ts.aux[tid] = row[2];
    ts.first[tid] = a;
    ts.end[tid] = b;
  }
  if (tid < n_params) ts.par[tid] = params[tid];
  __syncthreads();
}

// SE (h, s): h exp(-r2 / s^2)
struct SE {
  static __device__ __forceinline__ float value(const float* p, int,
                                                float r2) {
    return p[0] * expf(-r2 / (p[1] * p[1]));
  }
  static __device__ __forceinline__ void grads(const float* p, int, float r2,
                                               float& v, float (&g)[3],
                                               float& kp) {
    const float s = p[1];
    const float e = expf(-r2 / (s * s));
    v = p[0] * e;
    g[0] = e;
    g[1] = p[0] * e * 2.0f * r2 / (s * s * s);
    g[2] = 0.0f;
    kp = -v / (s * s);
  }
};

// White (s): s [r2 == 0]
struct White {
  static __device__ __forceinline__ float value(const float* p, int,
                                                float r2) {
    return r2 == 0.0f ? p[0] : 0.0f;
  }
  static __device__ __forceinline__ void grads(const float* p, int, float r2,
                                               float& v, float (&g)[3],
                                               float& kp) {
    v = r2 == 0.0f ? p[0] : 0.0f;
    g[0] = r2 == 0.0f ? 1.0f : 0.0f;
    g[1] = g[2] = kp = 0.0f;
  }
};

// Matern (sigma, l), nu = p + 1/2: sigma P_p(s) e^-s, s = sqrt(2p + 1) d / l,
// with P_0 = 1, P_1 = 1 + s, P_k = P_{k-1} + s^2 P_{k-2} / ((2k-1)(2k-3)):
// every term positive, so no cancellation at any s. dk/ds = -s / (2p - 1)
// sigma P_{p-1}(s) e^-s (p >= 1) gives dk/dl and dk/dr2 without a
// difference of polynomials; for p = 0, dk/dr2 = -sigma e^-s / (2 l d).
struct Matern {
  static __device__ __forceinline__ void polys(int p, float s, float& pm1,
                                               float& pp) {
    float a = 1.0f, b = 1.0f + s;
    const float s2 = s * s;
    for (int k = 2; k <= p; ++k) {
      const float c = __frcp_rn((float)((2 * k - 1) * (2 * k - 3)));
      const float nb = fmaf(s2 * c, a, b);
      a = b;
      b = nb;
    }
    pm1 = a;
    pp = p == 0 ? 1.0f : b;
  }
  static __device__ __forceinline__ float value(const float* p, int aux,
                                                float r2) {
    const float s = sqrtf((float)(2 * aux + 1)) * sqrtf(r2) / p[1];
    float pm1, pp;
    polys(aux, s, pm1, pp);
    return p[0] * pp * expf(-s);
  }
  static __device__ __forceinline__ void grads(const float* p, int aux,
                                               float r2, float& v,
                                               float (&g)[3], float& kp) {
    const float c = sqrtf((float)(2 * aux + 1)), l = p[1], d = sqrtf(r2);
    const float s = c * d / l;
    const float e = expf(-s);
    float pm1, pp;
    polys(aux, s, pm1, pp);
    v = p[0] * pp * e;
    g[0] = pp * e;
    g[2] = 0.0f;
    if (aux == 0) {
      g[1] = p[0] * s * e / l;
      kp = r2 > 0.0f ? -p[0] * e / (2.0f * l * d) : 0.0f;
    } else {
      const float q = p[0] * pm1 * e / (float)(2 * aux - 1);
      g[1] = q * s * s / l;
      kp = r2 > 0.0f ? -q * (c * c) / (2.0f * l * l) : 0.0f;
    }
  }
};

// RationalQuadratic (h, alpha, l): h (1 + z)^-alpha, z = r2 / (2 alpha l^2),
// as exp(-alpha log1p(z)). dk/dalpha = k (z / (1 + z) - log1p(z)) cancels to
// ~ -z^2 / 2 at small z, so the difference is taken in double.
struct RQ {
  static __device__ __forceinline__ float value(const float* p, int,
                                                float r2) {
    const float z = r2 / (2.0f * p[1] * p[2] * p[2]);
    return p[0] * expf(-p[1] * log1pf(z));
  }
  static __device__ __forceinline__ void grads(const float* p, int, float r2,
                                               float& v, float (&g)[3],
                                               float& kp) {
    const float a = p[1], l = p[2];
    const float z = r2 / (2.0f * a * l * l);
    const float q = 1.0f + z;
    const float e = expf(-a * log1pf(z));
    const double zd = (double)z;
    v = p[0] * e;
    g[0] = e;
    g[1] = v * (float)(zd / (1.0 + zd) - log1p(zd));
    g[2] = v * 2.0f * a * z / (l * q);
    kp = -v / (2.0f * l * l * q);
  }
};

// Periodic (h, period, l): h exp(-2 sin^2(pi d / period) / l^2), with
// sinpif / cospif reducing d / period exactly in f32
struct Periodic {
  static __device__ __forceinline__ float value(const float* p, int,
                                                float r2) {
    const float sn = sinpif(sqrtf(r2) / p[1]);
    return p[0] * expf(-2.0f * (sn * sn) / (p[2] * p[2]));
  }
  static __device__ __forceinline__ void grads(const float* p, int, float r2,
                                               float& v, float (&g)[3],
                                               float& kp) {
    const float per = p[1], l = p[2], d = sqrtf(r2);
    const float x = d / per;
    const float sn = sinpif(x), cs = cospif(x);
    const float e = expf(-2.0f * (sn * sn) / (l * l));
    const float pi = 3.14159265358979f;
    v = p[0] * e;
    g[0] = e;
    g[1] = v * 4.0f * pi * sn * cs * x / (l * l * per);
    g[2] = v * 4.0f * (sn * sn) / (l * l * l);
    kp = r2 > 0.0f ? -v * 2.0f * pi * sn * cs / (l * l * per * d) : 0.0f;
  }
};

// f(Family()) for the family of `type`: one switch, outside f's loops. `f`
// is a functor whose templated operator() is __forceinline__ (a lambda's
// may not inline, and its captured register arrays then go to the stack).
template <class F>
__device__ __forceinline__ void with_family(int type, const F& f) {
  switch (type) {
    case TERM_SE: f(SE()); break;
    case TERM_WHITE: f(White()); break;
    case TERM_MATERN: f(Matern()); break;
    case TERM_RQ: f(RQ()); break;
    default: f(Periodic()); break;
  }
}

// k(r2) of one term, the switch per call (for rolled per-entry loops)
__device__ __forceinline__ float term_value(int type, const float* p, int aux,
                                            float r2) {
  switch (type) {
    case TERM_SE: return SE::value(p, aux, r2);
    case TERM_WHITE: return White::value(p, aux, r2);
    case TERM_MATERN: return Matern::value(p, aux, r2);
    case TERM_RQ: return RQ::value(p, aux, r2);
    default: return Periodic::value(p, aux, r2);
  }
}

__device__ __forceinline__ int term_arity(int type) {
  return type == TERM_WHITE ? 1
         : (type == TERM_SE || type == TERM_MATERN) ? 2 : 3;
}

// A lone term's values over N entries, added into `out`
template <int N>
struct LoneValues {
  const float* p;
  int aux;
  const float (&r2)[N];
  float (&out)[N];
  template <class Fam>
  __device__ __forceinline__ void operator()(Fam) const {
#pragma unroll
    for (int c = 0; c < N; ++c) out[c] += Fam::value(p, aux, r2[c]);
  }
};

// A product's factor over N entries, into the running product `pr` (set
// by the first factor)
template <int N>
struct FactorValues {
  const float* p;
  int aux;
  bool first;
  const float (&r2)[N];
  float (&pr)[N];
  template <class Fam>
  __device__ __forceinline__ void operator()(Fam) const {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float v = Fam::value(p, aux, r2[c]);
      pr[c] = first ? v : pr[c] * v;
    }
  }
};

// out[c] += K(r2[c]) = sum_g prod_{t in g} k_t(r2[c]), c < N. A product is
// formed left to right, as the JAX package's Product forms it, at its
// first factor. Without STAGED, in N more registers (the Gram's 16
// entries a thread); STAGED (`stage`: 2 N floats of shared memory a
// thread, at stride `stride`), the entries pass through shared memory one
// at a time, so that a wide thread (matvec's 32 entries) holds no more
// registers for a product than for a lone term.
template <int N, bool STAGED = false>
__device__ __forceinline__ void kernel_values(const TermSmem& ts, int n_terms,
                                              const float (&r2)[N],
                                              float (&out)[N],
                                              float* stage = nullptr,
                                              int stride = 0) {
  for (int t = 0; t < n_terms; ++t) {
    const int end = ts.end[t];
    if (ts.first[t] != t) continue;
    if (end == t + 1) {
      with_family(ts.type[t],
                  LoneValues<N>{&ts.par[ts.off[t]], ts.aux[t], r2, out});
    } else if constexpr (!STAGED) {
      float pr[N];
      for (int u = t; u < end; ++u)
        with_family(ts.type[u], FactorValues<N>{&ts.par[ts.off[u]], ts.aux[u],
                                                u == t, r2, pr});
#pragma unroll
      for (int c = 0; c < N; ++c) out[c] += pr[c];
    } else {
      float* q = stage;
      float* prod = stage + N * stride;
#pragma unroll
      for (int c = 0; c < N; ++c) q[c * stride] = r2[c];
#pragma unroll 1
      for (int c = 0; c < N; ++c) {
        float v = term_value(ts.type[t], &ts.par[ts.off[t]], ts.aux[t],
                             q[c * stride]);
        for (int u = t + 1; u < end; ++u)
          v *= term_value(ts.type[u], &ts.par[ts.off[u]], ts.aux[u],
                          q[c * stride]);
        prod[c * stride] = v;
      }
#pragma unroll
      for (int c = 0; c < N; ++c) out[c] += prod[c * stride];
    }
  }
}

}  // namespace gpx
