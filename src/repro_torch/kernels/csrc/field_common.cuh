// Device helpers shared by the two field kernels (batch_cluster_field.cu,
// the generic one over explicit points, and batch_cluster_field_grid.cu,
// the one over a cluster's tensor-product Chebyshev grid), and the kernel
// ids and parameters of all three batch-cluster kernels (batch_cluster.cu
// too). Header only; `_build.library_path` hashes it into every library's
// name, so an edit here rebuilds them.
#pragma once

#include <cfloat>

#include <cuda_runtime.h>

#ifndef REPRO_USER_KERNEL
// A base library: the user kernel's functions (generated by
// kernels/codegen.py into the header a user library is built with) are
// declared, never defined, and never instantiated: every kUser branch is
// an `if constexpr`.
#define REPRO_USER_NPAR 0
namespace {
template <typename T>
__device__ T repro_user_g(T r2, const T* p);
template <typename T>
__device__ void repro_user_gc(T r2, const T* p, T* g, T* c);
}  // namespace
#endif

namespace field {

constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kOut = 4;                // phi, gx, gy, gz

constexpr int kCoulomb = 0;
constexpr int kYukawa = 1;
// Any other kernel: G and 2 G' from the header kernels/codegen.py
// generates from the kernel's torch function. Only a user library
// (-DREPRO_USER_KERNEL -include <header>) instantiates it, and it
// instantiates nothing else; the built-ins keep their hand-tuned paths.
constexpr int kUser = 2;

// A kernel's parameters in registers, read once a block from its system's
// row of par: Yukawa's kappa (Coulomb reads none), or a user kernel's
// REPRO_USER_NPAR values (the packed order of potentials.pack_params).
template <typename T, int KID>
struct Params {
  T kappa;
  __device__ __forceinline__ explicit Params(const T* row)
      : kappa(KID == kYukawa ? row[0] : T(0)) {}
};

constexpr int kUserParams = REPRO_USER_NPAR > 0 ? REPRO_USER_NPAR : 1;

template <typename T>
struct Params<T, kUser> {
  T p[kUserParams];
  __device__ __forceinline__ explicit Params(const T* row) {
#pragma unroll
    for (int k = 0; k < kUserParams; ++k)
      p[k] = k < REPRO_USER_NPAR ? row[k] : T(0);
  }
};

// The pair mask of every kernel: r2 >= FLT_MIN in f32 (MUFU.RSQ reads a
// denormal as 0), r2 > 0 in f64. A user kernel's G and 2 G' are taken on
// the masked value (r2, or 1 where the mask is off), never at r2 == 0,
// as Kernel.__call__ does: a 0/0 never reaches the sums.
__device__ __forceinline__ bool nonzero(float r2) { return r2 >= FLT_MIN; }
__device__ __forceinline__ bool nonzero(double r2) { return r2 > 0.0; }

// MUFU.RSQ on its own: a denormal x reads as 0 and gives +inf.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ void kahan_add(T& sum, T& comp, T v) {
  const T yk = v - comp;
  const T ts = sum + yk;
  comp = (ts - sum) - yk;
  sum = ts;
}

// Relative width of the band around a half-integer quotient in which
// fold() divides: d * (1/L) is within 1.5 eps |d / L| of d / L.
template <typename T>
__device__ __forceinline__ T tie_band();
template <>
__device__ __forceinline__ float tie_band<float>() {
  return 4.0f * FLT_EPSILON;
}
template <>
__device__ __forceinline__ double tie_band<double>() {
  return 4.0 * DBL_EPSILON;
}

// d - L rint(d / L), half to even: the reference's fold. d * (1/L)
// saves the division, but near a minimum-image tie it can round to the
// other image than d / L does, which flips that gradient component's
// sign (phi only sees r2). So within the band of a tie the quotient is
// taken by division; away from one the two round alike.
template <typename T>
__device__ __forceinline__ T fold(T d, T len, T inv_len) {
  const T q = d * inv_len;
  T k = rint(q);
  const T band = tie_band<T>();
  if (fabs(fabs(q - k) - T(0.5)) <= fma(fabs(q), band, band)) {
    k = rint(d / len);
  }
  return d - len * k;
}

// One output of a target's running total in shared memory += v, Kahan
// compensated (the compensation in a register) where KAHAN.
template <typename T, bool KAHAN>
__device__ __forceinline__ void add_total(T& total, T& comp, T v) {
  if (KAHAN) {
    T sum = total;
    kahan_add(sum, comp, v);
    total = sum;
  } else {
    total += v;
  }
}

// A tile with no real target: 0 in the four outputs of its slots below NB.
template <typename T, int TILE>
__device__ __forceinline__ void zero_tile(T* orow, int i0, int NB) {
  for (int e = threadIdx.x; e < TILE * kOut; e += kThreads) {
    if (i0 + e / kOut < NB) orow[i0 * kOut + e] = T(0);
  }
}

// The block's output tile: each target's warp totals added in warp order
// (Kahan compensated where KAHAN), 0 on slots at or past the real count
// nt, written with consecutive threads on consecutive addresses.
template <typename T, bool KAHAN, int TILE>
__device__ __forceinline__ void write_tile(const T (&tot)[kWarps][kOut][TILE],
                                           T* orow, int i0, int nt, int NB) {
  __syncthreads();
  for (int e = threadIdx.x; e < TILE * kOut; e += kThreads) {
    const int t = e / kOut, k = e % kOut;
    const int i = i0 + t;
    if (i >= NB) continue;
    T sum = T(0);
    if (i < nt) {
      T cmp = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        add_total<T, KAHAN>(sum, cmp, tot[w][k][t]);
    }
    orow[i * kOut + k] = sum;
  }
}

}  // namespace field
