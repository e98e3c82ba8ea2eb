// Batch-cluster interaction kernel for Hopper (sm_90a): Eq. 9 and Eq. 11.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/batch_cluster.py:batch_cluster_eval_pallas
//   (bodies _body, _body_kahan, _pair_r2, _min_image_1d).
//
//   phi[b, i] = sum_s [idx[b,s] >= 0] sum_j G(r2(x_bi, y_cj); par) q_cj,
//   c = idx[b, s].
//
// The same direct-sum form serves the direct lane (leaf particles, Eq. 9)
// and the approximation lane (Chebyshev grid points with modified charges,
// Eq. 11).
//
// What bounds it on the H100: operations. Every (target, source) pair
// costs ~12 fp32 operations, an IEEE square root and an IEEE division
// (plus an exp for Yukawa), against a few bytes of input per target and
// per cluster, so the fp32 pipeline (and the multi-instruction sqrt/div
// sequences) binds long before the 3.35 TB/s of HBM does.
//
// Design (first version, right before fast):
//   - one block of kThreads threads per (batch, target tile); one target
//     per thread, its coordinates and accumulator live in registers;
//   - the slot loop runs INSIDE the block (the TPU's sequential
//     "arbitrary" grid axis); phi is written once, no atomics;
//   - each cluster's sources stream through shared memory in kChunk-point
//     chunks that all threads of the block load together, then every
//     thread sweeps the chunk (a broadcast read, free of bank conflicts);
//   - a -1 slot adds exactly 0 wherever it sits in the row: the block
//     skips it (the Kahan variant still applies its compensation update,
//     as _body_kahan does with valid = 0);
//   - G is exactly 0 at r2 == 0; Coulomb is IEEE 1/sqrt(r2), Yukawa
//     exp(-kappa r)/r, never the approximate reciprocal square root (the
//     f64 bar is 1e-12, and the build uses no --use_fast_math);
//   - periodic fold d - L*rint(d/L): rint rounds half to even as
//     jnp.round / torch.round do (CUDA's round() would round half away);
//   - kernel parameters come through a device pointer, so a kappa sweep
//     reuses this binary and never waits on the host;
//   - the ragged target edge (NB not a multiple of kThreads) and the
//     ragged source edge (m not a multiple of kChunk) are masked here;
//   - layouts are the natural (..., P, 3) ones of the callers, so the
//     wrapper makes no transposed copies: a chunk of m x 3 coordinates is
//     contiguous, loaded by the block and broadcast from shared memory.
// Per slot the chunk sums go into `slot` first and the slot total is then
// added to phi (plainly or Kahan-compensated across slots, like
// _body_kahan).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // targets per block (one per thread)
constexpr int kChunk = 256;    // sources staged in shared memory per pass

constexpr int kCoulomb = 0;
constexpr int kYukawa = 1;

template <typename T, int KID>
__device__ __forceinline__ T green(T r2, T kappa) {
  if (!(r2 > T(0))) return T(0);  // r2 == 0 (and padding) adds exactly 0
  const T r = sqrt(r2);
  if (KID == kCoulomb) return T(1) / r;
  return exp(-kappa * r) / r;
}

template <typename T>
__device__ __forceinline__ T fold(T d, T len, T inv_len) {
  return d - len * rint(d * inv_len);
}

template <typename T, int KID, bool PERIODIC, bool KAHAN, bool MATMUL>
__global__ void __launch_bounds__(kThreads)
batch_cluster_kernel(const int* __restrict__ idx, const T* __restrict__ par,
                     const T* __restrict__ tgt, const T* __restrict__ src,
                     const T* __restrict__ q, T* __restrict__ out, int S,
                     int NB, int m, T Lx, T Ly, T Lz) {
  __shared__ T sx[kChunk];
  __shared__ T sy[kChunk];
  __shared__ T sz[kChunk];
  __shared__ T sq[kChunk];
  __shared__ T sy2[MATMUL ? kChunk : 1];

  const int b = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  const bool active = i < NB;
  T x = T(0), y = T(0), z = T(0);
  if (active) {
    const T* p = tgt + (static_cast<size_t>(b) * NB + i) * 3;
    x = p[0];
    y = p[1];
    z = p[2];
  }
  const T x2 = x * x + y * y + z * z;
  const T kappa = KID == kYukawa ? par[0] : T(0);
  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;

  T acc = T(0);
  T comp = T(0);
  const int* row = idx + static_cast<size_t>(b) * S;
  for (int s = 0; s < S; ++s) {
    const int c = row[s];  // the same for every thread: uniform branch
    T slot = T(0);
    if (c >= 0) {
      const T* cp = src + static_cast<size_t>(c) * m * 3;
      const T* cq = q + static_cast<size_t>(c) * m;
      for (int j0 = 0; j0 < m; j0 += kChunk) {
        const int n = min(kChunk, m - j0);
        __syncthreads();  // the previous chunk is fully consumed
        for (int t = threadIdx.x; t < n; t += kThreads) {
          const T* pt = cp + static_cast<size_t>(j0 + t) * 3;
          const T px = pt[0], py = pt[1], pz = pt[2];
          sx[t] = px;
          sy[t] = py;
          sz[t] = pz;
          sq[t] = cq[j0 + t];
          if (MATMUL) sy2[t] = px * px + py * py + pz * pz;
        }
        __syncthreads();
        if (active) {
          for (int t = 0; t < n; ++t) {
            T r2;
            if (MATMUL) {
              const T xy = x * sx[t] + y * sy[t] + z * sz[t];
              r2 = fmax(x2 + sy2[t] - T(2) * xy, T(0));
            } else {
              T dx = x - sx[t], dy = y - sy[t], dz = z - sz[t];
              if (PERIODIC) {
                dx = fold(dx, Lx, iLx);
                dy = fold(dy, Ly, iLy);
                dz = fold(dz, Lz, iLz);
              }
              r2 = dx * dx + dy * dy + dz * dz;
            }
            slot += green<T, KID>(r2, kappa) * sq[t];
          }
        }
      }
    }
    if (KAHAN) {
      const T yk = slot - comp;
      const T ts = acc + yk;
      comp = (ts - acc) - yk;
      acc = ts;
    } else {
      acc += slot;
    }
  }
  if (active) out[static_cast<size_t>(b) * NB + i] = acc;
}

template <typename T, int KID, bool PERIODIC, bool KAHAN, bool MATMUL>
void launch_one(const int* idx, const T* par, const T* tgt, const T* src,
                const T* q, T* out, int B, int S, int NB, int m, T Lx, T Ly,
                T Lz, cudaStream_t stream) {
  const dim3 grid(B, (NB + kThreads - 1) / kThreads);
  batch_cluster_kernel<T, KID, PERIODIC, KAHAN, MATMUL>
      <<<grid, kThreads, 0, stream>>>(idx, par, tgt, src, q, out, S, NB, m,
                                      Lx, Ly, Lz);
}

template <typename T, int KID, bool KAHAN>
void launch_space(const int* idx, const T* par, const T* tgt, const T* src,
                  const T* q, T* out, int B, int S, int NB, int m,
                  int periodic, int matmul, T Lx, T Ly, T Lz,
                  cudaStream_t st) {
  if (periodic)
    launch_one<T, KID, true, KAHAN, false>(idx, par, tgt, src, q, out, B, S,
                                           NB, m, Lx, Ly, Lz, st);
  else if (matmul)
    launch_one<T, KID, false, KAHAN, true>(idx, par, tgt, src, q, out, B, S,
                                           NB, m, Lx, Ly, Lz, st);
  else
    launch_one<T, KID, false, KAHAN, false>(idx, par, tgt, src, q, out, B, S,
                                            NB, m, Lx, Ly, Lz, st);
}

template <typename T>
int launch(const int* idx, const T* par, const T* tgt, const T* src,
           const T* q, T* out, int B, int S, int NB, int m, int kernel_id,
           int periodic, int kahan, int matmul, T Lx, T Ly, T Lz,
           cudaStream_t st) {
  if (kernel_id != kCoulomb && kernel_id != kYukawa)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && NB > 0) {
    if (kernel_id == kCoulomb) {
      if (kahan)
        launch_space<T, kCoulomb, true>(idx, par, tgt, src, q, out, B, S, NB,
                                        m, periodic, matmul, Lx, Ly, Lz, st);
      else
        launch_space<T, kCoulomb, false>(idx, par, tgt, src, q, out, B, S, NB,
                                         m, periodic, matmul, Lx, Ly, Lz, st);
    } else {
      if (kahan)
        launch_space<T, kYukawa, true>(idx, par, tgt, src, q, out, B, S, NB,
                                       m, periodic, matmul, Lx, Ly, Lz, st);
      else
        launch_space<T, kYukawa, false>(idx, par, tgt, src, q, out, B, S, NB,
                                        m, periodic, matmul, Lx, Ly, Lz, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers,
// `stream` the caller's cudaStream_t; the launch is asynchronous and the
// return value is cudaGetLastError() right after it (0 = launched).
extern "C" int bc_eval_f32(const int* idx, const float* par, const float* tgt,
                           const float* src, const float* q, float* out,
                           int B, int S, int NB, int m, int kernel_id,
                           int periodic, int kahan, int matmul, double Lx,
                           double Ly, double Lz, void* stream) {
  return launch<float>(idx, par, tgt, src, q, out, B, S, NB, m, kernel_id,
                       periodic, kahan, matmul, static_cast<float>(Lx),
                       static_cast<float>(Ly), static_cast<float>(Lz),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int bc_eval_f64(const int* idx, const double* par,
                           const double* tgt, const double* src,
                           const double* q, double* out, int B, int S, int NB,
                           int m, int kernel_id, int periodic, int kahan,
                           int matmul, double Lx, double Ly, double Lz,
                           void* stream) {
  return launch<double>(idx, par, tgt, src, q, out, B, S, NB, m, kernel_id,
                        periodic, kahan, matmul, Lx, Ly, Lz,
                        static_cast<cudaStream_t>(stream));
}
