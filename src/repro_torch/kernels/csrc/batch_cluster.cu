// Batch-cluster interaction kernel for Hopper (sm_90a): Eq. 9 and Eq. 11.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/batch_cluster.py:batch_cluster_eval_pallas
//   (bodies _body, _body_kahan, _pair_r2, _min_image_1d).
//
//   phi[b, i] = sum_s [idx[b,s] >= 0] sum_{j < n_c} G(r2(x_bi, y_cj); par) q_cj,
//   c = idx[b, s],  n_c = src_count[c] (m without counts),
//   phi[b, i] = 0 for i >= tgt_count[b] (NB without counts).
//
// Systems axis: every operand may carry a leading axis of W independent
// systems (an ensemble, `repro_torch.serve`), each with its own parameter
// row par[w, :P]. blockIdx.z is the system, as the grid dimension vmap
// gives the Pallas kernel: a block reads its own system's rows, its
// cluster ids index its own system's clusters, and W = 1 is the launch of
// a single system.
//
// The same direct-sum form serves the direct lane (leaf particles, Eq. 9)
// and the approximation lane (Chebyshev grid points with modified charges,
// Eq. 11).
//
// What bounds it on the H100: instruction issue on the fp32 pipe, and the
// SFU (MUFU) for the one reciprocal square root of each pair. A pair needs
// ~8 fp32 instructions (3 sub, 1 mul + 2 fma for r2, the r2 == 0 test,
// one fma into the sum, predicated by the test) and one MUFU, against a few
// bytes of input per target and per cluster; the 3.35 TB/s of HBM (and
// the tensor cores: G is nonlinear, and TF32 would break the f32 bar)
// play no part. So the design removes every instruction a pair does not
// need:
//
//   - count-aware work. Targets are packed from slot 0 of each batch row
//     and particles from slot 0 of each leaf, so a count is a prefix
//     length. A block whose target tile starts at or beyond
//     tgt_count[b] writes zeros and returns before it loads anything,
//     and the sweep of cluster c stops at src_count[c]: the padding of
//     the (B, NB) slab and of the (C, m) leaves is never swept. Padded
//     target slots get phi = 0 (the contract of the plain version too);
//   - f32 pairs: rinv = rsqrt(r2), one MUFU.RSQ instead of an IEEE sqrt
//     and division, two multi-instruction sequences with slow-path
//     branches. Coulomb G = rinv; Yukawa r = r2 * rinv,
//     G = expf(-kappa r) * rinv (accurate expf, no division); the sum
//     takes G q only where r2 >= FLT_MIN, a predicate on its fma. The
//     reciprocal square root is rsqrtf's approximation (within 2 ulp, far
//     inside the f32 bar against the plain version, rtol 2e-4, and the
//     end-to-end bar, 1e-5), written as PTX rsqrt.approx.ftz.f32: rsqrtf
//     itself keeps denormal inputs, which costs every pair a range check,
//     a predicate, two rescaling multiplies and moves (in the SASS, about
//     as many issues again as the pair needs). So r2 below FLT_MIN, the
//     smallest normal float (r < 1.1e-19, where 1/r > 9e18), adds 0 like
//     r2 == 0. f64 keeps IEEE sqrt and division: its bar against the
//     plain version is rtol 1e-12. No --use_fast_math or -ftz for the
//     file;
//   - each staged source is one (x, y, z, q) record in shared memory
//     (a float4, or two double2 for f64): one 16-byte broadcast load
//     (two for f64) instead of four 4-byte ones;
//   - register-tiled targets: each lane owns kPerThread = 4 targets of
//     the 128-target tile, so every loaded source feeds 4 independent
//     pairs (4 dependency chains for the MUFU and fma latencies);
//   - the inner loop is unrolled kUnroll times at compile time; a chunk's
//     ragged tail is rounded up to kUnroll with zero-charge records
//     (G is finite there, so they add exactly 0);
//   - the four warps of a block hold the same 128 targets and split the
//     row's source chunks round-robin (chunk g of the row goes to warp
//     g % 4, over all slots): each warp stages its own chunks and syncs
//     with __syncwarp only, the warps stay balanced to one chunk, and a
//     block's work is a quarter as long as with one warp per tile. One
//     __syncthreads at the end adds the four partial sums per target in
//     a fixed order (deterministic, no atomics; phi is written once);
//   - the slot loop runs INSIDE the block (the TPU's sequential
//     "arbitrary" grid axis): per slot a warp sums its chunks into `slot`
//     and then adds the slot total to its accumulator, plainly or
//     Kahan-compensated across slots like _body_kahan. The Kahan update
//     runs on every slot, -1 sentinels and slots with no chunk of this
//     warp included (they add 0), as _body_kahan does with valid = 0;
//   - a -1 slot adds exactly 0 wherever it sits in the row;
//   - G is exactly 0 at r2 == 0 (and for a NaN r2; in f32 below FLT_MIN);
//   - periodic fold d - L*rint(d/L): rint rounds half to even as
//     jnp.round / torch.round do (CUDA's round() would round half away);
//   - kernel parameters come through a device pointer, so a kappa sweep
//     reuses this binary and never waits on the host;
//   - a user kernel (any Kernel but the two built-ins) takes kUser: G
//     from repro_user_g, the function kernels/codegen.py generates from
//     the kernel's torch of_r2, on the masked r2 (1 where r2 is below
//     the mask), its parameters in registers (field::Params). Only a user
//     library (this source with -DREPRO_USER_KERNEL and -include of the
//     generated header) instantiates kUser, and only kUser; everything
//     else above holds for it unchanged;
//   - layouts are the natural (..., P, 3) ones of the callers, so the
//     wrapper makes no transposed copies.
// Double-buffering the chunks (cp.async) is left out: a warp's chunk
// loads (16 records a lane) are ~1% of its instructions, and the other
// warps of the SM cover their latency (a chunk load unrolled to put all
// 16 in flight at once measured slower, not faster).

#include <cfloat>

#include <cuda_runtime.h>

#include "field_common.cuh"

namespace {

constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = 32 * kWarps;      // 128
constexpr int kPerThread = 4;              // targets per lane
constexpr int kTile = 32 * kPerThread;     // 128 targets per block
constexpr int kChunk = 128;                // sources per staged chunk
constexpr int kUnroll = 4;                 // inner-loop unroll
static_assert(kTile == kThreads, "the final combine maps thread t to target t");
static_assert(kChunk % kUnroll == 0, "a chunk rounds up inside its buffer");

using field::kCoulomb;
using field::kUser;
using field::kYukawa;

// Blocks per SM the register budget is sized for: 8 x 4 warps of f32
// (<= 64 registers a thread), 4 x 4 warps of f64.
constexpr int min_blocks(int dtype_size) { return dtype_size == 4 ? 8 : 4; }

// MUFU.RSQ on its own: a denormal x reads as 0 and gives +inf.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s + G(r2) q, or s where r2 is 0 (G = 0 there).
template <typename T, int KID>
__device__ __forceinline__ T add_pair(T s, T r2, T q,
                                      const field::Params<T, KID>& kp) {
  if constexpr (KID == kUser) {
    const bool pos = field::nonzero(r2);
    const T g = repro_user_g<T>(pos ? r2 : T(1), kp.p);
    return pos ? s + g * q : s;
  } else if constexpr (sizeof(T) == 4) {
    const float kappa = kp.kappa;
    // The MUFU runs for every pair; the r2 test predicates the fma, so
    // r2 == 0 costs no select (the unused rinv is +inf there).
    const float rinv = rsqrt_ftz(r2);
    const float g = KID == kCoulomb ? rinv : expf(-kappa * (r2 * rinv)) * rinv;
    return r2 >= FLT_MIN ? fmaf(g, q, s) : s;
  } else {
    if (!(r2 > 0.0)) return s;
    const double r = sqrt(r2);
    const double g = KID == kCoulomb ? 1.0 / r : exp(-kp.kappa * r) / r;
    return s + g * q;
  }
}

template <typename T>
__device__ __forceinline__ T fold(T d, T len, T inv_len) {
  return d - len * rint(d * inv_len);
}

// One staged source: 4 consecutive T (x, y, z, q) in shared memory.
template <typename T>
struct Src {
  T x, y, z, q;
};

__device__ __forceinline__ Src<float> load_src(const float* s, int t) {
  const float4 v = reinterpret_cast<const float4*>(s)[t];
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Src<double> load_src(const double* s, int t) {
  const double2 a = reinterpret_cast<const double2*>(s)[2 * t];
  const double2 b = reinterpret_cast<const double2*>(s)[2 * t + 1];
  return {a.x, a.y, b.x, b.y};
}

__device__ __forceinline__ void store_src(float* s, int t, float x, float y,
                                          float z, float q) {
  reinterpret_cast<float4*>(s)[t] = make_float4(x, y, z, q);
}

__device__ __forceinline__ void store_src(double* s, int t, double x,
                                          double y, double z, double q) {
  reinterpret_cast<double2*>(s)[2 * t] = make_double2(x, y);
  reinterpret_cast<double2*>(s)[2 * t + 1] = make_double2(z, q);
}

template <typename T, int KID, bool PERIODIC, bool KAHAN, bool MATMUL>
__global__ void __launch_bounds__(kThreads, min_blocks(sizeof(T)))
batch_cluster_kernel(const int* __restrict__ idx, const T* __restrict__ par,
                     const T* __restrict__ tgt, const T* __restrict__ src,
                     const T* __restrict__ q,
                     const int* __restrict__ tgt_count,
                     const int* __restrict__ src_count, T* __restrict__ out,
                     int S, int NB, int m, int C, int P, T Lx, T Ly, T Lz) {
  // the row in the stacked (W * B) slab, and the system's first cluster
  const int b = blockIdx.z * gridDim.x + blockIdx.x;
  const int cbase = blockIdx.z * C;
  const int i0 = blockIdx.y * kTile;
  const int nt = tgt_count ? min(max(tgt_count[b], 0), NB) : NB;
  T* orow = out + static_cast<size_t>(b) * NB;
  if (i0 >= nt) {  // no real target in this tile: the whole block leaves
    const int i = i0 + threadIdx.x;
    if (i < NB) orow[i] = T(0);
    return;
  }

  __shared__ __align__(16) T stage[kWarps][4 * kChunk];
  __shared__ T stage_y2[kWarps][MATMUL ? kChunk : 1];
  __shared__ T part[kWarps][kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T tx[kPerThread], ty[kPerThread], tz[kPerThread], t2[kPerThread];
  T acc[kPerThread], comp[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = i0 + lane + 32 * r;  // lanes own neighbouring targets
    tx[r] = ty[r] = tz[r] = T(0);
    if (i < nt) {
      const T* p = tgt + (static_cast<size_t>(b) * NB + i) * 3;
      tx[r] = p[0];
      ty[r] = p[1];
      tz[r] = p[2];
    }
    t2[r] = tx[r] * tx[r] + ty[r] * ty[r] + tz[r] * tz[r];
    acc[r] = T(0);
    comp[r] = T(0);
  }
  const field::Params<T, KID> kp(par + static_cast<size_t>(blockIdx.z) * P);
  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;

  T* buf = stage[warp];
  T* buf_y2 = stage_y2[warp];
  const int* row = idx + static_cast<size_t>(b) * S;
  int g = 0;  // chunk counter over the row, the same in every warp
  for (int s = 0; s < S; ++s) {
    const int c = row[s];  // the same for every thread: uniform branch
    T slot[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) slot[r] = T(0);
    if (c >= 0) {
      const int cg = cbase + c;
      const int n = src_count ? min(max(src_count[cg], 0), m) : m;
      const T* cp = src + static_cast<size_t>(cg) * m * 3;
      const T* cq = q + static_cast<size_t>(cg) * m;
      for (int j0 = 0; j0 < n; j0 += kChunk, ++g) {
        if (g % kWarps != warp) continue;  // another warp's chunk
        const int len = min(kChunk, n - j0);
        const int padded = (len + kUnroll - 1) / kUnroll * kUnroll;
        __syncwarp();  // this warp's previous chunk is consumed
        for (int t = lane; t < padded; t += 32) {
          T px = T(0), py = T(0), pz = T(0), pq = T(0);
          if (t < len) {
            const T* pt = cp + static_cast<size_t>(j0 + t) * 3;
            px = pt[0];
            py = pt[1];
            pz = pt[2];
            pq = cq[j0 + t];
          }
          store_src(buf, t, px, py, pz, pq);
          if (MATMUL) buf_y2[t] = px * px + py * py + pz * pz;
        }
        __syncwarp();
        for (int t = 0; t < padded; t += kUnroll) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const Src<T> sv = load_src(buf, t + u);
            const T sy2 = MATMUL ? buf_y2[t + u] : T(0);
#pragma unroll
            for (int r = 0; r < kPerThread; ++r) {
              T r2;
              if (MATMUL) {
                const T xy = tx[r] * sv.x + ty[r] * sv.y + tz[r] * sv.z;
                r2 = fmax(t2[r] + sy2 - T(2) * xy, T(0));
              } else {
                T dx = tx[r] - sv.x, dy = ty[r] - sv.y, dz = tz[r] - sv.z;
                if (PERIODIC) {
                  dx = fold(dx, Lx, iLx);
                  dy = fold(dy, Ly, iLy);
                  dz = fold(dz, Lz, iLz);
                }
                r2 = dx * dx + dy * dy + dz * dz;
              }
              slot[r] = add_pair<T, KID>(slot[r], r2, sv.q, kp);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (KAHAN) {
        const T yk = slot[r] - comp[r];
        const T ts = acc[r] + yk;
        comp[r] = (ts - acc[r]) - yk;
        acc[r] = ts;
      } else {
        acc[r] += slot[r];
      }
    }
  }

  // The four warps' partial sums of each target, added in warp order by
  // the thread that owns the target's output slot.
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) part[warp][lane + 32 * r] = acc[r];
  __syncthreads();
  const int t = threadIdx.x;
  const int i = i0 + t;
  if (i < NB) {
    T sum = T(0);
    if (i < nt) {
      T cmp = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (KAHAN) {
          const T yk = part[w][t] - cmp;
          const T ts = sum + yk;
          cmp = (ts - sum) - yk;
          sum = ts;
        } else {
          sum += part[w][t];
        }
      }
    }
    orow[i] = sum;
  }
}

struct Args {
  const int* idx;
  const int* tgt_count;
  const int* src_count;
  int B, S, NB, m, W, C, P;
};

template <typename T, int KID, bool PERIODIC, bool KAHAN, bool MATMUL>
void launch_one(const Args& a, const T* par, const T* tgt, const T* src,
                const T* q, T* out, T Lx, T Ly, T Lz, cudaStream_t stream) {
  const dim3 grid(a.B, (a.NB + kTile - 1) / kTile, a.W);
  batch_cluster_kernel<T, KID, PERIODIC, KAHAN, MATMUL>
      <<<grid, kThreads, 0, stream>>>(a.idx, par, tgt, src, q, a.tgt_count,
                                      a.src_count, out, a.S, a.NB, a.m, a.C,
                                      a.P, Lx, Ly, Lz);
}

template <typename T, int KID, bool KAHAN>
void launch_space(const Args& a, const T* par, const T* tgt, const T* src,
                  const T* q, T* out, int periodic, int matmul, T Lx, T Ly,
                  T Lz, cudaStream_t st) {
  if (periodic)
    launch_one<T, KID, true, KAHAN, false>(a, par, tgt, src, q, out, Lx, Ly,
                                           Lz, st);
  else if (matmul)
    launch_one<T, KID, false, KAHAN, true>(a, par, tgt, src, q, out, Lx, Ly,
                                           Lz, st);
  else
    launch_one<T, KID, false, KAHAN, false>(a, par, tgt, src, q, out, Lx, Ly,
                                            Lz, st);
}

template <typename T, int KID>
void launch_kid(const Args& a, const T* par, const T* tgt, const T* src,
                const T* q, T* out, int periodic, int kahan, int matmul,
                T Lx, T Ly, T Lz, cudaStream_t st) {
  if (kahan)
    launch_space<T, KID, true>(a, par, tgt, src, q, out, periodic, matmul,
                               Lx, Ly, Lz, st);
  else
    launch_space<T, KID, false>(a, par, tgt, src, q, out, periodic, matmul,
                                Lx, Ly, Lz, st);
}

// A base library launches the built-ins, a user library kUser alone;
// any other id is refused.
template <typename T>
int launch(const Args& a, const T* par, const T* tgt, const T* src,
           const T* q, T* out, int kernel_id, int periodic, int kahan,
           int matmul, T Lx, T Ly, T Lz, cudaStream_t st) {
#ifdef REPRO_USER_KERNEL
  if (kernel_id != kUser) return static_cast<int>(cudaErrorInvalidValue);
#else
  if (kernel_id != kCoulomb && kernel_id != kYukawa)
    return static_cast<int>(cudaErrorInvalidValue);
#endif
  if (a.W > 0 && a.B > 0 && a.NB > 0) {
#ifdef REPRO_USER_KERNEL
    launch_kid<T, kUser>(a, par, tgt, src, q, out, periodic, kahan, matmul,
                         Lx, Ly, Lz, st);
#else
    if (kernel_id == kCoulomb)
      launch_kid<T, kCoulomb>(a, par, tgt, src, q, out, periodic, kahan,
                              matmul, Lx, Ly, Lz, st);
    else
      launch_kid<T, kYukawa>(a, par, tgt, src, q, out, periodic, kahan,
                             matmul, Lx, Ly, Lz, st);
#endif
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers,
// `stream` the caller's cudaStream_t; idx (W, B, S), par (W, P), tgt
// (W, B, NB, 3), src (W, C, m, 3), q (W, C, m), out (W, B, NB) (W = 1: a
// single system); tgt_count (W, B) and src_count (W, C) may be null
// (every target slot and every source point is real). The launch is
// asynchronous and the return value is cudaGetLastError() right after it
// (0 = launched).
extern "C" int bc_eval_f32(const int* idx, const float* par, const float* tgt,
                           const float* src, const float* q,
                           const int* tgt_count, const int* src_count,
                           float* out, int B, int S, int NB, int m, int W,
                           int C, int P, int kernel_id, int periodic,
                           int kahan, int matmul, double Lx, double Ly,
                           double Lz, void* stream) {
  const Args a{idx, tgt_count, src_count, B, S, NB, m, W, C, P};
  return launch<float>(a, par, tgt, src, q, out, kernel_id, periodic, kahan,
                       matmul, static_cast<float>(Lx), static_cast<float>(Ly),
                       static_cast<float>(Lz),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int bc_eval_f64(const int* idx, const double* par,
                           const double* tgt, const double* src,
                           const double* q, const int* tgt_count,
                           const int* src_count, double* out, int B, int S,
                           int NB, int m, int W, int C, int P, int kernel_id,
                           int periodic, int kahan, int matmul, double Lx,
                           double Ly, double Lz, void* stream) {
  const Args a{idx, tgt_count, src_count, B, S, NB, m, W, C, P};
  return launch<double>(a, par, tgt, src, q, out, kernel_id, periodic, kahan,
                        matmul, Lx, Ly, Lz, static_cast<cudaStream_t>(stream));
}

// The launch geometry, for the wrapper's grid check and the accounting of
// swept pairs: 0 -> targets per block, 1 -> the source unroll.
extern "C" int bc_geometry(int what) { return what == 0 ? kTile : kUnroll; }
