// Batch-cluster FIELD kernel for Hopper (sm_90a): the potential and its
// gradient at every target in one sweep over the pairs.
//
// Not a port of a TPU kernel. The JAX reference takes forces as three
// forward JVPs through its XLA executor
//   src/repro/core/eval.py:_target_gradient (and potential_and_forces),
// switching any Pallas backend to XLA under autodiff. This kernel is the
// card's counterpart of that path: for each target slot
//
//   phi[b, i] = sum_s [idx[b,s] >= 0] sum_{j < n_c} G(r2) q_cj
//   g[b, i]   = sum_s [idx[b,s] >= 0] sum_{j < n_c} 2 G'(r2) d q_cj,
//   d = x_bi - y_cj (minimum-image folded in a periodic box), r2 = |d|^2,
//   c = idx[b, s], n_c = src_count[c] (m without counts),
//   phi = g = 0 for i >= tgt_count[b] (NB without counts).
//
// Coulomb: 2 G'(r2) = -r^-3; Yukawa: 2 G'(r2) = -(1 + kappa r) e^(-kappa r)
// r^-3. out is (B, NB, 4): phi, then the three gradient components. Like
// batch_cluster.cu, every operand may carry a leading systems axis W
// (blockIdx.z = system, parameter row par[w, :P]).
//
// It takes the grid, the -1 sentinels and the count contract of
// batch_cluster.cu, and that kernel's design (count-aware tiles, one
// (x, y, z, q) record per staged source, 4 targets per lane, 4 warps
// splitting a row's chunks, the slot loop inside the block); see its
// header. It is its own source file so that the potential kernel's
// registers and instructions do not move. The forces run it on the
// direct lane (leaf particles); the approximation lane's Chebyshev grids
// go to batch_cluster_field_grid.cu, which sweeps them in factored form.
// Any caller with explicit points can still use it. What bounds it on
// the H100: fp32 issue (14.5 SASS instructions a pair: 3 sub, 3 for r2,
// the rsqrt, 3 mul, the phi fma, 3 gradient fmas and a quarter of the
// LDS.128), which ran at ~80% of the slots in every variant measured
// (tools/field_variants.py); the bytes are a few per target and per
// cluster. So the design spends registers on pairs in flight, not on
// warps, and drops what it can from the pair:
//
//   - the slot's sums stay in registers (4 targets x 4 outputs), but the
//     running totals across slots live in a shared-memory table per
//     warp, touched once a slot; at 6 blocks of 4 warps an SM (<= 80
//     registers) that leaves room for more pairs in flight, and ran
//     faster than 8 blocks at 64 registers. Adding each pair straight
//     into the totals would lengthen an f32 sum from a slot's ~500 terms
//     to a warp's whole row (~10^5): 6x the gradient error, measured;
//   - the exact-hit predicate (next item) costs an instruction a pair, and
//     only a chunk whose bounding box a target's clearance reaches can
//     hold a hit (in MD, its own leaf): a chunk farther than 1e-18 from
//     every target of a lane along some axis runs unpredicated, with the
//     same sums (free space; a fold can bring any source near);
//   - exact hits: in MD the targets are the sources, so every particle
//     meets itself in the direct lane (d = 0 exactly, folded or not). The
//     r2 >= FLT_MIN predicate (r2 > 0 in f64) guards all four sums, not
//     only phi: rinv is +inf there, and inf * 0 would poison the
//     gradient;
//   - phi is computed by the potential kernel's very expression
//     (fmaf(G, q, s) with the same G, the same slot and warp order), so
//     the field's phi equals the potential kernel's;
//   - the gradient reuses G: Coulomb s = (G q) rinv^2, Yukawa
//     s = (1 + kappa r) (G q) rinv^2, then g = fma(-s, d, g) per axis;
//   - Kahan compensates phi and each gradient component across slots
//     and in the warp combine, as the potential kernel does for phi;
//   - there is no matmul-r2 form: the gradient needs d, so
//     approx_r2 = "matmul" runs the difference form here (the JVP of the
//     matmul r2 is the same analytic derivative; only rounding differs);
//   - the periodic fold decides each image as the reference does,
//     rint(d / L) half to even, to the last bit (fold() in
//     field_common.cuh);
//   - f64 keeps IEEE sqrt and division;
//   - a user kernel takes kUser (see batch_cluster.cu): g and c = 2 G'
//     from repro_user_gc on the masked r2, then phi += g q and
//     grad += (c q) d under the same predicate; only a user library
//     instantiates it.

#include <cfloat>

#include <cuda_runtime.h>

#include "field_common.cuh"

namespace {

using field::kCoulomb;
using field::kOut;
using field::kThreads;
using field::kUser;
using field::kWarps;
using field::kYukawa;
using field::kahan_add;
using field::rsqrt_ftz;

constexpr int kPerThread = 4;              // targets per lane
constexpr int kTile = 32 * kPerThread;     // 128 targets per block
constexpr int kChunk = 128;                // sources per staged chunk
constexpr int kUnroll = 4;                 // inner-loop unroll
static_assert(kChunk % kUnroll == 0, "a chunk rounds up inside its buffer");

// Blocks per SM the register budget is sized for: 6 x 4 warps of f32
// (<= 80 registers a thread: 4 targets x (3 coordinates + 4 slot sums)
// live across the loop, the totals in shared memory, the rest pairs in
// flight), 3 x 4 warps of f64.
constexpr int min_blocks(int dtype_size) { return dtype_size == 4 ? 6 : 3; }

template <typename T>
struct Field {
  T p, x, y, z;  // phi and the gradient
};

template <typename T>
__device__ __forceinline__ void zero(Field<T>& f) {
  f.p = f.x = f.y = f.z = T(0);
}

// f += (G, 2 G'(r2) d) q. CHECK adds nothing where r2 is 0 (f32: below
// FLT_MIN); without it the caller has shown r2 is above that.
template <typename T, int KID, bool CHECK>
__device__ __forceinline__ void add_pair(Field<T>& f, T dx, T dy, T dz, T r2,
                                         T q, const field::Params<T, KID>& kp) {
  if constexpr (KID == kUser) {
    const bool pos = !CHECK || field::nonzero(r2);
    T g, c;
    repro_user_gc<T>(pos ? r2 : T(1), kp.p, &g, &c);
    if (pos) {
      const T cq = c * q;
      f.p = f.p + g * q;
      f.x = f.x + cq * dx;
      f.y = f.y + cq * dy;
      f.z = f.z + cq * dz;
    }
  } else if constexpr (sizeof(T) == 4) {
    const float kappa = kp.kappa;
    const float rinv = rsqrt_ftz(r2);
    const float g = KID == kCoulomb ? rinv : expf(-kappa * (r2 * rinv)) * rinv;
    const float gq = g * q;
    const float c = KID == kCoulomb ? rinv * rinv
                                    : fmaf(kappa, r2 * rinv, 1.0f) * rinv * rinv;
    const float s = gq * c;
    if (!CHECK || r2 >= FLT_MIN) {
      f.p = fmaf(g, q, f.p);
      f.x = fmaf(-s, dx, f.x);
      f.y = fmaf(-s, dy, f.y);
      f.z = fmaf(-s, dz, f.z);
    }
  } else {
    const double kappa = kp.kappa;
    if (CHECK && !(r2 > 0.0)) return;
    const double r = sqrt(r2);
    const double g = KID == kCoulomb ? 1.0 / r : exp(-kappa * r) / r;
    const double rinv = KID == kCoulomb ? g : 1.0 / r;
    f.p = f.p + g * q;
    const double s = (KID == kCoulomb ? g : (1.0 + kappa * r) * g) * q *
                     (rinv * rinv);
    f.x = f.x - s * dx;
    f.y = f.y - s * dy;
    f.z = f.z - s * dz;
  }
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

// The pairs of one staged chunk (`padded` sources in buf) for a lane's
// targets, into the slot's sums.
template <typename T, int KID, bool PERIODIC, bool CHECK>
__device__ __forceinline__ void sweep_chunk(
    const T* buf, int padded, const T (&tx)[kPerThread],
    const T (&ty)[kPerThread], const T (&tz)[kPerThread],
    Field<T> (&slot)[kPerThread], const field::Params<T, KID>& kp, T Lx,
    T Ly, T Lz) {
  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;
  for (int t = 0; t < padded; t += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Src<T> sv = load_src(buf, t + u);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        T dx = tx[r] - sv.x, dy = ty[r] - sv.y, dz = tz[r] - sv.z;
        if (PERIODIC) {
          dx = field::fold(dx, Lx, iLx);
          dy = field::fold(dy, Ly, iLy);
          dz = field::fold(dz, Lz, iLz);
        }
        const T r2 = dx * dx + dy * dy + dz * dz;
        add_pair<T, KID, CHECK>(slot[r], dx, dy, dz, r2, sv.q, kp);
      }
    }
  }
}

// A target farther than this from a chunk's bounding box along some axis
// meets every source of it at r2 > clearance^2: 1e-36 > FLT_MIN in f32,
// 1e-300 > 0 in f64, so the predicate cannot fire.
__device__ __forceinline__ float clearance(float) { return 1e-18f; }
__device__ __forceinline__ double clearance(double) { return 1e-150; }
__device__ __forceinline__ float largest(float) { return FLT_MAX; }
__device__ __forceinline__ double largest(double) { return DBL_MAX; }

template <typename T, int KID, bool PERIODIC, bool KAHAN>
__global__ void __launch_bounds__(kThreads, min_blocks(sizeof(T)))
field_kernel(const int* __restrict__ idx, const T* __restrict__ par,
             const T* __restrict__ tgt, const T* __restrict__ src,
             const T* __restrict__ q, const int* __restrict__ tgt_count,
             const int* __restrict__ src_count, T* __restrict__ out, int S,
             int NB, int m, int C, int P, T Lx, T Ly, T Lz) {
  // the row in the stacked (W * B) slab, and the system's first cluster
  const int b = blockIdx.z * gridDim.x + blockIdx.x;
  const int cbase = blockIdx.z * C;
  const int i0 = blockIdx.y * kTile;
  const int nt = tgt_count ? min(max(tgt_count[b], 0), NB) : NB;
  T* orow = out + static_cast<size_t>(b) * NB * kOut;
  if (i0 >= nt) {  // no real target in this tile: the whole block leaves
    field::zero_tile<T, kTile>(orow, i0, NB);
    return;
  }

  __shared__ __align__(16) T stage[kWarps][4 * kChunk];
  __shared__ T tot[kWarps][kOut][kTile];  // each warp's running totals

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T tx[kPerThread], ty[kPerThread], tz[kPerThread];
  T comp[kPerThread][kOut];  // Kahan only: the totals' compensations
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
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      tot[warp][k][lane + 32 * r] = T(0);
      comp[r][k] = T(0);
    }
  }
  const field::Params<T, KID> kp(par + static_cast<size_t>(blockIdx.z) * P);

  T* buf = stage[warp];
  const int* row = idx + static_cast<size_t>(b) * S;
  int g = 0;  // chunk counter over the row, the same in every warp
  for (int s = 0; s < S; ++s) {
    const int c = row[s];  // the same for every thread: uniform branch
    Field<T> slot[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) zero(slot[r]);
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
        // the chunk's bounding box, padding included (a padded source sits
        // at the origin with q = 0 and is swept like the others)
        T lo[3], hi[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          lo[k] = largest(T(0));
          hi[k] = -largest(T(0));
        }
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
          const T p3[3] = {px, py, pz};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            lo[k] = fmin(lo[k], p3[k]);
            hi[k] = fmax(hi[k], p3[k]);
          }
        }
        // the predicate only where a lane's target lies within the
        // clearance of the box (its own leaf, in MD); a fold can bring
        // any source near, so a periodic box keeps it everywhere
        bool clear = !PERIODIC;
        if (!PERIODIC) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              lo[k] = fmin(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], o));
              hi[k] = fmax(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], o));
            }
          }
#pragma unroll
          for (int r = 0; r < kPerThread; ++r) {
            const T gap = fmax(fmax(fmax(lo[0] - tx[r], tx[r] - hi[0]),
                                    fmax(lo[1] - ty[r], ty[r] - hi[1])),
                               fmax(lo[2] - tz[r], tz[r] - hi[2]));
            clear = clear && gap > clearance(T(0));
          }
        }
        __syncwarp();
        if (clear)
          sweep_chunk<T, KID, PERIODIC, false>(buf, padded, tx, ty, tz, slot,
                                               kp, Lx, Ly, Lz);
        else
          sweep_chunk<T, KID, PERIODIC, true>(buf, padded, tx, ty, tz, slot,
                                              kp, Lx, Ly, Lz);
      }
    }
    // the slot's sums into this warp's totals, once a slot (a lane owns
    // its targets' entries: no barrier)
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int t = lane + 32 * r;
      const T v[kOut] = {slot[r].p, slot[r].x, slot[r].y, slot[r].z};
#pragma unroll
      for (int k = 0; k < kOut; ++k)
        field::add_total<T, KAHAN>(tot[warp][k][t], comp[r][k], v[k]);
    }
  }
  field::write_tile<T, KAHAN, kTile>(tot, orow, i0, nt, NB);
}

struct Args {
  const int* idx;
  const int* tgt_count;
  const int* src_count;
  int B, S, NB, m, W, C, P;
};

template <typename T, int KID, bool PERIODIC, bool KAHAN>
void launch_one(const Args& a, const T* par, const T* tgt, const T* src,
                const T* q, T* out, T Lx, T Ly, T Lz, cudaStream_t stream) {
  const dim3 grid(a.B, (a.NB + kTile - 1) / kTile, a.W);
  field_kernel<T, KID, PERIODIC, KAHAN><<<grid, kThreads, 0, stream>>>(
      a.idx, par, tgt, src, q, a.tgt_count, a.src_count, out, a.S, a.NB, a.m,
      a.C, a.P, Lx, Ly, Lz);
}

template <typename T, int KID>
void launch_kid(const Args& a, const T* par, const T* tgt, const T* src,
                const T* q, T* out, int periodic, int kahan, T Lx, T Ly, T Lz,
                cudaStream_t st) {
  if (periodic) {
    if (kahan)
      launch_one<T, KID, true, true>(a, par, tgt, src, q, out, Lx, Ly, Lz, st);
    else
      launch_one<T, KID, true, false>(a, par, tgt, src, q, out, Lx, Ly, Lz, st);
  } else {
    if (kahan)
      launch_one<T, KID, false, true>(a, par, tgt, src, q, out, Lx, Ly, Lz, st);
    else
      launch_one<T, KID, false, false>(a, par, tgt, src, q, out, Lx, Ly, Lz,
                                       st);
  }
}

// A base library launches the built-ins, a user library kUser alone;
// any other id is refused.
template <typename T>
int launch(const Args& a, const T* par, const T* tgt, const T* src,
           const T* q, T* out, int kernel_id, int periodic, int kahan, T Lx,
           T Ly, T Lz, cudaStream_t st) {
#ifdef REPRO_USER_KERNEL
  if (kernel_id != kUser) return static_cast<int>(cudaErrorInvalidValue);
#else
  if (kernel_id != kCoulomb && kernel_id != kYukawa)
    return static_cast<int>(cudaErrorInvalidValue);
#endif
  if (a.W > 0 && a.B > 0 && a.NB > 0) {
#ifdef REPRO_USER_KERNEL
    launch_kid<T, kUser>(a, par, tgt, src, q, out, periodic, kahan, Lx, Ly,
                         Lz, st);
#else
    if (kernel_id == kCoulomb)
      launch_kid<T, kCoulomb>(a, par, tgt, src, q, out, periodic, kahan, Lx,
                              Ly, Lz, st);
    else
      launch_kid<T, kYukawa>(a, par, tgt, src, q, out, periodic, kahan, Lx,
                             Ly, Lz, st);
#endif
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers,
// `stream` the caller's cudaStream_t; the shapes are those of bc_eval_*
// (a leading W on every operand, par (W, P)) and out is (W, B, NB, 4);
// tgt_count (W, B) and src_count (W, C) may be null (every target slot and
// every source point is real). The launch is asynchronous and the return
// value is cudaGetLastError() right after it (0 = launched).
extern "C" int bcf_eval_f32(const int* idx, const float* par,
                            const float* tgt, const float* src,
                            const float* q, const int* tgt_count,
                            const int* src_count, float* out, int B, int S,
                            int NB, int m, int W, int C, int P, int kernel_id,
                            int periodic, int kahan, double Lx, double Ly,
                            double Lz, void* stream) {
  const Args a{idx, tgt_count, src_count, B, S, NB, m, W, C, P};
  return launch<float>(a, par, tgt, src, q, out, kernel_id, periodic, kahan,
                       static_cast<float>(Lx), static_cast<float>(Ly),
                       static_cast<float>(Lz),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int bcf_eval_f64(const int* idx, const double* par,
                            const double* tgt, const double* src,
                            const double* q, const int* tgt_count,
                            const int* src_count, double* out, int B, int S,
                            int NB, int m, int W, int C, int P,
                            int kernel_id, int periodic, int kahan, double Lx,
                            double Ly, double Lz, void* stream) {
  const Args a{idx, tgt_count, src_count, B, S, NB, m, W, C, P};
  return launch<double>(a, par, tgt, src, q, out, kernel_id, periodic, kahan,
                        Lx, Ly, Lz, static_cast<cudaStream_t>(stream));
}

// The launch geometry, for the wrapper's grid check and the accounting of
// swept pairs: 0 -> targets per block, 1 -> the source unroll.
extern "C" int bcf_geometry(int what) { return what == 0 ? kTile : kUnroll; }
