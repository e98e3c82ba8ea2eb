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
// r^-3. out is (B, NB, 4): phi, then the three gradient components.
//
// It takes the grid, the -1 sentinels and the count contract of
// batch_cluster.cu, and that kernel's design (count-aware tiles, one
// (x, y, z, q) record per staged source, 4 targets per lane, 4 warps
// splitting a row's chunks, the slot loop inside the block); see its
// header. It is its own source file so that the potential kernel's
// registers and instructions do not move. What bounds it on the H100:
// fp32 issue (about 20 operations a pair: 3 sub, 5 for r2, the rsqrt, 2
// for phi, 3 mul and 3 fma for the gradient) and one MUFU a pair; the
// bytes are a few per target and per cluster, as for the potential.
//
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
//     rint(d / L) half to even, to the last bit (see fold());
//   - f64 keeps IEEE sqrt and division.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = 32 * kWarps;      // 128
constexpr int kPerThread = 4;              // targets per lane
constexpr int kTile = 32 * kPerThread;     // 128 targets per block
constexpr int kChunk = 128;                // sources per staged chunk
constexpr int kUnroll = 4;                 // inner-loop unroll
constexpr int kOut = 4;                    // phi, gx, gy, gz
static_assert(kTile == kThreads, "the final combine maps thread t to target t");
static_assert(kChunk % kUnroll == 0, "a chunk rounds up inside its buffer");

constexpr int kCoulomb = 0;
constexpr int kYukawa = 1;

// Blocks per SM the register budget is sized for: 6 x 4 warps of f32
// (<= 80 registers a thread: 4 targets x (3 coordinates + 4 slot sums +
// 4 totals) live across the loop), 3 x 4 warps of f64.
constexpr int min_blocks(int dtype_size) { return dtype_size == 4 ? 6 : 3; }

// MUFU.RSQ on its own: a denormal x reads as 0 and gives +inf.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
struct Field {
  T p, x, y, z;  // phi and the gradient
};

template <typename T>
__device__ __forceinline__ void zero(Field<T>& f) {
  f.p = f.x = f.y = f.z = T(0);
}

// f += (G, 2 G'(r2) d) q, or nothing where r2 is 0 (f32: below FLT_MIN).
template <typename T, int KID>
__device__ __forceinline__ void add_pair(Field<T>& f, T dx, T dy, T dz, T r2,
                                         T q, T kappa) {
  if constexpr (sizeof(T) == 4) {
    const float rinv = rsqrt_ftz(r2);
    const float g = KID == kCoulomb ? rinv : expf(-kappa * (r2 * rinv)) * rinv;
    const float gq = g * q;
    const float c = KID == kCoulomb ? rinv * rinv
                                    : fmaf(kappa, r2 * rinv, 1.0f) * rinv * rinv;
    const float s = gq * c;
    if (r2 >= FLT_MIN) {
      f.p = fmaf(g, q, f.p);
      f.x = fmaf(-s, dx, f.x);
      f.y = fmaf(-s, dy, f.y);
      f.z = fmaf(-s, dz, f.z);
    }
  } else {
    if (!(r2 > 0.0)) return;
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

template <typename T, int KID, bool PERIODIC, bool KAHAN>
__global__ void __launch_bounds__(kThreads, min_blocks(sizeof(T)))
field_kernel(const int* __restrict__ idx, const T* __restrict__ par,
             const T* __restrict__ tgt, const T* __restrict__ src,
             const T* __restrict__ q, const int* __restrict__ tgt_count,
             const int* __restrict__ src_count, T* __restrict__ out, int S,
             int NB, int m, T Lx, T Ly, T Lz) {
  const int b = blockIdx.x;
  const int i0 = blockIdx.y * kTile;
  const int nt = tgt_count ? min(max(tgt_count[b], 0), NB) : NB;
  T* orow = out + static_cast<size_t>(b) * NB * kOut;
  if (i0 >= nt) {  // no real target in this tile: the whole block leaves
    const int i = i0 + threadIdx.x;
    if (i < NB) {
#pragma unroll
      for (int c = 0; c < kOut; ++c) orow[i * kOut + c] = T(0);
    }
    return;
  }

  __shared__ __align__(16) T stage[kWarps][4 * kChunk];
  __shared__ T part[kWarps][kOut][kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T tx[kPerThread], ty[kPerThread], tz[kPerThread];
  Field<T> acc[kPerThread], comp[kPerThread];
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
    zero(acc[r]);
    zero(comp[r]);
  }
  const T kappa = KID == kYukawa ? par[0] : T(0);
  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;

  T* buf = stage[warp];
  const int* row = idx + static_cast<size_t>(b) * S;
  int g = 0;  // chunk counter over the row, the same in every warp
  for (int s = 0; s < S; ++s) {
    const int c = row[s];  // the same for every thread: uniform branch
    Field<T> slot[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) zero(slot[r]);
    if (c >= 0) {
      const int n = src_count ? min(max(src_count[c], 0), m) : m;
      const T* cp = src + static_cast<size_t>(c) * m * 3;
      const T* cq = q + static_cast<size_t>(c) * m;
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
        }
        __syncwarp();
        for (int t = 0; t < padded; t += kUnroll) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const Src<T> sv = load_src(buf, t + u);
#pragma unroll
            for (int r = 0; r < kPerThread; ++r) {
              T dx = tx[r] - sv.x, dy = ty[r] - sv.y, dz = tz[r] - sv.z;
              if (PERIODIC) {
                dx = fold(dx, Lx, iLx);
                dy = fold(dy, Ly, iLy);
                dz = fold(dz, Lz, iLz);
              }
              const T r2 = dx * dx + dy * dy + dz * dz;
              add_pair<T, KID>(slot[r], dx, dy, dz, r2, sv.q, kappa);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (KAHAN) {
        kahan_add(acc[r].p, comp[r].p, slot[r].p);
        kahan_add(acc[r].x, comp[r].x, slot[r].x);
        kahan_add(acc[r].y, comp[r].y, slot[r].y);
        kahan_add(acc[r].z, comp[r].z, slot[r].z);
      } else {
        acc[r].p += slot[r].p;
        acc[r].x += slot[r].x;
        acc[r].y += slot[r].y;
        acc[r].z += slot[r].z;
      }
    }
  }

  // The four warps' partial sums of each target, added in warp order by
  // the thread that owns the target's output slot.
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int t = lane + 32 * r;
    part[warp][0][t] = acc[r].p;
    part[warp][1][t] = acc[r].x;
    part[warp][2][t] = acc[r].y;
    part[warp][3][t] = acc[r].z;
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int i = i0 + t;
  if (i < NB) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      T sum = T(0);
      if (i < nt) {
        T cmp = T(0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if (KAHAN)
            kahan_add(sum, cmp, part[w][k][t]);
          else
            sum += part[w][k][t];
        }
      }
      orow[i * kOut + k] = sum;
    }
  }
}

struct Args {
  const int* idx;
  const int* tgt_count;
  const int* src_count;
  int B, S, NB, m;
};

template <typename T, int KID, bool PERIODIC, bool KAHAN>
void launch_one(const Args& a, const T* par, const T* tgt, const T* src,
                const T* q, T* out, T Lx, T Ly, T Lz, cudaStream_t stream) {
  const dim3 grid(a.B, (a.NB + kTile - 1) / kTile);
  field_kernel<T, KID, PERIODIC, KAHAN><<<grid, kThreads, 0, stream>>>(
      a.idx, par, tgt, src, q, a.tgt_count, a.src_count, out, a.S, a.NB, a.m,
      Lx, Ly, Lz);
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

template <typename T>
int launch(const Args& a, const T* par, const T* tgt, const T* src,
           const T* q, T* out, int kernel_id, int periodic, int kahan, T Lx,
           T Ly, T Lz, cudaStream_t st) {
  if (kernel_id != kCoulomb && kernel_id != kYukawa)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B > 0 && a.NB > 0) {
    if (kernel_id == kCoulomb)
      launch_kid<T, kCoulomb>(a, par, tgt, src, q, out, periodic, kahan, Lx,
                              Ly, Lz, st);
    else
      launch_kid<T, kYukawa>(a, par, tgt, src, q, out, periodic, kahan, Lx,
                             Ly, Lz, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers,
// `stream` the caller's cudaStream_t; tgt_count (B,) and src_count (C,)
// may be null (every target slot and every source point is real); out is
// (B, NB, 4). The launch is asynchronous and the return value is
// cudaGetLastError() right after it (0 = launched).
extern "C" int bcf_eval_f32(const int* idx, const float* par,
                            const float* tgt, const float* src,
                            const float* q, const int* tgt_count,
                            const int* src_count, float* out, int B, int S,
                            int NB, int m, int kernel_id, int periodic,
                            int kahan, double Lx, double Ly, double Lz,
                            void* stream) {
  const Args a{idx, tgt_count, src_count, B, S, NB, m};
  return launch<float>(a, par, tgt, src, q, out, kernel_id, periodic, kahan,
                       static_cast<float>(Lx), static_cast<float>(Ly),
                       static_cast<float>(Lz),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int bcf_eval_f64(const int* idx, const double* par,
                            const double* tgt, const double* src,
                            const double* q, const int* tgt_count,
                            const int* src_count, double* out, int B, int S,
                            int NB, int m, int kernel_id, int periodic,
                            int kahan, double Lx, double Ly, double Lz,
                            void* stream) {
  const Args a{idx, tgt_count, src_count, B, S, NB, m};
  return launch<double>(a, par, tgt, src, q, out, kernel_id, periodic, kahan,
                        Lx, Ly, Lz, static_cast<cudaStream_t>(stream));
}

// The launch geometry, for the wrapper's grid check and the accounting of
// swept pairs: 0 -> targets per block, 1 -> the source unroll.
extern "C" int bcf_geometry(int what) { return what == 0 ? kTile : kUnroll; }
