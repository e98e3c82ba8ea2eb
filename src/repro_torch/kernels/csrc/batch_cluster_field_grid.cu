// Batch-cluster FIELD kernel over Chebyshev grids for Hopper (sm_90a): the
// approximation lane of the forces (Eq. 11 and its gradient), with each
// cluster's sources taken as the tensor-product grid they are.
//
// Not a port of a TPU kernel: like batch_cluster_field.cu it is the
// card's counterpart of the reference's forces path (three forward JVPs
// through XLA, src/repro/core/eval.py:_target_gradient). It computes what
// that generic field kernel computes on the points of
// core/cheby.py:cluster_grid, from the factored inputs:
//
//   y_c(k1,k2,k3) = (s_c0[k1], s_c1[k2], s_c2[k3]),  q = q_hat[c, k],
//   k = (k1 (n+1) + k2) (n+1) + k3 (k3 fastest)
//   phi[b, i] = sum_s [idx[b,s] >= 0] sum_k G(r2) q_ck
//   g[b, i]   = sum_s [idx[b,s] >= 0] sum_k 2 G'(r2) d q_ck,
//   phi = g = 0 for i >= tgt_count[b] (NB without counts),
//
// nodes (C, 3, n+1) being ops._cluster_nodes, bitwise the coordinates
// cluster_grid builds. out is (B, NB, 4): phi, then the gradient. Every
// operand may carry a leading systems axis W (blockIdx.z = system, its
// own parameter row), as in batch_cluster.cu.
//
// The structure: for one target and one cluster, d_x depends on k1 only,
// d_y on k2 only and d_z on k3 only. So
//   r2 = (d_x[k1]^2 + d_y[k2]^2) + d_z[k3]^2, one fma a pair,
//   g_x = -sum_k1 d_x[k1] sum_{k2,k3} s,  g_y = -sum_{k1,k2} d_y[k2] sum_k3 s,
//   g_z = -sum_k d_z[k3] s,  s = -2 G'(r2) q,
// and in a periodic box each minimum-image fold runs once per axis point,
// not three times per pair. A pair costs the fma for r2, the MUFU rsqrt,
// three multiplies (G q, rinv^2, s), the phi fma, the row sum's add and
// the g_z fma: 8 instructions against the generic kernel's 15.5 (which
// takes 3 subtractions, 3 for r2, 3 gradient fmas and the predicate a
// pair).
//
// What bounds it on the H100: the issue rate, with the SFU close below.
// One MUFU a pair at 16 a clock per SM is 8 issue cycles a warp-pair on
// a scheduler, against ~9.7 instructions a pair with a plane's staging
// and setup; measured, moving rsqrts to the FMA pipe made the kernel
// slower, so the SFU is not what it waits on (tools/field_variants.py).
// Bytes play no part (a cluster's q_hat is 729 values at degree 8, read
// once per block that sweeps it).
//
// Design:
//   - one block of 4 warps per (batch row, tile of 32 PER targets); PER
//     targets a lane is a compile-time function of n+1 and the type, so
//     each target's d_z row lives in registers (n+1 values);
//   - the warps split a row's planes (k1) round robin over the whole
//     row, as the generic kernel splits its chunks: per cluster 9 planes
//     over 4 warps would leave a warp idle a quarter of the time;
//   - a warp meeting a cluster stages its nodes and builds each lane's
//     d_y (shared memory, a column per lane) and d_z (registers), folded
//     with the tie-exact fold of field_common.cuh; per plane it stages
//     that plane of q_hat (rows padded to 16 bytes, read as broadcast
//     vector loads) and sweeps the rows with k3 unrolled;
//   - r2 >= FLT_MIN (r2 > 0 in f64) predicates all four sums, so a
//     target exactly on a grid point adds 0, as the reference's G(0) = 0
//     gives. The predicate costs an instruction a pair, and only a plane
//     whose x a target shares can hold a hit (r2 >= d_x^2): a plane with
//     d_x^2 >= FLT_MIN for each of the lane's targets runs unpredicated,
//     with the same sums; f32 takes MUFU.RSQ, f64 IEEE sqrt and division;
//   - the slot's sums live in registers and are added to each warp's
//     running totals in shared memory once a slot (Kahan compensated,
//     the compensation in shared memory too, when asked), then the warps'
//     totals in warp order: the count contract and the -1 sentinels of
//     the generic kernel;
//   - n+1 is a template parameter for degrees 1-14 (n+1 = 2..15); any
//     other degree runs grid_field_rt_kernel (below), whose n+1 is a
//     run-time argument and whose shared memory has a fixed size;
//   - a user kernel takes kUser (see batch_cluster.cu): g and c = 2 G'
//     from repro_user_gc on the masked r2, s = -c q. A user library
//     instantiates kUser alone, and for one n+1, REPRO_USER_N1, the
//     degree it is built for at first use: all 14 would take as long as
//     half of this file's base build. REPRO_USER_N1=0 (the build for any
//     degree from 15 up) instantiates the runtime-degree kernel alone.

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
using field::rsqrt_ftz;

constexpr int kMaxN1 = 15;

// The n+1 this library instantiates: 2..15, or a user library's one
// (none for REPRO_USER_N1=0). Every library has the runtime-degree
// kernel too.
constexpr bool instantiated(int n1) {
#ifdef REPRO_USER_N1
  return n1 == REPRO_USER_N1;
#else
  return n1 >= 2;
#endif
}

// Launch geometry of one (T, n+1) instantiation.
template <typename T, int N1>
struct GridGeo {
  // targets a lane: two where two d_z rows fit the register budget
  static constexpr int PER = sizeof(T) == 4 && N1 <= 9 ? 2 : 1;
  static constexpr int TILE = 32 * PER;                // targets a block
  static constexpr int VN = 16 / static_cast<int>(sizeof(T));
  static constexpr int ROW = (N1 + VN - 1) / VN * VN;  // staged row stride
  // blocks per SM the registers are sized for (f32: <= 96 a thread, the
  // rows of a plane unrolled; at 8 blocks and 64 registers fewer pairs
  // stay in flight and the lane ran 9% slower, tools/field_variants.py)
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 5 : 3;
};

// One staged row of q_hat (ROW values, the first N1 real) by 16-byte
// loads at one address for the whole warp (broadcast).
template <int ROW>
__device__ __forceinline__ void load_row(const float* p, float (&v)[ROW]) {
#pragma unroll
  for (int j = 0; j < ROW; j += 4) {
    const float4 w = reinterpret_cast<const float4*>(p)[j / 4];
    v[j] = w.x;
    v[j + 1] = w.y;
    v[j + 2] = w.z;
    v[j + 3] = w.w;
  }
}

template <int ROW>
__device__ __forceinline__ void load_row(const double* p, double (&v)[ROW]) {
#pragma unroll
  for (int j = 0; j < ROW; j += 2) {
    const double2 w = reinterpret_cast<const double2*>(p)[j / 2];
    v[j] = w.x;
    v[j + 1] = w.y;
  }
}

// One grid pair: r2 = ab + dz^2; phi += G q, the row's sum += s and
// gz += s dz with s = -2 G'(r2) q. CHECK predicates the sums on r2 >=
// FLT_MIN (r2 > 0 in f64), so an exact hit adds nothing. The expressions
// are the generic kernel's add_pair.
template <typename T, int KID, bool CHECK>
__device__ __forceinline__ void grid_pair(T ab, T dz, T q,
                                          const field::Params<T, KID>& kp,
                                          T& p, T& row, T& gz) {
  if constexpr (KID == kUser) {
    const T r2 = fma(dz, dz, ab);
    const bool pos = !CHECK || field::nonzero(r2);
    T g, c;
    repro_user_gc<T>(pos ? r2 : T(1), kp.p, &g, &c);
    if (pos) {
      const T s = -(c * q);
      p = fma(g, q, p);
      row += s;
      gz = fma(s, dz, gz);
    }
  } else if constexpr (sizeof(T) == 4) {
    const float kappa = kp.kappa;
    const float r2 = fmaf(dz, dz, ab);
    const float rinv = rsqrt_ftz(r2);
    const float g = KID == kCoulomb ? rinv : expf(-kappa * (r2 * rinv)) * rinv;
    const float gq = g * q;
    const float c = KID == kCoulomb ? rinv * rinv
                                    : fmaf(kappa, r2 * rinv, 1.0f) * rinv * rinv;
    const float s = gq * c;
    if (!CHECK || r2 >= FLT_MIN) {
      p = fmaf(g, q, p);
      row += s;
      gz = fmaf(s, dz, gz);
    }
  } else {
    const double kappa = kp.kappa;
    const double r2 = fma(dz, dz, ab);
    if (CHECK && !(r2 > 0.0)) return;
    const double r = sqrt(r2);
    const double g = KID == kCoulomb ? 1.0 / r : exp(-kappa * r) / r;
    const double rinv = KID == kCoulomb ? g : 1.0 / r;
    p = p + g * q;
    const double s = (KID == kCoulomb ? g : (1.0 + kappa * r) * g) * q *
                     (rinv * rinv);
    row = row + s;
    gz = fma(s, dz, gz);
  }
}

// True where no pair of a plane can be an exact hit: r2 >= d_x^2 on the
// whole plane (the adds are of squares), so d_x^2 >= FLT_MIN (> 0 in
// f64) passes every pair's predicate.
__device__ __forceinline__ bool clear_of_hits(float a) { return a >= FLT_MIN; }
__device__ __forceinline__ bool clear_of_hits(double a) { return a > 0.0; }

// Row k2 of the plane in hand for a lane's P targets: its q_hat
// (broadcast loads) and per target d_y (its column of yd), n+1 pairs with
// k3 unrolled, then g_y += d_y times the row's sum, and the plane's sum
// for g_x.
template <typename T, int N1, int KID, int P, int R, bool CHECK>
__device__ __forceinline__ void sweep_row(int k2, const T* qp,
                                          const T (*yd)[P][32], int lane,
                                          const T (&a)[P],
                                          const T (&dz)[P][N1],
                                          const field::Params<T, KID>& kp,
                                          T (&sp)[P], T (&sy)[P],
                                          T (&sz)[P], T (&pl)[P]) {
  T qv[R];
  load_row<R>(qp + k2 * R, qv);
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const T dy = yd[k2][r][lane];
    const T ab = fma(dy, dy, a[r]);
    T rs = T(0);
#pragma unroll
    for (int k3 = 0; k3 < N1; ++k3)
      grid_pair<T, KID, CHECK>(ab, dz[r][k3], qv[k3], kp, sp[r], rs, sz[r]);
    sy[r] = fma(dy, rs, sy[r]);
    pl[r] += rs;
  }
}

// The rows of one plane. The unchecked sweep (every plane but those a
// target shares in x) unrolls all of them, for the pairs in flight and
// the loop and load overhead; the rare checked one does not, to keep the
// code and the build small. Nor does a user kernel's: its generated G and
// 2 G' can be many times the built-ins' instructions, and unrolled rows
// multiply its code and its build time with them.
template <typename T, int N1, int KID, int P, int R, bool CHECK>
__device__ __forceinline__ void sweep_plane(const T* qp, const T (*yd)[P][32],
                                            int lane, const T (&a)[P],
                                            const T (&dz)[P][N1],
                                            const field::Params<T, KID>& kp,
                                            T (&sp)[P], T (&sy)[P],
                                            T (&sz)[P], T (&pl)[P]) {
  if constexpr (CHECK || KID == kUser) {
#pragma unroll 1
    for (int k2 = 0; k2 < N1; ++k2)
      sweep_row<T, N1, KID, P, R, true>(k2, qp, yd, lane, a, dz, kp, sp, sy,
                                        sz, pl);
  } else {
#pragma unroll
    for (int k2 = 0; k2 < N1; ++k2)
      sweep_row<T, N1, KID, P, R, false>(k2, qp, yd, lane, a, dz, kp, sp,
                                         sy, sz, pl);
  }
}

// The box and the Kahan compensation are run-time flags: the fold runs
// once per axis point and the compensated add once a slot, outside the
// pair loop, so a template of each would only multiply the build (14
// degrees x 2 types x 2 kernels).
template <typename T, int N1, int KID>
__global__ void __launch_bounds__(kThreads, GridGeo<T, N1>::MIN_BLOCKS)
grid_field_kernel(const int* __restrict__ idx, const T* __restrict__ par,
                  const T* __restrict__ tgt, const T* __restrict__ nodes,
                  const T* __restrict__ qhat,
                  const int* __restrict__ tgt_count, T* __restrict__ out,
                  int S, int NB, int C, int np, bool periodic, bool kahan,
                  T Lx, T Ly, T Lz) {
  using G = GridGeo<T, N1>;
  constexpr int P = G::PER, TILE = G::TILE, R = G::ROW, N2 = N1 * N1;
  // systems axis (blockIdx.z): the row in the stacked (W * B) slab, and
  // the system's first cluster; np is the parameter row's length
  const int b = blockIdx.z * gridDim.x + blockIdx.x;
  const int cbase = blockIdx.z * C;
  const int i0 = blockIdx.y * TILE;
  const int nt = tgt_count ? min(max(tgt_count[b], 0), NB) : NB;
  T* orow = out + static_cast<size_t>(b) * NB * kOut;
  if (i0 >= nt) {  // no real target in this tile: the whole block leaves
    field::zero_tile<T, TILE>(orow, i0, NB);
    return;
  }

  __shared__ __align__(16) T plane[kWarps][N1 * R];  // q_hat[c, k1, :, :]
  __shared__ T axis[kWarps][3 * N1];                 // the cluster's nodes
  __shared__ T ydisp[kWarps][N1][P][32];             // each lane's d_y
  __shared__ T tot[kWarps][kOut][TILE];              // running totals
  __shared__ T comp[kWarps][kOut][TILE];             // their compensation

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // target coordinates, 0 past the real count; y and z are read again
  // when a cluster begins, so only x stays in a register
  const int nreal = nt - i0;
  const T* tb = tgt + (static_cast<size_t>(b) * NB + i0 + lane) * 3;
  auto coord = [&](int r, int k) {
    return lane + 32 * r < nreal ? tb[96 * r + k] : T(0);
  };
  T tx[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {  // lanes own neighbouring targets
    tx[r] = coord(r, 0);
#pragma unroll
    for (int k = 0; k < kOut; ++k)
      tot[warp][k][lane + 32 * r] = comp[warp][k][lane + 32 * r] = T(0);
  }
  const field::Params<T, KID> kp(par + static_cast<size_t>(blockIdx.z) * np);
  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;

  T* qp = plane[warp];
  T* ax = axis[warp];
  const int* row = idx + static_cast<size_t>(b) * S;
  int g = 0;  // plane counter over the row, the same in every warp
  for (int s = 0; s < S; ++s) {
    const int c = row[s];  // the same for every thread: uniform branch
    // this slot's sums: phi and sum s d per axis
    T sp[P], sx[P], sy[P], sz[P];
#pragma unroll
    for (int r = 0; r < P; ++r) sp[r] = sx[r] = sy[r] = sz[r] = T(0);
    // the cluster's planes g .. g + N1 - 1 go round robin to the warps
    int k1 = ((warp - g) % kWarps + kWarps) % kWarps;
    if (c >= 0 && k1 < N1) {
      const size_t cg = static_cast<size_t>(cbase + c);
      const T* cq = qhat + cg * N1 * N2;
      __syncwarp();  // the previous cluster's nodes are consumed
      for (int t = lane; t < 3 * N1; t += 32) ax[t] = nodes[cg * 3 * N1 + t];
      __syncwarp();
      T dz[P][N1];
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const T ty = coord(r, 1), tz = coord(r, 2);
#pragma unroll
        for (int k = 0; k < N1; ++k) {
          T dy = ty - ax[N1 + k], d3 = tz - ax[2 * N1 + k];
          if (periodic) {
            dy = field::fold(dy, Ly, iLy);
            d3 = field::fold(d3, Lz, iLz);
          }
          ydisp[warp][k][r][lane] = dy;
          dz[r][k] = d3;
        }
      }
      for (; k1 < N1; k1 += kWarps) {
        __syncwarp();  // this warp's previous plane is consumed
        for (int t = lane; t < N2; t += 32)
          qp[(t / N1) * R + t % N1] = cq[static_cast<size_t>(k1) * N2 + t];
        __syncwarp();
        T dx[P], a[P], pl[P];
        bool clear = true;
#pragma unroll
        for (int r = 0; r < P; ++r) {
          dx[r] = tx[r] - ax[k1];
          if (periodic) dx[r] = field::fold(dx[r], Lx, iLx);
          a[r] = dx[r] * dx[r];
          pl[r] = T(0);
          clear = clear && clear_of_hits(a[r]);
        }
        // the predicate only where a target shares this plane's x
        if (clear)
          sweep_plane<T, N1, KID, P, R, false>(qp, ydisp[warp], lane, a, dz,
                                               kp, sp, sy, sz, pl);
        else
          sweep_plane<T, N1, KID, P, R, true>(qp, ydisp[warp], lane, a, dz,
                                              kp, sp, sy, sz, pl);
#pragma unroll
        for (int r = 0; r < P; ++r) sx[r] = fma(dx[r], pl[r], sx[r]);
      }
    }
    if (c >= 0) g += N1;
    // the slot's sums into this warp's totals (g = -sum s d), once a slot
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int t = lane + 32 * r;
      const T v[kOut] = {sp[r], -sx[r], -sy[r], -sz[r]};
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        if (kahan)
          field::add_total<T, true>(tot[warp][k][t], comp[warp][k][t], v[k]);
        else
          field::add_total<T, false>(tot[warp][k][t], comp[warp][k][t],
                                     v[k]);
      }
    }
  }
  if (kahan)
    field::write_tile<T, true, TILE>(tot, orow, i0, nt, NB);
  else
    field::write_tile<T, false, TILE>(tot, orow, i0, nt, NB);
}

// ---------------------------------------------------------------------------
// The runtime-degree path: n+1 an argument, for every n+1 the templates do
// not take (n+1 >= 16: degree 15 and above; a user library built for such
// a degree), and at any n+1 where an entry's force_runtime is set (the
// checks hold it against the templates). The template's static planes, node
// axes, d_y columns and register d_z rows grow with n+1 and pass the 48 KB
// of static shared memory at n+1 = 23 (f64). Here every table has a fixed
// size, whatever the degree:
//   - one target a lane (32 a block), 4 warps, the same grid, counts,
//     sentinels, systems axis, Kahan totals and warp-order sums;
//   - k3 is cut into blocks of at most kRtKB points. A warp's unit of work
//     is a (k3 block, plane k1) pair, planes fastest; the units of a
//     cluster go round robin to the warps, continuing over the row, as the
//     template's planes do. Per k3 block a lane writes its d_z column
//     (shared memory, kRtKB values) once; per plane it stages the plane's
//     part of q_hat in runs of kRtRB rows, and per row recomputes d_y
//     from the cluster's nodes (read from global memory, the same value
//     the template tabulates);
//   - the pair, the fold, the FLT_MIN / r2 > 0 predicate and the plane
//     test that skips it are the template's (grid_pair, clear_of_hits).
// At the templates' n+1 (forced: one k3 block) every sum runs in the
// template's order, so the result is the template's. Past them phi is
// summed by row (at most kRtKB pairs), the rows by unit and the units by
// slot, so that its rounding does not grow with the slot's (n+1)^3 pairs
// in one chain (at degrees 15 and 24 in f32 that chain left phi, where it
// cancels, several times farther from an f64 sum than the plain version's
// blocked sums); past one k3 block a row's sums are split at its edges.

constexpr int kRtKB = 16;  // k3 points a block
constexpr int kRtRB = 16;  // plane rows a staged run

template <typename T, int KID, bool CHECK>
__device__ __forceinline__ void sweep_row_rt(T ab, const T* dzc, const T* qr,
                                             int len, int lane,
                                             const field::Params<T, KID>& kp,
                                             T& sp, T& rs, T& sz) {
  for (int k = 0; k < len; ++k)
    grid_pair<T, KID, CHECK>(ab, dzc[k * 32 + lane], qr[k], kp, sp, rs, sz);
}

template <typename T, int KID>
__global__ void __launch_bounds__(kThreads)
grid_field_rt_kernel(const int* __restrict__ idx, const T* __restrict__ par,
                     const T* __restrict__ tgt, const T* __restrict__ nodes,
                     const T* __restrict__ qhat,
                     const int* __restrict__ tgt_count, T* __restrict__ out,
                     int S, int NB, int C, int np, int n1, bool periodic,
                     bool kahan, T Lx, T Ly, T Lz) {
  constexpr int TILE = 32;
  const int b = blockIdx.z * gridDim.x + blockIdx.x;
  const int cbase = blockIdx.z * C;
  const int i0 = blockIdx.y * TILE;
  const int nt = tgt_count ? min(max(tgt_count[b], 0), NB) : NB;
  T* orow = out + static_cast<size_t>(b) * NB * kOut;
  if (i0 >= nt) {  // no real target in this tile: the whole block leaves
    field::zero_tile<T, TILE>(orow, i0, NB);
    return;
  }

  __shared__ T plane[kWarps][kRtRB][kRtKB];  // a run of a plane's rows
  __shared__ T zcol[kWarps][kRtKB][32];      // each lane's d_z block
  __shared__ T tot[kWarps][kOut][TILE];      // running totals
  __shared__ T comp[kWarps][kOut][TILE];     // their compensation

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool real = lane < nt - i0;
  const T* tb = tgt + (static_cast<size_t>(b) * NB + i0 + lane) * 3;
  const T tx = real ? tb[0] : T(0), ty = real ? tb[1] : T(0),
          tz = real ? tb[2] : T(0);
#pragma unroll
  for (int k = 0; k < kOut; ++k)
    tot[warp][k][lane] = comp[warp][k][lane] = T(0);
  const field::Params<T, KID> kp(par + static_cast<size_t>(blockIdx.z) * np);
  const T iLx = T(1) / Lx, iLy = T(1) / Ly, iLz = T(1) / Lz;

  const size_t n2 = static_cast<size_t>(n1) * n1;
  const int units = n1 * ((n1 + kRtKB - 1) / kRtKB);  // per cluster
  const bool split = n1 > kMaxN1;  // phi by row, unit and slot
  T(*qp)[kRtKB] = plane[warp];
  T* zc = &zcol[warp][0][0];
  const int* row = idx + static_cast<size_t>(b) * S;
  int g = 0;  // unit counter over the row, the same in every warp
  for (int s = 0; s < S; ++s) {
    const int c = row[s];  // the same for every thread: uniform branch
    T sp = T(0), sx = T(0), sy = T(0), sz = T(0);
    int u = ((warp - g) % kWarps + kWarps) % kWarps;
    if (c >= 0 && u < units) {
      const size_t cg = static_cast<size_t>(cbase + c);
      const T* cq = qhat + cg * n2 * n1;
      const T* ax = nodes + cg * 3 * n1;
      int blk = -1;
      for (; u < units; u += kWarps) {
        const int b3 = u / n1, k1 = u - b3 * n1;
        const int k3a = b3 * kRtKB, len = min(kRtKB, n1 - k3a);
        if (b3 != blk) {  // this lane's d_z block (its own column)
          for (int k = 0; k < len; ++k) {
            T d3 = tz - ax[2 * n1 + k3a + k];
            if (periodic) d3 = field::fold(d3, Lz, iLz);
            zc[k * 32 + lane] = d3;
          }
          blk = b3;
        }
        T dx = tx - ax[k1];
        if (periodic) dx = field::fold(dx, Lx, iLx);
        const T a = dx * dx;
        // the predicate only where the target shares this plane's x
        const bool clear = clear_of_hits(a);
        T pl = T(0);
        T up = split ? T(0) : sp;  // this unit's phi (one block: the slot's)
        for (int k2a = 0; k2a < n1; k2a += kRtRB) {
          const int nr = min(kRtRB, n1 - k2a);
          __syncwarp();  // this warp's previous run is consumed
          for (int t = lane; t < nr * len; t += 32) {
            const int i = t / len, k = t - i * len;
            qp[i][k] = cq[(static_cast<size_t>(k1) * n1 + k2a + i) * n1 +
                          k3a + k];
          }
          __syncwarp();
          for (int i = 0; i < nr; ++i) {
            T dy = ty - ax[n1 + k2a + i];
            if (periodic) dy = field::fold(dy, Ly, iLy);
            const T ab = fma(dy, dy, a);
            T rs = T(0);
            T rp = split ? T(0) : up;  // this row's phi
            if (clear)
              sweep_row_rt<T, KID, false>(ab, zc, qp[i], len, lane, kp, rp,
                                          rs, sz);
            else
              sweep_row_rt<T, KID, true>(ab, zc, qp[i], len, lane, kp, rp,
                                         rs, sz);
            up = split ? up + rp : rp;
            sy = fma(dy, rs, sy);
            pl += rs;
          }
        }
        sp = split ? sp + up : up;
        sx = fma(dx, pl, sx);
      }
    }
    if (c >= 0) g += units;
    // the slot's sums into this warp's totals (g = -sum s d), once a slot
    const T v[kOut] = {sp, -sx, -sy, -sz};
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      if (kahan)
        field::add_total<T, true>(tot[warp][k][lane], comp[warp][k][lane],
                                  v[k]);
      else
        field::add_total<T, false>(tot[warp][k][lane], comp[warp][k][lane],
                                   v[k]);
    }
  }
  if (kahan)
    field::write_tile<T, true, TILE>(tot, orow, i0, nt, NB);
  else
    field::write_tile<T, false, TILE>(tot, orow, i0, nt, NB);
}

struct Args {
  const int* idx;
  const int* tgt_count;
  int B, S, NB, W, C, P;
  cudaStream_t stream;
};

template <typename T, int N1, int KID>
void launch_one(const Args& a, const T* par, const T* tgt, const T* nodes,
                const T* qhat, T* out, int periodic, int kahan, T Lx, T Ly,
                T Lz) {
  constexpr int TILE = GridGeo<T, N1>::TILE;
  const dim3 grid(a.B, (a.NB + TILE - 1) / TILE, a.W);
  grid_field_kernel<T, N1, KID><<<grid, kThreads, 0, a.stream>>>(
      a.idx, par, tgt, nodes, qhat, a.tgt_count, out, a.S, a.NB, a.C, a.P,
      periodic != 0, kahan != 0, Lx, Ly, Lz);
}

template <typename T, int KID>
void launch_one_rt(const Args& a, const T* par, const T* tgt,
                   const T* nodes, const T* qhat, T* out, int n1,
                   int periodic, int kahan, T Lx, T Ly, T Lz) {
  const dim3 grid(a.B, (a.NB + 31) / 32, a.W);
  grid_field_rt_kernel<T, KID><<<grid, kThreads, 0, a.stream>>>(
      a.idx, par, tgt, nodes, qhat, a.tgt_count, out, a.S, a.NB, a.C, a.P,
      n1, periodic != 0, kahan != 0, Lx, Ly, Lz);
}

// The runtime-degree launch of this library's kernel id.
template <typename T>
void dispatch_rt(int n1, const Args& a, const T* par, const T* tgt,
                 const T* nodes, const T* qhat, T* out, int kernel_id,
                 int periodic, int kahan, T Lx, T Ly, T Lz) {
#ifdef REPRO_USER_KERNEL
  launch_one_rt<T, kUser>(a, par, tgt, nodes, qhat, out, n1, periodic, kahan,
                          Lx, Ly, Lz);
#else
  if (kernel_id == kCoulomb)
    launch_one_rt<T, kCoulomb>(a, par, tgt, nodes, qhat, out, n1, periodic,
                               kahan, Lx, Ly, Lz);
  else
    launch_one_rt<T, kYukawa>(a, par, tgt, nodes, qhat, out, n1, periodic,
                              kahan, Lx, Ly, Lz);
#endif
}

// n+1 at run time -> the instantiation for it; false if there is none.
template <typename T, int N1 = 2>
bool dispatch(int n1, const Args& a, const T* par, const T* tgt,
              const T* nodes, const T* qhat, T* out, int kernel_id,
              int periodic, int kahan, T Lx, T Ly, T Lz) {
  if constexpr (N1 > kMaxN1) {
    return false;
  } else if constexpr (!instantiated(N1)) {
    return dispatch<T, N1 + 1>(n1, a, par, tgt, nodes, qhat, out, kernel_id,
                               periodic, kahan, Lx, Ly, Lz);
  } else {
    if (n1 != N1)
      return dispatch<T, N1 + 1>(n1, a, par, tgt, nodes, qhat, out,
                                 kernel_id, periodic, kahan, Lx, Ly, Lz);
#ifdef REPRO_USER_KERNEL
    launch_one<T, N1, kUser>(a, par, tgt, nodes, qhat, out, periodic, kahan,
                             Lx, Ly, Lz);
#else
    if (kernel_id == kCoulomb)
      launch_one<T, N1, kCoulomb>(a, par, tgt, nodes, qhat, out, periodic,
                                  kahan, Lx, Ly, Lz);
    else
      launch_one<T, N1, kYukawa>(a, par, tgt, nodes, qhat, out, periodic,
                                 kahan, Lx, Ly, Lz);
#endif
    return true;
  }
}

// Targets a block of the instantiation for n1, 0 if there is none.
template <typename T, int N1 = 2>
int tile(int n1) {
  if constexpr (N1 > kMaxN1) {
    return 0;
  } else {
    return n1 == N1 && instantiated(N1) ? GridGeo<T, N1>::TILE
                                        : tile<T, N1 + 1>(n1);
  }
}

// runtime: the runtime-degree kernel at any n1 >= 2; otherwise the
// instantiation for n1 where there is one, else the runtime-degree kernel.
template <typename T>
int launch(const Args& a, const T* par, const T* tgt, const T* nodes,
           const T* qhat, T* out, int n1, int kernel_id, int periodic,
           int kahan, T Lx, T Ly, T Lz, bool runtime) {
#ifdef REPRO_USER_KERNEL
  const bool known = kernel_id == kUser;
#else
  const bool known = kernel_id == kCoulomb || kernel_id == kYukawa;
#endif
  if (!known || n1 < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (a.W > 0 && a.B > 0 && a.NB > 0) {
    if (runtime || tile<T>(n1) == 0)
      dispatch_rt<T>(n1, a, par, tgt, nodes, qhat, out, kernel_id, periodic,
                     kahan, Lx, Ly, Lz);
    else
      dispatch<T>(n1, a, par, tgt, nodes, qhat, out, kernel_id, periodic,
                  kahan, Lx, Ly, Lz);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers,
// `stream` the caller's cudaStream_t; idx (W, B, S) int32 with -1
// sentinels; par (W, P); tgt (W, B, NB, 3); nodes (W, C, 3, n1); qhat
// (W, C, n1^3), k3 fastest; tgt_count (W, B) may be null (every target
// slot is real); out (W, B, NB, 4); W = 1 is a single system. n1 >= 2:
// the instantiations where this library has them (2..15 in a base
// library), the runtime-degree kernel elsewhere, and at any n1 where
// force_runtime is nonzero. The launch is asynchronous and the return
// value is cudaGetLastError() right after it (0 = launched).
#define BCFG_ENTRY(name, T)                                                   \
  extern "C" int name(const int* idx, const T* par, const T* tgt,             \
                      const T* nodes, const T* qhat, const int* tgt_count,    \
                      T* out, int B, int S, int NB, int n1, int W, int C,     \
                      int P, int kernel_id, int periodic, int kahan,          \
                      double Lx, double Ly, double Lz, int force_runtime,     \
                      void* stream) {                                         \
    const Args a{idx, tgt_count, B, S, NB, W, C, P,                           \
                 static_cast<cudaStream_t>(stream)};                          \
    return launch<T>(a, par, tgt, nodes, qhat, out, n1, kernel_id, periodic, \
                     kahan, static_cast<T>(Lx), static_cast<T>(Ly),           \
                     static_cast<T>(Lz), force_runtime != 0);                 \
  }
BCFG_ENTRY(bcfg_eval_f32, float)
BCFG_ENTRY(bcfg_eval_f64, double)

// 1 where a launch at n1 >= 2 that does not force the runtime-degree
// kernel runs it all the same (this library has no instantiation for
// n1); the wrapper counts its launches by this.
extern "C" int bcfg_runtime(int n1) {
  return n1 >= 2 && tile<float>(n1) == 0;
}

// Targets a block at (dtype size, n1) (0 for n1 < 2): the
// instantiation's, or the runtime-degree kernel's 32 where this library
// has no instantiation for n1. The wrapper's grid check and the
// accounting of swept pairs.
extern "C" int bcfg_tile(int dtype_size, int n1) {
  if (n1 < 2) return 0;
  const int t = dtype_size == 4 ? tile<float>(n1) : tile<double>(n1);
  return t > 0 ? t : 32;
}
