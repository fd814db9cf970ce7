// EOF cylinder force pass (K5) for Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_cylinder.py make_cyl_accel_kernel (the TPU
// kernel at its pallas_call, :257), CylinderForce's pallas force pass for
// both pallas_interp='spline' (the default) and 'linear'.
//
// Computes, for particles x (N, 3) and the coefficient-contracted coarse
// table Ct (xrows, ncy, SP) (ops/cyl_kernels.contract_coef_tables: per node
// the 6(M+1) values of pot, dU/dR, dU/dz x cos, sin in float4 columns,
// column m <= M holding (pot_c, pot_s, dR_c, dR_s) of m and column M+1+j
// holding (dz_c, dz_s) of m = 2j and 2j+1, zeros past m = M):
//   (R, z) shrunk onto the table sphere by rmax_grid / r beyond it,
//   v = the x (3 spline or 2 hat weights) and y (2 hats) interpolation of
//       Ct at the shrunk point,
//   pot = sum_m v_pot,c cos + v_pot,s sin, F_R, F_z likewise with minus
//   signs, F_phi = sum_m m (v_pot,c sin - v_pot,s cos) / R (unshrunk R),
// assembled into Cartesian (ax, ay, az) and pot, with the monopole
// continuation Phi_b r_b / r beyond rmax_grid.
//
// What bounds it on an H100, at the disk bench's shapes (mmax=6, xrows=66,
// ncy=128, N = 2^20, 'spline'): operations.  It moves 28 bytes a particle
// (12 read, 16 written) and the table once: 30.8 MB, 9.2 us at 3.35 TB/s;
// the function needs at least about 754 FP32 operations a particle (the 6
// node weights once, then 6 FMAs for each of the 42 values, the geometry,
// arcsinh, weights, trig and the 7-term assembly): 0.79 GFLOP, 11.8 us at
// 67 TFLOP/s.  What holds the kernel back is neither: each particle
// gathers 6 rows of 176 bytes of the 1.5 MB table from L2 (1.1 GB at 2^20,
// 2/3 of the first version's time there), and on a small bucket the one
// thread's chain of ~700 dependent instructions (PERF.md §6).
//
// Design.  A particle's column work on 4 consecutive threads (lanes):
// lane k interpolates the float4 columns k, k + 4, ... from the 6 rows,
// so the lanes read a row's columns side by side (full sectors, a few
// rows a warp load), and forms their terms: column m <= M gives the pot,
// F_R and F_phi terms of m, dz column M + 1 + j the F_z terms of m = 2j
// and 2j + 1.  Each sum gathers its terms by shuffles and adds them in the
// order m = 0 .. M.  The set-up (nodes, weights, trig rows; the JAX
// kernel's rounding, cyl_common.cuh) comes in two forms:
//   each lane sets its particle up (small buckets: the shortest chain);
//   broadcast (large buckets): a thread sets up one particle, and each
//     warp's 32 particles take 4 rounds of 8, their nodes shuffled to
//     their lanes, their sums back to their owners.
// Every product and sum is spelled out (no FMA contraction left to the
// compiler), and both forms run the same code on the same bits: a
// particle's output depends on its row alone, bit for bit the same under
// padding and whatever the plan.  No shared memory takes room from the L1
// that caches the table.  The lanes beat a thread a particle at every
// bucket size, and the broadcast beat each lane's own set-up on large
// buckets where the gather is cheap (the composite's halo under the
// disk's force; PERF.md §6).  The y node past the last row (ty == ncy -
// 1, the TPU's zero pad row) has weight 0 and an index held in range.
#include "cyl_common.cuh"

namespace {

using cyl::Params;

constexpr int kLanes = 4;          // lanes a particle
constexpr int kThreads = 256;      // threads a block

template <int MMAX>
struct Layout {
  static constexpr int M1 = MMAX + 1;
  static constexpr int SP4 = M1 + (M1 + 1) / 2;        // float4 columns a node
  static constexpr int CPL = (SP4 + kLanes - 1) / kLanes;   // columns a lane
};

// What a particle's column work reads: its first node, the steps to the
// next x and y node, the weights and the trig rows.
template <int MMAX>
struct Nodes {
  const float4* row0;        // node (jx0, jy0)
  int xstep, ystep;          // float4s to the next x and y node
  float wx[3], wy[2];
  float c[MMAX + 2], s[MMAX + 2];   // cos, sin(m phi); m = M + 1 is 0
};

// A particle's set-up: its nodes and the geometry of its assembly.
template <int MMAX>
struct Point {
  Nodes<MMAX> nd;
  float px, py, pz, R, r, cphi, sphi, shrink;
  bool outside;
};

template <int MMAX>
__device__ __forceinline__ void trig(Nodes<MMAX>& a, float cphi, float sphi) {
  cyl::trig_rows<MMAX>(cphi, sphi, a.c, a.s);
  a.c[MMAX + 1] = 0.0f;
  a.s[MMAX + 1] = 0.0f;
}

template <int MMAX, bool SPLINE>
__device__ __forceinline__ void set_up(Point<MMAX>& a, const float* x, long long i,
                                       const float4* Ct4, const Params& q) {
  constexpr int SP4 = Layout<MMAX>::SP4;
  constexpr int KX = cyl::XNodes<SPLINE>::K;
  a.px = x[3 * i];
  a.py = x[3 * i + 1];
  a.pz = x[3 * i + 2];
  cyl::cyl_maps(a.px, a.py, a.pz, a.R, a.r);
  a.cphi = a.px / a.R;
  a.sphi = a.py / a.R;
  a.outside = a.r > q.rmax_grid;
  a.shrink = a.outside ? q.rmax_grid / a.r : 1.0f;
  float tx, ty;
  cyl::grid_coords(a.R * a.shrink, a.pz * a.shrink, q, tx, ty);
  int jx[KX], jy[2];
  float wx[KX];
  cyl::x_weights<SPLINE>(tx, q.ncx, jx, wx);
  cyl::y_weights(ty, q.ncy, jy, a.nd.wy);
#pragma unroll
  for (int k = 0; k < 3; ++k) a.nd.wx[k] = k < KX ? wx[k] : 0.0f;
  a.nd.row0 = Ct4 + (long long)(jx[0] * q.ncy + jy[0]) * SP4;
  a.nd.xstep = (jx[1] - jx[0]) * q.ncy * SP4;
  a.nd.ystep = (jy[1] - jy[0]) * SP4;
}

// Lane src's particle's nodes, in every lane (the trig rows recomputed
// from its cos and sin phi, bit for bit the owner's).
template <int MMAX>
__device__ __forceinline__ Nodes<MMAX> broadcast(const Point<MMAX>& a, int src) {
  constexpr unsigned kAll = 0xffffffffu;
  Nodes<MMAX> b;
  b.row0 = reinterpret_cast<const float4*>(
      __shfl_sync(kAll, reinterpret_cast<unsigned long long>(a.nd.row0), src));
  b.xstep = __shfl_sync(kAll, a.nd.xstep, src);
  b.ystep = __shfl_sync(kAll, a.nd.ystep, src);
#pragma unroll
  for (int k = 0; k < 3; ++k) b.wx[k] = __shfl_sync(kAll, a.nd.wx[k], src);
#pragma unroll
  for (int k = 0; k < 2; ++k) b.wy[k] = __shfl_sync(kAll, a.nd.wy[k], src);
  trig(b, __shfl_sync(kAll, a.cphi, src), __shfl_sync(kAll, a.sphi, src));
  return b;
}

// Column col's value at the particle: sum_a wx_a (wy_0 Ct[jx_a, jy_0] +
// wy_1 Ct[jx_a, jy_1]), the TPU's (Ct @ Wy) then the x-weighted sum.
template <int MMAX, bool SPLINE>
__device__ __forceinline__ float4 value(const Nodes<MMAX>& a, int col) {
  constexpr int KX = cyl::XNodes<SPLINE>::K;
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int xa = 0; xa < KX; ++xa) {
    const float4* r0 = a.row0 + (long long)xa * a.xstep;
    const float4 b0 = __ldg(r0 + col), b1 = __ldg(r0 + a.ystep + col);
    const float wa = a.wx[xa], w0 = a.wy[0], w1 = a.wy[1];
    o.x = __fmaf_rn(wa, __fmaf_rn(w1, b1.x, __fmul_rn(w0, b0.x)), o.x);
    o.y = __fmaf_rn(wa, __fmaf_rn(w1, b1.y, __fmul_rn(w0, b0.y)), o.y);
    o.z = __fmaf_rn(wa, __fmaf_rn(w1, b1.z, __fmul_rn(w0, b0.z)), o.z);
    o.w = __fmaf_rn(wa, __fmaf_rn(w1, b1.w, __fmul_rn(w0, b0.w)), o.w);
  }
  return o;
}

// The terms of one column's value v: column m <= M gives pot, F_R and
// F_phi of m (t.x, t.y, t.z); dz column M + 1 + j gives F_z of m = 2j and
// 2j + 1 (t.x, t.y).  c1, s1 (c2, s2) the trig pair of the first (second)
// m.
__device__ __forceinline__ float4 terms(bool dz, float m, float4 v, float c1,
                                        float s1, float c2, float s2) {
  if (dz)
    return make_float4(__fmaf_rn(v.y, s1, __fmul_rn(v.x, c1)),
                       __fmaf_rn(v.w, s2, __fmul_rn(v.z, c2)), 0.0f, 0.0f);
  return make_float4(__fmaf_rn(v.y, s1, __fmul_rn(v.x, c1)),
                     __fmaf_rn(v.w, s1, __fmul_rn(v.z, c1)),
                     __fmul_rn(m, __fsub_rn(__fmul_rn(v.x, s1), __fmul_rn(v.y, c1))), 0.0f);
}

struct Sums {
  float p, FR, Fz, Fp;
};

// The sums of the particle of nodes a, in lane k (0..3) of its 4
// consecutive lanes: lane k forms the terms of columns k, k + 4, ...; each
// sum gathers its terms by shuffles in the order of m.  Every lane of the
// group gets the sums.
template <int MMAX, bool SPLINE>
__device__ __forceinline__ Sums particle_sums(const Nodes<MMAX>& a, int k) {
  constexpr int M1 = MMAX + 1, SP4 = Layout<MMAX>::SP4, CPL = Layout<MMAX>::CPL;
  float4 tm[CPL];                      // the terms of columns k, k + 4, ...
#pragma unroll
  for (int cc = 0; cc < CPL; ++cc) {
    const int col = k + cc * kLanes;
    tm[cc] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (col < SP4) {
      const bool dz = col >= M1;
      const int m1 = dz ? 2 * (col - M1) : col, m2 = dz ? m1 + 1 : col;
      float c1 = a.c[0], s1 = a.s[0], c2 = a.c[0], s2 = a.s[0];
#pragma unroll
      for (int m = 1; m <= M1; ++m) {     // a.c[m1] without a local array
        if (m == m1) { c1 = a.c[m]; s1 = a.s[m]; }
        if (m == m2) { c2 = a.c[m]; s2 = a.s[m]; }
      }
      tm[cc] = terms(dz, (float)m1, value<MMAX, SPLINE>(a, col), c1, s1, c2, s2);
    }
  }
  // m's terms from lane m % 4, its F_z from the lane of dz column M1 + m / 2
  Sums z{0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < M1; ++m) {
    const float4 v = tm[m / kLanes];
    const int src = m % kLanes;
    z.p = __fadd_rn(z.p, __shfl_sync(0xffffffffu, v.x, src, kLanes));
    z.FR = __fsub_rn(z.FR, __shfl_sync(0xffffffffu, v.y, src, kLanes));
    z.Fp = __fadd_rn(z.Fp, __shfl_sync(0xffffffffu, v.z, src, kLanes));
    const int cz = M1 + m / 2;
    const float4 w = tm[cz / kLanes];
    z.Fz = __fsub_rn(z.Fz, __shfl_sync(0xffffffffu, m % 2 ? w.y : w.x, cz % kLanes, kLanes));
  }
  return z;
}

// Cartesian acc and pot of particle i from its sums, with the monopole
// continuation Phi -> Phi_b r_b / r beyond the table sphere.
template <int MMAX>
__device__ __forceinline__ void finish(const Point<MMAX>& a, const Sums& z, long long i,
                                       float* acc, float* pot) {
  float p = z.p;
  const float FR = z.FR, Fz = z.Fz, Fp = z.Fp / a.R;
  float ax, ay, az;
  if (a.outside) {
    const float Fr_out = p * a.shrink / a.r;
    ax = Fr_out * a.px / a.r;
    ay = Fr_out * a.py / a.r;
    az = Fr_out * a.pz / a.r;
    p = p * a.shrink;
  } else {
    ax = FR * a.cphi - Fp * a.sphi;
    ay = FR * a.sphi + Fp * a.cphi;
    az = Fz;
  }
  acc[3 * i] = ax;
  acc[3 * i + 1] = ay;
  acc[3 * i + 2] = az;
  pot[i] = p;
}

// BCAST: a thread sets up one particle, and each warp's 32 particles take
// 4 rounds of 8, their nodes broadcast to their 4 lanes; else each of a
// particle's 4 lanes sets it up itself.
template <int MMAX, bool SPLINE, bool BCAST>
__global__ void __launch_bounds__(kThreads)
accel_kernel(const float* __restrict__ x, long long n,
             const float4* __restrict__ Ct4, Params q, float* __restrict__ acc,
             float* __restrict__ pot) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = BCAST ? t : t / kLanes;
  const bool live = i < n;
  Point<MMAX> a;
  set_up<MMAX, SPLINE>(a, x, live ? i : n - 1, Ct4, q);
  if (BCAST) {
    constexpr int kRound = 32 / kLanes;                // particles a round
    const int lane = threadIdx.x & 31;
    Sums mine{0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int r = 0; r < kLanes; ++r) {
      const Sums z = particle_sums<MMAX, SPLINE>(
          broadcast(a, kRound * r + lane / kLanes), lane % kLanes);
      // particle 8r + j's sums, from lane 4j, to lane 8r + j
      const int from = kLanes * (lane % kRound);
      const Sums v{__shfl_sync(0xffffffffu, z.p, from), __shfl_sync(0xffffffffu, z.FR, from),
                   __shfl_sync(0xffffffffu, z.Fz, from), __shfl_sync(0xffffffffu, z.Fp, from)};
      if (lane / kRound == r) mine = v;
    }
    if (live) finish(a, mine, i, acc, pot);
  } else {
    trig(a.nd, a.cphi, a.sphi);
    const Sums z = particle_sums<MMAX, SPLINE>(a.nd, (int)(t % kLanes));
    if (live && t % kLanes == 0) finish(a, z, i, acc, pot);
  }
}

template <int MMAX, bool SPLINE>
cudaError_t launch(const float* x, long long n, const float* Ct, const Params& q,
                   int bcast, int blocks, float* acc, float* pot, cudaStream_t s) {
  auto C4 = reinterpret_cast<const float4*>(Ct);
  if (bcast)
    accel_kernel<MMAX, SPLINE, true><<<blocks, kThreads, 0, s>>>(x, n, C4, q, acc, pot);
  else
    accel_kernel<MMAX, SPLINE, false><<<blocks, kThreads, 0, s>>>(x, n, C4, q, acc, pot);
  return cudaGetLastError();
}

template <bool SPLINE>
cudaError_t dispatch(const float* x, long long n, const float* Ct, const Params& q,
                     int bcast, int blocks, float* acc, float* pot, cudaStream_t s) {
  switch (q.mmax) {
    case 0: return launch<0, SPLINE>(x, n, Ct, q, bcast, blocks, acc, pot, s);
    case 1: return launch<1, SPLINE>(x, n, Ct, q, bcast, blocks, acc, pot, s);
    case 2: return launch<2, SPLINE>(x, n, Ct, q, bcast, blocks, acc, pot, s);
    case 3: return launch<3, SPLINE>(x, n, Ct, q, bcast, blocks, acc, pot, s);
    case 4: return launch<4, SPLINE>(x, n, Ct, q, bcast, blocks, acc, pot, s);
    case 5: return launch<5, SPLINE>(x, n, Ct, q, bcast, blocks, acc, pot, s);
    case 6: return launch<6, SPLINE>(x, n, Ct, q, bcast, blocks, acc, pot, s);
    case 7: return launch<7, SPLINE>(x, n, Ct, q, bcast, blocks, acc, pot, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (n, 3), Ct (xrows, ncy, SP) contracted table with SP = 6(mmax+1) rounded
// up to a multiple of 4 and xrows = ncx + 2 ('spline') or ncx ('linear');
// outputs acc (n, 3) and pot (n,).  All f32, contiguous, on the current
// device (Ct 16-byte aligned).  The plan (ops/cyl_kernels.accel_plan):
// bcast 1 (a thread a particle's set-up, broadcast to its 4 lanes) or 0
// (each lane sets it up), `blocks` blocks of 256 threads covering n
// particles (256 a block with bcast, else 64).  Returns a cudaError_t.
int cyl_accel_launch(const void* x, long long n, const void* Ct, void* acc, void* pot,
                     int bcast, int blocks, int spline, int mmax, int ncx, int ncy,
                     float acyl, float hcyl, float xmin, float dxc, float ymin,
                     float dy, float rmax_grid, void* stream) {
  if ((bcast != 0 && bcast != 1) || blocks < 0 ||
      (long long)blocks * (bcast ? kThreads : kThreads / kLanes) < n)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Params q{mmax, ncx, ncy, acyl, hcyl, xmin, dxc, ymin, dy, rmax_grid};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto cf = static_cast<const float*>(Ct);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  return spline ? dispatch<true>(xf, n, cf, q, bcast, blocks, af, pf, s)
                : dispatch<false>(xf, n, cf, q, bcast, blocks, af, pf, s);
}

const char* cyl_accel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
