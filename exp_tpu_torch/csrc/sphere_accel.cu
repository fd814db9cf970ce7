// Sphere force pass (K2) for Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_sphere.py make_accel_kernel (the TPU kernel
// at its pallas_call, :398), SphereSL's force pass under
// pallas_harmonics='auto' and 'recurrence', for pallas_interp='spline' and
// 'hat'.
//
// Computes, for particles x (N, 3) and the coefficient-contracted table twT
// ('spline': (2P, nc + 2), pot rows, then d(pot)/dxi rows, packed harmonic
// order, contract_coef_table2; 'hat': (P, nc) pot rows,
// contract_coef_table):
//   pc_p, dpc_p = the interpolation of twT at xi(min(r/scale, rmax)): the
//                 quadratic B-spline of both row sets, or the hat of the pot
//                 rows and their cell difference (+-1/dxc at the cell's
//                 ends)
//   Phi = sum_p fac P_lm(cos th) trig_m(phi) pc_p (r_b/r)^(l+1)
// and its gradient in spherical coordinates (the f32 pole clamp 1e-6 on
// cos th for dP/dth, the -(l+1)/rs derivative outside r_b = rmax*scale),
// assembled into Cartesian acc (N, 3) and pot (N,).
//
// What bounds it on an H100: 28 bytes a particle of device memory (12 read,
// 16 written; 29 MB at N = 2^20, about 9 us at 3.35 TB/s) against several
// hundred FP32 operations a particle (Legendre and dP recurrences, the
// interpolation of every packed row, the assembly): the CUDA cores, not
// memory.  The first version (one thread a particle walking the (m, l)
// triangle) spent ~2,000 instructions a particle at lmax 4, an IEEE
// division in each entry of the recurrence and in each row's outside
// derivative among them, and left a small bucket waiting on that one
// thread's chain (PERF.md §6).
//
// Design.  The (l, m) triangle's columns (one m each, l = m .. L) are
// summed column by column: a column's four sums (Phi, d/dr, d/dtheta,
// d/dphi) start from 0 and run over l, and the particle's sums add the
// columns' in the order m = 0 .. L.  Inside a column, the Legendre
// recurrence multiplies by a reciprocal 1/(l - m) from shared memory in
// place of the division, dP_lm is rounded step by step as before
// (the pole clamp), the entry's cos and sin rows are interpolated from the
// particle's nodes (a row's 2 or 3 nodes side by side in the
// packed-row-major table, one sector, through L1), and the outside
// derivative is one product with 1/rs.  Two launch forms compute the same
// bits:
//   lanes (small buckets): a particle's columns go to lanes = the power of
//     2 >= 1 + ceil(L/2) consecutive threads; lane 0 takes column 0, lane
//     k >= 1 the columns k and L + 1 - k (L + 1 entries each, so no lane
//     waits on a longer chain than column 0's), and the columns' sums are
//     gathered by shuffles in the order m = 0 .. L;
//   thread (large buckets): a thread a particle walks m = 0 .. L as the
//     first version did, and keeps the order.
// Every product and sum is spelled out (no FMA contraction left to the
// compiler), so both forms round alike: a particle's output depends on its
// row alone, bit for bit the same under padding and whatever the plan.
// lmax is a run-time argument (0..10).
#include "sphere_common.cuh"

namespace {

using sphere::Params;

constexpr int kThreads = 256;      // threads a block

// The particle, as every thread of it computes it.
struct Point {
  const float* tw;                 // twT's first row at the particle's first node
  float px, py, pz, r, xc, somx2, cphi, sphi, inv, base, rsinv, dxidr;
  float w0, w1, w2;
  bool outside;
};

__device__ __forceinline__ Point set_up(const float* x, long long i,
                                        const float* twT, const Params& q) {
  Point a;
  a.px = x[3 * i];
  a.py = x[3 * i + 1];
  a.pz = x[3 * i + 2];
  // Near the z axis 1 - cos^2(theta) is tiny, and dP_lm divides by it: the
  // radius and the dP terms are rounded step by step (no FMA contraction),
  // as the plain version and the JAX kernel round them, or an ulp of r
  // would move the theta force by up to 1e-3 relative; the hat cell,
  // floor(t), needs the same ulp.
  a.r = sphere::radius(a.px, a.py, a.pz);
  const float R = sqrtf(__fadd_rn(__fmul_rn(a.px, a.px), __fmul_rn(a.py, a.py))) + 1e-10f;
  const float costh = a.pz / a.r;
  a.cphi = a.px / R;
  a.sphi = a.py / R;
  const float rs = a.r / q.scale;
  a.outside = a.r > q.rb;
  const float xi = sphere::ximap(fminf(rs, q.rmax), q);
  const float peps = (float)(1.0 - 1e-6);
  a.xc = fminf(fmaxf(costh, -peps), peps);
  a.somx2 = sqrtf(fmaxf(__fmul_rn(__fsub_rn(1.0f, a.xc), __fadd_rn(1.0f, a.xc)), 0.0f));
  a.inv = 1.0f / __fsub_rn(__fmul_rn(a.xc, a.xc), 1.0f);
  a.dxidr = q.cmap == 1
                ? __fmul_rn(__fmul_rn(0.5f, __fsub_rn(1.0f, xi)), __fsub_rn(1.0f, xi)) / q.rmap
                : 1.0f;
  a.rsinv = 1.0f / rs;
  float w[3];
  const int j0 = sphere::radial_weights(xi, q, w);
  a.w0 = w[0];
  a.w1 = w[1];
  a.w2 = w[2];
  a.tw = twT + j0;
  a.base = a.outside ? q.rb / a.r : 1.0f;
  return a;
}

struct Sums {
  float l, r, t, p;      // potential, d/dr, d/dtheta, d/dphi series
};

__device__ __forceinline__ void add(Sums& a, const Sums& b) {
  a.l = __fadd_rn(a.l, b.l);
  a.r = __fadd_rn(a.r, b.r);
  a.t = __fadd_rn(a.t, b.t);
  a.p = __fadd_rn(a.p, b.p);
}

// The m-chain from m to m + 1, in the first version's order: cos and
// sin(m phi) by angle addition, P_mm, (r_b/r)^(m+1).
struct Chain {
  float cm, sm, pmm, fact, attm;
  int m;
  __device__ __forceinline__ void next(const Point& a) {
    const float c2 = __fsub_rn(__fmul_rn(cm, a.cphi), __fmul_rn(sm, a.sphi));
    sm = __fadd_rn(__fmul_rn(sm, a.cphi), __fmul_rn(cm, a.sphi));
    cm = c2;
    pmm = __fmul_rn(__fmul_rn(pmm, -fact), a.somx2);
    fact = __fadd_rn(fact, 2.0f);
    attm = __fmul_rn(attm, a.base);
    ++m;
  }
};

// What every entry reads besides the particle.
struct Table {
  const float* fs;       // (L+1)^2 fac in shared memory
  const float* rk;       // 1/d, d = 0..L, in shared memory
  int L, P, ncos, rows;
  bool hat;
  float idx;             // 1/dxc
};

// Column m's sums, entries l = m .. L, from the chain at m.
__device__ __forceinline__ Sums column(const Point& a, const Chain& ch, const Table& tb) {
  const int m = ch.m, L = tb.L;
  Sums z{0.0f, 0.0f, 0.0f, 0.0f};
  float pl1 = 0.0f, pl2 = 0.0f, at = ch.attm;
  for (int l = m; l <= L; ++l) {
    float plm;
    if (l == m) plm = ch.pmm;
    else if (l == m + 1) plm = __fmul_rn(__fmul_rn(a.xc, (float)(2 * m + 1)), pl1);
    else plm = __fmul_rn(__fsub_rn(__fmul_rn(__fmul_rn(a.xc, (float)(2 * l - 1)), pl1),
                                   __fmul_rn((float)(l + m - 1), pl2)),
                         tb.rk[l - m]);
    const float lxp = __fmul_rn(__fmul_rn((float)l, a.xc), plm);
    float dplm;
    if (l == 0) dplm = 0.0f;
    else if (l == m) dplm = __fmul_rn(a.inv, lxp);
    else dplm = __fmul_rn(a.inv, __fsub_rn(lxp, __fmul_rn((float)(l + m), pl1)));
    const float f = tb.fs[l * (L + 1) + m];
    const float fl = __fmul_rn(f, plm), fd = __fmul_rn(f, dplm);
    const float kout = __fmul_rn(a.rsinv, -(float)(l + 1));   // -(l+1)/rs
#pragma unroll
    for (int cs = 0; cs < 2; ++cs) {
      if (cs == 1 && m == 0) break;
      const int row = cs == 0 ? l * (l + 1) / 2 + m : tb.ncos + l * (l - 1) / 2 + m - 1;
      const float* t = a.tw + row * tb.rows;
      const float ta = __ldg(t), tb1 = __ldg(t + 1);
      float pc, dpc;
      if (tb.hat) {   // each product rounded on its own, as the plain version
        pc = __fadd_rn(__fmul_rn(a.w0, ta), __fmul_rn(a.w1, tb1));
        dpc = __fadd_rn(__fmul_rn(ta, -tb.idx), __fmul_rn(tb1, tb.idx));
      } else {
        const float* d = t + tb.P * tb.rows;
        pc = __fmaf_rn(a.w2, __ldg(t + 2), __fmaf_rn(a.w1, tb1, __fmul_rn(a.w0, ta)));
        dpc = __fmaf_rn(a.w2, __ldg(d + 2),
                        __fmaf_rn(a.w1, __ldg(d + 1), __fmul_rn(a.w0, __ldg(d))));
      }
      const float tg = cs == 0 ? ch.cm : ch.sm, og = cs == 0 ? ch.sm : ch.cm;
      const float pcv = __fmul_rn(pc, at);
      const float dpv = a.outside ? __fmul_rn(kout, pcv)
                                  : __fmul_rn(__fmul_rn(dpc, a.dxidr), at);
      const float flp = __fmul_rn(fl, pcv);
      z.l = __fmaf_rn(flp, tg, z.l);
      z.r = __fmaf_rn(__fmul_rn(fl, dpv), tg, z.r);
      z.t = __fmaf_rn(__fmul_rn(fd, pcv), tg, z.t);
      if (m != 0) z.p = __fmaf_rn(__fmul_rn(cs == 0 ? -(float)m : (float)m, flp), og, z.p);
    }
    pl2 = pl1;
    pl1 = plm;
    at = __fmul_rn(at, a.base);
  }
  return z;
}

__device__ __forceinline__ Sums shfl(const Sums& s, int src, int width) {
  return Sums{__shfl_sync(0xffffffffu, s.l, src, width),
              __shfl_sync(0xffffffffu, s.r, src, width),
              __shfl_sync(0xffffffffu, s.t, src, width),
              __shfl_sync(0xffffffffu, s.p, src, width)};
}

// LANES: a particle on `lanes` consecutive threads (lanes a power of 2 >=
// 1 + ceil(L/2)), else a particle a thread.  Asking for 4 blocks an SM
// made the thread form faster below 2^20 rows at lmax 4 and 10, and 6 or
// 8 spilled (PERF.md §6).
template <bool LANES>
__global__ void __launch_bounds__(kThreads, 4)
accel_kernel(const float* __restrict__ x, long long n,
             const float* __restrict__ twT, const float* __restrict__ fac,
             Params q, int lanes, float* __restrict__ acc, float* __restrict__ pot) {
  const int L = q.lmax, L1 = L + 1, P = L1 * L1;
  extern __shared__ float smem[];
  float* fs = smem;                                    // (L+1)^2 fac
  float* rk = fs + P;                                  // 1 / d, d = 1..L
  for (int e = threadIdx.x; e < P; e += blockDim.x) fs[e] = fac[e];
  for (int d = threadIdx.x; d < L1; d += blockDim.x) rk[d] = d ? 1.0f / (float)d : 0.0f;
  __syncthreads();

  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int G = LANES ? lanes : 1;
  const long long i = LANES ? t >> (__ffs(G) - 1) : t;
  const int k = LANES ? (int)(t & (G - 1)) : 0;       // the thread's lane
  const bool live = i < n;
  if (!LANES && !live) return;
  const Point a = set_up(x, live ? i : n - 1, twT, q);
  const Table tb{fs, rk, L, P, L1 * (L1 + 1) / 2, sphere::table_rows(q), q.hat != 0,
                 1.0f / q.dxc};

  Sums z{0.0f, 0.0f, 0.0f, 0.0f};
  Chain ch{1.0f, 0.0f, 1.0f, 1.0f, a.base, 0};
  if (LANES) {
    // lane 0: column 0; lane k in 1..h: columns k and L + 1 - k
    const int h = L1 / 2;
    Sums c1{0.0f, 0.0f, 0.0f, 0.0f}, c2{0.0f, 0.0f, 0.0f, 0.0f};
    if (k <= h) {
      while (ch.m < k) ch.next(a);
      c1 = column(a, ch, tb);
      if (k > 0 && L1 - k > k) {
        while (ch.m < L1 - k) ch.next(a);
        c2 = column(a, ch, tb);
      }
    }
    // the columns' sums in the order m = 0 .. L
    for (int m = 0; m <= L; ++m)
      add(z, m <= h ? shfl(c1, m, G) : shfl(c2, L1 - m, G));
    if (!live || k != 0) return;
  } else {
    for (int m = 0; m <= L; ++m) {
      if (m > 0) ch.next(a);
      add(z, column(a, ch, tb));
    }
  }

  // Cartesian acc and pot, in exp_tpu's assembly order
  const float px = a.px, py = a.py, pz = a.pz, r = a.r;
  const float potr = z.r / (q.scale * q.scale);
  const float potl = z.l / q.scale;
  const float pott = z.t / q.scale;
  const float potp = z.p / q.scale;
  const float r3 = r * r * r;
  const float rho2 = px * px + py * py;
  float ax = -(potr * px / r - pott * px * pz / r3);
  float ay = -(potr * py / r - pott * py * pz / r3);
  const float az = -(potr * pz / r + pott * rho2 / r3);
  if (rho2 > 1e-10f) {
    ax = ax + potp * py / rho2;
    ay = ay - potp * px / rho2;
  }
  acc[3 * i] = ax;
  acc[3 * i + 1] = ay;
  acc[3 * i + 2] = az;
  pot[i] = potl;
}

}  // namespace

extern "C" {

// x (n, 3), twT the coefficient-contracted table ((2P, nc + 2) 'spline',
// (P, nc) with hat = 1), fac (lmax+1, lmax+1); outputs acc (n, 3) and pot
// (n,).  All f32, contiguous, on the current device; lmax 0..10.
// The plan (ops/sphere_kernels.k2_plan): `lanes` threads a particle (1, or
// the power of 2 >= 1 + ceil(lmax/2)), `blocks` blocks of 256 threads
// covering n particles, `smem` bytes of shared memory a block.  Returns a
// cudaError_t.
int sphere_accel_launch(const void* x, long long n, const void* twT,
                        const void* fac, void* acc, void* pot, int lanes,
                        int blocks, int smem, int lmax, int nmax, int nc,
                        int cmap, float xmin, float dxc, float rmin,
                        float rmax, float rmap, float scale, float rb, int hat,
                        void* stream) {
  int need = 1;
  while (need < 1 + (lmax + 1) / 2) need *= 2;
  if (lmax < 0 || lmax > 10 || (lanes != 1 && lanes != need) || blocks < 0 ||
      (long long)blocks * kThreads / lanes < n ||
      smem < (int)sizeof(float) * ((lmax + 1) * (lmax + 1) + lmax + 1))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, rb, hat};
  auto xf = static_cast<const float*>(x);
  auto tf = static_cast<const float*>(twT);
  auto ff = static_cast<const float*>(fac);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  auto s = static_cast<cudaStream_t>(stream);
  if (lanes > 1)
    accel_kernel<true><<<blocks, kThreads, smem, s>>>(xf, n, tf, ff, q, lanes, af, pf);
  else
    accel_kernel<false><<<blocks, kThreads, smem, s>>>(xf, n, tf, ff, q, lanes, af, pf);
  return cudaGetLastError();
}

const char* sphere_accel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
