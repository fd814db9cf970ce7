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
//                 rows and their cell difference (+-1/dxc at the cell's ends)
//   Phi = sum_p fac P_lm(cos th) trig_m(phi) pc_p (r_b/r)^(l+1)
// and its gradient in spherical coordinates (the f32 pole clamp 1e-6 on
// cos th for dP/dth, the -(l+1)/rs derivative outside r_b = rmax*scale),
// assembled into Cartesian acc (N, 3) and pot (N,).
//
// What bounds it on an H100: 28 bytes a particle of device memory (12 read,
// 16 written; 29 MB at N = 2^20, about 9 us at 3.35 TB/s) against several
// hundred FP32 operations a particle (Legendre and dP recurrences, the
// interpolation of every packed row, the assembly): the CUDA cores, not
// memory.
//
// Design: one thread per particle, grid-stride over a grid sized to fill
// the card once; lmax is a runtime argument (0..10), so one instantiation
// serves every lmax.  m runs outer and l inner: the Legendre recurrence
// keeps two previous values, dP_lm needs only P_lm and P_{l-1,m}, and cos,
// sin(m phi) and (r_b/r)^(m+1) run along, so a thread holds O(1) values
// (at lmax 10, keeping every P_lm, dP_lm and table row in registers, as a
// template unrolled on LMAX did up to lmax 6, would take ~520 registers,
// and staging the table 246 KB of shared memory).  Each packed row is
// interpolated from the table as it is assembled, the table read through
// L1/L2: only the 3 nonzero spline weights (2 hat weights) are used, where
// the TPU multiplied by a dense (rows, B) weight matrix.  The sum runs in
// that (m, l) order, not the packed order of the plain version.  It ran
// faster than the unrolled template on the template's own inputs ('spline',
// lmax 4 and 6; PERF.md §6), so it replaced it.
#include "sphere_common.cuh"

namespace {

using sphere::Params;

constexpr int kThreads = 256;

struct Sums {
  float l, r, t, p;   // potential, d/dr, d/dtheta, d/dphi series
};

// The interpolated table row k at a particle: pc and the raw d/dxi dpc.
struct Interp {
  const float* tw;   // twT
  int rows, P, j0, hat;
  float w0, w1, w2, idx;   // node weights; 1/dxc for the hat cell derivative
  __device__ __forceinline__ void row(int k, float& pc, float& dpc) const {
    const float* t = tw + (long long)k * rows + j0;
    const float a = __ldg(t), b = __ldg(t + 1);
    if (hat) {   // each product rounded on its own, as the plain version
      pc = __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
      dpc = __fadd_rn(__fmul_rn(a, -idx), __fmul_rn(b, idx));
    } else {
      pc = w0 * a + w1 * b + w2 * __ldg(t + 2);
      const float* d = t + (long long)P * rows;
      dpc = w0 * __ldg(d) + w1 * __ldg(d + 1) + w2 * __ldg(d + 2);
    }
  }
};

// Adds one packed row's terms in exp_tpu's arithmetic: cs 0 or 1, degree
// l, order m, at = (r_b/r)^(l+1), tg/og the row's and the other trig value.
__device__ __forceinline__ void add_row(Sums& s, int cs, int l, int m, float pcr,
                                        float dpcr, float at, float fac,
                                        float plm, float dplm, float tg,
                                        float og, bool outside, float rs,
                                        float dxidr) {
  const float pcv = pcr * at;
  const float dpv = outside ? -(float)(l + 1) / rs * pcv : dpcr * dxidr * at;
  const float fl = fac * plm;
  const float fd = fac * dplm;
  s.l += fl * pcv * tg;
  s.r += fl * dpv * tg;
  s.t += fd * pcv * tg;
  if (m != 0) {
    const float sgn = cs == 0 ? -1.0f : 1.0f;
    s.p += sgn * (float)m * fac * plm * pcv * og;
  }
}

__global__ void __launch_bounds__(kThreads)
accel_kernel(const float* __restrict__ x, long long n,
             const float* __restrict__ twT, const float* __restrict__ fac,
             Params q, float* __restrict__ acc, float* __restrict__ pot) {
  const int L = q.lmax;
  extern __shared__ float fs[];                   // (L+1) x (L+1)
  for (int e = threadIdx.x; e < (L + 1) * (L + 1); e += blockDim.x) fs[e] = fac[e];
  __syncthreads();

  const float peps = (float)(1.0 - 1e-6);
  const float idx = 1.0f / q.dxc;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2];
    // Near the z axis 1 - cos^2(theta) is tiny, and dP_lm below divides by
    // it: the radius and the dP terms are rounded step by step (no FMA
    // contraction), as the plain version and the JAX kernel round them, or
    // an ulp of r would move the theta force by up to 1e-3 relative; the
    // hat cell, floor(t), needs the same ulp.
    const float r = sphere::radius(px, py, pz);
    const float R = sqrtf(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py))) + 1e-10f;
    const float costh = pz / r, cphi = px / R, sphi = py / R;
    const float rs = r / q.scale;
    const bool outside = r > q.rb;
    const float xi = sphere::ximap(fminf(rs, q.rmax), q);
    const float xc = fminf(fmaxf(costh, -peps), peps);
    const float somx2 = sqrtf(fmaxf((1.0f - xc) * (1.0f + xc), 0.0f));
    const float inv = 1.0f / __fsub_rn(__fmul_rn(xc, xc), 1.0f);
    const float dxidr = q.cmap == 1 ? 0.5f * (1.0f - xi) * (1.0f - xi) / q.rmap : 1.0f;

    float w[3];
    const int j0 = sphere::radial_weights(xi, q, w);
    const Interp tab{twT, sphere::table_rows(q), sphere::npacked(L), j0, q.hat,
                     w[0], w[1], w[2], idx};
    const float base = outside ? q.rb / r : 1.0f;

    Sums sum{0.0f, 0.0f, 0.0f, 0.0f};
    float cm = 1.0f, sm = 0.0f;           // cos(m phi), sin(m phi)
    float pmm = 1.0f, fact = 1.0f;        // P_mm
    float attm = base;                    // (r_b/r)^(m+1)
    for (int m = 0; m <= L; ++m) {
      if (m > 0) {
        const float c2 = cm * cphi - sm * sphi;
        sm = sm * cphi + cm * sphi;
        cm = c2;
        pmm = pmm * (-fact) * somx2;
        fact += 2.0f;
        attm = attm * base;
      }
      float pl1 = 0.0f, pl2 = 0.0f;       // P_{l-1,m}, P_{l-2,m}
      float at = attm;
      for (int l = m; l <= L; ++l) {
        float plm;
        if (l == m) plm = pmm;
        else if (l == m + 1) plm = xc * (float)(2 * m + 1) * pmm;
        else plm = (xc * (float)(2 * l - 1) * pl1 - (float)(l + m - 1) * pl2)
                   / (float)(l - m);
        const float lxp = __fmul_rn(__fmul_rn((float)l, xc), plm);
        float dplm;
        if (l == 0) dplm = 0.0f;
        else if (l == m) dplm = __fmul_rn(inv, lxp);
        else dplm = __fmul_rn(inv, __fsub_rn(lxp, __fmul_rn((float)(l + m), pl1)));
        const float f = fs[l * (L + 1) + m];
        float pc, dpc;
        tab.row(sphere::cos_row(l, m), pc, dpc);
        add_row(sum, 0, l, m, pc, dpc, at, f, plm, dplm, cm, sm, outside, rs, dxidr);
        if (m > 0) {
          tab.row(sphere::sin_row(l, m, L), pc, dpc);
          add_row(sum, 1, l, m, pc, dpc, at, f, plm, dplm, sm, cm, outside, rs, dxidr);
        }
        pl2 = pl1;
        pl1 = plm;
        at = at * base;
      }
    }
    // Cartesian acc and pot, in exp_tpu's assembly order
    const float potr = sum.r / (q.scale * q.scale);
    const float potl = sum.l / q.scale;
    const float pott = sum.t / q.scale;
    const float potp = sum.p / q.scale;
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
}

// Fill the card once: blocks of kThreads, as many as are resident.
cudaError_t launch(const float* x, long long n, const float* twT,
                   const float* fac, const Params& q, float* acc, float* pot,
                   cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (q.lmax + 1) * (q.lmax + 1);
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accel_kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long full = (long long)nsm * per_sm;
  const int grid = (int)(need < full ? need : full);
  accel_kernel<<<grid, kThreads, smem, stream>>>(x, n, twT, fac, q, acc, pot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), twT the coefficient-contracted table ((2P, nc + 2) 'spline',
// (P, nc) with hat = 1), fac (lmax+1, lmax+1); outputs acc (n, 3) and pot
// (n,).  All f32, contiguous, on the current device; lmax 0..10.  Returns
// a cudaError_t.
int sphere_accel_launch(const void* x, long long n, const void* twT,
                        const void* fac, void* acc, void* pot, int lmax,
                        int nmax, int nc, int cmap, float xmin, float dxc,
                        float rmin, float rmax, float rmap, float scale,
                        float rb, int hat, void* stream) {
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, rb, hat};
  if (lmax < 0 || lmax > 10) return cudaErrorInvalidValue;
  return launch(static_cast<const float*>(x), n, static_cast<const float*>(twT),
                static_cast<const float*>(fac), q, static_cast<float*>(acc),
                static_cast<float*>(pot), static_cast<cudaStream_t>(stream));
}

const char* sphere_accel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
