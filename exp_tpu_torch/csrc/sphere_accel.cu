// Sphere force pass (K2) for Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_sphere.py make_accel_kernel (the TPU kernel
// at its pallas_call, :398), SphereSL's default force pass
// (pallas_harmonics='auto', pallas_interp='spline').
//
// Computes, for particles x (N, 3) and the coefficient-contracted spline
// table twT (2P, rows) (pot rows, then d(pot)/dxi rows, packed harmonic
// order; contract_coef_table2):
//   pc_p, dpc_p = the spline interpolation of twT at xi(min(r/scale, rmax))
//   Phi = sum_p fac P_lm(cos th) trig_m(phi) pc_p (r_b/r)^(l+1)
// and its gradient in spherical coordinates (the f32 pole clamp 1e-6 on
// cos th for dP/dth, the -(l+1)/rs derivative outside r_b = rmax*scale),
// assembled into Cartesian acc (N, 3) and pot (N,).
//
// What bounds it on an H100: 28 bytes a particle of device memory (12 read,
// 16 written; 29 MB at N = 2^20, about 9 us at 3.35 TB/s) against several
// hundred FP32 operations a particle (Legendre and dP recurrences, 150
// interpolation FMAs, the 25-row assembly): the CUDA cores, not memory.
//
// Design: one thread per particle, grid-stride over a grid sized to fill
// the card once.  The recurrences are unrolled by a template on LMAX so
// every P_lm, dP_lm and trig value lives in registers.  Only the 3 nonzero
// spline weights are used (the TPU multiplied by a dense (rows, B) weight
// matrix).  The table is staged once per block into shared memory,
// transposed to node-major rows of Q = 2P rounded up to 4 floats, so a
// particle reads its 3 nodes as 16-byte vector loads (51.6 KB at lmax=4,
// dynamic shared memory above the 48 KB default).
#include <utility>

#include "sphere_common.cuh"

namespace {

using sphere::Params;

constexpr int kThreads = 256;

template <int L>
struct Layout {
  static constexpr int P = sphere::npacked(L);
  static constexpr int Q = (2 * P + 3) / 4 * 4;   // float4-aligned row
};

struct Sums {
  float l, r, t, p;   // potential, d/dr, d/dtheta, d/dphi series
};

// One particle's per-row inputs: interpolated table rows, P_lm, dP_lm
// ((L+1) x (L+1), row-major), trig rows, continuation factors, fac.
template <int L>
struct Row {
  const float* pcd;
  const float* Pl;
  const float* dPl;
  const float* cm;
  const float* sm;
  const float* att;
  const float* fs;
  bool outside;
  float rs, dxidr;
};

// Adds packed row Pr's terms in exp_tpu's order; cs, l, m are front-end
// constants, so every array index below is too.
template <int L, int Pr>
__device__ __forceinline__ void assemble_row(const Row<L>& a, Sums& s) {
  constexpr int P = Layout<L>::P;
  constexpr int cs = sphere::row_cs(Pr, L), l = sphere::row_l(Pr, L),
                mm = sphere::row_m(Pr, L);
  constexpr int lm = l * (L + 1) + mm;
  const float at = a.att[l];
  const float pcv = a.pcd[Pr] * at;
  const float dpv = a.outside ? -(float)(l + 1) / a.rs * pcv : a.pcd[P + Pr] * a.dxidr * at;
  const float fl = a.fs[lm] * a.Pl[lm];
  const float fd = a.fs[lm] * a.dPl[lm];
  const float tg = cs == 0 ? a.cm[mm] : a.sm[mm];
  s.l += fl * pcv * tg;
  s.r += fl * dpv * tg;
  s.t += fd * pcv * tg;
  if constexpr (mm != 0) {
    const float og = cs == 0 ? a.sm[mm] : a.cm[mm];
    const float sgn = cs == 0 ? -1.0f : 1.0f;
    s.p += sgn * (float)mm * a.fs[lm] * a.Pl[lm] * pcv * og;
  }
}

template <int L, int... Pr>
__device__ __forceinline__ void assemble(const Row<L>& a, Sums& s,
                                         std::integer_sequence<int, Pr...>) {
  (assemble_row<L, Pr>(a, s), ...);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
accel_kernel(const float* __restrict__ x, long long n,
             const float* __restrict__ twT, const float* __restrict__ fac,
             Params q, float* __restrict__ acc, float* __restrict__ pot) {
  constexpr int P = Layout<L>::P, Q = Layout<L>::Q;
  const int rows = q.nc + 2;
  extern __shared__ float4 sh4[];
  float* tw = reinterpret_cast<float*>(sh4);      // rows x Q
  float* fs = tw + rows * Q;                      // (L+1) x (L+1)

  for (int e = threadIdx.x; e < rows * Q; e += blockDim.x) {
    const int j = e / Q, k = e % Q;
    tw[e] = k < 2 * P ? twT[k * rows + j] : 0.0f;
  }
  for (int e = threadIdx.x; e < (L + 1) * (L + 1); e += blockDim.x) fs[e] = fac[e];
  __syncthreads();

  const float peps = (float)(1.0 - 1e-6);
  const float s2 = q.scale * q.scale;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2];
    // Near the z axis 1 - cos^2(theta) is tiny, and dP_lm below divides by
    // it: the radius and the dP terms are rounded step by step (no FMA
    // contraction), as the plain version and the JAX kernel round them, or
    // an ulp of r would move the theta force by up to 1e-3 relative.
    const float r = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                                    __fmul_rn(pz, pz))) + 1e-10f;
    const float R = sqrtf(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py))) + 1e-10f;
    const float costh = pz / r, cphi = px / R, sphi = py / R;
    const float rs = r / q.scale;
    const bool outside = r > q.rb;
    const float xi = sphere::ximap(fminf(rs, q.rmax), q);

    // P_lm and dP_lm/dx at the clamped cos(theta)
    const float xc = fminf(fmaxf(costh, -peps), peps);
    float Pl[L + 1][L + 1], dPl[L + 1][L + 1];
    Pl[0][0] = 1.0f;
    if (L > 0) {
      const float somx2 = sqrtf(fmaxf((1.0f - xc) * (1.0f + xc), 0.0f));
      float pll = 1.0f, fact = 1.0f;
#pragma unroll
      for (int mm = 1; mm <= L; ++mm) {
        pll = pll * (-fact) * somx2;
        Pl[mm][mm] = pll;
        fact += 2.0f;
      }
    }
#pragma unroll
    for (int mm = 0; mm < L; ++mm) {
      float pl2 = Pl[mm][mm];
      float pl1 = xc * (float)(2 * mm + 1) * pl2;
      Pl[mm + 1][mm] = pl1;
#pragma unroll
      for (int ll = mm + 2; ll <= L; ++ll) {
        const float pnew = (xc * (float)(2 * ll - 1) * pl1 - (float)(ll + mm - 1) * pl2)
                           / (float)(ll - mm);
        Pl[ll][mm] = pnew;
        pl2 = pl1;
        pl1 = pnew;
      }
    }
    const float inv = 1.0f / __fsub_rn(__fmul_rn(xc, xc), 1.0f);
#pragma unroll
    for (int l = 0; l <= L; ++l) {
#pragma unroll
      for (int mm = 0; mm <= l; ++mm) {
        const float lxp = __fmul_rn(__fmul_rn((float)l, xc), Pl[l][mm]);
        if (l == 0) dPl[l][mm] = 0.0f;
        else if (l == mm) dPl[l][mm] = __fmul_rn(inv, lxp);
        else dPl[l][mm] = __fmul_rn(
            inv, __fsub_rn(lxp, __fmul_rn((float)(l + mm), Pl[l - 1][mm])));
      }
    }
    // cos/sin(m phi) by angle addition
    float cm[L + 1], sm[L + 1];
    cm[0] = 1.0f;
    sm[0] = 0.0f;
#pragma unroll
    for (int mm = 1; mm <= L; ++mm) {
      cm[mm] = cm[mm - 1] * cphi - sm[mm - 1] * sphi;
      sm[mm] = sm[mm - 1] * cphi + cm[mm - 1] * sphi;
    }

    const float dxidr = q.cmap == 1 ? 0.5f * (1.0f - xi) * (1.0f - xi) / q.rmap : 1.0f;

    // spline interpolation of the contracted table: 3 nodes, Q/4 float4 each
    float w[3];
    const int c = sphere::spline_weights(xi, q, w);
    float pcd[Q];
    {
      const float4* r0 = reinterpret_cast<const float4*>(tw + (c - 1) * Q);
      const float4* r1 = reinterpret_cast<const float4*>(tw + c * Q);
      const float4* r2 = reinterpret_cast<const float4*>(tw + (c + 1) * Q);
#pragma unroll
      for (int k = 0; k < Q / 4; ++k) {
        const float4 a = r0[k], b = r1[k], d = r2[k];
        pcd[4 * k + 0] = w[0] * a.x + w[1] * b.x + w[2] * d.x;
        pcd[4 * k + 1] = w[0] * a.y + w[1] * b.y + w[2] * d.y;
        pcd[4 * k + 2] = w[0] * a.z + w[1] * b.z + w[2] * d.z;
        pcd[4 * k + 3] = w[0] * a.w + w[1] * b.w + w[2] * d.w;
      }
    }

    // vacuum continuation att_l = (r_b/r)^(l+1) outside r_b
    const float base = outside ? q.rb / r : 1.0f;
    float att[L + 1];
    att[0] = base;
#pragma unroll
    for (int l = 1; l <= L; ++l) att[l] = att[l - 1] * base;

    Sums sum{0.0f, 0.0f, 0.0f, 0.0f};
    Row<L> row{pcd, &Pl[0][0], &dPl[0][0], cm, sm, att, fs, outside, rs, dxidr};
    assemble(row, sum, std::make_integer_sequence<int, P>{});
    float potl = sum.l, potr = sum.r, pott = sum.t, potp = sum.p;
    potr = potr / s2;
    potl = potl / q.scale;
    pott = pott / q.scale;
    potp = potp / q.scale;

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

template <int L>
cudaError_t launch(const float* x, long long n, const float* twT,
                   const float* fac, const Params& q, float* acc, float* pot,
                   cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int rows = q.nc + 2;
  const size_t smem = sizeof(float) * ((size_t)rows * Layout<L>::Q + (L + 1) * (L + 1));
  cudaError_t err = cudaFuncSetAttribute(
      accel_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accel_kernel<L>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long full = (long long)nsm * per_sm;
  const int grid = (int)(need < full ? need : full);
  accel_kernel<L><<<grid, kThreads, smem, stream>>>(x, n, twT, fac, q, acc, pot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), twT (2P, nc + 2) coefficient-contracted spline table, fac
// (lmax+1, lmax+1); outputs acc (n, 3) and pot (n,).  All f32, contiguous,
// on the current device.  Returns a cudaError_t.
int sphere_accel_launch(const void* x, long long n, const void* twT,
                        const void* fac, void* acc, void* pot, int lmax,
                        int nmax, int nc, int cmap, float xmin, float dxc,
                        float rmin, float rmax, float rmap, float scale,
                        float rb, void* stream) {
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, rb};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto tf = static_cast<const float*>(twT);
  auto ff = static_cast<const float*>(fac);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  switch (lmax) {
    case 0: return launch<0>(xf, n, tf, ff, q, af, pf, s);
    case 1: return launch<1>(xf, n, tf, ff, q, af, pf, s);
    case 2: return launch<2>(xf, n, tf, ff, q, af, pf, s);
    case 3: return launch<3>(xf, n, tf, ff, q, af, pf, s);
    case 4: return launch<4>(xf, n, tf, ff, q, af, pf, s);
    case 5: return launch<5>(xf, n, tf, ff, q, af, pf, s);
    case 6: return launch<6>(xf, n, tf, ff, q, af, pf, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* sphere_accel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
