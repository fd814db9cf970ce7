// Sphere force pass from the solid-harmonic polynomials (K6) for Hopper,
// CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_sphere.py make_accel_kernel_poly (the TPU
// kernel at its pallas_call, :649), SphereSL's force pass under
// pallas_harmonics='poly', for pallas_interp='spline' and 'hat'.
//
// Computes K2's function without Legendre recurrences: for particles
// x (N, 3), u = x/r, and the coefficient-contracted table twT (K2's),
//   [Y; Gx; Gy; Gz]_p = Ms[(k P + p)] . mono(u)       (Ms (4P, n_mono))
//   g_p  = pc_p (r_b/r)^(l+1)
//   dg_p = -pc_p (l+1)(r_b/r)^(l+1) / rs  outside r_b, dpc_p (r_b/r)^(l+1) in
//   pot = sum Y g / scale,  T_j = sum G_j g,  R = sum Y dg
//   acc = -(u R / scale^2 + (T - u (u . T)) / (r scale))
// The tangential projection T - u(u.T) is regular at the poles: no clamp.
//
// What bounds it on an H100: the per-particle arithmetic (16 bytes of
// particle memory against ~1,100 FMAs at lmax 4: the 4P polynomial rows,
// the interpolation of 2P table rows, the sums), on the CUDA cores.
//
// Design: one thread per particle, grid-stride over a grid that fills the
// card once, a template on LMAX (0..6, where the f32 monomials hold) so the
// monomials and every row index are compile-time constants and live in
// registers.  A value row of degree l is fit on the monomials of degree <= l
// and of l's parity, so its gradient rows M D_j have degree <= l - 1 and the
// other parity: the products over the other monomials are skipped at compile
// time, and ops/sphere_kernels.poly_matrix_stack checks on the matrices
// themselves that every skipped entry is zero.  Ms (66 KB at lmax 6) is
// staged in shared memory and read at constant offsets (a broadcast); each
// packed row is interpolated from twT as it is assembled, the table read
// through L1/L2 (2 x 49 x 258 floats at lmax 6 'spline').
#include <utility>

#include "sphere_common.cuh"

namespace {

using sphere::nmono;
using sphere::Params;

constexpr int kThreads = 256;

// sum of Mrow[k] mono[k] over the monomials of degree D, D - 2, ... >= 0
template <int D>
__device__ __forceinline__ float poly_row(const float* Mrow, const float* mono) {
  float s = 0.0f;
  if constexpr (D >= 0) {
#pragma unroll
    for (int d = D & 1; d <= D; d += 2) {
#pragma unroll
      for (int k = sphere::mono_start(d); k < nmono(d); ++k) s += Mrow[k] * mono[k];
    }
  }
  return s;
}

struct Point {
  const float* mono;
  const float* att;    // (r_b/r)^(l+1), l = 0..L
  const float* tw;     // twT at the first node
  int rows;
  float w0, w1, w2, idx, dxidr, rs;
  bool outside, hat;
};

struct Sums {
  float pot, tx, ty, tz, r;
};

template <int L, int Pr>
__device__ __forceinline__ void add_row(const Point& a, const float* Ms, Sums& s) {
  constexpr int P = sphere::npacked(L), NM = nmono(L);
  constexpr int l = sphere::row_l(Pr, L);
  const float* t = a.tw + Pr * a.rows;
  const float ta = __ldg(t), tb = __ldg(t + 1);
  float pc, dpc;
  if (a.hat) {   // each product rounded on its own, as the plain version
    pc = __fadd_rn(__fmul_rn(a.w0, ta), __fmul_rn(a.w1, tb));
    dpc = __fadd_rn(__fmul_rn(ta, -a.idx), __fmul_rn(tb, a.idx));
  } else {
    pc = a.w0 * ta + a.w1 * tb + a.w2 * __ldg(t + 2);
    const float* d = t + P * a.rows;
    dpc = a.w0 * __ldg(d) + a.w1 * __ldg(d + 1) + a.w2 * __ldg(d + 2);
  }
  dpc = dpc * a.dxidr;
  const float at = a.att[l];
  const float g = pc * at;
  const float dg = a.outside ? -pc * ((float)(l + 1) * at) / a.rs : dpc * at;
  const float y = poly_row<l>(Ms + Pr * NM, a.mono);
  s.pot += y * g;
  s.r += y * dg;
  s.tx += poly_row<l - 1>(Ms + (P + Pr) * NM, a.mono) * g;
  s.ty += poly_row<l - 1>(Ms + (2 * P + Pr) * NM, a.mono) * g;
  s.tz += poly_row<l - 1>(Ms + (3 * P + Pr) * NM, a.mono) * g;
}

template <int L, int... Pr>
__device__ __forceinline__ void add_rows(const Point& a, const float* Ms, Sums& s,
                                         std::integer_sequence<int, Pr...>) {
  (add_row<L, Pr>(a, Ms, s), ...);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
accel_poly_kernel(const float* __restrict__ x, long long n,
                  const float* __restrict__ twT, const float* __restrict__ Mg,
                  Params q, float* __restrict__ acc, float* __restrict__ pot) {
  constexpr int P = sphere::npacked(L), NM = nmono(L);
  extern __shared__ float Ms[];                   // 4P x NM
  for (int e = threadIdx.x; e < 4 * P * NM; e += blockDim.x) Ms[e] = Mg[e];
  __syncthreads();

  const int rows = sphere::table_rows(q);
  const float idx = 1.0f / q.dxc;
  const float s2inv = 1.0f / (q.scale * q.scale);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2];
    const float r = sphere::radius(px, py, pz);   // the hat cell needs its ulp
    const float rs = r / q.scale;
    const bool outside = r > q.rb;
    const float xi = sphere::ximap(fminf(rs, q.rmax), q);
    const float dxidr = q.cmap == 1 ? 0.5f * (1.0f - xi) * (1.0f - xi) / q.rmap : 1.0f;
    float w[3];
    const int j0 = sphere::radial_weights(xi, q, w);

    const float base = outside ? q.rb / r : 1.0f;
    float att[L + 1];
    att[0] = base;
#pragma unroll
    for (int l = 1; l <= L; ++l) att[l] = att[l - 1] * base;

    const float rinv = 1.0f / r;
    const float ux = px * rinv, uy = py * rinv, uz = pz * rinv;
    float mono[NM];
    sphere::monomials<L>(mono, ux, uy, uz);

    const Point a{mono, att, twT + j0, rows, w[0], w[1], w[2], idx, dxidr, rs,
                  outside, q.hat != 0};
    Sums s{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    add_rows<L>(a, Ms, s, std::make_integer_sequence<int, P>{});

    const float uT = ux * s.tx + uy * s.ty + uz * s.tz;
    const float rsinv = rinv / q.scale;
    acc[3 * i] = -(ux * s.r * s2inv + (s.tx - ux * uT) * rsinv);
    acc[3 * i + 1] = -(uy * s.r * s2inv + (s.ty - uy * uT) * rsinv);
    acc[3 * i + 2] = -(uz * s.r * s2inv + (s.tz - uz * uT) * rsinv);
    pot[i] = s.pot / q.scale;
  }
}

template <int L>
cudaError_t launch(const float* x, long long n, const float* twT, const float* Ms,
                   const Params& q, float* acc, float* pot, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * 4 * sphere::npacked(L) * nmono(L);
  cudaError_t err = cudaFuncSetAttribute(
      accel_poly_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accel_poly_kernel<L>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long full = (long long)nsm * per_sm;
  const int grid = (int)(need < full ? need : full);
  accel_poly_kernel<L><<<grid, kThreads, smem, stream>>>(x, n, twT, Ms, q, acc, pot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), twT the coefficient-contracted table ((2P, nc + 2) 'spline',
// (P, nc) with hat = 1), Ms (4P, n_mono) from poly_matrix_stack; outputs acc
// (n, 3) and pot (n,).  All f32, contiguous, on the current device.  Returns
// a cudaError_t.
int sphere_accel_poly_launch(const void* x, long long n, const void* twT,
                             const void* Ms, void* acc, void* pot, int lmax,
                             int nmax, int nc, int cmap, float xmin, float dxc,
                             float rmin, float rmax, float rmap, float scale,
                             float rb, int hat, void* stream) {
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, rb, hat};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto tf = static_cast<const float*>(twT);
  auto mf = static_cast<const float*>(Ms);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  switch (lmax) {
    case 0: return launch<0>(xf, n, tf, mf, q, af, pf, s);
    case 1: return launch<1>(xf, n, tf, mf, q, af, pf, s);
    case 2: return launch<2>(xf, n, tf, mf, q, af, pf, s);
    case 3: return launch<3>(xf, n, tf, mf, q, af, pf, s);
    case 4: return launch<4>(xf, n, tf, mf, q, af, pf, s);
    case 5: return launch<5>(xf, n, tf, mf, q, af, pf, s);
    case 6: return launch<6>(xf, n, tf, mf, q, af, pf, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* sphere_accel_poly_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
