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
// What bounds it on an H100: the per-particle arithmetic (28 bytes of
// particle memory against ~600 FP32 operations at lmax 4: the 215 nonzero
// products of the stack, the interpolation of 2P table rows, the sums),
// on the CUDA cores.  The first version multiplied every entry that
// degree and parity allow (886 at lmax 4, of which 215 are nonzero), each
// with a shared-memory load of its Ms entry, and kept its monomials in
// local memory (a 144-byte stack frame at lmax 4, 368 with spills at 6):
// 0.24 ms at 2^20 rows, of which its split put only 13% in the Ms loads
// (PERF.md §6).
//
// Design: one thread a particle, a template on LMAX (0..10) and on the
// interpolation, so the monomials and every row index are compile-time
// constants and live in registers: at lmax 0..6 the monomials as they are,
// at 7..10 their even form (sphere_common.cuh EvenMonomials: 56 values and
// 8 parity factors at lmax 10 where the 286 monomials would spill), each
// stack row one factor times a sum over the even products.  Only the
// nonzeros of the stack are multiplied: their pattern
// (csrc/sphere_poly_support.cuh, generated from
// ops/sphere_kernels.k6_support, which the wrapper checks Ms against) is
// unrolled at compile time, and their values reach the kernel as a
// parameter (MsNz, 860 bytes at lmax 4, 3.8 KB at 6, 30.0 KB at 10: the
// 7,494 nonzeros fit the 32,764 bytes of launch parameters), so each product
// reads its factor from the constant bank at a fixed offset, with no
// load.  A row's terms are added in the monomials' order, as the first
// version added them (the skipped products were exact zeros).  Each
// packed row is interpolated from twT as it is assembled, K2's row-major
// table read through L1/L2 (2 x 49 x 258 floats at lmax 6 'spline'); the
// outside derivative multiplies by 1/rs.  The launch covers the rows
// (ops/sphere_kernels.k6_plan), so the launcher queries nothing.  No
// stack frame at any lmax.  Measured (PERF.md §6; NVIDIA H100 80GB
// HBM3, 700 W, 2^20 rows, lmax 4): ~0.069 ms 'spline', ~0.045 'hat', 3.5x
// and 5x the first version, and below K2's 0.095 on the same function.
#include <utility>

#include "sphere_common.cuh"
#include "sphere_poly_support.cuh"

namespace {

using sphere::nmono;
using sphere::Params;
using sphere::PolySupport;

// the largest lmax whose monomials a thread holds as they are; above, their
// even form (sphere::EvenMonomials)
constexpr int kMonoL = 6;

// the nonzero entries of the stack, in PolySupport's order
template <int L>
struct MsNz {
  float v[PolySupport<L>::kNnz];
};

// entry E of the pattern: its monomial, and the first entry of row R
template <int L, int E>
struct Col {
  static constexpr int value = PolySupport<L>::col[E];
};
template <int L, int R>
struct RowStart {
  static constexpr int value = PolySupport<L>::start[R];
};

// sum over the nonzeros E0 + e of one stack row of v[E0 + e] mono[col]
template <int L, int E0, int... e>
__device__ __forceinline__ float dot_row(const MsNz<L>& M, const float* mono,
                                         std::integer_sequence<int, e...>) {
  float s = 0.0f;
  ((s += M.v[E0 + e] * mono[Col<L, E0 + e>::value]), ...);
  return s;
}

template <int L, int R>
__device__ __forceinline__ float stack_row(const MsNz<L>& M, const float* mono) {
  constexpr int e0 = RowStart<L, R>::value, e1 = RowStart<L, R + 1>::value;
  return dot_row<L, e0>(M, mono, std::make_integer_sequence<int, e1 - e0>{});
}

// the same row from the monomials' even form (lmax 7..10)
template <int L, int R>
__device__ __forceinline__ float stack_row(const MsNz<L>& M,
                                           const sphere::EvenMonomials<L>* ev) {
  return sphere::even_pattern_row<PolySupport<L>, L, R>(M.v, *ev);
}

// A: the monomials (const float*, lmax 0..6) or their even form
template <class A>
struct PointOf {
  A mono;
  const float* att;    // (r_b/r)^(l+1), l = 0..L
  const float* tw;     // twT at the first node
  int rows;
  float w0, w1, w2, idx, dxidr, rsinv;
  bool outside;
};

using Point = PointOf<const float*>;

struct Sums {
  float pot, tx, ty, tz, r;
};

template <int L, bool HAT, int Pr, class A>
__device__ __forceinline__ void add_row(const PointOf<A>& a, const MsNz<L>& M, Sums& s) {
  constexpr int P = sphere::npacked(L);
  constexpr int l = sphere::row_l(Pr, L);
  const float* t = a.tw + Pr * a.rows;
  const float ta = __ldg(t), tb = __ldg(t + 1);
  float pc, dpc;
  if constexpr (HAT) {   // each product rounded on its own, as the plain version
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
  const float dg = a.outside ? -pc * ((float)(l + 1) * at) * a.rsinv : dpc * at;
  const float y = stack_row<L, Pr>(M, a.mono);
  s.pot += y * g;
  s.r += y * dg;
  s.tx += stack_row<L, P + Pr>(M, a.mono) * g;
  s.ty += stack_row<L, 2 * P + Pr>(M, a.mono) * g;
  s.tz += stack_row<L, 3 * P + Pr>(M, a.mono) * g;
}

template <int L, bool HAT, class A, int... Pr>
__device__ __forceinline__ void add_rows(const PointOf<A>& a, const MsNz<L>& M, Sums& s,
                                         std::integer_sequence<int, Pr...>) {
  (add_row<L, HAT, Pr>(a, M, s), ...);
}

// HAT: the 'hat' interpolation (q.hat = 1), else 'spline'
template <int L, bool HAT>
__global__ void __launch_bounds__(256)
accel_poly_kernel(const float* __restrict__ x, long long n,
                  const float* __restrict__ twT, const __grid_constant__ MsNz<L> M,
                  Params q, float* __restrict__ acc, float* __restrict__ pot) {
  constexpr int P = sphere::npacked(L), NM = nmono(L);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
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
  Sums s{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (L <= kMonoL) {
    float mono[NM];
    sphere::monomials<L>(mono, ux, uy, uz);
    const Point a{mono, att, twT + j0, sphere::table_rows(q), w[0], w[1], w[2],
                  1.0f / q.dxc, dxidr, 1.0f / rs, outside};
    add_rows<L, HAT>(a, M, s, std::make_integer_sequence<int, P>{});
  } else {
    const sphere::EvenMonomials<L> ev(ux, uy, uz);
    const PointOf<const sphere::EvenMonomials<L>*> a{
        &ev, att, twT + j0, sphere::table_rows(q), w[0], w[1], w[2],
        1.0f / q.dxc, dxidr, 1.0f / rs, outside};
    add_rows<L, HAT>(a, M, s, std::make_integer_sequence<int, P>{});
  }

  const float uT = ux * s.tx + uy * s.ty + uz * s.tz;
  const float s2inv = 1.0f / (q.scale * q.scale);
  const float rsinv = rinv / q.scale;
  acc[3 * i] = -(ux * s.r * s2inv + (s.tx - ux * uT) * rsinv);
  acc[3 * i + 1] = -(uy * s.r * s2inv + (s.ty - uy * uT) * rsinv);
  acc[3 * i + 2] = -(uz * s.r * s2inv + (s.tz - uz * uT) * rsinv);
  pot[i] = s.pot / q.scale;
}

template <int L>
cudaError_t launch(const float* x, long long n, const float* twT, const float* Mnz,
                   const Params& q, float* acc, float* pot, int threads, int blocks,
                   cudaStream_t stream) {
  MsNz<L> M;
  for (int e = 0; e < PolySupport<L>::kNnz; ++e) M.v[e] = Mnz[e];
  if (q.hat)
    accel_poly_kernel<L, true><<<blocks, threads, 0, stream>>>(x, n, twT, M, q, acc, pot);
  else
    accel_poly_kernel<L, false><<<blocks, threads, 0, stream>>>(x, n, twT, M, q, acc, pot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), twT the coefficient-contracted table ((2P, nc + 2) 'spline',
// (P, nc) with hat = 1); outputs acc (n, 3) and pot (n,): f32, contiguous,
// on the current device.  Ms_nz the nonzeros of the stack Ms (4P, n_mono)
// in row-major order (ops/sphere_kernels.k6_support), f32 in host memory,
// copied into the launch's parameters.  The plan (ops/sphere_kernels.
// k6_plan): `blocks` blocks of `threads` threads (a multiple of 32, at
// most 256) covering the n rows.  Returns a cudaError_t.
int sphere_accel_poly_launch(const void* x, long long n, const void* twT,
                             const void* Ms_nz, void* acc, void* pot, int threads,
                             int blocks, int lmax, int nmax, int nc, int cmap, float xmin,
                             float dxc, float rmin, float rmax, float rmap, float scale,
                             float rb, int hat, void* stream) {
  if (threads < 32 || threads > 256 || threads % 32 || blocks < 0 ||
      (long long)blocks * threads < n)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, rb, hat};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto tf = static_cast<const float*>(twT);
  auto mf = static_cast<const float*>(Ms_nz);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  switch (lmax) {
    case 0: return launch<0>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 1: return launch<1>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 2: return launch<2>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 3: return launch<3>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 4: return launch<4>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 5: return launch<5>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 6: return launch<6>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 7: return launch<7>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 8: return launch<8>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 9: return launch<9>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    case 10: return launch<10>(xf, n, tf, mf, q, af, pf, threads, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* sphere_accel_poly_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
