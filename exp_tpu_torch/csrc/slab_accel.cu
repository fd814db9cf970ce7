// Periodic-slab force pass (K10) for Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_slab.py make_slab_accel_kernel (the TPU
// kernel at its pallas_call, :286), SlabForce's pallas force pass for both
// pallas_interp='spline' (the default) and 'linear'.
//
// Computes, for particles x (N, 3), with u = x - floor(x) on the two
// horizontal axes and e_k = e^{+2 pi i (kx u_x + ky u_y)}:
//   inside (|z| <= zmax): T_k, T'_k interpolated at z on the coarse rows,
//     pot = Re sum T e, a_x = Im sum 2 pi kx T e, a_y = Im sum 2 pi ky T e,
//     a_z = -Re sum T' e;
//   outside: the vacuum continuation from the boundary values Tb_k, Td_k of
//     the full-resolution tables at z = +-zmax (the side of z): with
//     dz = |z| - zmax and att = e^{-2 pi |k| dz}, pot = Re sum Tb e att +
//     Td_0 dz sign(z), a_x, a_y = Im sum 2 pi k Tb e att, a_z = -Td_0 +
//     sign(z) sum 2 pi |k| Re(Tb e att).
// From tab (zrows, H, 4), the profiles (Re T, Im T, Re T', Im T') folded
// onto the half lattice (T_h + conj T_{-h}; ops/slab_kernels.slab_force_table)
// and aux (H, 8), the folded boundary rows (top pot, bottom pot, top dPhi/dz,
// bottom dPhi/dz, each (re, im); slab_force_aux).  Since Re and Im of conj(z)
// are Re z and -Im z, the terms k and -k of every output sum to the folded
// term at k, and att depends on |k| only, so only the H half-lattice
// wavevectors are visited: 41 of 81 at nmax 4 x 4.
//
// What bounds it on an H100, at the slab bench's shapes (nmax 4 x 4,
// zrows = 128, N = 2^20, 'spline'): operations.  It moves 28 bytes a
// particle (12 read, 16 written: 29 MB, 9 us at 3.35 TB/s) and the table
// once (84 KB); the function needs, per particle and half-lattice
// wavevector, the 4 profiles at 3 nodes (12 FMAs), e_h and the assembly,
// about 2 GFLOP at 2^20 (chip_smoke.py k10_work).
//
// Design: one thread per particle, grid-stride over a grid that fills the
// card once.  e_h by angle addition along the (kx, ky) loops from one
// sincospif an axis (cube_common.cuh).  A particle's KZ rows are contiguous
// (z-major layout), read with 16-byte loads through L1/L2, as the boundary
// rows are.  (Staging the table in shared memory, two blocks an SM, took
// 0.1346 ms against 0.1375 ms through L1/L2 at the bench's shapes on an
// H100 80GB HBM3 at 700 W, and does not fit at larger nmax: not kept.)
// The 2 pi kx, 2 pi ky and 2 pi |k| factors are computed from h, not read.  The outside branch is taken per particle (a warp
// diverges only where it holds particles on both sides), and exp(-2 pi |k|
// dz) goes to 0 for far particles without NaN.  No fast-math intrinsics.
#include "slab_common.cuh"

namespace {

using slab::Params;

constexpr int kThreads = 256;

struct Sums {
  float pot, fx, fy, fz;
};

// f(h, kx, ky, e_k) for every half-lattice wavevector, e_k = px^kx py^ky by
// angle addition (ky < 0 through the conjugate of py^|ky|).
template <class F>
__device__ __forceinline__ void half_lattice(float2 e1x, float2 e1y, int nx, int ny, F&& f) {
  const int B2 = 2 * ny + 1;
  float2 px = make_float2(1.0f, 0.0f);
  for (int a = 0; a <= nx; ++a) {
    float2 py = make_float2(1.0f, 0.0f);
    for (int b = 0; b <= ny; ++b) {
      f(a * B2 + b, a, b, cube::cmul(px, py));
      if (a > 0 && b > 0) f(a * B2 - b, a, -b, cube::cmul(px, cube::conj(py)));
      py = cube::cmul(py, e1y);
    }
    px = cube::cmul(px, e1x);
  }
}

template <int KZ>
__global__ void __launch_bounds__(kThreads)
accel_kernel(const float* __restrict__ x, long long n, const float4* __restrict__ tab,
             const float4* __restrict__ aux, Params q, float* __restrict__ acc,
             float* __restrict__ pot) {
  const int H = slab::half_count(q.nx, q.ny);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float pz = x[3 * i + 2];
    const float2 e1x = cube::unit_phase(cube::wrap(x[3 * i]), 1.0f);
    const float2 e1y = cube::unit_phase(cube::wrap(x[3 * i + 1]), 1.0f);
    const float dzp = fmaxf(fabsf(pz) - q.zmax, 0.0f);
    Sums s{0.0f, 0.0f, 0.0f, 0.0f};
    if (dzp > 0.0f) {
      const bool top = pz >= 0.0f;
      const float szn = top ? 1.0f : -1.0f;
      half_lattice(e1x, e1y, q.nx, q.ny, [&](int h, int kx, int ky, float2 e) {
        const float4 b = __ldg(aux + 2 * h);
        const float2 t = cube::cmul(top ? make_float2(b.x, b.y) : make_float2(b.z, b.w), e);
        const float km = cube::kTwoPi * sqrtf((float)(kx * kx + ky * ky));
        const float att = expf(-km * dzp);
        const float oer = t.x * att, oei = t.y * att;
        s.pot += oer;
        s.fx += cube::kTwoPi * (float)kx * oei;
        s.fy += cube::kTwoPi * (float)ky * oei;
        s.fz += szn * (km * oer);
      });
      const float4 d = __ldg(aux + 1);              // k = 0, where e = 1
      const float td = top ? d.x : d.z;
      s.pot += td * dzp * szn;
      s.fz -= td;
    } else {
      float w[KZ];
      const int j0 = slab::z_nodes<KZ>(slab::z_grid(pz, q), q.nzc, w);
      const float4* rows = tab + (size_t)j0 * H;
      half_lattice(e1x, e1y, q.nx, q.ny, [&](int h, int kx, int ky, float2 e) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int k = 0; k < KZ; ++k) {
          const float4 r = __ldg(rows + k * H + h);
          v.x += w[k] * r.x;
          v.y += w[k] * r.y;
          v.z += w[k] * r.z;
          v.w += w[k] * r.w;
        }
        const float wr = v.x * e.x - v.y * e.y;
        const float wi = v.x * e.y + v.y * e.x;
        s.pot += wr;
        s.fx += cube::kTwoPi * (float)kx * wi;
        s.fy += cube::kTwoPi * (float)ky * wi;
        s.fz -= v.z * e.x - v.w * e.y;
      });
    }
    acc[3 * i] = s.fx;
    acc[3 * i + 1] = s.fy;
    acc[3 * i + 2] = s.fz;
    pot[i] = s.pot;
  }
}

template <int KZ>
cudaError_t launch(const float* x, long long n, const float* tab, const float* aux,
                   const Params& q, float* acc, float* pot, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accel_kernel<KZ>,
                                                           kThreads, 0)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long full = (long long)nsm * per_sm;
  const int grid = (int)(need < full ? need : full);
  accel_kernel<KZ><<<grid, kThreads, 0, stream>>>(
      x, n, reinterpret_cast<const float4*>(tab), reinterpret_cast<const float4*>(aux), q,
      acc, pot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), tab (zrows, H, 4) folded z-profiles, aux (H, 8) boundary rows;
// outputs acc (n, 3) and pot (n,).  All f32, contiguous, on the current
// device, tab and aux 16-byte aligned; nmax 0..8 on each axis, nzc >= 2,
// zrows = nzc + 2 ('spline') or nzc ('linear') at most 128.  Returns a
// cudaError_t.
int slab_accel_launch(const void* x, long long n, const void* tab, const void* aux,
                      void* acc, void* pot, int nmaxx, int nmaxy, int nzc, int spline,
                      float zmax, float dz, void* stream) {
  if (nmaxx < 0 || nmaxx > 8 || nmaxy < 0 || nmaxy > 8 || nzc < 2)
    return cudaErrorInvalidValue;
  const Params q{nmaxx, nmaxy, nzc, spline ? nzc + 2 : nzc, zmax, dz};
  if (q.zrows > 128) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto tf = static_cast<const float*>(tab);
  auto uf = static_cast<const float*>(aux);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  return spline ? launch<3>(xf, n, tf, uf, q, af, pf, s)
                : launch<2>(xf, n, tf, uf, q, af, pf, s);
}

const char* slab_accel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
