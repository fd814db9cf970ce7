// Periodic-cube force pass (K8, and K11b through it) for Hopper, CUDA-core
// FP32.
//
// Replaces: exp_tpu/ops/pallas_cube.py make_cube_accel_kernel_v2 (K8, the
// default pallas_version 2, its pallas_call at :392) and
// make_cube_accel_kernel (K11b, pallas_version 1, :220).  Both compute the
// same function from b = coef * norm; they differ only in how the TPU packs
// b into its force matrix (ops/cube_kernels.py turns either packing into
// this kernel's table).
//
// Computes, for particles x (N, 3), with u = x - floor(x) and e_k(u) =
// e^{+2 pi i k.u}:
//   pot   = Re sum_k b_k e_k,    acc_c = Im sum_k 2 pi k_c b_k e_k,
// from the folded table tab (nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1, 2) f32:
// tab[0, ky, kz] = b_{0, ky, kz} and, for kx > 0, tab[kx, ky, kz] = b_k +
// conj b_{-k} (ops/cube_kernels.cube_force_table).  Since Re and Im of
// conj(z) are Re z and -Im z, the terms k and -k of every output sum to the
// term of tab_k at k, so only the planes kx >= 0 are visited: 7 of 13 at
// nmax = 6.  The fold needs no symmetry of b.
//
// What bounds it on an H100: operations.  It moves 28 bytes a particle (12
// read, 16 written: 117 MB at N = 2^22, 0.035 ms at 3.35 TB/s); the sums
// need two complex multiply-adds a point of the folded lattice (1183 at
// nmax = 6) a particle, about 1.1 ms at 67 TFLOP/s at that N.
//
// Design: one thread per particle, grid-stride over a grid that fills the
// card once.  The table (9.5 KB at nmax = 6) is staged in shared memory by
// each block; every thread reads it in the same order, so each read is a
// broadcast.  The sum is factored as the einsum path of forces/cube.py
// factors it (:214-228): for each (kx, ky) the z contraction
// t = sum_kz tab e_kz and t_z = sum_kz tab 2 pi kz e_kz (the kz rows in
// registers, the template on KZ), then e = e_kx e_ky (angle addition along
// the a and b loops), pot += Re(t e), ax and ay += 2 pi kx, 2 pi ky Im(t e),
// az += Im(t_z e).
#include "cube_common.cuh"

namespace {

constexpr int kThreads = 256;

struct Acc {
  float pot, sa, fy, fz;
};

// one (kx, ky) row of the table against the particle's kz row
template <int KZ>
__device__ __forceinline__ void row_term(const float2* __restrict__ row,
                                         const float2 (&ez)[KZ],
                                         const float2 (&ezk)[KZ], float2 e,
                                         float wky, Acc& s) {
  float2 t = make_float2(0.0f, 0.0f), tz = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < KZ; ++c) {
    const float2 b = row[c];
    t.x += b.x * ez[c].x - b.y * ez[c].y;
    t.y += b.x * ez[c].y + b.y * ez[c].x;
    tz.x += b.x * ezk[c].x - b.y * ezk[c].y;
    tz.y += b.x * ezk[c].y + b.y * ezk[c].x;
  }
  const float wr = t.x * e.x - t.y * e.y;
  const float wi = t.x * e.y + t.y * e.x;
  s.pot += wr;
  s.sa += wi;
  s.fy += wky * wi;
  s.fz += tz.x * e.y + tz.y * e.x;
}

template <int KZ>
__global__ void __launch_bounds__(kThreads)
accel_kernel(const float* __restrict__ x, long long n, const float2* __restrict__ tab,
             int nx, int ny, float* __restrict__ acc, float* __restrict__ pot) {
  constexpr int NZ = (KZ - 1) / 2;
  extern __shared__ float2 T[];
  const int ky = 2 * ny + 1;
  const int tabn = (nx + 1) * ky * KZ;
  for (int e = threadIdx.x; e < tabn; e += blockDim.x) T[e] = tab[e];
  __syncthreads();

  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float2 e1x = cube::unit_phase(cube::wrap(x[3 * i]), 1.0f);
    const float2 e1y = cube::unit_phase(cube::wrap(x[3 * i + 1]), 1.0f);
    const float2 e1z = cube::unit_phase(cube::wrap(x[3 * i + 2]), 1.0f);
    float2 ez[KZ], ezk[KZ];
    cube::axis_row<KZ>(e1z, ez);
#pragma unroll
    for (int c = 0; c < KZ; ++c) {
      const float w = cube::kTwoPi * (float)(c - NZ);
      ezk[c] = make_float2(w * ez[c].x, w * ez[c].y);
    }
    float fx = 0.0f;
    Acc s{0.0f, 0.0f, 0.0f, 0.0f};
    float2 px = make_float2(1.0f, 0.0f);
    for (int a = 0; a <= nx; ++a) {
      s.sa = 0.0f;                        // sum over ky of Im(t e) at this kx
      float2 py = make_float2(1.0f, 0.0f);
      const float2* plane = T + (long long)a * ky * KZ;
      for (int kb = 0; kb <= ny; ++kb) {
        const float wky = cube::kTwoPi * (float)kb;
        row_term<KZ>(plane + (ny + kb) * KZ, ez, ezk, cube::cmul(px, py), wky, s);
        if (kb)
          row_term<KZ>(plane + (ny - kb) * KZ, ez, ezk, cube::cmul(px, cube::conj(py)),
                       -wky, s);
        py = cube::cmul(py, e1y);
      }
      fx += cube::kTwoPi * (float)a * s.sa;
      px = cube::cmul(px, e1x);
    }
    acc[3 * i] = fx;
    acc[3 * i + 1] = s.fy;
    acc[3 * i + 2] = s.fz;
    pot[i] = s.pot;
  }
}

template <int KZ>
cudaError_t launch(const float* x, long long n, const float* tab, int nx, int ny,
                   float* acc, float* pot, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const size_t smem = sizeof(float2) * (size_t)(nx + 1) * (2 * ny + 1) * KZ;
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accel_kernel<KZ>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long full = (long long)nsm * per_sm;
  const int grid = (int)(need < full ? need : full);
  accel_kernel<KZ><<<grid, kThreads, smem, stream>>>(
      x, n, reinterpret_cast<const float2*>(tab), nx, ny, acc, pot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), tab (nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1, 2) folded force table;
// outputs acc (n, 3) and pot (n,).  All f32, contiguous, on the current
// device; nmax 0..8 on each axis.  Returns a cudaError_t.
int cube_accel_launch(const void* x, long long n, const void* tab, void* acc, void* pot,
                      int nmaxx, int nmaxy, int nmaxz, void* stream) {
  if (nmaxx < 0 || nmaxx > 8 || nmaxy < 0 || nmaxy > 8) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto tf = static_cast<const float*>(tab);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  switch (nmaxz) {
    case 0: return launch<1>(xf, n, tf, nmaxx, nmaxy, af, pf, s);
    case 1: return launch<3>(xf, n, tf, nmaxx, nmaxy, af, pf, s);
    case 2: return launch<5>(xf, n, tf, nmaxx, nmaxy, af, pf, s);
    case 3: return launch<7>(xf, n, tf, nmaxx, nmaxy, af, pf, s);
    case 4: return launch<9>(xf, n, tf, nmaxx, nmaxy, af, pf, s);
    case 5: return launch<11>(xf, n, tf, nmaxx, nmaxy, af, pf, s);
    case 6: return launch<13>(xf, n, tf, nmaxx, nmaxy, af, pf, s);
    case 7: return launch<15>(xf, n, tf, nmaxx, nmaxy, af, pf, s);
    case 8: return launch<17>(xf, n, tf, nmaxx, nmaxy, af, pf, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* cube_accel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
