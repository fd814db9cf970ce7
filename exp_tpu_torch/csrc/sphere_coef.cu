// Sphere coefficient pass (K1) for Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_sphere.py make_coef_kernel_poly (the TPU
// kernel at its pallas_call, :521), as selected by SphereSL's default
// pallas_harmonics='auto' at lmax <= 6 with pallas_interp='spline'.
//
// Computes, for particles x (N, 3), mass (N,):
//   w_i   = mass_i if rmin <= r_i/scale <= rmax else 0
//   Y_pi  = sum_k M[p, k] mono_k(x_i / r_i)          (packed real-Ylm rows)
//   S[p, j] = sum_i w_i Y_pi b2(j - 1 - t_i)          (3 nonzero j per i)
//   coef[cs, l, m, n] = -4 pi sum_j S[p(cs,l,m), j] tab[j, l*nmax + n]
//
// What bounds it on an H100: not memory (16 bytes a particle, 17 MB at
// N = 2^20, about 5 us at 3.35 TB/s) but the per-particle arithmetic on the
// CUDA cores: the monomials, the M . mono product (334 nonzero FMAs at
// lmax=4 of the dense 25 x 35) and 75 accumulations into the (P, rows)
// table, together several hundred FP32 operations a particle.
//
// Design: one thread per particle for the geometry and the angular rows.
// The structural zeros of M (degree above l, or of the other parity) are
// skipped at compile time (template on LMAX).  Only the 3 nonzero spline
// weights are used, where the TPU built a dense (rows, B) weight matrix.
// Each warp owns a private (P, rows) f32 accumulator in shared memory
// (25 x 259 floats at lmax=4, rows padded to an odd stride so the 25 lanes
// of one update hit 25 banks); a warp stages its 32 particles' rows in
// shared memory and then adds them particle by particle, lane p updating
// row p, so no atomics are needed and the sum order is fixed.  The block
// sums its warps' accumulators in warp order into one partial per block,
// and a second kernel reduces the partials in block order and contracts
// them with the radial table: the whole pass is deterministic.
#include <utility>

#include "sphere_common.cuh"

namespace {

using sphere::Params;

__host__ __device__ constexpr int nmono(int L) {
  return (L + 1) * (L + 2) * (L + 3) / 6;
}

// Monomial k in the order degree, then i descending, then j descending
// (exp_tpu solidharm.monomial_exponents): its degree and exponents.
__host__ __device__ constexpr int mono_deg(int k) {
  int d = 0;
  while (nmono(d) <= k) ++d;
  return d;
}
__host__ __device__ constexpr int mono_i(int k) {
  int d = mono_deg(k), r = k - (d == 0 ? 0 : nmono(d - 1));
  int i = d;
  while (r > d - i) { r -= d - i + 1; --i; }
  return i;
}
__host__ __device__ constexpr int mono_j(int k) {
  int d = mono_deg(k), r = k - (d == 0 ? 0 : nmono(d - 1));
  int i = d;
  while (r > d - i) { r -= d - i + 1; --i; }
  return d - i - r;
}
// index of the monomial of degree d with exponents (i, j, d - i - j)
__host__ __device__ constexpr int mono_index(int d, int i, int j) {
  int k = d == 0 ? 0 : nmono(d - 1);
  for (int a = d; a > i; --a) k += d - a + 1;
  return k + (d - i) - j;
}

// Monomial K is a lower-degree monomial times one component of u: split off
// the first axis with a nonzero exponent (solidharm.monomial_build_plan).
// Everything here is evaluated by the compiler's front end.
template <int K>
struct MonoStep {
  static constexpr int i = mono_i(K), j = mono_j(K), d = mono_deg(K);
  static constexpr int axis = i > 0 ? 0 : (j > 0 ? 1 : 2);
  static constexpr int src = mono_index(d - 1, i - (axis == 0), j - (axis == 1));
};

constexpr int kWarp = 32;

template <int L>
struct Layout {
  static constexpr int P = sphere::npacked(L);
  static constexpr int NM = nmono(L);
  static constexpr int PS = P | 1;        // staged-row stride (odd)
};

template <int... K>
__device__ __forceinline__ void monomials(float* mono, float ux, float uy,
                                          float uz, std::integer_sequence<int, K...>) {
  mono[0] = 1.0f;
  ((mono[K + 1] = mono[MonoStep<K + 1>::src] *
                  (MonoStep<K + 1>::axis == 0 ? ux
                                              : (MonoStep<K + 1>::axis == 1 ? uy : uz))),
   ...);
}

// s += M[p, k] mono_k, only where M can be nonzero: monomial degree <= l and
// of the parity of l (the harmonic fit's support in solidharm)
template <int L, int Pr, int K>
__device__ __forceinline__ void mac(float& s, const float* Mrow, const float* mono) {
  constexpr int l = sphere::row_l(Pr, L), d = mono_deg(K);
  if constexpr (d <= l && ((l - d) & 1) == 0) s += Mrow[K] * mono[K];
}

template <int L, int Pr, int... K>
__device__ __forceinline__ float yrow(const float* Mrow, const float* mono,
                                      std::integer_sequence<int, K...>) {
  float s = 0.0f;
  (mac<L, Pr, K>(s, Mrow, mono), ...);
  return s;
}

template <int L, int... Pr>
__device__ __forceinline__ void yrows(float* Y, const float* Ms, const float* mono,
                                      float wm, std::integer_sequence<int, Pr...>) {
  constexpr int NM = Layout<L>::NM;
  ((Y[Pr] = yrow<L, Pr>(Ms + Pr * NM, mono, std::make_integer_sequence<int, NM>{}) * wm),
   ...);
}

template <int L>
__global__ void __launch_bounds__(256)
coef_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                long long n, const float* __restrict__ Mg, Params q,
                float* __restrict__ partial) {
  constexpr int P = Layout<L>::P, NM = Layout<L>::NM, PS = Layout<L>::PS;
  const int rows = q.nc + 2;
  const int RS = rows | 1;
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  extern __shared__ float sh[];
  float* Ms = sh;                                   // P * NM
  float* acc_all = Ms + P * NM;                     // nw * P * RS
  float* stage_all = acc_all + nw * P * RS;         // nw * 32 * (PS + 4)
  float* acc = acc_all + warp * P * RS;
  float* ysh = stage_all + warp * kWarp * (PS + 4);
  float* wsh = ysh + kWarp * PS;                    // 32 x (3 weights + c)

  for (int e = threadIdx.x; e < P * NM; e += blockDim.x) Ms[e] = Mg[e];
  for (int e = threadIdx.x; e < nw * P * RS; e += blockDim.x) acc_all[e] = 0.0f;
  __syncthreads();

  const long long ntiles = (n + kWarp - 1) / kWarp;
  for (long long tile = (long long)blockIdx.x * nw + warp; tile < ntiles;
       tile += (long long)gridDim.x * nw) {
    const long long i = tile * kWarp + lane;
    float Y[P];
    float wt[3] = {0.0f, 0.0f, 0.0f};
    int c = 1;
    float wm = 0.0f;
    if (i < n) {
      const float px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2];
      const float r = sqrtf(px * px + py * py + pz * pz) + 1e-10f;
      const float rs = r / q.scale;
      const float xi = sphere::ximap(rs, q);
      const float m = mass[i];
      wm = (rs >= q.rmin && rs <= q.rmax) ? m : 0.0f;
      const float rinv = 1.0f / r;
      float mono[NM];
      monomials(mono, px * rinv, py * rinv, pz * rinv,
                std::make_integer_sequence<int, NM - 1>{});
      yrows<L>(Y, Ms, mono, wm, std::make_integer_sequence<int, P>{});
      c = sphere::spline_weights(xi, q, wt);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) Y[p] = 0.0f;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) ysh[lane * PS + p] = Y[p];
    wsh[lane * 4 + 0] = wt[0];
    wsh[lane * 4 + 1] = wt[1];
    wsh[lane * 4 + 2] = wt[2];
    wsh[lane * 4 + 3] = __int_as_float(wm != 0.0f ? c : 0);
    __syncwarp();
    for (int src = 0; src < kWarp; ++src) {
      const int cc = __float_as_int(wsh[src * 4 + 3]);
      if (cc == 0) continue;                        // masked or past the end
      const float a0 = wsh[src * 4], a1 = wsh[src * 4 + 1],
                  a2 = wsh[src * 4 + 2];
      for (int p = lane; p < P; p += kWarp) {
        const float y = ysh[src * PS + p];
        float* row = acc + p * RS + cc - 1;
        row[0] += y * a0;
        row[1] += y * a1;
        row[2] += y * a2;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  float* out = partial + (long long)blockIdx.x * P * rows;
  for (int e = threadIdx.x; e < P * rows; e += blockDim.x) {
    const int p = e / rows, j = e % rows;
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s += acc_all[w * P * RS + p * RS + j];
    out[e] = s;
  }
}

// One block per (cs, l, m) slot of the output: reduce the block partials of
// its packed row in block order, then contract with the radial table.
__global__ void coef_reduce(const float* __restrict__ partial, int nblocks,
                            const float* __restrict__ tab, Params q,
                            float* __restrict__ coef) {
  const int L = q.lmax, nmax = q.nmax, rows = q.nc + 2;
  const int P = sphere::npacked(L), F = (L + 1) * nmax;
  const int slot = blockIdx.x;
  const int m = slot % (L + 1), l = (slot / (L + 1)) % (L + 1);
  const int cs = slot / ((L + 1) * (L + 1));
  float* out = coef + (long long)slot * nmax;
  const bool valid = m <= l && (cs == 0 || m >= 1);
  if (!valid) {
    for (int k = threadIdx.x; k < nmax; k += blockDim.x) out[k] = 0.0f;
    return;
  }
  const int p = cs == 0 ? l * (l + 1) / 2 + m
                        : sphere::ncos(L) + l * (l - 1) / 2 + (m - 1);

  extern __shared__ float S[];                      // rows
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b)
      s += partial[(long long)b * P * rows + p * rows + j];
    S[j] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nw = blockDim.x / kWarp;
  const float m4pi = (float)(-4.0 * 3.14159265358979323846);
  for (int k = warp; k < nmax; k += nw) {
    float s = 0.0f;
    for (int j = lane; j < rows; j += kWarp) s += S[j] * tab[j * F + l * nmax + k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[k] = m4pi * s;
  }
}

template <int L>
size_t accumulate_smem(int nw, int rows) {
  constexpr int P = Layout<L>::P, NM = Layout<L>::NM, PS = Layout<L>::PS;
  return sizeof(float) * ((size_t)P * NM + (size_t)nw * P * (rows | 1) +
                          (size_t)nw * kWarp * (PS + 4));
}

template <int L>
cudaError_t launch(const float* x, const float* mass, long long n,
                   const float* M, const float* tab, float* partial,
                   int nblocks, float* coef, const Params& q,
                   cudaStream_t stream) {
  const int rows = q.nc + 2;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // as many warps (each with its own accumulator) as shared memory holds
  int nw = 8;
  while (nw > 0 && accumulate_smem<L>(nw, rows) > (size_t)optin) --nw;
  if (nw == 0) return cudaErrorInvalidValue;
  const size_t smem = accumulate_smem<L>(nw, rows);
  err = cudaFuncSetAttribute(coef_accumulate<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  coef_accumulate<L><<<nblocks, nw * kWarp, smem, stream>>>(x, mass, n, M, q, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int slots = 2 * (L + 1) * (L + 1);
  coef_reduce<<<slots, 256, rows * sizeof(float), stream>>>(partial, nblocks, tab, q, coef);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), M (P, n_mono) packed-row monomial matrix with fac,
// tab (nc + 2, (lmax+1)*nmax) spline-prefiltered radial table, partial
// (nblocks, P, nc + 2) scratch, coef (2, lmax+1, lmax+1, nmax) output; all
// f32, contiguous, on the current device.  Returns a cudaError_t.
int sphere_coef_launch(const void* x, const void* mass, long long n,
                       const void* M, const void* tab, void* partial,
                       int nblocks, void* coef, int lmax, int nmax, int nc,
                       int cmap, float xmin, float dxc, float rmin, float rmax,
                       float rmap, float scale, void* stream) {
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, 0.0f};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto Mf = static_cast<const float*>(M);
  auto tf = static_cast<const float*>(tab);
  auto pf = static_cast<float*>(partial);
  auto cf = static_cast<float*>(coef);
  switch (lmax) {
    case 0: return launch<0>(xf, mf, n, Mf, tf, pf, nblocks, cf, q, s);
    case 1: return launch<1>(xf, mf, n, Mf, tf, pf, nblocks, cf, q, s);
    case 2: return launch<2>(xf, mf, n, Mf, tf, pf, nblocks, cf, q, s);
    case 3: return launch<3>(xf, mf, n, Mf, tf, pf, nblocks, cf, q, s);
    case 4: return launch<4>(xf, mf, n, Mf, tf, pf, nblocks, cf, q, s);
    case 5: return launch<5>(xf, mf, n, Mf, tf, pf, nblocks, cf, q, s);
    case 6: return launch<6>(xf, mf, n, Mf, tf, pf, nblocks, cf, q, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* sphere_coef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
