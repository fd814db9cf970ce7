// Sphere coefficient pass from the Legendre and trig recurrences (K3) for
// Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_sphere.py make_coef_kernel (the TPU kernel at
// its pallas_call, :249), as selected by SphereSL's pallas_harmonics=
// 'recurrence', and by 'auto' above lmax 6, for pallas_interp='spline' and
// 'hat'.
//
// Computes K1's function with the angular rows from the recurrences: for
// particles x (N, 3), mass (N,),
//   w_i   = mass_i if rmin <= r_i/scale <= rmax else 0
//   Y_pi  = w_i fac[l,m] P_lm(cos th_i) {cos, sin}(m phi_i)   (packed rows)
//   S[p, j] = sum_i Y_pi W_j(t_i)              (W: 3 spline or 2 hat weights)
//   coef[cs, l, m, n] = -4 pi sum_j S[p(cs,l,m), j] tab[j, l*nmax + n]
// with P_lm from _legendre_rows (unclamped cos th) and cos/sin(m phi) by
// angle addition from x/R, y/R (_trig_rows).
//
// What bounds it on an H100: the per-particle arithmetic, not memory (16
// bytes a particle): the recurrences, ~6 operations for each of the
// (L+1)(L+2)/2 Legendre values and 2 for each of the P = (L+1)^2 rows, and 3
// FMAs (2 for 'hat') into each row's table.
//
// Design: K1's deterministic scheme (csrc/sphere_coef.cu), with the packed
// rows split across blocks.  K1 gives each warp a private (P, rows)
// accumulator in shared memory; at lmax 10 that is 121 x 259 floats (122 KiB)
// for 'spline' and 121 x 513 (242 KiB) for 'hat' at numr_c 512, over the
// 227 KiB a block may hold, and a register array Y[P] spills.  Here block
// (bx, g) owns the rows [g G, g G + G) of a group of G <= 32 rows: each warp
// holds a (G, rows) accumulator (32 x 259 or 32 x 513 floats), lane k owns
// row g G + k, and the warp's 32 particles stage only that group's rows in
// shared memory.  The rows come from the recurrences with m outer and l
// inner, so a thread keeps O(1) values in registers and writes each row
// straight to the stage; lmax is a runtime argument.  Each group block
// recomputes the recurrences of its particles (P/G times in all, 4 at lmax
// 10).  Warps add their particles in order, blocks write ordered partials
// (nbx, P, rows), and sphere::coef_reduce sums them in block order and
// contracts with the table: the pass is deterministic.  The wrapper picks G,
// the warps a block and nbx from the device's shared memory.
#include "sphere_common.cuh"

namespace {

using sphere::Params;

constexpr int kWarp = 32;

// shared floats of one block: fac, nw accumulators (G, rows|1), nw stages of
// 32 particles x ((G|1) rows + 3 weights + the first node)
size_t block_smem(int L, int G, int nw, int rows) {
  return sizeof(float) * ((size_t)(L + 1) * (L + 1) + (size_t)nw * G * (rows | 1) +
                          (size_t)nw * kWarp * ((G | 1) + 4));
}

// The packed rows of this block's group, [p0, p0 + G), of one particle with
// mass weight wm: w fac P_lm {cos, sin}(m phi) written to ys[p - p0].
__device__ __forceinline__ void group_rows(float* ys, int p0, int G, int L,
                                           const float* fs, float wm, float x,
                                           float cphi, float sphi) {
  const float somx2 = sqrtf(fmaxf((1.0f - x) * (1.0f + x), 0.0f));
  float cm = 1.0f, sm = 0.0f;     // cos(m phi), sin(m phi)
  float pmm = 1.0f, fact = 1.0f;  // P_mm
  for (int m = 0; m <= L; ++m) {
    if (m > 0) {
      const float c2 = cm * cphi - sm * sphi;
      sm = sm * cphi + cm * sphi;
      cm = c2;
      pmm = pmm * (-fact) * somx2;
      fact += 2.0f;
    }
    float pl1 = 0.0f, pl2 = 0.0f;  // P_{l-1,m}, P_{l-2,m}
    for (int l = m; l <= L; ++l) {
      float plm;
      if (l == m) plm = pmm;
      else if (l == m + 1) plm = x * (float)(2 * m + 1) * pmm;
      else plm = (x * (float)(2 * l - 1) * pl1 - (float)(l + m - 1) * pl2) / (float)(l - m);
      const float wp = wm * fs[l * (L + 1) + m] * plm;
      const int pc = sphere::cos_row(l, m) - p0;
      if (pc >= 0 && pc < G) ys[pc] = wp * cm;
      if (m > 0) {
        const int ps = sphere::sin_row(l, m, L) - p0;
        if (ps >= 0 && ps < G) ys[ps] = wp * sm;
      }
      pl2 = pl1;
      pl1 = plm;
    }
  }
}

__global__ void __launch_bounds__(256)
coef_rec_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                    long long n, const float* __restrict__ fac, Params q, int G,
                    float* __restrict__ partial) {
  const int L = q.lmax, P = sphere::npacked(L);
  const int rows = sphere::table_rows(q), RS = rows | 1, GS = G | 1;
  const int p0 = blockIdx.y * G, g = min(G, P - p0);   // rows of this block
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  extern __shared__ float sh[];
  float* fs = sh;                                    // (L+1)^2
  float* acc_all = fs + (L + 1) * (L + 1);           // nw * G * RS
  float* stage_all = acc_all + nw * G * RS;          // nw * 32 * (GS + 4)
  float* acc = acc_all + warp * G * RS;
  float* ysh = stage_all + warp * kWarp * (GS + 4);
  float* wsh = ysh + kWarp * GS;                     // 32 x (3 weights + node)

  for (int e = threadIdx.x; e < (L + 1) * (L + 1); e += blockDim.x) fs[e] = fac[e];
  for (int e = threadIdx.x; e < nw * G * RS; e += blockDim.x) acc_all[e] = 0.0f;
  __syncthreads();

  const long long ntiles = (n + kWarp - 1) / kWarp;
  for (long long tile = (long long)blockIdx.x * nw + warp; tile < ntiles;
       tile += (long long)gridDim.x * nw) {
    const long long i = tile * kWarp + lane;
    float wt[3] = {0.0f, 0.0f, 0.0f};
    int c = 0;                                       // first node + 1; 0: skip
    if (i < n) {
      const float px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2];
      const float r = sphere::radius(px, py, pz);
      const float R = sqrtf(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py))) + 1e-10f;
      const float rs = r / q.scale;
      const float m = mass[i];
      const float wm = (rs >= q.rmin && rs <= q.rmax) ? m : 0.0f;
      if (wm != 0.0f) {
        group_rows(ysh + lane * GS, p0, g, L, fs, wm, pz / r, px / R, py / R);
        c = sphere::radial_weights(sphere::ximap(rs, q), q, wt) + 1;
      }
    }
    wsh[lane * 4 + 0] = wt[0];
    wsh[lane * 4 + 1] = wt[1];
    wsh[lane * 4 + 2] = wt[2];
    wsh[lane * 4 + 3] = __int_as_float(c);
    __syncwarp();
    if (lane < g) {
      for (int src = 0; src < kWarp; ++src) {
        const int cc = __float_as_int(wsh[src * 4 + 3]);
        if (cc == 0) continue;                       // masked or past the end
        const float y = ysh[src * GS + lane];
        float* row = acc + lane * RS + cc - 1;
        row[0] += y * wsh[src * 4];
        row[1] += y * wsh[src * 4 + 1];
        if (!q.hat) row[2] += y * wsh[src * 4 + 2];
      }
    }
    __syncwarp();
  }
  __syncthreads();

  float* out = partial + (long long)blockIdx.x * P * rows + (long long)p0 * rows;
  for (int e = threadIdx.x; e < g * rows; e += blockDim.x) {
    const int k = e / rows, j = e % rows;
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s += acc_all[w * G * RS + k * RS + j];
    out[e] = s;
  }
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), fac (lmax+1, lmax+1), tab (rows, (lmax+1)*nmax)
// radial table (rows = nc + 2 spline-prefiltered, or nc node values with
// hat = 1), partial (nbx, P, rows) scratch, coef (2, lmax+1, lmax+1, nmax)
// output; all f32, contiguous, on the current device.  The launch plan:
// groups of G rows (grid (nbx, ceil(P / G))), nw warps a block.  Returns a
// cudaError_t.
int sphere_coef_rec_launch(const void* x, const void* mass, long long n,
                           const void* fac, const void* tab, void* partial,
                           int nbx, int G, int nw, void* coef, int lmax,
                           int nmax, int nc, int cmap, float xmin, float dxc,
                           float rmin, float rmax, float rmap, float scale,
                           int hat, void* stream) {
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, 0.0f, hat};
  auto s = static_cast<cudaStream_t>(stream);
  const int P = sphere::npacked(lmax), rows = sphere::table_rows(q);
  if (lmax < 0 || G < 1 || G > kWarp || nw < 1 || nw > 8 || nbx < 1)
    return cudaErrorInvalidValue;
  const size_t smem = block_smem(lmax, G, nw, rows);
  cudaError_t err = cudaFuncSetAttribute(
      coef_rec_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nbx, (P + G - 1) / G);
  coef_rec_accumulate<<<grid, nw * kWarp, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(mass), n,
      static_cast<const float*>(fac), q, G, static_cast<float*>(partial));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sphere::coef_reduce<<<2 * (lmax + 1) * (lmax + 1), 256, rows * sizeof(float), s>>>(
      static_cast<const float*>(partial), nbx, static_cast<const float*>(tab), q,
      static_cast<float*>(coef));
  return cudaGetLastError();
}

const char* sphere_coef_rec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
