// EOF cylinder coefficient pass (K4) for Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_cylinder.py make_cyl_coef_kernel (the TPU
// kernel at its pallas_call, :164), CylinderForce's pallas coefficient pass
// for both pallas_interp='spline' (the default) and 'linear'.
//
// Computes, for particles x (N, 3), mass (N,), the raw MTTKRP sums
//   w_i = mass_i if r_i <= rmax_grid else 0
//   G[jx, t, jy] = sum_i Wx[jx, i] * (w_i trig_t(phi_i)) * Wy[jy, i]
// with t = cs*(M+1) + m over cos(m phi), sin(m phi) (angle addition), Wx the
// x weights (3 spline or 2 hat weights a particle) and Wy the 2 y hats.  The
// caller contracts G with the coarse pot table and applies -4 pi
// (ops/cyl_kernels.contract_coef_output).
//
// What bounds it on an H100, at the disk bench's shapes (mmax=6, xrows=66,
// ncy=128, N = 2^20, 'spline'): bytes, narrowly.  It must move 17.3 MB (16
// bytes a particle in, G out; 5.1 us at 3.35 TB/s) and do at least 0.30
// GFLOP of FP32 (about 288 a particle: the geometry, arcsinh, weights and
// trig, the 6 node weights once, then 6 nonzero (jx, jy) nodes x 13
// nonzero trig rows = 78 multiply-adds into G; 4.5 us at 67 TFLOP/s).  In
// practice the 78 read-modify-writes into G limit it: they are
// shared-memory atomics, and in a thin disk many particles of a warp land
// on the same nodes.
//
// Design: the TPU accumulated G in one VMEM block across a sequential grid;
// here blocks run in parallel and G (66 x 14 x 128 f32 = 473 KB at the
// bench's shapes) does not fit one block's shared memory.  The trig rows are
// split into groups of `tg` rows (4 at the bench's shapes: 135 KB of shared
// accumulator, one 1024-thread block per SM), and the grid is (chunks,
// groups): block (c, g) walks particle chunk c, computes each particle's
// geometry, weights and trig rows, and adds its 6 nodes x tg rows into a
// shared (xrows, tg, ncy) accumulator with shared-memory atomics.  Only the
// nonzero weights are touched (the TPU multiplied dense (xrows, B) and
// (ncyp, B) weight matrices), and particles outside the mask add nothing,
// so zero-mass rows give exactly 0.  Each block writes its slice to a
// partial (chunks, xrows, T, ncy) buffer, and a second kernel sums the
// chunks in a fixed order.  The atomics sum in a varying order inside a
// block, so G varies between runs at f32 rounding level.
#include "cyl_common.cuh"

namespace {

using cyl::Params;

constexpr int kThreads = 1024;

template <int MMAX, bool SPLINE>
__global__ void __launch_bounds__(kThreads)
coef_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                long long n, Params q, int tg, float* __restrict__ partial) {
  constexpr int M1 = MMAX + 1, T = 2 * M1, KX = cyl::XNodes<SPLINE>::K;
  const int xrows = SPLINE ? q.ncx + 2 : q.ncx;
  const int ncy = q.ncy;
  const int chunk = blockIdx.x, nchunks = gridDim.x;
  const int t0 = blockIdx.y * tg;
  const int t1 = min(t0 + tg, T);

  extern __shared__ float acc[];                 // (xrows, tg, ncy)
  const int nacc = xrows * tg * ncy;
  for (int e = threadIdx.x; e < nacc; e += blockDim.x) acc[e] = 0.0f;
  __syncthreads();

  const long long per = (n + nchunks - 1) / nchunks;
  const long long lo = (long long)chunk * per;
  const long long hi = lo + per < n ? lo + per : n;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const float px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2];
    float R, r;
    cyl::cyl_maps(px, py, pz, R, r);
    const float w = r <= q.rmax_grid ? mass[i] : 0.0f;
    if (w == 0.0f) continue;                     // adds nothing
    float c[M1], s[M1];
    cyl::trig_rows<MMAX>(px / R, py / R, c, s);
    float tx, ty;
    cyl::grid_coords(R, pz, q, tx, ty);
    int jx[KX], jy[2];
    float wx[KX], wy[2];
    cyl::x_weights<SPLINE>(tx, q.ncx, jx, wx);
    cyl::y_weights(ty, ncy, jy, wy);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (t == M1) continue;                     // sin(0 phi) == 0
      if (t < t0 || t >= t1) continue;
      const float val = w * (t < M1 ? c[t] : s[t - M1]);
      float* base = acc + (t - t0) * ncy;
#pragma unroll
      for (int a = 0; a < KX; ++a) {
        const float va = wx[a] * val;            // A = Wx * (w trig), as the TPU
        float* row = base + jx[a] * tg * ncy;
        atomicAdd(row + jy[0], va * wy[0]);
        atomicAdd(row + jy[1], va * wy[1]);
      }
    }
  }
  __syncthreads();

  // this block's rows [t0, t1) of G into its chunk's partial
  const int nt = t1 - t0;
  float* out = partial + (long long)chunk * xrows * T * ncy;
  for (int e = threadIdx.x; e < xrows * nt * ncy; e += blockDim.x) {
    const int jyy = e % ncy, tl = (e / ncy) % nt, jxx = e / (ncy * nt);
    out[((long long)jxx * T + t0 + tl) * ncy + jyy] = acc[(jxx * tg + tl) * ncy + jyy];
  }
}

// G = the sum of the chunk partials, in chunk order (deterministic).
__global__ void coef_reduce(const float* __restrict__ partial, int nchunks,
                            long long total, float* __restrict__ G) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < nchunks; ++c) s += partial[(long long)c * total + e];
    G[e] = s;
  }
}

template <int MMAX, bool SPLINE>
cudaError_t launch(const float* x, const float* mass, long long n, const Params& q,
                   int tg, int nchunks, float* partial, float* G, cudaStream_t stream) {
  constexpr int T = 2 * (MMAX + 1);
  const int xrows = SPLINE ? q.ncx + 2 : q.ncx;
  if (tg < 1 || tg > T || nchunks < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)xrows * tg * q.ncy;
  cudaError_t err = cudaFuncSetAttribute(coef_accumulate<MMAX, SPLINE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nchunks, (T + tg - 1) / tg);
  coef_accumulate<MMAX, SPLINE><<<grid, kThreads, smem, stream>>>(x, mass, n, q, tg, partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = (long long)xrows * T * q.ncy;
  const int rblocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  coef_reduce<<<rblocks, 256, 0, stream>>>(partial, nchunks, total, G);
  return cudaGetLastError();
}

template <bool SPLINE>
cudaError_t dispatch(const float* x, const float* mass, long long n, const Params& q,
                     int tg, int nchunks, float* partial, float* G, cudaStream_t s) {
  switch (q.mmax) {
    case 0: return launch<0, SPLINE>(x, mass, n, q, tg, nchunks, partial, G, s);
    case 1: return launch<1, SPLINE>(x, mass, n, q, tg, nchunks, partial, G, s);
    case 2: return launch<2, SPLINE>(x, mass, n, q, tg, nchunks, partial, G, s);
    case 3: return launch<3, SPLINE>(x, mass, n, q, tg, nchunks, partial, G, s);
    case 4: return launch<4, SPLINE>(x, mass, n, q, tg, nchunks, partial, G, s);
    case 5: return launch<5, SPLINE>(x, mass, n, q, tg, nchunks, partial, G, s);
    case 6: return launch<6, SPLINE>(x, mass, n, q, tg, nchunks, partial, G, s);
    case 7: return launch<7, SPLINE>(x, mass, n, q, tg, nchunks, partial, G, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), partial (nchunks, xrows, T, ncy) scratch, G (xrows,
// T, ncy) output, T = 2(mmax+1), xrows = ncx + 2 ('spline') or ncx
// ('linear'); all f32, contiguous, on the current device.  tg trig rows a
// block (their (xrows, tg, ncy) accumulator must fit the block's shared
// memory), nchunks particle chunks.  Returns a cudaError_t.
int cyl_coef_launch(const void* x, const void* mass, long long n, void* partial,
                    void* G, int tg, int nchunks, int spline, int mmax, int ncx,
                    int ncy, float acyl, float hcyl, float xmin, float dxc,
                    float ymin, float dy, float rmax_grid, void* stream) {
  Params q{mmax, ncx, ncy, acyl, hcyl, xmin, dxc, ymin, dy, rmax_grid};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto pf = static_cast<float*>(partial);
  auto gf = static_cast<float*>(G);
  return spline ? dispatch<true>(xf, mf, n, q, tg, nchunks, pf, gf, s)
                : dispatch<false>(xf, mf, n, q, tg, nchunks, pf, gf, s);
}

const char* cyl_coef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
