// EOF cylinder coefficient pass (K4) for Hopper, CUDA-core FP32 and
// integer shared-memory atomics.
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
// ncy=128, N = 2^20, 'spline'): the function moves 17.3 MB (16 bytes a
// particle in, G out; 5.1 us at 3.35 TB/s) and needs about 0.30 GFLOP of
// FP32 (4.5 us at 67 TFLOP/s).  The kernel is bound by neither but by its
// scattered adds: each particle adds 6 nodes x 13 nonzero trig rows = 78
// values into G (473 KB), which lives in shared memory split over blocks.
// An FP32 atomic add to shared memory is a compare-and-swap loop on this
// card (SASS ATOMS.CAST.SPIN), an integer one a single instruction
// (ATOMS.ADD); and on a multistep bucket the fixed cost of a launch
// (zeroing, writing out and summing partial copies of G) outweighs the
// particles.
//
// Design.  The 13 nonzero trig rows (sin(0 phi) is skipped) are split into
// `groups` groups of at most tg rows, and G's rows of a group, (xrows, tg,
// ncyp) i32, sit in one block's shared memory; the grid is (chunks,
// groups), and the wrapper's plan (ops/cyl_kernels.coef_plan) sizes chunks
// by the bucket: at least K4_MIN_CHUNK particles a chunk, at most enough
// chunks to fill the SMs once.  A block first sums |mass| over its chunk,
// W, which bounds every entry of G, and takes the fixed-point scale 2^e
// with W 2^e <= 2^30.  One thread a particle computes the geometry,
// weights and trig rows and stages a record: its base offset in the
// accumulator and its kx x 2 x tg updates (wx_a (w trig_t)) wy_b, the
// plain version's product order, each rounded once to the fixed point.
// Then, particle by particle, a warp's lanes add one record's updates with
// integer atomics, lane (a, t, b) at G[jx0 + a, t, jy0 + b]: the row
// stride ncyp = ncy rounded up to 2 mod 32 puts them on 32 distinct banks.
// Integer sums are exact, so G does not depend on the order of the adds:
// the pass is deterministic.  Particles outside the mask add nothing, so
// zero-mass rows give exactly 0.  A bucket of one chunk writes G directly
// (f32, scaled back exactly); several chunks write a partial (chunks,
// xrows, 2M+1, ncy), and a second kernel, coef_reduce, sums it in chunk
// order.
#include "cyl_common.cuh"

namespace {

using cyl::Params;

constexpr int kWarp = 32;
constexpr int kMaxThreads = 768;
constexpr int kBatch = 4;          // particles whose updates go out together


// Row t of G of the r-th nonzero trig row: cos rows 0..M, sin rows M+2..2M+1
// (sin(0 phi) == 0 has no sums).
__device__ __forceinline__ int trig_row(int r, int M1) { return r < M1 ? r : r + 1; }

// Words of a staged particle record: its base offset in the accumulator
// (-1: it adds nothing), then its kx x 2 x tg fixed-point updates in lane
// order; odd, so the 32 lanes writing their records hit 32 banks.
__host__ __device__ constexpr int record_words(int kx, int tg) {
  return (1 + 2 * kx * tg) | 1;
}

// The block's fixed-point scale: 2^e with W 2^e <= 2^30 (exponent clamped
// to the f32 range), W = sum |mass| of the chunk bounds every entry of G.
__device__ __forceinline__ int scale_exponent(float W) {
  if (!(W > 0.0f)) return 0;
  return max(-126, min(126, 30 - (ilogbf(fminf(W, 3.0e38f)) + 1)));
}

// 2^e for |e| <= 126, exactly
__device__ __forceinline__ float pow2(int e) { return __int_as_float((e + 127) << 23); }

template <int MMAX, bool SPLINE>
__global__ void __launch_bounds__(kMaxThreads)
coef_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                long long n, Params q, int tg, int ncyp, long long per,
                float* __restrict__ out) {
  constexpr int M1 = MMAX + 1, R = 2 * MMAX + 1, KX = cyl::XNodes<SPLINE>::K;
  const int xrows = SPLINE ? q.ncx + 2 : q.ncx;
  const int ncy = q.ncy;
  const int chunk = blockIdx.x, nchunks = gridDim.x;
  const int g = blockIdx.y, groups = gridDim.y;
  const int r0 = g * R / groups, ng = (g + 1) * R / groups - r0;
  const int rec = record_words(KX, tg);
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  extern __shared__ int sh[];
  int* acc = sh;                                        // (xrows, tg, ncyp)
  float* wsum = reinterpret_cast<float*>(acc + xrows * tg * ncyp);       // nw
  int* stage = reinterpret_cast<int*>(wsum + nw) + warp * kWarp * rec;
  const int nacc = xrows * tg * ncyp;
  for (int e = threadIdx.x; e < nacc / 4; e += blockDim.x)
    reinterpret_cast<int4*>(acc)[e] = make_int4(0, 0, 0, 0);
  for (int e = nacc / 4 * 4 + threadIdx.x; e < nacc; e += blockDim.x) acc[e] = 0;

  // the chunk's rows and its scale: |G| <= sum |w| <= sum |mass|
  const long long lo = (long long)chunk * per;
  const long long hi = lo + per < n ? lo + per : n;
  float W = 0.0f;
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) W += fabsf(mass[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) W += __shfl_down_sync(0xffffffffu, W, off);
  if (lane == 0) wsum[warp] = W;
  __syncthreads();
  W = 0.0f;
  for (int w = 0; w < nw; ++w) W += wsum[w];
  const int ex = scale_exponent(W);
  const float sc = pow2(ex), inv = pow2(-ex);

  // this lane's update of a particle: x node a, group row tl, y node b, at
  // offset (a tg + tl) ncyp + b from the particle's base
  const int rho = lane >> 1, b = lane & 1;
  const bool active = rho / tg < KX && rho % tg < ng;
  const int lofs = rho * ncyp + b;

  // a warp's 32 particles at a time; the next 32's positions and masses
  // are loaded while these are added
  long long i0 = lo + (long long)warp * kWarp;
  float px = 0.0f, py = 0.0f, pz = 0.0f, pm = 0.0f;
  if (i0 + lane < hi) {
    const long long i = i0 + lane;
    px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2], pm = mass[i];
  }
  for (; i0 < hi; i0 += (long long)nw * kWarp) {
    // 1. one thread a particle: its record, each update
    // (wx_a (w trig_t)) wy_b rounded once to the block's fixed point
    int* mine = stage + lane * rec;
    int base = -1;                                      // adds nothing
    if (i0 + lane < hi) {
      float R_, r;
      cyl::cyl_maps(px, py, pz, R_, r);
      const float w = r <= q.rmax_grid ? pm : 0.0f;
      if (w != 0.0f) {
        float c[M1], s[M1];
        cyl::trig_rows<MMAX>(px / R_, py / R_, c, s);
        float tx, ty;
        cyl::grid_coords(R_, pz, q, tx, ty);
        int jx[KX], jy[2];
        float wx[KX], wy[2];
        cyl::x_weights<SPLINE>(tx, q.ncx, jx, wx);
        cyl::y_weights(ty, ncy, jy, wy);
        base = jx[0] * tg * ncyp + jy[0];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          if (rr < r0 || rr >= r0 + ng) continue;
          const float val = w * (rr < M1 ? c[rr] : s[rr - M1 + 1]);
#pragma unroll
          for (int k = 0; k < KX; ++k) {
            const float A = wx[k] * val;                // A = Wx * (w trig)
            int* u = mine + 1 + 2 * (k * tg + rr - r0);
            u[0] = __float2int_rn(__fmul_rn(__fmul_rn(A, wy[0]), sc));
            u[1] = __float2int_rn(__fmul_rn(__fmul_rn(A, wy[1]), sc));
          }
        }
      }
    }
    mine[0] = base;
    __syncwarp();
    const long long nxt = i0 + (long long)nw * kWarp + lane;
    if (nxt < hi) px = x[3 * nxt], py = x[3 * nxt + 1], pz = x[3 * nxt + 2], pm = mass[nxt];

    // 2. kBatch particles at a time, the lanes over each one's distinct
    // updates, added with integer atomics: exact sums, in any order
    for (int s0 = 0; s0 < kWarp; s0 += kBatch) {
      int bs[kBatch], val[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int* rp = stage + (s0 + k) * rec;
        bs[k] = rp[0];
        val[k] = active ? rp[1 + lane] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (bs[k] >= 0 && val[k] != 0) atomicAdd(acc + bs[k] + lofs, val[k]);
    }
    __syncwarp();
  }
  __syncthreads();

  // this block's rows of G back in f32 (exact scaling of the integer
  // sums), a warp a row: straight into G (xrows, 2(M+1), ncy) for one
  // chunk, else into its chunk's partial (chunks, xrows, R, ncy)
  for (int row = warp; row < xrows * ng; row += nw) {
    const int jxx = row / ng, tl2 = row - jxx * ng;
    const int* src = acc + (jxx * tg + tl2) * ncyp;
    float* dst = out + (nchunks == 1
        ? ((long long)jxx * (R + 1) + trig_row(r0 + tl2, M1)) * ncy
        : (((long long)chunk * xrows + jxx) * R + r0 + tl2) * ncy);
    for (int j0 = 0; j0 < ncy; j0 += 4 * kWarp) {       // 4 loads, then 4 stores
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * kWarp + lane;
        v[u] = j < ncy ? src[j] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * kWarp + lane;
        if (j < ncy) dst[j] = __fmul_rn((float)v[u], inv);
      }
    }
  }
  if (nchunks == 1 && g == 0)                           // the sin(0 phi) row
    for (int jxx = warp; jxx < xrows; jxx += nw)
      for (int j = lane; j < ncy; j += kWarp)
        out[((long long)jxx * (R + 1) + M1) * ncy + j] = 0.0f;
  __syncthreads();
}

// G (xrows, R + 1, ncy) = the sum of the chunk partials (chunks, xrows, R,
// ncy) in chunk order (deterministic), 0 on the sin(0 phi) row: a block a
// row (jx, t), a thread a jy.
__global__ void coef_reduce(const float* __restrict__ partial, int nchunks,
                            int xrows, int R, int ncy, float* __restrict__ G) {
  const int M1 = (R + 1) / 2;
  const int jx = blockIdx.x / (R + 1), t = blockIdx.x % (R + 1);
  const long long stride = (long long)xrows * R * ncy;
  float* dst = G + (long long)blockIdx.x * ncy;
  for (int jy = threadIdx.x; jy < ncy; jy += blockDim.x) {
    float s = 0.0f;
    if (t != M1) {
      const float* p = partial + ((long long)jx * R + (t < M1 ? t : t - 1)) * ncy + jy;
      int c = 0;
      for (; c + 4 <= nchunks; c += 4) {                // 4 loads in flight
        const float v0 = p[(c + 0) * stride], v1 = p[(c + 1) * stride];
        const float v2 = p[(c + 2) * stride], v3 = p[(c + 3) * stride];
        s += v0;
        s += v1;
        s += v2;
        s += v3;
      }
      for (; c < nchunks; ++c) s += p[c * stride];
    }
    dst[jy] = s;
  }
}

template <int MMAX, bool SPLINE>
cudaError_t launch(const float* x, const float* mass, long long n, const Params& q,
                   int tg, int groups, int nw, int nchunks, int ncyp, float* partial,
                   float* G, cudaStream_t stream) {
  constexpr int R = 2 * MMAX + 1, KX = cyl::XNodes<SPLINE>::K;
  const int xrows = SPLINE ? q.ncx + 2 : q.ncx;
  if (groups < 1 || groups > R || tg < (R + groups - 1) / groups || KX * 2 * tg > kWarp ||
      nw < 1 || nw * kWarp > kMaxThreads || nchunks < 1 || ncyp < q.ncy ||
      q.ncy > 0xffff || (nchunks > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)xrows * tg * ncyp + nw +
                                       (size_t)nw * kWarp * record_words(KX, tg));
  cudaError_t err = cudaFuncSetAttribute(coef_accumulate<MMAX, SPLINE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const long long per = (n + nchunks - 1) / nchunks;
  const dim3 grid(nchunks, groups);
  coef_accumulate<MMAX, SPLINE><<<grid, nw * kWarp, smem, stream>>>(
      x, mass, n, q, tg, ncyp, per, nchunks == 1 ? G : partial);
  if ((err = cudaGetLastError()) != cudaSuccess || nchunks == 1) return err;
  coef_reduce<<<xrows * (R + 1), 128, 0, stream>>>(partial, nchunks, xrows, R, q.ncy, G);
  return cudaGetLastError();
}

template <bool SPLINE>
cudaError_t dispatch(const float* x, const float* mass, long long n, const Params& q,
                     int tg, int groups, int nw, int nchunks, int ncyp, float* partial,
                     float* G, cudaStream_t s) {
  switch (q.mmax) {
#define K4_CASE(M) \
    case M: return launch<M, SPLINE>(x, mass, n, q, tg, groups, nw, nchunks, ncyp, partial, G, s);
    K4_CASE(0) K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4) K4_CASE(5) K4_CASE(6) K4_CASE(7)
#undef K4_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), G (xrows, T, ncy) output, T = 2(mmax+1), xrows =
// ncx + 2 ('spline') or ncx ('linear'); partial (nchunks, xrows, T - 1, ncy)
// scratch when nchunks > 1 (else unused, may be null); all f32, contiguous,
// on the current device.  The plan (ops/cyl_kernels.coef_plan): `groups`
// groups of at most tg trig rows, nw warps a block, nchunks particle
// chunks, ncyp the shared accumulator's row stride.  Returns a cudaError_t.
int cyl_coef_launch(const void* x, const void* mass, long long n, void* partial,
                    void* G, int tg, int groups, int nw, int nchunks, int ncyp,
                    int spline, int mmax, int ncx, int ncy, float acyl, float hcyl,
                    float xmin, float dxc, float ymin, float dy, float rmax_grid,
                    void* stream) {
  Params q{mmax, ncx, ncy, acyl, hcyl, xmin, dxc, ymin, dy, rmax_grid};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto pf = static_cast<float*>(partial);
  auto gf = static_cast<float*>(G);
  return spline ? dispatch<true>(xf, mf, n, q, tg, groups, nw, nchunks, ncyp, pf, gf, s)
                : dispatch<false>(xf, mf, n, q, tg, groups, nw, nchunks, ncyp, pf, gf, s);
}


const char* cyl_coef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
