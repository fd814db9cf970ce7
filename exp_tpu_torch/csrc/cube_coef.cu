// Periodic-cube coefficient pass (K7, and K11a through it) for Hopper,
// CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_cube.py make_cube_coef_kernel_v2 (K7, the
// default pallas_version 2, its pallas_call at :332) and
// make_cube_coef_kernel (K11a, pallas_version 1, :141).  Both compute the
// same raw sums; only their TPU layouts differ.
//
// Computes, for particles x (N, 3), mass (N,), with u = x - floor(x):
//   S[kx, ky, kz] = sum_i m_i e^{-2 pi i k.u_i},  k_c = -nmax_c..nmax_c,
// as out (2 nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1, 2) f32 (re, im); the caller
// applies -norm.
//
// What bounds it on an H100: operations.  The input is 16 bytes a particle
// (67 MB at N = 2^22, 0.02 ms at 3.35 TB/s); the sums need a complex
// multiply-add for every particle and lattice point, 2197 a particle at
// nmax = 6, or about half with S(-k) = conj S(k): ~0.55 ms at 67 TFLOP/s.
//
// Design: real masses give S(-k) = conj S(k), so the kernel sums only the
// planes kx = 0..nmaxx (every ky, kz) and the reduction writes each kx > 0
// value twice, once conjugated into -k.  The kx = 0 plane is summed in full,
// as the plain version sums it.  A block stages a tile of particles' phase
// rows in shared memory (e^{-2 pi i a ux} for a = 0..nmaxx, e^{-2 pi i ky uy},
// m e^{-2 pi i kz uz}: 33 complex a particle at nmax = 6, cube_common.cuh).
// The block is NG groups of TPG threads; each group takes its own 32
// particles of the tile, and each thread of a group owns two (a, b) pairs
// and all kz for them, 2 x 13 complex sums in registers: per particle it
// reads the kz row once (a broadcast) and does 4 FMAs a lattice point.
// The groups' sums are added in group order into one partial per block,
// and a second kernel adds the block partials in block order: the pass is
// deterministic.  Rows past N are never staged, and a zero mass makes the
// kz row 0, so such a particle adds exactly 0.
#include "cube_common.cuh"

namespace {

constexpr int kTile = 32;        // particles a group takes per staged tile
constexpr int kPairs = 2;        // (a, b) pairs a thread owns
constexpr int kMaxThreads = 256;
constexpr int kReduceWarps = 8;

struct Geo {
  int nx, ny, nz;       // nmax per axis
  int ax, ky, kz;       // nmaxx + 1 half-lattice x planes, full y and z rows
  int npairs;           // ax * ky
  int tpg, ng;          // threads a group (a multiple of 32), groups a block
};

Geo geometry(int nx, int ny, int nz) {
  Geo g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.ax = nx + 1;
  g.ky = 2 * ny + 1;
  g.kz = 2 * nz + 1;
  g.npairs = g.ax * g.ky;
  const int t = (g.npairs + kPairs - 1) / kPairs;
  g.tpg = (t + 31) / 32 * 32;
  g.ng = kMaxThreads / g.tpg > 1 ? kMaxThreads / g.tpg : 1;
  return g;
}

size_t smem_bytes(const Geo& g) {
  const size_t tile = (size_t)g.ng * kTile * (g.ax + g.ky + g.kz);
  const size_t red = (size_t)g.ng * g.npairs * g.kz;
  return sizeof(float2) * (tile > red ? tile : red);
}

template <int KZ>
__global__ void __launch_bounds__(kMaxThreads)
coef_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                long long n, Geo g, float2* __restrict__ partial) {
  extern __shared__ float2 sh[];
  const int rowlen = g.ax + g.ky + KZ;          // staged float2 a particle
  const int ntile = g.ng * kTile;
  const int grp = threadIdx.x / g.tpg, lt = threadIdx.x % g.tpg;

  int qa[kPairs], qb[kPairs];
  bool live[kPairs];
  float2 acc[kPairs][KZ];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int q = lt * kPairs + j;
    live[j] = q < g.npairs;
    qa[j] = live[j] ? q / g.ky : 0;
    qb[j] = live[j] ? q % g.ky : 0;
#pragma unroll
    for (int c = 0; c < KZ; ++c) acc[j][c] = make_float2(0.0f, 0.0f);
  }

  for (long long base = (long long)blockIdx.x * ntile; base < n;
       base += (long long)gridDim.x * ntile) {
    __syncthreads();                            // the last tile is consumed
    for (int task = threadIdx.x; task < 3 * ntile; task += blockDim.x) {
      const int p = task / 3, axis = task % 3;
      const long long i = base + p;
      if (i >= n) continue;
      float2* row = sh + p * rowlen;
      const float2 e1 = cube::unit_phase(cube::wrap(x[3 * i + axis]), -1.0f);
      if (axis == 0)
        cube::powers(e1, g.nx, row);
      else if (axis == 1)
        cube::axis_row(e1, g.ny, 1.0f, row + g.ax);
      else
        cube::axis_row(e1, g.nz, mass[i], row + g.ax + g.ky);
    }
    __syncthreads();

    const long long left = n - base - (long long)grp * kTile;
    const int cnt = left >= kTile ? kTile : (left > 0 ? (int)left : 0);
    const float2* rows = sh + grp * kTile * rowlen;
    for (int p = 0; p < cnt; ++p) {
      const float2* row = rows + p * rowlen;
      float2 z[KZ];
#pragma unroll
      for (int c = 0; c < KZ; ++c) z[c] = row[g.ax + g.ky + c];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        if (!live[j]) continue;
        const float2 e = cube::cmul(row[qa[j]], row[g.ax + qb[j]]);
#pragma unroll
        for (int c = 0; c < KZ; ++c) {
          acc[j][c].x += e.x * z[c].x - e.y * z[c].y;
          acc[j][c].y += e.x * z[c].y + e.y * z[c].x;
        }
      }
    }
  }
  __syncthreads();

  // the groups' sums, in group order, into this block's partial
  const int M = g.npairs * KZ;
  float2* red = sh;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (!live[j]) continue;
    const int q = lt * kPairs + j;
#pragma unroll
    for (int c = 0; c < KZ; ++c) red[grp * M + q * KZ + c] = acc[j][c];
  }
  __syncthreads();
  float2* out = partial + (long long)blockIdx.x * M;
  for (int o = threadIdx.x; o < M; o += blockDim.x) {
    float2 s = red[o];
    for (int k = 1; k < g.ng; ++k) {
      s.x += red[k * M + o].x;
      s.y += red[k * M + o].y;
    }
    out[o] = s;
  }
}

// Sum the block partials in block order: a block takes 32 of the 2M floats,
// its warp w the partials w, w + 8, ..., then warp 0 adds the 8 warp sums in
// order.  Writes S at (nmaxx + a, b, c) and, for a > 0, conj S at the
// mirrored point (nmaxx - a, ky - 1 - b, kz - 1 - c).
__global__ void __launch_bounds__(32 * kReduceWarps)
coef_reduce(const float* __restrict__ partial, int nblocks, Geo g,
            float* __restrict__ out) {
  __shared__ float sums[kReduceWarps][32];
  const int M2 = 2 * g.npairs * g.kz;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int f = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (f < M2)
    for (int b = w; b < nblocks; b += kReduceWarps) s += partial[(long long)b * M2 + f];
  sums[w][lane] = s;
  __syncthreads();
  if (w != 0 || f >= M2) return;
  float t = sums[0][lane];
  for (int k = 1; k < kReduceWarps; ++k) t += sums[k][lane];
  const int o = f >> 1, ri = f & 1;
  const int c = o % g.kz, q = o / g.kz;
  const int b = q % g.ky, a = q / g.ky;
  out[(((long long)(g.nx + a) * g.ky + b) * g.kz + c) * 2 + ri] = t;
  if (a > 0)
    out[(((long long)(g.nx - a) * g.ky + (g.ky - 1 - b)) * g.kz + (g.kz - 1 - c)) * 2 + ri] =
        ri ? -t : t;
}

template <int KZ>
cudaError_t launch(const float* x, const float* mass, long long n, float* partial,
                   int nblocks, float* out, const Geo& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      coef_accumulate<KZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  coef_accumulate<KZ><<<nblocks, g.ng * g.tpg, smem, stream>>>(
      x, mass, n, g, reinterpret_cast<float2*>(partial));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int M2 = 2 * g.npairs * g.kz;
  coef_reduce<<<(M2 + 31) / 32, 32 * kReduceWarps, 0, stream>>>(partial, nblocks, g, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), partial (nblocks, nmaxx + 1, 2 nmaxy + 1,
// 2 nmaxz + 1, 2) scratch, out (2 nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1, 2);
// all f32, contiguous, on the current device; nmax 0..8 on each axis.
// Returns a cudaError_t.
int cube_coef_launch(const void* x, const void* mass, long long n, void* partial,
                     int nblocks, void* out, int nmaxx, int nmaxy, int nmaxz,
                     void* stream) {
  if (nblocks < 1 || nmaxx < 0 || nmaxx > 8 || nmaxy < 0 || nmaxy > 8)
    return cudaErrorInvalidValue;
  const Geo g = geometry(nmaxx, nmaxy, nmaxz);
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto pf = static_cast<float*>(partial);
  auto of = static_cast<float*>(out);
  switch (nmaxz) {
    case 0: return launch<1>(xf, mf, n, pf, nblocks, of, g, s);
    case 1: return launch<3>(xf, mf, n, pf, nblocks, of, g, s);
    case 2: return launch<5>(xf, mf, n, pf, nblocks, of, g, s);
    case 3: return launch<7>(xf, mf, n, pf, nblocks, of, g, s);
    case 4: return launch<9>(xf, mf, n, pf, nblocks, of, g, s);
    case 5: return launch<11>(xf, mf, n, pf, nblocks, of, g, s);
    case 6: return launch<13>(xf, mf, n, pf, nblocks, of, g, s);
    case 7: return launch<15>(xf, mf, n, pf, nblocks, of, g, s);
    case 8: return launch<17>(xf, mf, n, pf, nblocks, of, g, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* cube_coef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
