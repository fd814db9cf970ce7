// Periodic-cube coefficient pass (K7, and K11a through it) for Hopper: a
// split-TF32 product over particles on the tensor cores.
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
// The algebra.  Real masses give S(-k) = conj S(k), so only the half
// lattice is summed: the (kx, ky) pairs with kx > 0, or kx = 0 and ky >= 0
// (85 of 169 at nmax 6).  The kz axis folds into cosines and sines: with
// XY = e^{-2 pi i (a ux + b uy)}, c_q = cos 2 pi q uz, s_q = sin 2 pi q uz,
//   U(a, b, q) = sum m c_q XY,  V(a, b, q) = sum m s_q XY,
//   S(a, b, +q) = U - i V,  S(a, b, -q) = U + i V,
// so the sums are one real product over particles: the 2 x 85 rows [Re XY;
// Im XY] against the 13 columns [m c_0..m c_nz, m s_1..m s_nz] at nmax 6.
//
// What bounds it on an H100: operations.  The input is 16 bytes a particle
// (67 MB at N = 2^22, 0.02 ms at 3.35 TB/s).  The least work is the phase
// rows, XY for the pairs and the folded product, 2 x 170 x 13 FLOPs a
// particle at nmax 6 (chip_smoke.py k7_work): 0.31 ms in FP32 on the CUDA
// cores at 67 TFLOP/s, or 0.11 ms with the product as three TF32 passes on
// the tensor cores at 495 TFLOP/s (the rest, 0.04 ms on the CUDA cores,
// runs beside it).  The
// first version of this kernel (FP32, 2.33 ms) left 29% of its pair slots
// dead, staged behind two barriers and ran at ~17 of 67 TFLOP/s.  This one
// takes ~0.66 ms on an H100 80GB HBM3 (700 W): its mma.sync products alone
// ~0.31 ms (the tensor cores take about half their wgmma rate through
// mma.sync), the rest its phase rows, splits and fragment loads
// (probe_cube_split.py).
//
// Design.  The product runs on the tensor cores as mma.sync m16n8k8 TF32
// with every operand split hi + lo (tf32_mma.cuh; three passes, error ~3
// 2^-22 of a product).  A: 16 rows = Re and Im of 8 (a, b) pairs (a "pair
// group"), K = 8 particles; B: the 8 particles' fold columns, n-tiles of 8.
// A block stages tiles of 64 particles (8 k-steps) into a double buffer:
// each particle's e^{-2 pi i a ux}, e^{-2 pi i b uy} and its fold columns
// split into a hi and a lo plane, element-major (element k of particle p
// at k 72 + pos(p), where pos puts particles p and p + 4 of a k-step side
// by side), so that the staging threads, one a particle, store without
// bank conflicts, a lane's two B values (particles t and t + 4) are one
// 8-byte load into the register pair the mma takes, and a lane's two e_x
// (or e_y) are one 16-byte load.  Each warp owns up to 3 pair groups and
// makes their A fragments in registers, XY = e_x e_y from the staged rows,
// so no pair slot is dead but the last group's padding.  The accumulators
// stay in registers; the tensor core adds with truncation (the
// accumulation probe of probe_cube_split.py: a mean error of one sign,
// 4.6e-7 of sum |a b| after 8 k-steps of three passes, 5e-4 after 8,192),
// so after every tile (8 k-steps) each accumulator is added into an f32
// register sum and zeroed.  One barrier a tile: the next tile is staged
// while the current one is consumed.  Each block writes its sums U, V; a
// second kernel adds the block partials in block order, forms S(+q) = U -
// iV and S(-q) = U + iV and writes each value and, conjugated, its mirror
// -k: S is Hermitian bit for bit and the pass is deterministic.  Rows past
// N stage a zero mass, and a zero mass makes every fold column 0, so such a
// particle adds exactly 0.
#include "cube_fold.cuh"

namespace {

constexpr int kTile = 64;            // particles a staged tile: 8 k-steps
constexpr int kSteps = kTile / 8;
constexpr int kGroupsPerWarp = 3;    // pair groups (8 pairs) a warp owns
constexpr int kMaxWarps = 8;
constexpr int kReduceWarps = 8;

struct Geo {
  int nx, ny, nz;
  int ax, ky, kz;   // nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1
  int npairs;       // the half (kx, ky) lattice: (nmaxy + 1) + nmaxx ky
  int ngroups;      // pair groups of 8
  int nwarps;       // ceil(ngroups / kGroupsPerWarp)
  int nt;           // n-tiles of 8 fold columns: ceil(kz / 8)
  int elems;        // float2 a particle: ax + ky phases, a zero, 8 nt columns
};

// the element stride of a tile, 8 mod 16 (in float2 for the phase rows, in
// floats for the column planes): a warp's loads, 4 particle pairs at 8
// elements 1 apart, then take the fewest wavefronts
constexpr int kStride = kTile + 8;

// the place of particle p in its k-step of 8: p and p + 4 side by side
__device__ __forceinline__ int pos(int p) { return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1); }

// ops/cube_kernels.py coef_plan sizes the grid by nwarps.
constexpr Geo geometry(int nx, int ny, int nz) {
  Geo g{};
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.ax = nx + 1;
  g.ky = 2 * ny + 1;
  g.kz = 2 * nz + 1;
  g.npairs = (ny + 1) + nx * g.ky;
  g.ngroups = (g.npairs + 7) / 8;
  g.nwarps = (g.ngroups + kGroupsPerWarp - 1) / kGroupsPerWarp;
  g.nt = (g.kz + 7) / 8;
  g.elems = g.ax + g.ky + 1 + 8 * g.nt;
  return g;
}

// one buffer: the tile's elements, each kStride float2 (a column's hi and
// lo planes kStride floats each)
__host__ __device__ constexpr size_t buffer_floats(const Geo& g) {
  return (size_t)2 * kStride * g.elems;
}

constexpr size_t smem_bytes(const Geo& g) { return sizeof(float) * 2 * buffer_floats(g); }

// the largest block, at nmax 8 on every axis, within the H100's 227 KB and
// kMaxWarps
static_assert(smem_bytes(geometry(8, 8, 8)) <= 227 * 1024, "K7's tiles outgrow shared memory");
static_assert(geometry(8, 8, 8).nwarps <= kMaxWarps, "K7's pair groups outgrow its block");

// Stage the tile at `base` into `buf` (element k of particle p at k kStride
// + pos(p)): task p < kTile writes particle p's e_x^a (a = 0..nmaxx) and
// e_y^b (b = -nmaxy..nmaxy), then a zero for the dead pairs; task kTile + p
// its fold columns times its mass, split, into the hi and lo planes after
// them.
template <int NT>
__device__ void stage(const float* __restrict__ x, const float* __restrict__ mass,
                      long long n, long long base, const Geo& g, float* buf) {
  float2* el = reinterpret_cast<float2*>(buf);
  for (int task = threadIdx.x; task < 2 * kTile; task += blockDim.x) {
    const int p = task % kTile;
    const long long i = base + p;
    const bool live = i < n;
    if (task < kTile) {
      float2* r = el + pos(p);
      float2 ex = make_float2(1.0f, 0.0f), ey = ex;
      if (live) {
        ex = cube::unit_phase(cube::wrap(x[3 * i]), -1.0f);
        ey = cube::unit_phase(cube::wrap(x[3 * i + 1]), -1.0f);
      }
      cube::xy_rows(ex, ey, g.nx, g.ny, r, kStride);
      r[(g.ax + g.ky) * kStride] = make_float2(0.0f, 0.0f);   // the dead pairs'
    } else {
      float m = 0.0f;
      float2 ez = make_float2(1.0f, 0.0f);
      if (live) {
        m = mass[i];
        const float u = cube::wrap(x[3 * i + 2]);
        ez = cube::unit_phase(u, 1.0f);
      }
      float* hi = reinterpret_cast<float*>(el + (g.ax + g.ky + 1) * kStride) + pos(p);
      cube::fold_columns<8 * NT>(ez, g.nz, m, hi, hi + 8 * NT * kStride, kStride);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(32 * kMaxWarps)
coef_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                long long n, Geo g, float* __restrict__ partial) {
  extern __shared__ __align__(16) float sh[];
  const size_t bufn = buffer_floats(g);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, t = lane % 4;

  // this warp's pair groups and, for each, this lane's pair: its e_x and
  // e_y elements, times kStride (a dead pair reads the zero twice)
  const int j0 = warp * kGroupsPerWarp;
  const int nown = min(kGroupsPerWarp, g.ngroups - j0);
  int ia[kGroupsPerWarp], ib[kGroupsPerWarp];
#pragma unroll
  for (int j = 0; j < kGroupsPerWarp; ++j) {
    const int q = 8 * (j0 + j) + gq;
    int a = 0, b = 0;
    if (j < nown && q < g.npairs) {
      cube::half_pair(q, g.ny, a, b);
      ia[j] = a * kStride;
      ib[j] = (g.ax + g.ny + b) * kStride;
    } else {
      ia[j] = ib[j] = (g.ax + g.ky) * kStride;
    }
  }

  float acc[kGroupsPerWarp][NT][4], sum[kGroupsPerWarp][NT][4];
#pragma unroll
  for (int j = 0; j < kGroupsPerWarp; ++j)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][q][e] = sum[j][q][e] = 0.0f;

  const long long stride = (long long)gridDim.x * kTile;
  long long base = (long long)blockIdx.x * kTile;
  if (base < n) stage<NT>(x, mass, n, base, g, sh);
  __syncthreads();
  for (int it = 0; base < n; ++it, base += stride) {
    if (base + stride < n) stage<NT>(x, mass, n, base + stride, g, sh + ((it + 1) & 1) * bufn);
    const float2* el = reinterpret_cast<const float2*>(sh + (it & 1) * bufn);
    const float* hi = reinterpret_cast<const float*>(el + (g.ax + g.ky + 1) * kStride);
    const float* lo = hi + 8 * NT * kStride;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      // B: b0 = column 8q + gq of particle 8s + t, b1 of particle 8s + t + 4,
      // side by side at 8s + 2t
      const int pp = 8 * s + 2 * t;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const uint2 h = *reinterpret_cast<const uint2*>(hi + (8 * q + gq) * kStride + pp);
        const uint2 l = *reinterpret_cast<const uint2*>(lo + (8 * q + gq) * kStride + pp);
        bh[q][0] = h.x;
        bh[q][1] = h.y;
        bl[q][0] = l.x;
        bl[q][1] = l.y;
      }
      const float2* r = el + pp;
#pragma unroll
      for (int j = 0; j < kGroupsPerWarp; ++j) {
        if (j >= nown) break;
        const float4 ex = *reinterpret_cast<const float4*>(r + ia[j]);
        const float4 ey = *reinterpret_cast<const float4*>(r + ib[j]);
        const float2 xy0 = cube::cmul(make_float2(ex.x, ex.y), make_float2(ey.x, ey.y));
        const float2 xy1 = cube::cmul(make_float2(ex.z, ex.w), make_float2(ey.z, ey.w));
        // A: row gq the pair's Re, row gq + 8 its Im; k = t, t + 4
        const float av[4] = {xy0.x, xy0.y, xy1.x, xy1.y};
        uint32_t xh[4], xl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const tf32::Split q = tf32::split(av[e]);
          xh[e] = q.hi;
          xl[e] = q.lo;
        }
#pragma unroll
        for (int q = 0; q < NT; ++q)
          tf32::mma3(acc[j][q], xh, xl, bh[q], bl[q]);
      }
    }
    // promotion: the tensor core's truncating adds stay within a tile
#pragma unroll
    for (int j = 0; j < kGroupsPerWarp; ++j)
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[j][q][e] += acc[j][q][e];
          acc[j][q][e] = 0.0f;
        }
    __syncthreads();
  }

  // this block's U and V: partial[block][pair][q][Ur, Ui, Vr, Vi]; lane
  // (gq, t) holds Re (c0, c1) and Im (c2, c3) of pair 8 jg + gq at the fold
  // columns 8 nt + 2t and 8 nt + 2t + 1
  const int U4 = 4 * (g.nz + 1);
  float* out = partial + (long long)blockIdx.x * g.npairs * U4;
#pragma unroll
  for (int j = 0; j < kGroupsPerWarp; ++j) {
    const int pq = 8 * (j0 + j) + gq;
    if (j >= nown || pq >= g.npairs) continue;
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * q + 2 * t + e;
        if (c >= g.kz) continue;
        const int qz = c <= g.nz ? c : c - g.nz;
        float* o = out + pq * U4 + 4 * qz + (c <= g.nz ? 0 : 2);
        o[0] = sum[j][q][e];
        o[1] = sum[j][q][2 + e];
        if (c == 0) o[2] = o[3] = 0.0f;            // V at q = 0
      }
  }
}

// Sum the block partials in block order: a block takes 32 of the floats (8
// whole (pair, q) records), its warp w the partials w, w + 8, ..., then
// warp 0 adds the 8 warp sums in order.  The first lane of each record
// forms S(a, b, +q) = (Ur + Vi, Ui - Vr) and S(a, b, -q) = (Ur - Vi, Ui + Vr)
// and writes each with its conjugate at the mirrored point -k (the centre
// once; at a = b = 0, S(0, 0, -q) is the mirror of S(0, 0, q)).
__global__ void __launch_bounds__(32 * kReduceWarps)
coef_reduce(const float* __restrict__ partial, int nblocks, Geo g, float* __restrict__ out) {
  __shared__ float sums[kReduceWarps][32];
  const int U4 = 4 * (g.nz + 1);
  const int M = g.npairs * U4;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int f = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (f < M)
    for (int b = w; b < nblocks; b += kReduceWarps) s += partial[(long long)b * M + f];
  sums[w][lane] = s;
  __syncthreads();
  if (w != 0) return;
  float v = sums[0][lane];
  for (int k = 1; k < kReduceWarps; ++k) v += sums[k][lane];
  const int r0 = lane & ~3;
  const float ur = __shfl_sync(0xffffffffu, v, r0);
  const float ui = __shfl_sync(0xffffffffu, v, r0 + 1);
  const float vr = __shfl_sync(0xffffffffu, v, r0 + 2);
  const float vi = __shfl_sync(0xffffffffu, v, r0 + 3);
  if ((lane & 3) != 0 || f >= M) return;
  const int rec = f / 4;
  const int qz = rec % (g.nz + 1), pq = rec / (g.nz + 1);
  int a, b;
  cube::half_pair(pq, g.ny, a, b);
  auto put = [&](int ka, int kb, int kc, float re, float im) {
    float* o = out + ((((long long)(g.nx + ka) * g.ky + (g.ny + kb)) * g.kz + (g.nz + kc)) * 2);
    o[0] = re;
    o[1] = im;
  };
  const float pr = ur + vi, pi = ui - vr;          // S(a, b, +q)
  put(a, b, qz, pr, pi);
  if (a != 0 || b != 0 || qz != 0) put(-a, -b, -qz, pr, -pi);
  if (qz > 0 && (a != 0 || b != 0)) {
    const float mr = ur - vi, mi = ui + vr;        // S(a, b, -q)
    put(a, b, -qz, mr, mi);
    put(-a, -b, qz, mr, -mi);
  }
}

template <int NT>
cudaError_t launch(const float* x, const float* mass, long long n, float* partial,
                   int nblocks, float* out, const Geo& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      coef_accumulate<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  coef_accumulate<NT><<<nblocks, 32 * g.nwarps, smem, stream>>>(x, mass, n, g, partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int M = g.npairs * 4 * (g.nz + 1);
  coef_reduce<<<(M + 31) / 32, 32 * kReduceWarps, 0, stream>>>(partial, nblocks, g, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), partial (nblocks, npairs, nmaxz + 1, 4) scratch, out
// (2 nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1, 2); all f32, contiguous, on the
// current device; nmax 0..8 on each axis.  `nblocks` is the plan's
// (ops/cube_kernels.py coef_plan).  Returns a cudaError_t.
int cube_coef_launch(const void* x, const void* mass, long long n, void* partial,
                     int nblocks, void* out, int nmaxx, int nmaxy, int nmaxz, void* stream) {
  if (nblocks < 1 || nmaxx < 0 || nmaxx > 8 || nmaxy < 0 || nmaxy > 8 || nmaxz < 0 ||
      nmaxz > 8)
    return cudaErrorInvalidValue;
  const Geo g = geometry(nmaxx, nmaxy, nmaxz);
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto pf = static_cast<float*>(partial);
  auto of = static_cast<float*>(out);
  switch (g.nt) {
    case 1: return launch<1>(xf, mf, n, pf, nblocks, of, g, s);
    case 2: return launch<2>(xf, mf, n, pf, nblocks, of, g, s);
    case 3: return launch<3>(xf, mf, n, pf, nblocks, of, g, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* cube_coef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
