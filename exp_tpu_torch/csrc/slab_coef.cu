// Periodic-slab coefficient pass (K9) for Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_slab.py make_slab_coef_kernel (the TPU kernel
// at its pallas_call, :134), SlabForce's pallas coefficient pass for both
// pallas_interp='spline' (the default) and 'linear'.
//
// Computes, for particles x (N, 3), mass (N,), with u = x - floor(x) on the
// two horizontal axes and w the mass masked to |z| <= zmax:
//   G[ab, j] = sum_i w_i e^{-2 pi i (kx u_x + ky u_y)} Wz[j, i]
// over the C = (2 nmaxx + 1)(2 nmaxy + 1) wavevectors ab and the zrows z
// rows, as out (C, zrows, 2) f32 (re, im).  Wz holds a particle's 3 spline
// weights ('spline') or 2 hats ('linear') at t = clip((z + zmax)/dz, 0,
// nzc - 1) (slab_common.cuh).  The caller contracts G with the signed
// z-tables and applies -4 pi and the pairing signs
// (ops/slab_kernels.contract_coef_output).
//
// What bounds it on an H100, at the slab bench's shapes (nmax 4 x 4,
// zrows = 128, N = 2^20, 'spline'): operations.  The input is 16 bytes a
// particle (16.8 MB, 5 us at 3.35 TB/s); the function needs, on the half
// lattice, a complex-by-real multiply-add into each of 41 x 3 sums a
// particle, 0.87 GFLOP with the phases and the z weights (chip_smoke.py
// k9_work).
//
// Design: real weights give G(-k, j) = conj G(k, j), so only the H = 41
// half-lattice wavevectors (kx > 0, or kx = 0 and ky >= 0; the h of
// slab_common.cuh) are summed, and the reduction writes each h > 0 twice,
// once conjugated into its mirror.  Each particle touches only KZ of the
// zrows rows, so G is a scatter in z, not a dense product.  It is done
// without atomics: a block is ng groups of gt threads (gt = H rounded up
// to 32), thread h of a group owns column h of its group's (zrows, H)
// complex accumulator in shared memory (42 KB at the bench's shapes), and
// a group walks its particles in order, each live thread adding
// e_h w Wz[k] into rows j0..j0+KZ-1 of its own column.  The block stages
// tiles of kTile particles a group: the x powers e^{-2 pi i a u_x},
// a = 0..nmaxx, the y row e^{-2 pi i ky u_y} (cube_common.cuh: one
// sincospif an axis, then angle addition), and w Wz with j0.  The wrapper
// plans the grid (ops/slab_kernels.coef_plan): two blocks an SM where their
// shared memory fits (2 groups each at the bench's shapes), so that one
// block's staging, which waits on its global loads, overlaps the other's
// sums.  The groups'
// accumulators are added in group order into one partial per block, and a
// second kernel adds the block partials in block order: the pass is
// deterministic.  Rows past N are never staged, and a zero mass or
// |z| > zmax makes w Wz = 0, so such a particle adds exactly 0.
#include "slab_common.cuh"

namespace {

using slab::Params;

// kTile, kMaxGroups and group_bytes are mirrored in ops/slab_kernels.py
// (K9_TILE, K9_MAX_GROUPS, coef_plan), which plans the grid
constexpr int kTile = 64;        // particles a group takes per staged tile
constexpr int kMaxTasks = 3 * kTile / 32;   // staging tasks a thread, at most
constexpr int kMaxThreads = 1024;
constexpr int kMaxGroups = 8;
constexpr int kReduceWarps = 8;

struct Geo {
  Params q;
  int H, B2, ax;        // half-lattice size, y row length, x powers 0..nmaxx
  int gt, ng;           // threads a group (H rounded up to 32), groups a block
};

size_t group_bytes(const Geo& g) {
  return sizeof(float4) * kTile + sizeof(float2) * kTile * (g.ax + g.B2) +
         sizeof(float2) * (size_t)g.H * g.q.zrows;
}

template <int KZ>
__global__ void __launch_bounds__(kMaxThreads)
coef_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                long long n, Geo g, float2* __restrict__ partial) {
  extern __shared__ float4 sh4[];
  const int rowlen = g.ax + g.B2;
  const int ntile = g.ng * kTile;
  const int accn = g.H * g.q.zrows;
  float4* zrec = sh4;                                        // (ntile): w Wz, j0
  float2* rows = reinterpret_cast<float2*>(sh4 + ntile);     // (ntile, rowlen)
  float2* accs = rows + (size_t)ntile * rowlen;              // (ng, zrows, H)

  const int grp = threadIdx.x / g.gt, lt = threadIdx.x % g.gt;
  const bool live = lt < g.H;
  const int kx = live ? (lt + g.q.ny) / g.B2 : 0;
  const int kyi = live ? lt - kx * g.B2 + g.q.ny : 0;        // ky + nmaxy
  float2* acc = accs + (size_t)grp * accn + lt;

  for (int e = threadIdx.x; e < g.ng * accn; e += blockDim.x)
    accs[e] = make_float2(0.0f, 0.0f);

  for (long long base = (long long)blockIdx.x * ntile; base < n;
       base += (long long)gridDim.x * ntile) {
    __syncthreads();                            // the last tile is consumed
    // 3 tasks a particle (its x row, y row, z record), kind-major so that a
    // warp takes one kind; a thread issues the global loads of all its
    // tasks (at most kMaxTasks: gt >= 32) before it computes any
    float in[kMaxTasks], ms[kMaxTasks];
#pragma unroll
    for (int t = 0; t < kMaxTasks; ++t) {
      const int task = threadIdx.x + t * blockDim.x;
      const int kind = task / ntile;
      const long long i = base + task % ntile;
      const bool ok = task < 3 * ntile && i < n;
      in[t] = ok ? x[3 * i + kind] : 0.0f;
      ms[t] = ok && kind == 2 ? mass[i] : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kMaxTasks; ++t) {
      const int task = threadIdx.x + t * blockDim.x;
      const int kind = task / ntile, p = task % ntile;
      if (task >= 3 * ntile || base + p >= n) continue;
      float2* row = rows + p * rowlen;
      if (kind == 0) {
        cube::powers(cube::unit_phase(cube::wrap(in[t]), -1.0f), g.q.nx, row);
      } else if (kind == 1) {
        cube::axis_row(cube::unit_phase(cube::wrap(in[t]), -1.0f), g.q.ny, 1.0f,
                       row + g.ax);
      } else {
        const float z = in[t];
        const float w = fabsf(z) <= g.q.zmax ? ms[t] : 0.0f;
        float wz[KZ];
        const int j0 = slab::z_nodes<KZ>(slab::z_grid(z, g.q), g.q.nzc, wz);
        zrec[p] = make_float4(w * wz[0], w * wz[1], KZ == 3 ? w * wz[KZ - 1] : 0.0f,
                              __int_as_float(j0));
      }
    }
    __syncthreads();

    const long long left = n - base - (long long)grp * kTile;
    const int cnt = left >= kTile ? kTile : (left > 0 ? (int)left : 0);
    if (!live || cnt == 0) continue;
    // A particle's loads are all issued before its stores, and the next
    // particle's inputs are loaded with them: the rows of the accumulator
    // may alias (H is not known at compile time), so the compiler keeps
    // shared-memory accesses in program order, and one load latency a
    // particle is left instead of four.
    const int p0 = grp * kTile;
    float2 ea = rows[p0 * rowlen + kx], eb = rows[p0 * rowlen + g.ax + kyi];
    float4 r = zrec[p0];
    for (int p = p0; p < p0 + cnt; ++p) {
      const float2 e = cube::cmul(ea, eb);
      const float wk[3] = {r.x, r.y, r.z};
      float2* dst = acc + (size_t)__float_as_int(r.w) * g.H;
      float2 v[KZ];
#pragma unroll
      for (int k = 0; k < KZ; ++k) v[k] = dst[k * g.H];
      if (p + 1 < p0 + cnt) {
        ea = rows[(p + 1) * rowlen + kx];
        eb = rows[(p + 1) * rowlen + g.ax + kyi];
        r = zrec[p + 1];
      }
#pragma unroll
      for (int k = 0; k < KZ; ++k) {
        v[k].x += e.x * wk[k];
        v[k].y += e.y * wk[k];
      }
#pragma unroll
      for (int k = 0; k < KZ; ++k) dst[k * g.H] = v[k];
    }
  }
  __syncthreads();

  // the groups' sums, in group order, into this block's partial
  float2* out = partial + (long long)blockIdx.x * accn;
  for (int o = threadIdx.x; o < accn; o += blockDim.x) {
    float2 s = accs[o];
    for (int k = 1; k < g.ng; ++k) {
      s.x += accs[(size_t)k * accn + o].x;
      s.y += accs[(size_t)k * accn + o].y;
    }
    out[o] = s;
  }
}

// Sum the block partials in block order: a block takes 32 of the 2 zrows H
// floats, its warp w the partials w, w + 8, ..., then warp 0 adds the 8 warp
// sums in order.  Writes G at ab = ctr + h and, for h > 0, conj G at the
// mirror ctr - h (ctr = (C - 1)/2, the k = 0 wavevector).
__global__ void __launch_bounds__(32 * kReduceWarps)
coef_reduce(const float* __restrict__ partial, int nblocks, Geo g,
            float* __restrict__ out) {
  __shared__ float sums[kReduceWarps][32];
  const int M2 = 2 * g.H * g.q.zrows;
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
  const int h = o % g.H, j = o / g.H;
  const int ctr = g.H - 1;
  out[((long long)(ctr + h) * g.q.zrows + j) * 2 + ri] = t;
  if (h > 0) out[((long long)(ctr - h) * g.q.zrows + j) * 2 + ri] = ri ? -t : t;
}

template <int KZ>
cudaError_t launch(const float* x, const float* mass, long long n, float* partial,
                   float* out, int nblocks, Geo g, cudaStream_t stream) {
  const size_t smem = group_bytes(g) * g.ng;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(coef_accumulate<KZ>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  coef_accumulate<KZ><<<nblocks, g.ng * g.gt, smem, stream>>>(
      x, mass, n, g, reinterpret_cast<float2*>(partial));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int M2 = 2 * g.H * g.q.zrows;
  coef_reduce<<<(M2 + 31) / 32, 32 * kReduceWarps, 0, stream>>>(partial, nblocks, g, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), partial (nblocks, zrows, H, 2) scratch, out (C,
// zrows, 2); all f32, contiguous, on the current device; nmax 0..8 on each axis,
// nzc >= 2, zrows = nzc + 2 ('spline') or nzc ('linear') at most 128; ng
// groups a block and nblocks blocks (ops/slab_kernels.coef_plan).  Returns a
// cudaError_t.
int slab_coef_launch(const void* x, const void* mass, long long n, void* partial,
                     void* out, int ng, int nblocks, int nmaxx, int nmaxy, int nzc,
                     int spline, float zmax, float dz, void* stream) {
  if (nblocks < 1 || ng < 1 || ng > kMaxGroups || nmaxx < 0 || nmaxx > 8 || nmaxy < 0 ||
      nmaxy > 8 || nzc < 2)
    return cudaErrorInvalidValue;
  Geo g;
  g.q = Params{nmaxx, nmaxy, nzc, spline ? nzc + 2 : nzc, zmax, dz};
  if (g.q.zrows > 128) return cudaErrorInvalidValue;
  g.H = slab::half_count(nmaxx, nmaxy);
  g.B2 = 2 * nmaxy + 1;
  g.ax = nmaxx + 1;
  g.gt = (g.H + 31) / 32 * 32;
  g.ng = ng;
  if (ng * g.gt > kMaxThreads) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto pf = static_cast<float*>(partial);
  auto of = static_cast<float*>(out);
  return spline ? launch<3>(xf, mf, n, pf, of, nblocks, g, s)
                : launch<2>(xf, mf, n, pf, of, nblocks, g, s);
}

const char* slab_coef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
