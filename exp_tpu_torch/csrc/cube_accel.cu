// Periodic-cube force pass (K8, and K11b through it) for Hopper: a
// split-TF32 product of each particle's kz phases with a folded table on
// the tensor cores, then a per-row epilogue on the CUDA cores.
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
// conj b_{-k} (ops/cube_kernels.cube_force_table): since Re and Im of
// conj(z) are Re z and -Im z, the terms k and -k of every output sum to the
// term of tab_k at k.
//
// The algebra.  Per (kx, ky) row, with T(q) = tab[a, b, q], c_q = cos 2 pi
// q uz, s_q = sin 2 pi q uz, the kz sums t = sum_q T(q) e^{2 pi i q uz} and
// t_z = sum_q 2 pi q T(q) e^{...} are real combinations of the 13 phases
// [c_0..c_nz, s_1..s_nz] (at nmax 6):
//   t   = T(0) + sum_q>0 (T(q) + T(-q)) c_q + i (T(q) - T(-q)) s_q,
//   t_z = sum_q>0 2 pi q ((T(q) - T(-q)) c_q + i (T(q) + T(-q)) s_q).
// The rows with kx = 0 fold once more, ky with -ky (e_y^-b = conj e_y^b):
// t_b + conj t_-b and t_z,b - conj t_z,-b keep pot, a_y and a_z.  That
// leaves 85 rows at nmax 6 and the product (N, 13) x (13, 4 x 85): the
// columns Re t, Im t, Re t_z, Im t_z of each row.  Then, with e = e_x^a
// e_y^b: pot += Re(t e), a_x += 2 pi a Im(t e), a_y += 2 pi b Im(t e), a_z
// += Im(t_z e).
//
// What bounds it on an H100: operations.  It moves 28 bytes a particle (12
// read, 16 written: 117 MB at N = 2^22, 0.035 ms at 3.35 TB/s).  The least
// work is the phase rows, the folded product (2 x 13 x 340 FLOPs a particle
// at nmax 6) and the epilogue, ~21 FLOPs a row (chip_smoke.py k8_work):
// 0.67 ms in FP32 on the CUDA cores at 67 TFLOP/s, or 0.22 ms with the
// product as three TF32 passes on the tensor cores at 495 TFLOP/s (the
// rest, 0.11 ms on the CUDA cores, runs beside it).  The first version (FP32, one thread a particle,
// 2.50 ms) spent 86% of its time in the kz sums (the no_table variant of
// probe_cube_split.py, whose rows are all equal, ran in 0.35 ms).  This one
// takes ~0.91 ms on an H100 80GB HBM3 (700 W): its 16.5 mma.sync a
// particle need ~0.6 ms at the rate the tensor cores give mma.sync (about
// half their wgmma rate), and the shared-memory loads of the table's B
// fragments (the whole table for every 32 particles) and of the
// epilogue's e_x, e_y are about as many wavefronts again; the two overlap
// in part.
//
// Design.  mma.sync m16n8k8 TF32 with every operand split hi + lo
// (tf32_mma.cuh; three passes).  A: 16 particles x 8 phases; B: the table,
// 8 phases x 8 columns, where an n-tile holds (Re, Im) of t (or of t_z) for
// 4 rows, so that lane 4g + t's accumulator pairs (c0, c1) and (c2, c3) are
// t (or t_z) of row 4j + t at particles g and g + 8; the t tile and the t_z
// tile of a row group land in the same lane.  Each block builds the whole
// table in shared memory once, already split and in B fragment order (one
// 16-byte load a lane an n-tile and k-step): 45 KB at nmax 6, 114 KB at
// nmax 8 on every axis, which still fits (one block an SM, fewer warps).
// Each warp walks its own tiles of 32 particles: the lanes make the
// particles' e_x, e_y powers and split kz phases into the warp's stage
// (element-major, so that neither the stores nor the fragment loads meet
// bank conflicts), the A fragments go to registers, and the warp runs the
// row groups: 2 x KS x 2 x 3 products each, then the epilogue on its
// accumulators.  Every lane
// holds 4 rows' share of 4 particles' sums; a quad's 4 lanes add them by
// shuffles at the end.  The depth is at most 24 (3 k-steps), so the tensor
// core's truncating adds lose nothing that matters.
#include "cube_fold.cuh"

namespace {

constexpr int kMTiles = 2;                    // m-tiles of 16 particles a warp
constexpr int kWarpTile = 16 * kMTiles;       // particles a warp stages at once
static_assert(kWarpTile == 32, "a lane stages one particle");
constexpr int kPw = kWarpTile + 8;            // float2 an element of a warp's stage
constexpr int kMaxWarps = 16;

struct Geo {
  int nx, ny, nz;
  int ax, ky, kz;   // nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1
  int rows;         // the folded (kx, ky) rows: (nmaxy + 1) + nmaxx ky
  int groups;       // row groups of 4
  int ks;           // k-steps of 8 phases: ceil(kz / 8)
  int elems;        // float2 a particle staged: ax + ky phases, 8 ks kz phases
};

// ops/cube_kernels.py accel_plan chooses the warps a block by this layout.
Geo geometry(int nx, int ny, int nz) {
  Geo g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.ax = nx + 1;
  g.ky = 2 * ny + 1;
  g.kz = 2 * nz + 1;
  g.rows = (ny + 1) + nx * g.ky;
  g.groups = (g.rows + 3) / 4;
  g.ks = (g.kz + 7) / 8;
  g.elems = g.ax + g.ky + 8 * g.ks;
  return g;
}

// the table's B fragments and the rows' {a, b index, 2 pi a, 2 pi b}
__host__ __device__ size_t table_floats(const Geo& g) {
  return (size_t)4 * 32 * 2 * g.ks * g.groups + (size_t)4 * 4 * g.groups;
}

// a warp's stage: its tile's elements, each kPw float2 (a phase's hi and lo
// planes kPw floats each); 8 mod 16, so that 8 consecutive particles at 4
// elements 1 apart, as the epilogue's and the A fragments' loads take
// them, take the fewest wavefronts, and the staging lanes, one a particle,
// store without conflicts
__host__ __device__ size_t warp_floats(const Geo& g) {
  return (size_t)2 * kPw * g.elems;
}

size_t smem_bytes(const Geo& g, int warps) {
  return sizeof(float) * (table_floats(g) + (size_t)warps * warp_floats(g));
}

// T(a, b, q) of the folded table, complex
__device__ __forceinline__ float2 tab_at(const float2* __restrict__ tab, const Geo& g, int a,
                                         int b, int q) {
  return tab[((long long)a * g.ky + (g.ny + b)) * g.kz + (g.nz + q)];
}

// The coefficient of phase k (c_0..c_nz, then s_1..s_nz) in t (tz false) or
// t_z (tz true) of table row (a, b), unfolded in ky.
__device__ float2 phase_coef(const float2* __restrict__ tab, const Geo& g, int a, int b,
                             int k, bool tz) {
  if (k >= g.kz) return make_float2(0.0f, 0.0f);
  if (k == 0) return tz ? make_float2(0.0f, 0.0f) : tab_at(tab, g, a, b, 0);
  const bool sine = k > g.nz;
  const int q = sine ? k - g.nz : k;
  const float2 tp = tab_at(tab, g, a, b, q), tm = tab_at(tab, g, a, b, -q);
  const float2 P = make_float2(tp.x + tm.x, tp.y + tm.y);
  const float2 D = make_float2(tp.x - tm.x, tp.y - tm.y);
  // t: P c_q + i D s_q;  t_z: 2 pi q (D c_q + i P s_q)
  const float2 base = sine == tz ? P : D;
  const float2 v = sine ? make_float2(-base.y, base.x) : base;
  const float w = tz ? cube::kTwoPi * (float)q : 1.0f;
  return make_float2(w * v.x, w * v.y);
}

// Build the B fragments: for row group j, tile z (0: t, 1: t_z), k-step s
// and lane 4 gg + tt, {b0 hi, b1 hi, b0 lo, b1 lo} with b0 = B[8s + tt][gg],
// b1 = B[8s + tt + 4][gg]; column gg is part gg % 2 of row 4j + gg / 2.
__device__ void build_table(const float2* __restrict__ tab, const Geo& g, float* sh) {
  float4* frag = reinterpret_cast<float4*>(sh);
  const int nfrag = 2 * g.ks * g.groups * 32;
  for (int e = threadIdx.x; e < nfrag; e += blockDim.x) {
    const int lane = e % 32, s = (e / 32) % g.ks, z = (e / (32 * g.ks)) % 2;
    const int j = e / (64 * g.ks);
    const int gg = lane / 4, tt = lane % 4;
    const int r = 4 * j + gg / 2, part = gg % 2;
    float v[2] = {0.0f, 0.0f};
    if (r < g.rows) {
      int a, b;
      cube::half_pair(r, g.ny, a, b);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * s + tt + 4 * h;
        float2 c = phase_coef(tab, g, a, b, k, z == 1);
        if (a == 0 && b > 0) {   // fold in row (0, -b), conjugated
          const float2 m = phase_coef(tab, g, 0, -b, k, z == 1);
          c = z == 0 ? make_float2(c.x + m.x, c.y - m.y) : make_float2(c.x - m.x, c.y + m.y);
        }
        v[h] = part ? c.y : c.x;
      }
    }
    const tf32::Split q0 = tf32::split(v[0]), q1 = tf32::split(v[1]);
    frag[e] = make_float4(__uint_as_float(q0.hi), __uint_as_float(q1.hi),
                          __uint_as_float(q0.lo), __uint_as_float(q1.lo));
  }
  float4* info = frag + nfrag;
  for (int r = threadIdx.x; r < 4 * g.groups; r += blockDim.x) {
    int a = 0, b = 0;
    if (r < g.rows) cube::half_pair(r, g.ny, a, b);
    info[r] = make_float4(__int_as_float(a * kPw), __int_as_float((g.ax + g.ny + b) * kPw),
                          cube::kTwoPi * (float)a, cube::kTwoPi * (float)b);
  }
}

template <int KS>
__global__ void __launch_bounds__(32 * kMaxWarps)
accel_kernel(const float* __restrict__ x, long long n, const float2* __restrict__ tab, Geo g,
             float* __restrict__ acc, float* __restrict__ pot) {
  extern __shared__ __align__(16) float sh[];
  build_table(tab, g, sh);
  __syncthreads();
  const float4* tabf = reinterpret_cast<const float4*>(sh);
  const float4* info = tabf + 2 * KS * g.groups * 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  const int gq = lane / 4, t = lane % 4;
  // this warp's stage, element-major: element k of particle p at k kPw + p;
  // e_x^a, e_y^b (b = -nmaxy..nmaxy), then the split kz phases in a hi and
  // a lo plane (kPw floats an element each)
  float2* el = reinterpret_cast<float2*>(sh + table_floats(g)) + (size_t)warp * g.elems * kPw;
  float* phh = reinterpret_cast<float*>(el + (g.ax + g.ky) * kPw);
  float* phl = phh + 8 * KS * kPw;

  for (long long base = ((long long)blockIdx.x * nw + warp) * kWarpTile; base < n;
       base += (long long)gridDim.x * nw * kWarpTile) {
    // stage: lane p makes particle p's elements
    {
      const int p = lane;
      const long long i = base + p;
      float2 ex = make_float2(1.0f, 0.0f), ey = ex, ez = ex;
      if (i < n) {
        ex = cube::unit_phase(cube::wrap(x[3 * i]), 1.0f);
        ey = cube::unit_phase(cube::wrap(x[3 * i + 1]), 1.0f);
        ez = cube::unit_phase(cube::wrap(x[3 * i + 2]), 1.0f);
      }
      cube::xy_rows(ex, ey, g.nx, g.ny, el + p, kPw);
      cube::fold_columns<8 * KS>(ez, g.nz, 1.0f, phh + p, phl + p, kPw);
    }
    __syncwarp();
    // A fragments: a0 = phase 8s + t of particle 16 mt + gq, a1 of particle
    // + 8, a2 and a3 of phase 8s + t + 4
    uint32_t ah[kMTiles][KS][4], al[kMTiles][KS][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = (8 * s + t + 4 * (e / 2)) * kPw + 16 * mt + gq + 8 * (e % 2);
          ah[mt][s][e] = __float_as_uint(phh[o]);
          al[mt][s][e] = __float_as_uint(phl[o]);
        }

    // sums[mt][h]: particle 16 mt + gq + 8 h; pot, a_x, a_y, a_z
    float sums[kMTiles][2][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) sums[mt][h][c] = 0.0f;

    for (int j = 0; j < g.groups; ++j) {
      float d[2][kMTiles][4];   // [tile t / t_z][m-tile][c0..c3]
#pragma unroll
      for (int z = 0; z < 2; ++z)
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c) d[z][mt][c] = 0.0f;
      const float4* bf = tabf + ((long long)j * 2 * KS) * 32 + lane;
#pragma unroll
      for (int z = 0; z < 2; ++z)
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const float4 f = bf[(z * KS + s) * 32];
          const uint32_t bh[2] = {__float_as_uint(f.x), __float_as_uint(f.y)};
          const uint32_t bl[2] = {__float_as_uint(f.z), __float_as_uint(f.w)};
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) tf32::mma3(d[z][mt], ah[mt][s], al[mt][s], bh, bl);
        }
      // epilogue: lane (gq, t) holds t and t_z of row 4j + t at particles
      // 16 mt + gq (c0, c1) and 16 mt + gq + 8 (c2, c3)
      const float4 ri = info[4 * j + t];
      const int ia = __float_as_int(ri.x), ib = __float_as_int(ri.y);
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2* pr = el + 16 * mt + gq + 8 * h;
          const float2 ex = pr[ia], ey = pr[ib];
          const float2 e = cube::cmul(ex, ey);
          const float tr = d[0][mt][2 * h], ti = d[0][mt][2 * h + 1];
          const float zr = d[1][mt][2 * h], zi = d[1][mt][2 * h + 1];
          const float wr = tr * e.x - ti * e.y;
          const float wi = tr * e.y + ti * e.x;
          sums[mt][h][0] += wr;
          sums[mt][h][1] += ri.z * wi;
          sums[mt][h][2] += ri.w * wi;
          sums[mt][h][3] += zr * e.y + zi * e.x;
        }
    }
    // a quad's 4 lanes hold 4 rows' shares of the same particles: add them,
    // then lane t writes output t (a_x, a_y, a_z, pot) of each particle
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = sums[mt][h][c];
          v[c] += __shfl_xor_sync(0xffffffffu, v[c], 1);
          v[c] += __shfl_xor_sync(0xffffffffu, v[c], 2);
        }
        // lane t keeps output t, chosen without a dynamic index
        const float mine = t == 0 ? v[1] : t == 1 ? v[2] : t == 2 ? v[3] : v[0];
        const long long i = base + 16 * mt + gq + 8 * h;
        if (i < n) {
          if (t < 3)
            acc[3 * i + t] = mine;
          else
            pot[i] = mine;
        }
      }
    __syncwarp();    // the stage is rewritten by the next tile
  }
}

template <int KS>
cudaError_t launch(const float* x, long long n, const float* tab, int nblocks, int warps,
                   const Geo& g, float* acc, float* pot, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const size_t smem = smem_bytes(g, warps);
  cudaError_t err = cudaFuncSetAttribute(
      accel_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  accel_kernel<KS><<<nblocks, 32 * warps, smem, stream>>>(
      x, n, reinterpret_cast<const float2*>(tab), g, acc, pot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), tab (nmaxx + 1, 2 nmaxy + 1, 2 nmaxz + 1, 2) folded force table;
// outputs acc (n, 3) and pot (n,).  All f32, contiguous, on the current
// device; nmax 0..8 on each axis.  `nblocks` and `warps` are the plan's
// (ops/cube_kernels.py accel_plan: the warps that the device's shared
// memory holds beside the table).  Returns a cudaError_t.
int cube_accel_launch(const void* x, long long n, const void* tab, void* acc, void* pot,
                      int nmaxx, int nmaxy, int nmaxz, int nblocks, int warps, void* stream) {
  if (nmaxx < 0 || nmaxx > 8 || nmaxy < 0 || nmaxy > 8 || nmaxz < 0 || nmaxz > 8 ||
      nblocks < 1 || warps < 1 || warps > kMaxWarps)
    return cudaErrorInvalidValue;
  const Geo g = geometry(nmaxx, nmaxy, nmaxz);
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto tf = static_cast<const float*>(tab);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  switch (g.ks) {
    case 1: return launch<1>(xf, n, tf, nblocks, warps, g, af, pf, s);
    case 2: return launch<2>(xf, n, tf, nblocks, warps, g, af, pf, s);
    case 3: return launch<3>(xf, n, tf, nblocks, warps, g, af, pf, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* cube_accel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
