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
// k9_work).  The first version gave each wavevector a thread of a group
// of H rounded up to 32 (23 of 64 lanes idle at H = 41), which added
// each particle into its column of the group's own shared (zrows, H)
// accumulator by KZ read-modify-writes, 64 particles a tile.  Its split
// (exp_tpu_torch/probe_poly_slab_split.py, PERF.md §6) put a fifth
// of its 0.185 ms in those read-modify-writes and the rest across its
// loads, its dependent chain a particle and its staging.
//
// Design: real weights give G(-k, j) = conj G(k, j), so only the H = 41
// half-lattice wavevectors (kx > 0, or kx = 0 and ky >= 0; the h of
// slab_common.cuh) are summed, and the reduction writes each h > 0 twice,
// once conjugated into its mirror.  A block takes tiles of particles
// (ops/slab_kernels.coef_plan: 416 at the bench's shapes, two blocks an
// SM).  It sorts each tile by the particle's first z node j0, a stable
// counting sort (each warp's counts of 32 particles by __match_any_sync,
// the bins' totals and places by a thread a bin, their scan by one warp),
// keeping only particles of nonzero w, and stages each particle's record
// (w Wz, j0) and its phase rows (the x powers e^{-2 pi i a u_x}, a =
// 0..nmaxx, and the y row, cube_common.cuh) at its sorted place.  Its ng
// groups of H threads, packed side by side with no lanes rounded up (H =
// 41: 14 groups in 576 threads, two idle), take the sorted tile in parts
// of whole bins, about equal; thread h of a group keeps its column's KZ
// sums of the current j0 in registers, a window that slides up when j0
// does and adds the rows it leaves into the block's one (zrows, H)
// accumulator in shared memory.  Those rows lie below the next part's
// first j0 and are the column's alone; of the last window, the rows from
// that j0 on (at most KZ - 1) go to a side buffer, and after the walk the
// part whose window first holds such a row adds the windows that hold it,
// in the parts' order.  A window's sums are kept in two levels (kChain
// particles, then their sums), so that a part on one node does not add
// hundreds of particles in one f32 chain.  The block's
// accumulator is its partial, and a second kernel adds the partials in
// block order: the pass is deterministic.  Rows past N and particles of
// zero w are never staged, so they add exactly 0.
//
// Measured (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W, the bench's
// sheet at 2^20): ~0.13 ms against the first version's 0.184.  Per tile
// and block, clock64 put ~45% of the cycles in the walk (about 20
// instructions a particle and column, issued at half the SM's rate), ~33%
// in the sort and the staging, the rest in the global loads and the side
// buffer's rows; forms that cut the walk's instructions (three columns a
// thread stepped along ky, bin-by-bin loops) did not run faster.
#include "slab_common.cuh"

namespace {

using slab::Params;

constexpr int kWarp = 32;
constexpr int kMaxThreads = 576;     // two blocks an SM fit the registers
constexpr int kChain = 32;           // particles a thread adds in one f32 chain
constexpr int kReduceWarps = 8;

struct Geo {
  Params q;
  int H, B2, ax, row;   // half-lattice size, y row length, x powers 0..nmaxx, a phase row
  int ng, tile;         // groups a block, particles a tile (a multiple of 32)
  int nbins, kz;        // the j0 bins (nzc rounded up to 32); z rows a particle
};

// The block's shared memory, carved in this order from the plan's
// (ng, tile) (ops/slab_kernels.k9_smem): the sorted records (w Wz, j0), the
// (zrows, H) accumulator, the sorted phase rows, the side buffer (KZ - 1
// rows of H a group), each particle's bin and rank, each 32-particle
// chunk's counts (then first places) by bin, the bins' totals (then first
// places) and the tile's count of sorted particles, and the groups' parts
// and next j0.
struct Smem {
  float4* rec;
  float2* acc;
  float2* rows;
  float2* side;
  int* key;
  int* cnt;
  int* bsum;
  int* meta;
  size_t bytes;
  __host__ __device__ Smem(void* base, const Geo& g) {
    char* p = static_cast<char*>(base);
    rec = reinterpret_cast<float4*>(p);
    acc = reinterpret_cast<float2*>(rec + g.tile);
    rows = acc + (size_t)g.q.zrows * g.H;
    side = rows + (size_t)g.tile * g.row;
    key = reinterpret_cast<int*>(side + (size_t)g.ng * (g.kz - 1) * g.H);
    cnt = key + g.tile;
    bsum = cnt + (g.tile / kWarp) * g.nbins;
    meta = bsum + g.nbins + 1;
    bytes = reinterpret_cast<char*>(meta + 2 * g.ng + 1) - p;
  }
};

// Each 32-particle chunk's counts by bin (cnt, chunk-major) become its
// first place in the sorted order (bin-major, then chunk: a stable sort):
// the bins' totals (bsum) by a thread a bin, their exclusive scan by warp
// 0 (bsum[b] the first place of bin b, bsum[nbins] the number of sorted
// particles), then each bin's chunks by a thread a bin.  Ends with every
// thread past a barrier.
__device__ __forceinline__ void sort_places(int* cnt, int* bsum, int nch, int nbins) {
  const int tid = threadIdx.x, lane = tid % kWarp;
  for (int b = tid; b < nbins; b += blockDim.x) {
    int tot = 0;
#pragma unroll 4
    for (int c = 0; c < nch; ++c) tot += cnt[c * nbins + b];
    bsum[b] = tot;
  }
  __syncthreads();
  if (tid < kWarp) {
    int carry = 0;
    for (int b0 = 0; b0 < nbins; b0 += kWarp) {
      const int tot = bsum[b0 + lane];
      int incl = tot;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      bsum[b0 + lane] = carry + incl - tot;
      carry += __shfl_sync(0xffffffffu, incl, kWarp - 1);
    }
    if (lane == 0) bsum[nbins] = carry;
  }
  __syncthreads();
  for (int b = tid; b < nbins; b += blockDim.x) {
    int run = bsum[b];
#pragma unroll 4
    for (int c = 0; c < nch; ++c) {
      const int t = cnt[c * nbins + b];
      cnt[c * nbins + b] = run;
      run += t;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void cadd(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}

// One thread's column of its group's part of the sorted tile: the part's
// rows below `next` (the next part's first j0) are this column's alone.
// Each row's sum is kept in two levels, `lo` adding kChain particles at a
// time and `hi` those sums, so that no f32 chain of adds is longer than
// kChain + (particles a part) / kChain.
template <int KZ>
struct Column {
  float2 hi[KZ], lo[KZ];     // rows c .. c + KZ - 1
  int c, next, m;            // m: particles in lo

  __device__ __forceinline__ void add(float2 e, const float* wk) {
#pragma unroll
    for (int q = 0; q < KZ; ++q) {
      lo[q].x += e.x * wk[q];
      lo[q].y += e.y * wk[q];
    }
    if (++m == kChain) {
#pragma unroll
      for (int q = 0; q < KZ; ++q) {
        cadd(hi[q], lo[q]);
        lo[q] = make_float2(0.0f, 0.0f);
      }
      m = 0;
    }
  }

  __device__ __forceinline__ float2 row(int q) const {
    return make_float2(hi[q].x + lo[q].x, hi[q].y + lo[q].y);
  }

  // the window moves up to rows j .. j + KZ - 1; the rows it leaves lie
  // below next (they are below the part's last j0)
  __device__ __forceinline__ void slide(int j, float2* acc, int H) {
    const int d = j - c;
#pragma unroll
    for (int k = 0; k < KZ; ++k)
      if (k < d) cadd(acc[(size_t)(c + k) * H], row(k));
#pragma unroll
    for (int k = 0; k < KZ; ++k) {
      float2 h = make_float2(0.0f, 0.0f), l = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int s = k + 1; s < KZ; ++s)
        if (s - k == d) {
          h = hi[s];
          l = lo[s];
        }
      hi[k] = h;
      lo[k] = l;
    }
    c = j;
  }
};

// The first place at or after `at` where a bin starts: bsum[0..nbins] are
// the bins' first places (nondecreasing, bsum[nbins] the count).
__device__ __forceinline__ int bin_start_from(const int* bsum, int nbins, int at) {
  int lo = 0, hi = nbins;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (bsum[mid] < at) lo = mid + 1;
    else hi = mid;
  }
  return bsum[lo];
}

template <int KZ>
__global__ void __launch_bounds__(kMaxThreads, 2)
coef_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                long long n, Geo g, float2* __restrict__ partial) {
  extern __shared__ float4 sh4[];
  const Smem sm(sh4, g);
  const int tid = threadIdx.x, lane = tid % kWarp, nthreads = blockDim.x;
  const int nch = g.tile / kWarp;
  const int grp = tid / g.H, h = tid % g.H;       // group and column
  const bool walker = grp < g.ng;
  const int kx = (h + g.q.ny) / g.B2;
  const int kyi = h - kx * g.B2 + g.q.ny;         // ky + nmaxy
  float2* acc = sm.acc + h;
  int* part = sm.meta;                    // ng + 1 parts' first places
  int* nexts = sm.meta + g.ng + 1;        // each part's next j0, or -1

  for (int e = tid; e < g.q.zrows * g.H; e += nthreads) sm.acc[e] = make_float2(0.0f, 0.0f);
  for (int e = tid; e < nch * g.nbins; e += nthreads) sm.cnt[e] = 0;

  for (long long base = (long long)blockIdx.x * g.tile; base < n;
       base += (long long)gridDim.x * g.tile) {
    // A. each particle's bin (its first z node; -1 for w = 0) and its rank
    // among its chunk's particles of that bin, a warp a chunk
    for (int c0 = tid - lane; c0 < g.tile; c0 += nthreads) {
      const int p = c0 + lane;
      const long long i = base + p;
      int bin = -1;
      if (i < n) {
        const float z = x[3 * i + 2];
        if (fabsf(z) <= g.q.zmax && mass[i] != 0.0f) {
          float wz[KZ];
          bin = slab::z_nodes<KZ>(slab::z_grid(z, g.q), g.q.nzc, wz);
        }
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (bin >= 0 && rank == 0) sm.cnt[(p / kWarp) * g.nbins + bin] = __popc(peers);
      sm.key[p] = bin < 0 ? -1 : bin | (rank << 16);
    }
    __syncthreads();
    sort_places(sm.cnt, sm.bsum, nch, g.nbins);
    // B. each live particle's record and phase rows at its sorted place;
    // the groups' parts: whole bins, group gr's from the first bin that
    // starts at or after gr live / ng
    const int live = sm.bsum[g.nbins];
    for (int p = tid; p < g.tile; p += nthreads) {
      const int key = sm.key[p];
      if (key < 0) continue;
      const int bin = key & 0xffff;
      const int pos = sm.cnt[(p / kWarp) * g.nbins + bin] + (key >> 16);
      const long long i = base + p;
      const float w = mass[i];
      float wz[KZ];
      slab::z_nodes<KZ>(slab::z_grid(x[3 * i + 2], g.q), g.q.nzc, wz);
      sm.rec[pos] = make_float4(w * wz[0], w * wz[1], KZ == 3 ? w * wz[KZ - 1] : 0.0f,
                                __int_as_float(bin));
      float2* row = sm.rows + (size_t)pos * g.row;
      cube::powers(cube::unit_phase(cube::wrap(x[3 * i]), -1.0f), g.q.nx, row);
      cube::axis_row(cube::unit_phase(cube::wrap(x[3 * i + 1]), -1.0f), g.q.ny, 1.0f,
                     row + g.ax);
    }
    for (int gr = tid; gr <= g.ng; gr += nthreads)
      part[gr] = bin_start_from(sm.bsum, g.nbins, (int)((long long)gr * live / g.ng));
    __syncthreads();
    for (int e = tid; e < nch * g.nbins; e += nthreads) sm.cnt[e] = 0;

    // C. the walk: group grp takes its part [k0, k1) of the sorted tile
    const int k0 = walker ? part[grp] : 0, k1 = walker ? part[grp + 1] : 0;
    Column<KZ> col;
#pragma unroll
    for (int q = 0; q < KZ; ++q) col.hi[q] = col.lo[q] = make_float2(0.0f, 0.0f);
    col.m = 0;
    col.next = k1 < live ? __float_as_int(sm.rec[k1].w) : -1;
    if (walker && k0 < k1) {
      // particle by particle; the next particle's record and phases are
      // loaded with the current one's sums (past the part's end the loads
      // stay inside the block's shared memory, unused)
      const float4* rp = sm.rec + k0;
      const float2* row = sm.rows + (size_t)k0 * g.row;
      float4 r = rp[0];
      float2 ea = row[kx], eb = row[g.ax + kyi];
      col.c = __float_as_int(r.w);
#pragma unroll 2
      for (int k = k0; k < k1; ++k) {
        const float4 rc = r;
        const float2 e = cube::cmul(ea, eb);
        ++rp;
        row += g.row;
        r = *rp;
        ea = row[kx];
        eb = row[g.ax + kyi];
        const int j = __float_as_int(rc.w);
        if (j != col.c) col.slide(j, acc, g.H);
        const float wk[3] = {rc.x, rc.y, rc.z};
        col.add(e, wk);
      }
      // the last window: its rows below the next part's first j0 are the
      // part's own; rows next .. next + KZ - 2 may be the next parts' too,
      // and wait in the side buffer (0 where the window does not reach)
#pragma unroll
      for (int q = 0; q < KZ; ++q)
        if (col.next < 0 || col.c + q < col.next) cadd(acc[(size_t)(col.c + q) * g.H], col.row(q));
      if (col.next >= 0) {
#pragma unroll
        for (int s = 0; s < KZ - 1; ++s) {
          const int k = col.next + s - col.c;
          float2 v = make_float2(0.0f, 0.0f);
#pragma unroll
          for (int q = 0; q < KZ; ++q)
            if (k == q) v = col.row(q);
          sm.side[((size_t)grp * (KZ - 1) + s) * g.H + h] = v;
        }
      }
    }
    if (walker && h == 0) nexts[grp] = k0 < k1 ? col.next : -1;
    __syncthreads();

    // D. the waiting rows: a part's rows next .. next + KZ - 2, in the
    // order of the parts; the parts' next j0 increase, so the part of the
    // first window that holds a row adds the later ones
    if (walker && nexts[grp] >= 0) {
#pragma unroll
      for (int q = 0; q < KZ - 1; ++q) {
        const int r = nexts[grp] + q;
        int prev = grp - 1;
        while (prev >= 0 && nexts[prev] < 0) --prev;
        if (prev >= 0 && nexts[prev] + KZ - 1 > r) continue;   // an earlier part holds r
        float2 v = acc[(size_t)r * g.H];
        for (int gr = grp; gr < g.ng; ++gr) {
          const int nx = nexts[gr];
          if (nx < 0) continue;
          if (nx > r) break;
          cadd(v, sm.side[((size_t)gr * (KZ - 1) + r - nx) * g.H + h]);
        }
        acc[(size_t)r * g.H] = v;
      }
    }
  }
  __syncthreads();

  // this block's sums are its partial
  float2* out = partial + (long long)blockIdx.x * g.q.zrows * g.H;
  for (int o = tid; o < g.q.zrows * g.H; o += nthreads) out[o] = sm.acc[o];
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
                   float* out, int nblocks, int threads, int smem, const Geo& g,
                   cudaStream_t stream) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(coef_accumulate<KZ>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  coef_accumulate<KZ><<<nblocks, threads, smem, stream>>>(
      x, mass, n, g, reinterpret_cast<float2*>(partial));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int M2 = 2 * g.H * g.q.zrows;
  coef_reduce<<<(M2 + 31) / 32, 32 * kReduceWarps, 0, stream>>>(partial, nblocks, g, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), partial (nblocks, zrows, H, 2) scratch, out (C,
// zrows, 2); all f32, contiguous, on the current device; nmax 0..8 on each
// axis, nzc >= 2, zrows = nzc + 2 ('spline') or nzc ('linear') at most 128.
// The plan (ops/slab_kernels.coef_plan): ng groups of H threads a block
// (ng H at most kMaxThreads), tiles of `tile` particles (a multiple of
// 32), nblocks blocks and smem bytes of shared memory a block, at least
// what the layout carves.  Returns a cudaError_t.
int slab_coef_launch(const void* x, const void* mass, long long n, void* partial,
                     void* out, int ng, int tile, int nblocks, int smem, int nmaxx, int nmaxy,
                     int nzc, int spline, float zmax, float dz, void* stream) {
  if (nblocks < 1 || ng < 1 || tile < kWarp || tile % kWarp || nmaxx < 0 || nmaxx > 8 ||
      nmaxy < 0 || nmaxy > 8 || nzc < 2)
    return cudaErrorInvalidValue;
  Geo g;
  g.q = Params{nmaxx, nmaxy, nzc, spline ? nzc + 2 : nzc, zmax, dz};
  g.H = slab::half_count(nmaxx, nmaxy);
  g.B2 = 2 * nmaxy + 1;
  g.ax = nmaxx + 1;
  g.row = g.ax + g.B2;
  g.ng = ng;
  g.tile = tile;
  g.nbins = (nzc + kWarp - 1) / kWarp * kWarp;
  g.kz = spline ? 3 : 2;
  const int threads = (ng * g.H + kWarp - 1) / kWarp * kWarp;
  if (g.q.zrows > 128 || threads > kMaxThreads || Smem(nullptr, g).bytes > (size_t)smem)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto pf = static_cast<float*>(partial);
  auto of = static_cast<float*>(out);
  return spline ? launch<3>(xf, mf, n, pf, of, nblocks, threads, smem, g, s)
                : launch<2>(xf, mf, n, pf, of, nblocks, threads, smem, g, s);
}

const char* slab_coef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
