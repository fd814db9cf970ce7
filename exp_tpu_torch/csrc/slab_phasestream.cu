// Slab phase-stream probe P1 for Hopper: K9's G from a streamed bf16 phase
// table, CUDA-core FP32.
//
// Replaces: scripts/probe_slab_phasestream.py make_stream_kernel (the TPU
// kernel at its pallas_call, :128), the probe's stream1 and stream2.
//
// Computes, for particles x (N, 3), mass (N,) and the probe's phase table ph
// (2 Cr, N) bf16 [re | im] (stream1) or (4 Cr, N) [re_hi | im_hi | re_lo |
// im_lo] (stream2), Cr = C rounded up to 8 (ops/slab_kernels.phase_table):
//   G[c, j] = sum_i P_c(i) w_i Wz[j, i],  P = ph widened to f32 (hi + lo)
// with w the mass masked to |z| <= zmax and Wz the particle's 3 spline
// weights ('spline') or 2 hats ('linear') at t = clip((z + zmax)/dz, 0,
// nzc - 1) (slab_common.cuh), as out (C, zrows, 2) f32 (re, im).  This is
// the Hopper meaning of the probe's DEFAULT matmul: the phases are rounded
// to bf16 (by the producer), the arithmetic is f32.  A split table's hi + lo
// is exact in f32, so stream2 adds it once and multiplies once, where the
// TPU ran two bf16 matmuls.
//
// What bounds it on an H100, at the probe's shapes (nmax 4, C = 81, zrows
// 128, N = 2^20): bytes.  The function reads the 2C (stream1) or 4C
// (stream2) table rows it uses, 324 or 648 B a particle, and 8 B of z and
// mass: 0.10 or 0.20 ms at 3.35 TB/s; its operations, 3 FMAs a row and
// particle, take 0.015 ms at 67 TFLOP/s.  The producer writes the same
// table, so producer + kernel cannot beat twice the read.  K9
// (slab_coef.cu) does the same job with the phases made in the kernel.
//
// Why not the TPU's dense (2 Cr, B) x (B, 128) product on tensor cores: Wz
// has KZ nonzeros in its 128 columns, so a dense product does 43x the
// FMAs, and it would round w Wz to bf16, far outside the plain version's
// 1e-5.  The first port scattered instead: thread a owned output row a in
// a shared (zrows, 2C) f32 accumulator and made 3 dependent shared
// read-modify-writes a particle, on tiles of 64 particles loaded between
// two barriers; that chain was half its time and the synchronous staging
// most of the rest (exp_tpu_torch/probe_rec_split.py).
//
// Design: no shared accumulator.  Thread a keeps row a's zrows sums in
// registers, s[j] for j < kMaxZ, and walks each tile's particles grouped
// by their first z node j0, so that every s index is known at compile
// time: the walk is unrolled over j0 and loops over the particles of each
// j0 that occurs.  A tile of TILE particles is sorted by j0 in shared
// memory by a stable counting sort (each warp's counts by __match_any_sync,
// one warp's scan over the bins), only particles of nonzero weight w;
// each sorted record holds w Wz and the particle's place in the tile.
// The table rows of the next tile stream into a second buffer by 4-byte
// cp.async while the current tile is walked, at a row stride of TILE/2 + 1
// words, so that a warp reading one particle of 32 rows hits 32 banks; z
// and mass of the next tile wait in registers.  Blocks take tiles in a
// grid stride; each writes its sums as a partial, and a second kernel adds
// the partials in block order: the pass is deterministic (the sort is
// stable, every sum is taken in one order).  A zero mass or |z| > zmax
// gives w = 0, and such particles are not walked: they add exactly 0.
//
// Measured (exp_tpu_torch/bench_kernels.py, the probe's sample at 2^20,
// NVIDIA H100 80GB HBM3 at 700 W, the first port in the same call):
// stream1 0.40 ms (0.90), stream2 0.64 (0.98); torch.matmul of the table
// with a dense bf16 Wz^T takes 0.25 and 0.36 (chip_smoke.py PS2).  168
// registers, two blocks of 6 warps an SM.  The walk, about 10
// instructions for a particle and a row, is most of the time: without it
// the pass takes 0.15 and 0.27 (exp_tpu_torch/probe_rec_split.py).
#include <cstdint>

#include "slab_common.cuh"

namespace {

using slab::Params;

// kMaxZ, kMaxThreads and the tiles are mirrored in ops/slab_kernels.py
// (KERNEL_ZROWS_MAX, P1_MAX_THREADS, P1_TILES, stream_smem_bytes), which
// plans the grid
constexpr int kWarp = 32;
constexpr int kMaxZ = 128;             // z rows a thread sums in registers
constexpr int kMaxThreads = 256;       // 2C rows: nmax 0..5 on each axis
constexpr int kReduceThreads = 256;

struct Geo {
  Params q;
  int C, Cr;      // wavevectors; rows of each half of the table
  int A;          // output rows 2C
  int nst;        // staged rows: A, or 2A for a split table
  int split;
};

// The table row of staged row s: rows 0..A-1 the re and im rows a thread
// owns, then (split) their lo rows.
__device__ __forceinline__ long long table_row(int s, const Geo& g) {
  const bool lo = s >= g.A;
  const int a = lo ? s - g.A : s;
  const int r = a < g.C ? a : g.Cr + (a - g.C);
  return lo ? 2 * g.Cr + r : r;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared bytes of a block: sorted records, each sorting warp's counts and
// offsets by bin, the bins' starts and occupancy, the staged rows' table
// offsets and two buffers of nst staged rows of TILE/2 + 1 words
template <int TILE>
constexpr size_t stream_smem(int nst) {
  return sizeof(float4) * TILE + sizeof(int) * (2 * (TILE / kWarp) * kMaxZ + kMaxZ + 4) +
         sizeof(uint32_t) * (kMaxZ / kWarp) + sizeof(long long) * nst +
         sizeof(uint32_t) * 2 * (size_t)nst * (TILE / 2 + 1);
}

// The table rows of the particles [base, base + TILE) into a buffer: row s
// at dst + s W, particle p in half-word p.  Asynchronous (4-byte cp.async,
// waited for by cp_async_wait) for a whole tile of an even n from a 4-byte
// aligned table; otherwise loaded here, the pairs past n as 0.
template <int TILE>
__device__ __forceinline__ void stage_tile(const uint16_t* __restrict__ ph, long long n,
                                           long long base, int nst, const long long* rowoff,
                                           bool async, uint32_t* dst) {
  constexpr int H = TILE / 2, W = H + 1;
  if (async) {
    for (int t = threadIdx.x; t < nst * H; t += blockDim.x) {
      const int s = t / H, w = t % H;
      cp_async4(dst + s * W + w, ph + rowoff[s] + base + 2 * w);
    }
    return;
  }
  const long long left = n - base;
  for (int t = threadIdx.x; t < nst * H; t += blockDim.x) {
    const int s = t / H, w = t % H;
    const uint16_t* src = ph + rowoff[s] + base + 2 * w;
    const uint32_t lo = 2 * w < left ? src[0] : 0u;
    const uint32_t hi = 2 * w + 1 < left ? src[1] : 0u;
    dst[s * W + w] = lo | (hi << 16);
  }
}

// One warp: the bins' counts of the SW sorting warps (cnt, zeroed here) to
// each warp's first place in the sorted order (off, bin-major then warp),
// the bins' starts (bstart, kMaxZ + 1) and their occupancy bits (occ).
template <int SW>
__device__ __forceinline__ void scan_bins(int* cnt, int* off, int* bstart, uint32_t* occ,
                                          int lane) {
  int carry = 0;
#pragma unroll
  for (int b = 0; b < kMaxZ / kWarp; ++b) {
    const int bin = b * kWarp + lane;
    int c[SW], tot = 0;
#pragma unroll
    for (int w = 0; w < SW; ++w) {
      c[w] = cnt[w * kMaxZ + bin];
      cnt[w * kMaxZ + bin] = 0;
      tot += c[w];
    }
    int incl = tot;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    int run = carry + incl - tot;
    bstart[bin] = run;
#pragma unroll
    for (int w = 0; w < SW; ++w) {
      off[w * kMaxZ + bin] = run;
      run += c[w];
    }
    const uint32_t m = __ballot_sync(0xffffffffu, tot > 0);
    if (lane == 0) occ[b] = m;
    carry += __shfl_sync(0xffffffffu, incl, kWarp - 1);
  }
  if (lane == 0) bstart[kMaxZ] = carry;
}

// The particles [k0, k1) of one bin into a row's sums of its KZ z rows
template <int KZ, bool SPLIT>
__device__ __forceinline__ void walk_bin(float& s0, float& s1, float& s2,
                                         const float4* __restrict__ srt, int k0, int k1,
                                         const uint16_t* hrow, const uint16_t* lrow) {
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const float4 r = srt[k];
    const int p = __float_as_int(r.w);
    float v = __uint_as_float((uint32_t)hrow[p] << 16);
    if (SPLIT) v += __uint_as_float((uint32_t)lrow[p] << 16);
    s0 = __fmaf_rn(v, r.x, s0);
    s1 = __fmaf_rn(v, r.y, s1);
    if (KZ == 3) s2 = __fmaf_rn(v, r.z, s2);
  }
}

template <int KZ, int TILE, bool SPLIT>
__global__ void __launch_bounds__(kMaxThreads, 1)
stream_accumulate(const uint16_t* __restrict__ ph, const float* __restrict__ x,
                  const float* __restrict__ mass, long long n, Geo g, int vec,
                  float* __restrict__ partial) {
  constexpr int W = TILE / 2 + 1, SW = TILE / kWarp;
  extern __shared__ float4 sh4[];
  float4* srt = sh4;                                                  // (TILE)
  int* cnt = reinterpret_cast<int*>(srt + TILE);                      // (SW, kMaxZ)
  int* off = cnt + SW * kMaxZ;                                        // (SW, kMaxZ)
  int* bstart = off + SW * kMaxZ;                                     // kMaxZ + 1
  uint32_t* occ = reinterpret_cast<uint32_t*>(bstart + kMaxZ + 4);    // kMaxZ / 32
  long long* rowoff = reinterpret_cast<long long*>(occ + kMaxZ / kWarp);   // nst
  uint32_t* stage = reinterpret_cast<uint32_t*>(rowoff + g.nst);      // 2 x (nst, W)
  const uint16_t* sh16 = reinterpret_cast<const uint16_t*>(stage);

  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  for (int e = tid; e < SW * kMaxZ; e += blockDim.x) cnt[e] = 0;
  for (int s = tid; s < g.nst; s += blockDim.x) rowoff[s] = table_row(s, g) * n;
  __syncthreads();
  float s[kMaxZ];
#pragma unroll
  for (int j = 0; j < kMaxZ; ++j) s[j] = 0.0f;

  const long long step = (long long)gridDim.x * TILE;
  long long base = (long long)blockIdx.x * TILE;
  float pz = 0.0f, pm = 0.0f;                       // this thread's particle of the tile
  if (tid < TILE && base + tid < n) pz = x[3 * (base + tid) + 2], pm = mass[base + tid];
  if (base < n) stage_tile<TILE>(ph, n, base, g.nst, rowoff, vec && base + TILE <= n, stage);
  cp_async_commit();
  for (int buf = 0; base < n; base += step, buf ^= 1) {
    // the tile's records; each sorting warp's count of a bin and a
    // particle's rank among its warp's particles of that bin
    int bin = -1, rank = 0;
    float4 rec = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tid < TILE) {
      const float w = base + tid < n && fabsf(pz) <= g.q.zmax ? pm : 0.0f;
      if (w != 0.0f) {
        float wz[KZ];
        bin = slab::z_nodes<KZ>(slab::z_grid(pz, g.q), g.q.nzc, wz);
        rec = make_float4(w * wz[0], w * wz[1], KZ == 3 ? w * wz[KZ - 1] : 0.0f,
                          __int_as_float(tid));
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      rank = __popc(peers & ((1u << lane) - 1u));
      if (bin >= 0 && rank == 0) cnt[warp * kMaxZ + bin] = __popc(peers);
      const long long nx = base + step + tid;
      if (nx < n) pz = x[3 * nx + 2], pm = mass[nx];
    }
    __syncthreads();
    // every thread is past the walk that last read the other buffer
    if (base + step < n)
      stage_tile<TILE>(ph, n, base + step, g.nst, rowoff, vec && base + step + TILE <= n,
                       stage + (buf ^ 1) * g.nst * W);
    cp_async_commit();
    if (warp == 0) scan_bins<SW>(cnt, off, bstart, occ, lane);
    __syncthreads();
    if (bin >= 0) srt[off[warp * kMaxZ + bin] + rank] = rec;
    cp_async_wait<1>();                              // this tile's rows are in
    __syncthreads();

    // the walk: thread a, row a, over the tile's bins in order
    const int a = tid;
    if (a >= g.A) continue;
    const uint16_t* hrow = sh16 + (buf * g.nst + a) * (2 * W);
    const uint16_t* lrow = hrow + g.A * (2 * W);
    const uint32_t o0 = occ[0], o1 = occ[1], o2 = occ[2], o3 = occ[3];
    int k0 = 0;                                      // the next bin's first record
#pragma unroll
    for (int j = 0; j <= kMaxZ - KZ; ++j) {
      const uint32_t ow = j < 32 ? o0 : j < 64 ? o1 : j < 96 ? o2 : o3;
      if (!((ow >> (j % 32)) & 1u)) continue;
      const int k1 = bstart[j + 1];
      walk_bin<KZ, SPLIT>(s[j], s[j + 1], s[j + KZ - 1], srt, k0, k1, hrow, lrow);
      k0 = k1;
    }
  }
  cp_async_wait<0>();
  if (tid < g.A) {
    float* out = partial + (long long)blockIdx.x * g.q.zrows * g.A + tid;
#pragma unroll
    for (int j = 0; j < kMaxZ; ++j)
      if (j < g.q.zrows) out[(long long)j * g.A] = s[j];
  }
}

// Sum the block partials in block order; element e = j A + a of the
// (zrows, A) sums goes to G[c, j] (re for a < C, im otherwise).
__global__ void __launch_bounds__(kReduceThreads)
stream_reduce(const float* __restrict__ partial, int nblocks, Geo g,
              float* __restrict__ out) {
  const int accn = g.q.zrows * g.A;
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= accn) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partial[(long long)b * accn + e];
  const int j = e / g.A, a = e % g.A;
  const int c = a < g.C ? a : a - g.C;
  out[((long long)c * g.q.zrows + j) * 2 + (a < g.C ? 0 : 1)] = s;
}

template <int KZ, int TILE, bool SPLIT>
cudaError_t launch(const uint16_t* ph, const float* x, const float* mass, long long n,
                   float* partial, float* out, int nblocks, int threads, int vec,
                   const Geo& g, cudaStream_t stream) {
  const size_t smem = stream_smem<TILE>(g.nst);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(stream_accumulate<KZ, TILE, SPLIT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  stream_accumulate<KZ, TILE, SPLIT><<<nblocks, threads, smem, stream>>>(ph, x, mass, n, g,
                                                                          vec, partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int accn = g.q.zrows * g.A;
  stream_reduce<<<(accn + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, stream>>>(
      partial, nblocks, g, out);
  return cudaGetLastError();
}

template <int KZ, int TILE>
cudaError_t launch_split(const uint16_t* ph, const float* x, const float* mass, long long n,
                         float* partial, float* out, int nblocks, int threads, int vec,
                         const Geo& g, cudaStream_t stream) {
  return g.split ? launch<KZ, TILE, true>(ph, x, mass, n, partial, out, nblocks, threads, vec,
                                          g, stream)
                 : launch<KZ, TILE, false>(ph, x, mass, n, partial, out, nblocks, threads,
                                           vec, g, stream);
}

}  // namespace

extern "C" {

// ph (2 Cr or 4 Cr, n) bf16 (split: 4 Cr), x (n, 3), mass (n,), partial
// (nblocks, zrows, 2C) scratch, out (C, zrows, 2); f32 but ph, contiguous,
// on the current device; vec: n even and ph 4-byte aligned (asynchronous
// 4-byte loads).  The plan (ops/slab_kernels.stream_plan): tiles of `tile`
// particles (64 or 128), `threads` threads a block (a multiple of 32, at
// least 2C and the tile, at most 256).  nmax 0..8 on each axis, nzc >= 2,
// zrows = nzc + 2 ('spline') or nzc ('linear') at most 128; the shared
// memory must fit a block.  Returns a cudaError_t.
int slab_phasestream_launch(const void* ph, const void* x, const void* mass, long long n,
                            void* partial, void* out, int nblocks, int tile, int threads,
                            int split, int vec, int nmaxx, int nmaxy, int nzc, int spline,
                            float zmax, float dz, void* stream) {
  if (nblocks < 1 || nmaxx < 0 || nmaxx > 8 || nmaxy < 0 || nmaxy > 8 || nzc < 2 ||
      (tile != 64 && tile != 128))
    return cudaErrorInvalidValue;
  Geo g;
  g.q = Params{nmaxx, nmaxy, nzc, spline ? nzc + 2 : nzc, zmax, dz};
  if (g.q.zrows > kMaxZ) return cudaErrorInvalidValue;
  g.C = (2 * nmaxx + 1) * (2 * nmaxy + 1);
  g.Cr = (g.C + 7) / 8 * 8;
  g.A = 2 * g.C;
  if (threads % kWarp || threads < g.A || threads < tile || threads > kMaxThreads)
    return cudaErrorInvalidValue;
  g.split = split ? 1 : 0;
  g.nst = split ? 2 * g.A : g.A;
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<const uint16_t*>(ph);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto pf = static_cast<float*>(partial);
  auto of = static_cast<float*>(out);
  if (spline)
    return tile == 128 ? launch_split<3, 128>(pp, xf, mf, n, pf, of, nblocks, threads, vec, g, s)
                       : launch_split<3, 64>(pp, xf, mf, n, pf, of, nblocks, threads, vec, g, s);
  return tile == 128 ? launch_split<2, 128>(pp, xf, mf, n, pf, of, nblocks, threads, vec, g, s)
                     : launch_split<2, 64>(pp, xf, mf, n, pf, of, nblocks, threads, vec, g, s);
}

const char* slab_phasestream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
