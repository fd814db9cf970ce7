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
// Design: Wz has only KZ nonzeros a particle, so G is a scatter in z, not
// the TPU's dense (2 Cr, B) x (B, 128) product.  Thread a of a block owns
// output row a (re of c = a for a < C, im of c = a - C) and keeps its zrows
// z-columns in shared memory, (zrows, 2C) f32 with a the fastest index, so
// a warp's read-modify-writes hit 32 banks; no atomics.  A block stages a
// tile of kTile particles: the table rows it reads, with 16-byte coalesced
// loads, all issued before any is stored, at a row stride of kStride words
// (one spare) so that a warp reading one word of 32 rows hits 32 banks; and
// each particle's w Wz with j0.  Each thread then walks the tile's
// particles, two to a 32-bit word of its row.  Blocks take tiles in a grid
// stride; each writes its accumulator as a partial, and a second kernel
// adds the partials in block order: the pass is deterministic.  A zero mass
// or |z| > zmax makes w Wz = 0, and rows past N are staged as 0, so such a
// particle adds exactly 0.
#include <cstdint>

#include "slab_common.cuh"

namespace {

using slab::Params;

// kTile, kStride and kMaxThreads are mirrored in ops/slab_kernels.py
// (P1_TILE, P1_STRIDE, P1_MAX_THREADS, stream_smem_bytes), which plans the
// grid
constexpr int kTile = 64;               // particles a staged tile
constexpr int kChunks = kTile / 8;      // 16-byte chunks of a staged row
constexpr int kStride = kTile / 2 + 1;  // 32-bit words a staged row
constexpr int kMaxThreads = 256;       // 2C rows: nmax 0..5 on each axis
constexpr int kMaxTasks = 2 * kChunks + 1;   // staging loads a thread, at most
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

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <int KZ>
__device__ __forceinline__ void scatter(float* acc, int A, float4 r, float v) {
  float* dst = acc + __float_as_int(r.w) * A;
  dst[0] += v * r.x;
  dst[A] += v * r.y;
  if (KZ == 3) dst[2 * A] += v * r.z;
}

template <int KZ>
__global__ void __launch_bounds__(kMaxThreads)
stream_accumulate(const uint16_t* __restrict__ ph, const float* __restrict__ x,
                  const float* __restrict__ mass, long long n, Geo g, int vec,
                  float* __restrict__ partial) {
  extern __shared__ float4 sh4[];
  float4* zrec = sh4;                                                // (kTile)
  uint32_t* stage = reinterpret_cast<uint32_t*>(sh4 + kTile);        // (nst, kStride)
  float* acc = reinterpret_cast<float*>(stage + g.nst * kStride);    // (zrows, A)
  const int accn = g.q.zrows * g.A;
  for (int e = threadIdx.x; e < accn; e += blockDim.x) acc[e] = 0.0f;

  const int ntask = g.nst * kChunks;
  for (long long base = (long long)blockIdx.x * kTile; base < n;
       base += (long long)gridDim.x * kTile) {
    __syncthreads();                              // the last tile is consumed
    uint4 in[kMaxTasks];
#pragma unroll
    for (int t = 0; t < kMaxTasks; ++t) {
      const int task = threadIdx.x + t * blockDim.x;
      in[t] = make_uint4(0u, 0u, 0u, 0u);
      if (task >= ntask) continue;
      const long long p0 = base + (task % kChunks) * 8;
      const uint16_t* src = ph + table_row(task / kChunks, g) * n + p0;
      if (vec && p0 + 8 <= n) {
        in[t] = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t a = p0 + 2 * i < n ? src[2 * i] : 0u;
          const uint32_t b = p0 + 2 * i + 1 < n ? src[2 * i + 1] : 0u;
          w[i] = a | (b << 16);
        }
        in[t] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    for (int p = threadIdx.x; p < kTile; p += blockDim.x) {
      const long long i = base + p;
      float4 r = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0));
      if (i < n) {
        const float z = x[3 * i + 2];
        const float w = fabsf(z) <= g.q.zmax ? mass[i] : 0.0f;
        float wz[KZ];
        const int j0 = slab::z_nodes<KZ>(slab::z_grid(z, g.q), g.q.nzc, wz);
        r = make_float4(w * wz[0], w * wz[1], KZ == 3 ? w * wz[KZ - 1] : 0.0f,
                        __int_as_float(j0));
      }
      zrec[p] = r;
    }
#pragma unroll
    for (int t = 0; t < kMaxTasks; ++t) {
      const int task = threadIdx.x + t * blockDim.x;
      if (task >= ntask) continue;
      uint32_t* dst = stage + (task / kChunks) * kStride + (task % kChunks) * 4;
      dst[0] = in[t].x;
      dst[1] = in[t].y;
      dst[2] = in[t].z;
      dst[3] = in[t].w;
    }
    __syncthreads();

    const long long left = n - base;
    const int cnt = left >= kTile ? kTile : (int)left;
    const int a = threadIdx.x;
    if (a >= g.A) continue;
    const uint32_t* hrow = stage + a * kStride;
    const uint32_t* lrow = stage + (g.A + a) * kStride;
    for (int p = 0; p < cnt; p += 2) {
      const uint32_t wh = hrow[p >> 1];
      float v0 = bf16_lo(wh), v1 = bf16_hi(wh);
      if (g.split) {
        const uint32_t wl = lrow[p >> 1];
        v0 += bf16_lo(wl);
        v1 += bf16_hi(wl);
      }
      scatter<KZ>(acc + a, g.A, zrec[p], v0);
      if (p + 1 < cnt) scatter<KZ>(acc + a, g.A, zrec[p + 1], v1);
    }
  }
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * accn;
  for (int e = threadIdx.x; e < accn; e += blockDim.x) out[e] = acc[e];
}

// Sum the block partials in block order; element e = j A + a of the
// (zrows, A) accumulator goes to G[c, j] (re for a < C, im otherwise).
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

template <int KZ>
cudaError_t launch(const uint16_t* ph, const float* x, const float* mass, long long n,
                   float* partial, float* out, int nblocks, int vec, const Geo& g,
                   cudaStream_t stream) {
  const int threads = (g.A + 31) / 32 * 32;
  const size_t smem = sizeof(float4) * kTile + sizeof(uint32_t) * (size_t)g.nst * kStride +
                      sizeof(float) * (size_t)g.q.zrows * g.A;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(stream_accumulate<KZ>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  stream_accumulate<KZ><<<nblocks, threads, smem, stream>>>(ph, x, mass, n, g, vec, partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int accn = g.q.zrows * g.A;
  stream_reduce<<<(accn + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, stream>>>(
      partial, nblocks, g, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ph (2 Cr or 4 Cr, n) bf16 (split: 4 Cr), x (n, 3), mass (n,), partial
// (nblocks, zrows, 2C) scratch, out (C, zrows, 2); f32 but ph, contiguous,
// on the current device; vec: n % 8 == 0 and ph 16-byte aligned (16-byte
// loads).  nmax 0..8 on each axis with 2C <= 256 threads, nzc >= 2, zrows =
// nzc + 2 ('spline') or nzc ('linear') at most 128; the shared memory must
// fit a block (ops/slab_kernels.stream_plan checks it).  Returns a
// cudaError_t.
int slab_phasestream_launch(const void* ph, const void* x, const void* mass, long long n,
                            void* partial, void* out, int nblocks, int split, int vec,
                            int nmaxx, int nmaxy, int nzc, int spline, float zmax, float dz,
                            void* stream) {
  if (nblocks < 1 || nmaxx < 0 || nmaxx > 8 || nmaxy < 0 || nmaxy > 8 || nzc < 2)
    return cudaErrorInvalidValue;
  Geo g;
  g.q = Params{nmaxx, nmaxy, nzc, spline ? nzc + 2 : nzc, zmax, dz};
  if (g.q.zrows > 128) return cudaErrorInvalidValue;
  g.C = (2 * nmaxx + 1) * (2 * nmaxy + 1);
  g.Cr = (g.C + 7) / 8 * 8;
  g.A = 2 * g.C;
  if ((g.A + 31) / 32 * 32 > kMaxThreads) return cudaErrorInvalidValue;
  g.split = split ? 1 : 0;
  g.nst = split ? 2 * g.A : g.A;
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<const uint16_t*>(ph);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto pf = static_cast<float*>(partial);
  auto of = static_cast<float*>(out);
  return spline ? launch<3>(pp, xf, mf, n, pf, of, nblocks, vec, g, s)
                : launch<2>(pp, xf, mf, n, pf, of, nblocks, vec, g, s);
}

const char* slab_phasestream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
