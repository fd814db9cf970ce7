// The fixed-point sums and the finish shared by the sphere coefficient
// passes that split their rows into groups: K3 (sphere_coef_rec.cu, rows
// from the recurrences) and K1's split form (sphere_coef.cu, rows from the
// polynomials).  A block adds rounded terms y W 2^e_p into i32 sums, 2^e_p
// the scale of packed row p; then S[p, j] (f32) is contracted with the
// radial table tab (rows, (L+1)*nmax) and scaled by -4 pi, by the block
// itself or, over several blocks, by coef_reduce_slots.  Every path adds in
// one order, so the pass is deterministic.
#pragma once

#include "sphere_common.cuh"

namespace sphere {
namespace {  // internal linkage in each kernel library, as before

constexpr int kSumWarp = 32;
constexpr int kChains = 4;        // interleaved chains of a contraction
constexpr int kTree = 4;          // interleaved chains of the block partials
constexpr int kBatch = 4;         // particles whose adds go out together
constexpr int kFinishThreads = 1024;

// The block's fixed-point scale: 2^e with W bound 2^e <= 2^30 (exponent
// clamped to the f32 range), W a bound of every sum the block adds into.
__device__ __forceinline__ int scale_exponent(float W) {
  if (!(W > 0.0f)) return 0;
  return max(-126, min(126, 30 - (ilogbf(fminf(W, 3.0e38f)) + 1)));
}

// 2^e for |e| <= 126, exactly
__device__ __forceinline__ float pow2(int e) { return __int_as_float((e + 127) << 23); }

// Sum over the block's rows of |mass| (rows past n count 0), in a fixed
// order: each lane its rows in tile order (tile t holds rows 32 t ..
// 32 t + 31; the warp's tiles first, first + step, ...), a shuffle tree
// over the lanes, the warps in order.  Rows of zero mass after the live
// ones add exact zeros, so the sum, and the block's scales, do not change
// with them.
__device__ __forceinline__ float block_mass(const float* __restrict__ mass, long long n,
                                            long long first, long long step, int nw,
                                            float* wsum) {
  const int warp = threadIdx.x / kSumWarp, lane = threadIdx.x % kSumWarp;
  float s = 0.0f;
  for (long long t = first; t * kSumWarp < n; t += step) {
    const long long i = t * kSumWarp + lane;
    if (i < n) s += fabsf(mass[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) wsum[warp] = s;
  __syncthreads();
  float W = 0.0f;
  for (int w = 0; w < nw; ++w) W += wsum[w];
  return W;
}

// coef[slot(p), k] = -4 pi sum_j S[p, j] tab[j, l*nmax + k] for every
// packed row p, S row p at S + qof[p] * stride, tab's rows at stride ts:
// one thread an output, its sum over j as kChains interleaved chains
// (j mod kChains, each in order) added in order, as coef_reduce_slots
// sums, so that one block and several agree bit for bit.
__device__ __forceinline__ void contract_rows(const float* S, int stride, const int* qof,
                                              const float* tab, int ts, const Params& q,
                                              float* coef) {
  const int L = q.lmax, nmax = q.nmax, rows = table_rows(q);
  const float m4pi = (float)(-4.0 * 3.14159265358979323846);
  for (int o = threadIdx.x; o < npacked(L) * nmax; o += blockDim.x) {
    const int p = o / nmax, k = o % nmax;
    const int l = row_l(p, L), m = row_m(p, L), cs = row_cs(p, L);
    const float* Sp = S + (long long)qof[p] * stride;
    const float* tk = tab + l * nmax + k;
    float c[kChains] = {0.0f, 0.0f, 0.0f, 0.0f};
    int j = 0;
    for (; j + kChains <= rows; j += kChains) {
#pragma unroll
      for (int h = 0; h < kChains; ++h)
        c[h] = __fmaf_rn(Sp[j + h], tk[(j + h) * ts], c[h]);
    }
#pragma unroll
    for (int h = 0; h < kChains - 1; ++h)            // the last rows % kChains
      if (j + h < rows) c[h] = __fmaf_rn(Sp[j + h], tk[(j + h) * ts], c[h]);
    const float s = ((c[0] + c[1]) + c[2]) + c[3];
    coef[(long long)((cs * (L + 1) + l) * (L + 1) + m) * nmax + k] = m4pi * s;
  }
}

// zeros into the slots of no packed row (m > l, or sin with m = 0)
__device__ __forceinline__ void zero_slots(const Params& q, float* coef) {
  const int L = q.lmax, nmax = q.nmax;
  for (int e = threadIdx.x; e < 2 * (L + 1) * (L + 1) * nmax; e += blockDim.x) {
    const int slot = e / nmax, m = slot % (L + 1), l = (slot / (L + 1)) % (L + 1);
    const int cs = slot / ((L + 1) * (L + 1));
    if (m > l || (cs == 1 && m == 0)) coef[e] = 0.0f;
  }
}

// The second pass over several blocks: block p sums packed row p of the
// partials (nblocks, P, rows) as kTree interleaved chains of blocks in
// block order (chain h on blocks h, h + kTree, ...), added in order, so
// blocks of zeros after the live ones leave it unchanged; then contracts
// it with the table as contract_rows does, from the table's (rows, nmax)
// slice staged in shared memory or, where that does not fit (staged = 0),
// from device memory; block 0 also writes the slots of no packed row.
// Any block size from 4 nmax up gives the same bits.  Shared memory:
// finish_smem(q, blockDim.x, staged).
__global__ void __launch_bounds__(kFinishThreads)
coef_reduce_slots(const float* __restrict__ partial, int nblocks,
                  const float* __restrict__ tab, Params q, int staged,
                  float* __restrict__ coef) {
  const int L = q.lmax, P = npacked(L);
  const int rows = table_rows(q), nmax = q.nmax, F = (L + 1) * nmax;
  const int p = blockIdx.x;
  const int l = row_l(p, L), m = row_m(p, L), cs = row_cs(p, L);
  const int span = blockDim.x / kTree;
  extern __shared__ float S[];        // rows, kTree x span, chains, (rows, nmax) table
  float* T = S + rows;
  float* ch = T + blockDim.x;
  float* tl = ch + kChains * nmax;
  const float* ts = tab + l * nmax;   // the table slice, row stride tstride
  int tstride = F;
  if (staged) {
    for (int e = threadIdx.x; e < rows * nmax; e += blockDim.x)
      tl[e] = __ldg(tab + (e / nmax) * F + l * nmax + e % nmax);
    ts = tl;
    tstride = nmax;
  }
  const long long stride = (long long)P * rows;
  const int h = threadIdx.x / span, jj = threadIdx.x % span;
  for (int j0 = 0; j0 < rows; j0 += span) {
    const int j = j0 + jj;
    float t = 0.0f;
    if (j < rows) {
      const float* src = partial + (long long)p * rows + j;
      for (int b = h; b < nblocks; b += kTree) t += __ldcg(src + b * stride);
    }
    T[h * span + jj] = t;
    __syncthreads();
    if (h == 0 && j < rows) {
      float s = T[jj];
#pragma unroll
      for (int hh = 1; hh < kTree; ++hh) s += T[hh * span + jj];
      S[j] = s;
    }
    __syncthreads();
  }
  // contract_rows' sum, its kChains chains on kChains threads an output
  if (threadIdx.x < kChains * nmax) {
    const int k = threadIdx.x / kChains, c = threadIdx.x % kChains;
    float a = 0.0f;
    for (int j = c; j < rows; j += kChains) a = __fmaf_rn(S[j], ts[j * tstride + k], a);
    ch[threadIdx.x] = a;
  }
  __syncthreads();
  if (threadIdx.x < nmax) {
    const float* a = ch + threadIdx.x * kChains;
    const float s = ((a[0] + a[1]) + a[2]) + a[3];
    coef[(long long)((cs * (L + 1) + l) * (L + 1) + m) * nmax + threadIdx.x] =
        (float)(-4.0 * 3.14159265358979323846) * s;
  }
  if (p == 0) zero_slots(q, coef);
}

// coef_reduce_slots' shared memory with `threads` threads
inline size_t finish_smem(const Params& q, int threads, int staged) {
  return sizeof(float) * ((size_t)table_rows(q) * (1 + (staged ? q.nmax : 0)) + threads +
                          kChains * q.nmax);
}

// A chunk's staged rows: 32 (a lane each), fewer in a smaller group; the
// stride of a particle's staged rows is odd
__host__ __device__ constexpr int stage_stride(int R) {
  return (R < kSumWarp ? R : kSumWarp) | 1;
}

// shared bytes of a block of nw warps whose group has R rows: each warp's
// 32 weight records and stage of 32 particles, the group's (R, rows | 1)
// i32 sums and a packed row and scale exponent a group row
inline size_t block_smem(int nw, int R, int rows) {
  return sizeof(float4) * nw * kSumWarp +
         sizeof(float) * (size_t)nw * kSumWarp * stage_stride(R) +
         sizeof(int) * ((size_t)R * (rows | 1) + R);
}

// A group row's packed row (bits 0-7) and scale exponent + 128 (bits 8-15)
__device__ __forceinline__ int row_of(int e) { return e & 0xff; }
__device__ __forceinline__ int exp_of(int e) { return (e >> 8) - 128; }

// Lane k adds chunk row k (the group's row qc + k) of the warp's 32 staged
// particles: their terms y W_j, rounded to the row's fixed point, into the
// block's sums by integer atomics.
__device__ __forceinline__ void add_chunk(int* acc, int RS, const float* ysh, int CS,
                                          const float4* wst, const int* rowe, int qc,
                                          int cnt, bool three, int lane) {
  __syncwarp();
  if (lane < cnt) {
    const int qq = qc + lane;
    int* arow = acc + qq * RS - 1;
    const float sc = pow2(exp_of(rowe[qq]));
    for (int s0 = 0; s0 < kSumWarp; s0 += kBatch) {
      float4 w[kBatch];
      float y[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) w[k] = wst[s0 + k];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) y[k] = ysh[(s0 + k) * CS + lane];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int cc = __float_as_int(w[k].w);
        if (cc == 0) continue;                       // masked or past the end
        int* row = arow + cc;
        atomicAdd(row, __float2int_rn(__fmul_rn(__fmul_rn(y[k], w[k].x), sc)));
        atomicAdd(row + 1, __float2int_rn(__fmul_rn(__fmul_rn(y[k], w[k].y), sc)));
        if (three)
          atomicAdd(row + 2, __float2int_rn(__fmul_rn(__fmul_rn(y[k], w[k].z), sc)));
      }
    }
  }
  __syncwarp();
}

// The end of a group's accumulation: the sums back in f32 (exact scaling
// of the rounded integers).  With one block of one group, in place, and
// the block contracts them itself (`qof` R ints of scratch); else into the
// block's partial (nblocks, P, rows) at the packed rows, which
// coef_reduce_slots sums.
__device__ __forceinline__ void group_finish(int* acc, int RS, const int* rowe, int R,
                                             bool one, int* qof, const float* tab,
                                             const Params& q, float* partial, float* coef) {
  const int L = q.lmax, P = npacked(L), rows = table_rows(q);
  const int nw = blockDim.x / kSumWarp;
  const int warp = threadIdx.x / kSumWarp, lane = threadIdx.x % kSumWarp;
  if (one) {
    float* S = reinterpret_cast<float*>(acc);
    for (int qq = threadIdx.x; qq < R; qq += blockDim.x) qof[row_of(rowe[qq])] = qq;
    for (int qq = warp; qq < R; qq += nw) {
      const float inv = pow2(-exp_of(rowe[qq]));
      for (int j = lane; j < rows; j += kSumWarp)
        S[qq * RS + j] = __fmul_rn((float)acc[qq * RS + j], inv);
    }
    __syncthreads();
    contract_rows(S, RS, qof, tab, (L + 1) * q.nmax, q, coef);
    zero_slots(q, coef);
    return;
  }
  float* out = partial + (long long)blockIdx.x * P * rows;
  for (int qq = warp; qq < R; qq += nw) {
    const float inv = pow2(-exp_of(rowe[qq]));
    float* o = out + (long long)row_of(rowe[qq]) * rows;
    for (int j = lane; j < rows; j += kSumWarp)
      o[j] = __fmul_rn((float)acc[qq * RS + j], inv);
  }
}

}  // namespace
}  // namespace sphere
