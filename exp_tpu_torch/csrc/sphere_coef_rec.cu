// Sphere coefficient pass from the Legendre and trig recurrences (K3) for
// Hopper, CUDA-core FP32 and integer shared-memory atomics.
//
// Replaces: exp_tpu/ops/pallas_sphere.py make_coef_kernel (the TPU kernel at
// its pallas_call, :249), as selected by SphereSL's pallas_harmonics=
// 'recurrence', and by 'auto' above lmax 6, for pallas_interp='spline' and
// 'hat'.
//
// Computes K1's function with the angular rows from the recurrences: for
// particles x (N, 3), mass (N,),
//   w_i   = mass_i if rmin <= r_i/scale <= rmax else 0
//   Y_pi  = w_i fac[l,m] P_lm(cos th_i) {cos, sin}(m phi_i)   (packed rows)
//   S[p, j] = sum_i Y_pi W_j(t_i)              (W: 3 spline or 2 hat weights)
//   coef[cs, l, m, n] = -4 pi sum_j S[p(cs,l,m), j] tab[j, l*nmax + n]
// with P_lm from _legendre_rows (unclamped cos th) and cos/sin(m phi) by
// angle addition from x/R, y/R (_trig_rows).
//
// What bounds it on an H100: not memory (16 bytes a particle) nor FP32
// arithmetic (about 6 operations for each of the (L+1)(L+2)/2 Legendre
// values, 2 for each of the P = (L+1)^2 rows), but the P x 3 scattered
// adds a particle makes into the (P, rows) sums in shared memory.  The
// first port kept a private f32 (32, rows) copy of the sums for each warp
// (6 warps an SM at lmax 10), added into it with dependent
// load-add-store chains, split lmax 10's 121 rows into 4 groups of blocks
// that each ran every recurrence, and divided in the recurrence's inner
// loop; its second kernel summed 132 partials a thread in one chain.
//
// Design: K1's scheme (sphere_coef.cu), fed by the recurrences.  A thread
// makes its particle's rows with m outer and l inner, keeping O(1) values
// in registers, in the order cos(l, 0) for l = 0..L, then (cos, sin)(l, m)
// for l = m..L at each m >= 1, and stages them in chunks of up to 32 rows;
// after each chunk, particle by particle, lane k rounds chunk row k's
// terms y W_j to a fixed point and adds them with integer atomics into one
// i32 (rows, table rows) accumulator a block.  Row p's scale is 2^e with
// W bound_p 2^e <= 2^30, W the block's sum of |mass| and bound_p =
// |fac[l,m]| sqrt((l+m)!/(l-m)!), over sqrt 2 for m > 0 (the addition
// theorem), with 1% to spare (ops/sphere_kernels.k3_row_bounds): no sum can
// overflow, integer sums are exact, so the order of the adds changes no
// bit.  The recurrence's 1/(l - m), fac and the bounds are kernel
// parameters (the constant bank).  The rows split into groups (ranges of
// that order) only where the accumulator and one warp's stage do not fit
// a block ('hat' at lmax 10 on 512 nodes: 2 groups); a group's blocks run
// the m chain up to their last row and the l recurrences of the columns
// they hold.  Warp tiles of 32 particles go to blocks by the particle index
// alone (ops/sphere_kernels.k3_plan), the grid as large as the rows need;
// one block writes the coefficients itself, several write f32 partials
// (nblocks, P, rows) that coef_reduce_slots sums in block order:
// deterministic, and zero-mass rows after the live ones change no bit.
//
// Measured (exp_tpu_torch/bench_kernels.py, 2^20 rows, NVIDIA H100 80GB
// HBM3 at 700 W, the first port in the same call): lmax 4 'spline' 0.092
// ms (0.240), 'hat' 0.090 (0.363), lmax 10 0.33 (2.02); 224 rows 0.015
// (0.043).  The atomic adds are about a third of the time at lmax 4 and
// 40% at lmax 10 (exp_tpu_torch/probe_rec_split.py `no_adds`).
#include <cstring>

#include "sphere_common.cuh"

namespace {

using sphere::Params;

constexpr int kWarp = 32;
constexpr int kMaxL = 10;                        // ops/sphere_kernels.REC_LMAX
constexpr int kMaxP = sphere::npacked(kMaxL);
constexpr int kBatch = 4;                        // particles whose adds go out together
constexpr int kMaxThreads = 512;                 // ops/sphere_kernels.K3_WARPS

// The fixed point and the finish, as K1's (sphere_coef.cu), there with L a
// template argument.  A block adds rounded terms y W 2^e_p into i32 sums,
// 2^e_p the scale of packed row p; then S[p, j] (f32) is contracted with
// the radial table tab (rows, (L+1)*nmax) and scaled by -4 pi, by the block
// itself or, over several blocks, by coef_reduce_slots.  Every path adds
// in one order, so the pass is deterministic.

constexpr int kChains = 4;        // interleaved chains of a contraction
constexpr int kTree = 4;          // interleaved chains of the block partials
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
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float s = 0.0f;
  for (long long t = first; t * kWarp < n; t += step) {
    const long long i = t * kWarp + lane;
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
  const int L = q.lmax, nmax = q.nmax, rows = sphere::table_rows(q);
  const float m4pi = (float)(-4.0 * 3.14159265358979323846);
  for (int o = threadIdx.x; o < sphere::npacked(L) * nmax; o += blockDim.x) {
    const int p = o / nmax, k = o % nmax;
    const int l = sphere::row_l(p, L), m = sphere::row_m(p, L), cs = sphere::row_cs(p, L);
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
  const int L = q.lmax, P = sphere::npacked(L);
  const int rows = sphere::table_rows(q), nmax = q.nmax, F = (L + 1) * nmax;
  const int p = blockIdx.x;
  const int l = sphere::row_l(p, L), m = sphere::row_m(p, L), cs = sphere::row_cs(p, L);
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

// The recurrence's reciprocals, fac, the row bounds and the groups: a
// kernel parameter, read from the constant bank
struct RecConst {
  float fac[kMaxP];          // fac[l (L+1) + m]
  float bound[kMaxP];        // bound_p >= |Y_p| / w on the sphere, packed row p
  float rk[kMaxL + 1];       // 1 / d, d = l - m >= 1
  int qstart[kMaxP + 1];     // group g: the rows [qstart[g], qstart[g + 1]) of the order
};

// The rows before m column m in the order the rows are made: L + 1 cos
// rows at m = 0, 2 (L + 1 - m) (cos, sin) rows at m >= 1
__host__ __device__ constexpr int col_start(int m, int L) {
  return m == 0 ? 0 : (L + 1) + (m - 1) * (2 * L + 2 - m);
}

// A chunk's staged rows: 32 (a lane each), fewer in a smaller group; the
// stride of a particle's staged rows is odd
__host__ __device__ constexpr int stage_stride(int R) { return (R < kWarp ? R : kWarp) | 1; }

// shared bytes of a block of nw warps whose group has R rows: each warp's
// 32 weight records and stage of 32 particles, the group's (R, rows | 1)
// i32 sums and a packed row and scale exponent a group row
size_t block_smem(int nw, int R, int rows) {
  return sizeof(float4) * nw * kWarp + sizeof(float) * (size_t)nw * kWarp * stage_stride(R) +
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
    for (int s0 = 0; s0 < kWarp; s0 += kBatch) {
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

// ONE: the group is all the rows (no row needs a check)
template <bool ONE>
__global__ void __launch_bounds__(kMaxThreads)
coef_rec_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                    long long n, const __grid_constant__ RecConst K, Params q,
                    const float* __restrict__ tab, float* __restrict__ partial,
                    float* __restrict__ coef) {
  const int L = q.lmax, P = sphere::npacked(L);
  const int rows = sphere::table_rows(q), RS = rows | 1;
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const bool three = !q.hat;
  const int qg0 = K.qstart[blockIdx.y], qg1 = K.qstart[blockIdx.y + 1], R = qg1 - qg0;
  const int CS = stage_stride(R);

  extern __shared__ float4 sh4[];
  float4* wst = sh4 + warp * kWarp;                 // 32 x (3 weights, node)
  float* stage = reinterpret_cast<float*>(sh4 + nw * kWarp);    // nw x 32 x CS
  float* ysh = stage + warp * kWarp * CS;
  int* acc = reinterpret_cast<int*>(stage + nw * kWarp * CS);  // (R, RS)
  int* rowe = acc + R * RS;          // each group row's packed row and exponent

  for (int e = threadIdx.x; e < R * RS; e += blockDim.x) acc[e] = 0;
  // tile t of 32 particles runs on block (t / nw) mod gridDim.x, warp t mod nw
  const long long ntiles = (n + kWarp - 1) / kWarp;
  const long long step = (long long)gridDim.x * nw;
  long long tile = (long long)blockIdx.x * nw + warp;
  const float W = block_mass(mass, n, tile, step, nw, stage);
  if (warp == 0) {                                  // lane m: column m's rows in the group
    for (int m = lane; m <= L; m += kWarp) {
      int qq = col_start(m, L);
      for (int l = m; l <= L; ++l) {
        for (int cs = 0; cs < (m > 0 ? 2 : 1); ++cs, ++qq) {
          if (qq < qg0 || qq >= qg1) continue;
          const int p = cs == 0 ? sphere::cos_row(l, m) : sphere::sin_row(l, m, L);
          rowe[qq - qg0] = p | ((scale_exponent(W * K.bound[p]) + 128) << 8);
        }
      }
    }
  }
  __syncthreads();

  // a tile's positions and masses are loaded while the previous one is added
  float px = 0.0f, py = 0.0f, pz = 0.0f, pm = 0.0f;
  if (tile * kWarp + lane < n) {
    const long long i = tile * kWarp + lane;
    px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2], pm = mass[i];
  }
  float* ys = ysh + lane * CS;
  for (; tile < ntiles; tile += step) {
    float wt[3] = {0.0f, 0.0f, 0.0f};
    int c = 0;                                      // first node + 1; 0: adds nothing
    float wm = 0.0f, xc = 0.0f, cphi = 1.0f, sphi = 0.0f;
    if (tile * kWarp + lane < n) {
      const float r = sphere::radius(px, py, pz);
      const float rs = r / q.scale;
      wm = (rs >= q.rmin && rs <= q.rmax) ? pm : 0.0f;
      if (wm != 0.0f) {
        const float Rc = sqrtf(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py))) + 1e-10f;
        xc = pz / r;
        cphi = px / Rc;
        sphi = py / Rc;
        c = sphere::radial_weights(sphere::ximap(rs, q), q, wt) + 1;
      }
    }
    wst[lane] = make_float4(wt[0], wt[1], wt[2], __int_as_float(c));
    const long long nxt = (tile + step) * kWarp + lane;
    if (nxt < n) px = x[3 * nxt], py = x[3 * nxt + 1], pz = x[3 * nxt + 2], pm = mass[nxt];

    // the rows, each product and sum rounded on its own as the plain
    // version rounds them; the group's rows are staged, a chunk of 32 added
    // as soon as it is full
    const float somx2 = sqrtf(fmaxf(__fmul_rn(__fsub_rn(1.0f, xc), __fadd_rn(1.0f, xc)), 0.0f));
    float cm = 1.0f, sm = 0.0f;                     // cos(m phi), sin(m phi)
    float pmm = 1.0f, fact = 1.0f;                  // P_mm
    int k = 0, qc = 0;                              // rows staged; the chunk's first
    auto put = [&](float v) {                       // stage a row; add a full chunk
      ys[k] = v;
      if (++k == kWarp) {
        add_chunk(acc, RS, ysh, CS, wst, rowe, qc, kWarp, three, lane);
        qc += kWarp, k = 0;
      }
    };
    for (int m = 0; m <= L && col_start(m, L) < qg1; ++m) {
      if (m > 0) {
        const float c2 = __fsub_rn(__fmul_rn(cm, cphi), __fmul_rn(sm, sphi));
        sm = __fadd_rn(__fmul_rn(sm, cphi), __fmul_rn(cm, sphi));
        cm = c2;
        pmm = __fmul_rn(__fmul_rn(pmm, -fact), somx2);
        fact += 2.0f;
      }
      if (col_start(m + 1, L) <= qg0) continue;
      // a column wholly in the group stages every row; one across its
      // bounds checks each
      const bool whole = ONE || (col_start(m, L) >= qg0 && col_start(m + 1, L) <= qg1);
      float pl1 = 0.0f, pl2 = 0.0f;                 // P_{l-1,m}, P_{l-2,m}
      int qq = col_start(m, L);
      for (int l = m; l <= L && (ONE || qq < qg1); ++l) {
        float plm;
        if (l == m) {
          plm = pmm;
        } else if (l == m + 1) {
          plm = __fmul_rn(__fmul_rn(xc, (float)(2 * m + 1)), pmm);
        } else {
          plm = __fmul_rn(__fsub_rn(__fmul_rn(__fmul_rn(xc, (float)(2 * l - 1)), pl1),
                                    __fmul_rn((float)(l + m - 1), pl2)),
                          K.rk[l - m]);
        }
        const float wp = __fmul_rn(__fmul_rn(wm, K.fac[l * (L + 1) + m]), plm);
        if (whole || (qq >= qg0 && qq < qg1)) put(__fmul_rn(wp, cm));
        ++qq;
        if (m > 0) {
          if (whole || (qq >= qg0 && qq < qg1)) put(__fmul_rn(wp, sm));
          ++qq;
        }
        pl2 = pl1;
        pl1 = plm;
      }
    }
    if (k > 0) add_chunk(acc, RS, ysh, CS, wst, rowe, qc, k, three, lane);
  }
  __syncthreads();

  // the sums back in f32 (exact scaling of the rounded integers): in place
  // for one block, which contracts them itself, else into the block's
  // partial at the packed rows
  if (ONE && gridDim.x == 1) {
    float* S = reinterpret_cast<float*>(acc);
    int* qof = reinterpret_cast<int*>(stage);       // each packed row's group row
    for (int qq = threadIdx.x; qq < R; qq += blockDim.x) qof[row_of(rowe[qq])] = qq;
    for (int qq = warp; qq < R; qq += nw) {
      const float inv = pow2(-exp_of(rowe[qq]));
      for (int j = lane; j < rows; j += kWarp)
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
    for (int j = lane; j < rows; j += kWarp)
      o[j] = __fmul_rn((float)acc[qq * RS + j], inv);
  }
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), tab (rows, (lmax+1)*nmax) radial table (rows = nc + 2
// spline-prefiltered, or nc node values with hat = 1), coef (2, lmax+1,
// lmax+1, nmax) output: f32, contiguous, on the current device.  consts_host:
// fac ((lmax+1)^2, row-major) followed by the row bounds (P, packed rows),
// f32 in host memory; qstart_host: the ngroups + 1 group boundaries in the
// order the rows are made (0 = qstart[0] < ... < qstart[ngroups] = P), int
// in host memory; both copied into the launch's parameters.  The plan
// (ops/sphere_kernels.k3_plan): a grid of nblocks x ngroups blocks of nw
// warps; partial (nblocks, P, rows) f32 scratch unless nblocks = ngroups =
// 1 (then unused, may be null); the second kernel's threads and whether it
// stages the table.  Returns a cudaError_t.
int sphere_coef_rec_launch(const void* x, const void* mass, long long n,
                           const void* consts_host, const void* qstart_host, int ngroups,
                           const void* tab, void* partial, int nblocks, int nw,
                           int finish_threads, int finish_staged, void* coef, int lmax,
                           int nmax, int nc, int cmap, float xmin, float dxc, float rmin,
                           float rmax, float rmap, float scale, int hat, void* stream) {
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, 0.0f, hat};
  auto s = static_cast<cudaStream_t>(stream);
  if (lmax < 0 || lmax > kMaxL || nw < 1 || nw * kWarp > kMaxThreads || nblocks < 1 ||
      finish_threads < 4 * nmax || finish_threads > kFinishThreads ||
      finish_threads % (kTree * kWarp))
    return cudaErrorInvalidValue;
  const int P = sphere::npacked(lmax), rows = sphere::table_rows(q);
  if (ngroups < 1 || ngroups > P || ((nblocks > 1 || ngroups > 1) && partial == nullptr))
    return cudaErrorInvalidValue;
  RecConst K;
  std::memset(&K, 0, sizeof(K));
  const float* ch = static_cast<const float*>(consts_host);
  std::memcpy(K.fac, ch, sizeof(float) * P);
  std::memcpy(K.bound, ch + P, sizeof(float) * P);
  for (int d = 1; d <= kMaxL; ++d) K.rk[d] = 1.0f / (float)d;
  const int* qs = static_cast<const int*>(qstart_host);
  int R = 0;
  for (int g = 0; g <= ngroups; ++g) {
    K.qstart[g] = qs[g];
    if (g > 0) {
      if (qs[g] <= qs[g - 1]) return cudaErrorInvalidValue;
      R = qs[g] - qs[g - 1] > R ? qs[g] - qs[g - 1] : R;
    }
  }
  if (qs[0] != 0 || qs[ngroups] != P) return cudaErrorInvalidValue;
  const size_t smem = block_smem(nw, R, rows);
  auto kernel = ngroups == 1 ? coef_rec_accumulate<true> : coef_rec_accumulate<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nblocks, ngroups);
  kernel<<<grid, nw * kWarp, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(mass), n, K, q,
      static_cast<const float*>(tab), static_cast<float*>(partial),
      static_cast<float*>(coef));
  if ((err = cudaGetLastError()) != cudaSuccess || (nblocks == 1 && ngroups == 1)) return err;
  const size_t fsmem = finish_smem(q, finish_threads, finish_staged);
  err = cudaFuncSetAttribute(coef_reduce_slots,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fsmem);
  if (err != cudaSuccess) return err;
  coef_reduce_slots<<<P, finish_threads, fsmem, s>>>(
      static_cast<const float*>(partial), nblocks, static_cast<const float*>(tab), q,
      finish_staged, static_cast<float*>(coef));
  return cudaGetLastError();
}

const char* sphere_coef_rec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
