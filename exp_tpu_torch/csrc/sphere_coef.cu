// Sphere coefficient pass (K1) for Hopper, CUDA-core FP32 and integer
// shared-memory atomics.
//
// Replaces: exp_tpu/ops/pallas_sphere.py make_coef_kernel_poly (the TPU
// kernel at its pallas_call, :521), as selected by SphereSL's default
// pallas_harmonics='auto' at lmax <= 6 and by 'poly' at lmax 0..10, for
// both pallas_interp='spline' and 'hat'.
//
// Computes, for particles x (N, 3), mass (N,):
//   w_i   = mass_i if rmin <= r_i/scale <= rmax else 0
//   Y_pi  = sum_k M[p, k] mono_k(x_i / r_i)          (packed real-Ylm rows)
//   S[p, j] = sum_i w_i Y_pi W_j(t_i)                 (3 or 2 nonzero j per i)
//   coef[cs, l, m, n] = -4 pi sum_j S[p(cs,l,m), j] tab[j, l*nmax + n]
// with W the quadratic B-spline b2(j - 1 - t) against the nc + 2 ghosted
// spline rows, or the hat max(0, 1 - |j - t|) against nc node rows.
//
// What bounds it on an H100: not memory (16 bytes a particle, 17 MB at
// N = 2^20, about 5 us at 3.35 TB/s) nor FP32 arithmetic (6 us at 67
// TFLOP/s), but the P x 3 scattered adds a particle makes into the (P,
// rows) sums in shared memory, and, on a multistep bucket of a few hundred
// rows, the fixed cost of a launch.  The first port gave each warp a
// private f32 copy of the sums (7 warps an SM at lmax 4), so its
// load-add-store chains ran with little to hide their latency; it read M
// from shared memory once per multiply-add; and every launch zeroed and
// folded 132 blocks' copies and summed 132 partials a thread in a
// dependent chain.
//
// Design.  One thread per particle computes the geometry and the angular
// rows; M reaches the kernel as a parameter (the constant bank: a
// multiply-add reads its operand there), and only the entries that can be
// nonzero are multiplied, chosen at compile time: degree <= l and the
// parities of the row under x -> -x, y -> -y, z -> -z (94 of the dense
// 25 x 35 at lmax 4; ops/sphere_kernels.k1_support, which the wrapper
// checks M against).  A warp stages its 32 particles' rows and weights in
// shared memory; then, particle by particle, lane p rounds row p's terms
// y W_k to a fixed point and adds them with integer atomics (native on
// this card: an FP32 shared atomic is a compare-and-swap loop) into one
// (P, rows) i32 accumulator a block, so blocks of 16 warps run two an SM.
// The scale of row p is 2^e with W bound_p 2^e <= 2^30, W the block's sum
// of |mass| and bound_p >= |Y_p| (ops/sphere_kernels.k1_row_bounds), so no
// sum can overflow; integer sums are exact, so the order of the adds
// changes no bit.  Warp tiles of 32 rows go to (block, warp) by the row
// index alone, tile t to block (t / nw) mod the plan's largest grid, and
// the grid is only as large as the rows need
// (ops/sphere_kernels.k1_plan).  One block converts its sums to f32 and
// writes the coefficients itself; several write f32 partials (nblocks, P,
// rows), and a second kernel sums them as kTree interleaved chains of
// blocks in block order and contracts the result with the table.  Both
// paths contract alike, so the pass is deterministic, and rows of zero
// mass after the live ones change no bit of it: they add nothing, change
// no block's sum of |mass|, move no live tile, and the blocks they add
// contribute exact zeros to the chains.
//
// The split form, for lmax 7..10 and for a table whose (P, rows)
// accumulator does not fit a block (a 'hat' table of more than about 1,150
// nodes at lmax 6; 512 nodes at lmax 10).  Above lmax 6 the one form does
// not hold: M (54 KB dense at lmax 8) passes the 32,764 bytes of launch
// parameters, the accumulator and the stage of 32 x P rows a warp pass a
// block's shared memory, and a thread's mono[286] and Y[121] pass its 255
// registers.  So, as K3 (sphere_coef_rec.cu) does with the same sums
// (sphere_coef_sums.cuh): the packed rows split into groups over the grid's
// second dimension, as few as let the group's (R, rows) accumulator and a
// warp's stage fit (ops/sphere_kernels.k1_plan: 1 group at lmax 10
// 'spline', 2 on 512 'hat' nodes); a block reads every particle and makes
// only its group's rows, each staged as it is made and added by chunks of
// 32 rows, lane k chunk row k.  M reaches the kernel as its k1_support
// entries alone (2,513 at lmax 10, 10 KB of parameters, in the order of
// csrc/sphere_poly_support.cuh's CoefSupport), and the rows come from the
// monomials' even form (sphere_common.cuh EvenMonomials: 56 products of
// x^2, y^2, z^2 and 8 parity factors at lmax 10, where every row is one
// factor times a sum over them), so a thread's registers hold no row and
// no full monomial list.  The even form is made anew for each chunk of 32
// rows from the lane's unit vector and mass, kept in shared memory (a
// float4 a lane), so it holds no register through the chunk's adds.  The
// scales, the grid's rule and the finish are K3's, so the split form is
// deterministic too.
#include <cstring>
#include <utility>

#include "sphere_coef_sums.cuh"
#include "sphere_poly_support.cuh"

namespace {

using sphere::block_mass;
using sphere::kBatch;
using sphere::kChains;
using sphere::kFinishThreads;
using sphere::kTree;
using sphere::mono_deg;
using sphere::nmono;
using sphere::Params;
using sphere::pow2;
using sphere::scale_exponent;
using sphere::zero_slots;

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;


template <int L>
struct Layout {
  static constexpr int P = sphere::npacked(L);
  static constexpr int NM = nmono(L);
  static constexpr int PS = P | 1;        // staged-row stride (odd)
};

// M (P, n_mono) by value, a kernel parameter read from the constant bank,
// and bound[p] = sum_k |M[p, k]| >= |Y_p| on the unit sphere
template <int L>
struct MDense {
  float v[Layout<L>::P * Layout<L>::NM];
  float bound[Layout<L>::P];
};

// Entry (p, k) of M can be nonzero: monomial degree <= l and the monomial's
// exponents (i, j, kz) of the row's parities, i = m + cs, j = cs,
// kz = l + m (mod 2); ops/sphere_kernels.k1_support is the same rule.
template <int L>
__host__ __device__ constexpr bool in_support(int p, int k) {
  const int l = sphere::row_l(p, L), m = sphere::row_m(p, L), cs = sphere::row_cs(p, L);
  const int d = mono_deg(k), i = sphere::mono_i(k), j = sphere::mono_j(k);
  return d <= l && ((i - m - cs) & 1) == 0 && ((j - cs) & 1) == 0 &&
         ((d - i - j - l - m) & 1) == 0;
}

template <int L, int Pr, int K>
__device__ __forceinline__ void mac(float& s, const MDense<L>& M, const float* mono) {
  if constexpr (in_support<L>(Pr, K)) s += M.v[Pr * Layout<L>::NM + K] * mono[K];
}

template <int L, int Pr, int... K>
__device__ __forceinline__ float yrow(const MDense<L>& M, const float* mono,
                                      std::integer_sequence<int, K...>) {
  float s = 0.0f;
  (mac<L, Pr, K>(s, M, mono), ...);
  return s;
}

template <int L, int... Pr>
__device__ __forceinline__ void yrows(float* Y, const MDense<L>& M, const float* mono,
                                      float wm, std::integer_sequence<int, Pr...>) {
  constexpr int NM = Layout<L>::NM;
  ((Y[Pr] = yrow<L, Pr>(M, mono, std::make_integer_sequence<int, NM>{}) * wm), ...);
}

// coef[slot(p), k] = -4 pi sum_j S[p, j] tab[j, l*nmax + k] for the packed
// rows p in [p0, p1), S row p at S + (p - p0) * stride, tab's rows at
// stride ts: one thread an output, its sum over j as kChains interleaved
// chains (j mod kChains, each in order) added in order.  Every path
// contracts this way, so they agree bit for bit.
__device__ __forceinline__ void contract_rows(const float* S, int stride, int p0, int p1,
                                              const float* tab, int ts, const Params& q,
                                              float* coef) {
  const int L = q.lmax, nmax = q.nmax, rows = sphere::table_rows(q);
  const float m4pi = (float)(-4.0 * 3.14159265358979323846);
  for (int o = threadIdx.x; o < (p1 - p0) * nmax; o += blockDim.x) {
    const int p = p0 + o / nmax, k = o % nmax;
    const int l = sphere::row_l(p, L), m = sphere::row_m(p, L), cs = sphere::row_cs(p, L);
    const float* Sp = S + (long long)(p - p0) * stride;
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

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
coef_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                long long n, const __grid_constant__ MDense<L> M, Params q,
                const float* __restrict__ tab, float* __restrict__ partial,
                float* __restrict__ coef) {
  constexpr int P = Layout<L>::P, NM = Layout<L>::NM, PS = Layout<L>::PS;
  const int rows = sphere::table_rows(q);
  const int RS = rows | 1;
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nk = q.hat ? 2 : 3;

  extern __shared__ float4 sh4[];
  float4* wst = sh4 + warp * kWarp;                 // 32 x (3 weights, node)
  float* ysh = reinterpret_cast<float*>(sh4 + nw * kWarp) + warp * kWarp * PS;
  int* acc = reinterpret_cast<int*>(sh4 + nw * kWarp) + nw * kWarp * PS;  // (P, RS)
  float* wsum = reinterpret_cast<float*>(acc + P * RS);                   // nw

  for (int e = threadIdx.x; e < P * RS; e += blockDim.x) acc[e] = 0;
  // tile t of 32 rows runs on block (t / nw) mod gridDim, warp t mod nw
  const long long ntiles = (n + kWarp - 1) / kWarp;
  const long long step = (long long)gridDim.x * nw;
  long long tile = (long long)blockIdx.x * nw + warp;
  const float W = block_mass(mass, n, tile, step, nw, wsum);
  // lane p's rows p, p + 32: their scales 2^e, exact in f32
  float sc[(P + kWarp - 1) / kWarp];
#pragma unroll
  for (int h = 0; h * kWarp < P; ++h) {
    const int p = h * kWarp + lane;
    sc[h] = pow2(p < P ? scale_exponent(W * M.bound[p]) : 0);
  }

  // a tile's positions and masses are loaded while the previous one is added
  float px = 0.0f, py = 0.0f, pz = 0.0f, pm = 0.0f;
  if (tile * kWarp + lane < n) {
    const long long i = tile * kWarp + lane;
    px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2], pm = mass[i];
  }
  for (; tile < ntiles; tile += step) {
    float wt[3] = {0.0f, 0.0f, 0.0f};
    int c = 0;                                      // first node + 1; 0: adds nothing
    if (tile * kWarp + lane < n) {
      const float r = sphere::radius(px, py, pz);
      const float rs = r / q.scale;
      const float wm = (rs >= q.rmin && rs <= q.rmax) ? pm : 0.0f;
      if (wm != 0.0f) {
        const float rinv = 1.0f / r;
        float mono[NM], Y[P];
        sphere::monomials<L>(mono, px * rinv, py * rinv, pz * rinv);
        yrows<L>(Y, M, mono, wm, std::make_integer_sequence<int, P>{});
        c = sphere::radial_weights(sphere::ximap(rs, q), q, wt) + 1;
#pragma unroll
        for (int p = 0; p < P; ++p) ysh[lane * PS + p] = Y[p];
      }
    }
    wst[lane] = make_float4(wt[0], wt[1], wt[2], __int_as_float(c));
    __syncwarp();
    const long long nxt = (tile + step) * kWarp + lane;
    if (nxt < n) px = x[3 * nxt], py = x[3 * nxt + 1], pz = x[3 * nxt + 2], pm = mass[nxt];
    // particle by particle, lane p adds row p's terms y W_k, each rounded
    // to the block's fixed point, with integer atomics: exact sums, so the
    // order of the adds, within the warp or across warps, changes no bit
    for (int s0 = 0; s0 < kWarp; s0 += kBatch) {
      float4 w[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) w[k] = wst[s0 + k];
#pragma unroll
      for (int h = 0; h * kWarp < P; ++h) {
        const int p = h * kWarp + lane;
        if (p >= P) continue;
        float y[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) y[k] = ysh[(s0 + k) * PS + p];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int cc = __float_as_int(w[k].w);
          if (cc == 0) continue;                    // masked or past the end
          int* row = acc + p * RS + cc - 1;
          atomicAdd(row, __float2int_rn(__fmul_rn(__fmul_rn(y[k], w[k].x), sc[h])));
          atomicAdd(row + 1, __float2int_rn(__fmul_rn(__fmul_rn(y[k], w[k].y), sc[h])));
          if (nk == 3)
            atomicAdd(row + 2, __float2int_rn(__fmul_rn(__fmul_rn(y[k], w[k].z), sc[h])));
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // S = the block's sums back in f32 (exact scaling of the rounded
  // integers): in place for one block (the coefficients follow), else into
  // the block's partial
  const bool one = gridDim.x == 1;
  float* S = reinterpret_cast<float*>(acc);
  float* out = one ? S : partial + (long long)blockIdx.x * P * rows;
  const int ostride = one ? RS : rows;
  for (int p = warp; p < P; p += nw) {
    const float inv = pow2(-scale_exponent(W * M.bound[p]));
    for (int j = lane; j < rows; j += kWarp)
      out[p * ostride + j] = __fmul_rn((float)acc[p * RS + j], inv);
  }
  if (!one) return;                                 // coef_reduce_slots follows

  // one block: the table into the freed stages when it fits
  const int F = (L + 1) * q.nmax;
  const float* tsrc = tab;
  __syncthreads();
  if (rows * F <= nw * kWarp * (PS + 4)) {
    float* tsh = reinterpret_cast<float*>(sh4);
    const int n4 = rows * F / 4;                   // tab is 16-byte aligned
    const float4* t4 = reinterpret_cast<const float4*>(tab);
#pragma unroll 4
    for (int e = threadIdx.x; e < n4; e += blockDim.x) sh4[e] = __ldg(t4 + e);
    for (int e = n4 * 4 + threadIdx.x; e < rows * F; e += blockDim.x) tsh[e] = tab[e];
    tsrc = tsh;
    __syncthreads();
  }
  contract_rows(S, RS, 0, P, tsrc, F, q, coef);
  zero_slots(q, coef);
}

// The second pass over several blocks: block p sums packed row p of the
// partials (nblocks, P, rows) as kTree interleaved chains of blocks in
// block order (chain h on blocks h, h + kTree, ...), added in order, so
// blocks of zeros after the live ones leave it unchanged; then contracts
// it with the table as contract_rows does; block 0 also writes the slots
// of no packed row.
template <int L>
__global__ void __launch_bounds__(kFinishThreads)
coef_reduce_slots(const float* __restrict__ partial, int nblocks,
                  const float* __restrict__ tab, Params q, float* __restrict__ coef) {
  constexpr int P = Layout<L>::P;
  const int rows = sphere::table_rows(q), nmax = q.nmax, F = (L + 1) * nmax;
  const int p = blockIdx.x;
  const int l = sphere::row_l(p, L), m = sphere::row_m(p, L), cs = sphere::row_cs(p, L);
  const int span = blockDim.x / kTree;
  extern __shared__ float S[];        // rows, kTree x span, (rows, nmax) table, chains
  float* T = S + rows;
  float* tl = T + blockDim.x;
  float* ch = tl + rows * nmax;
  for (int e = threadIdx.x; e < rows * nmax; e += blockDim.x)
    tl[e] = __ldg(tab + (e / nmax) * F + l * nmax + e % nmax);
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
    for (int j = c; j < rows; j += kChains) a = __fmaf_rn(S[j], tl[j * nmax + k], a);
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

template <int L>
size_t accumulate_smem(int nw, int rows) {
  constexpr int P = Layout<L>::P, PS = Layout<L>::PS;
  return sizeof(float) * ((size_t)nw * kWarp * (4 + PS) + (size_t)P * (rows | 1) + nw);
}

template <int L>
cudaError_t launch(const float* x, const float* mass, long long n, const float* Mh,
                   const float* tab, float* partial, int nblocks, int nw, float* coef,
                   const Params& q, cudaStream_t stream) {
  constexpr int P = Layout<L>::P;
  const int rows = sphere::table_rows(q);
  if (nw < 1 || nw * kWarp > kMaxThreads || nblocks < 1 ||
      (nblocks > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  MDense<L> M;
  std::memcpy(&M, Mh, sizeof(M));
  const size_t smem = accumulate_smem<L>(nw, rows);
  cudaError_t err = cudaFuncSetAttribute(coef_accumulate<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  coef_accumulate<L><<<nblocks, nw * kWarp, smem, stream>>>(x, mass, n, M, q, tab, partial,
                                                          coef);
  err = cudaGetLastError();
  if (err != cudaSuccess || nblocks == 1) return err;
  const size_t fsmem = sizeof(float) * ((size_t)rows * (1 + q.nmax) + kFinishThreads +
                                        kChains * q.nmax);
  err = cudaFuncSetAttribute(coef_reduce_slots<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fsmem);
  if (err != cudaSuccess) return err;
  coef_reduce_slots<L><<<P, kFinishThreads, fsmem, stream>>>(partial, nblocks, tab, q, coef);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The split form: lmax 0..10, any table a row of which fits a block.


// M's nonzeros (CoefSupport<L>, k1_support row-major), the row bounds and
// the groups' bounds: a kernel parameter, read from the constant bank
// (10.5 KB at lmax 10)
template <int L>
struct MSplit {
  float v[sphere::CoefSupport<L>::kNnz];
  float bound[Layout<L>::P];
  int qstart[Layout<L>::P + 1];
};

// packed row Pr of chunk c (rows 32 c .. 32 c + 31), staged at ys[Pr - c0]
// when it lies in the block's group [qg0, qg1)
template <int L, int Pr>
__device__ __forceinline__ void stage_row(float* ys, int c0, int qg0, int qg1,
                                          const MSplit<L>& M,
                                          const sphere::EvenMonomials<L>& ev, float wm) {
  if (Pr >= qg0 && Pr < qg1)
    ys[Pr - c0] = sphere::even_pattern_row<sphere::CoefSupport<L>, L, Pr>(M.v, ev) * wm;
}

template <int L, int C, int... r>
__device__ __forceinline__ void stage_chunk(float* ys, int c0, int qg0, int qg1,
                                            const MSplit<L>& M,
                                            const sphere::EvenMonomials<L>& ev, float wm,
                                            std::integer_sequence<int, r...>) {
  (stage_row<L, kWarp * C + r>(ys, c0, qg0, qg1, M, ev, wm), ...);
}

// Chunk C of 32 packed rows: its rows of the block's group [qg0, qg1) are
// made from the lane's unit vector and mass (uw), staged, and then added
// (sphere::add_chunk), lane k its chunk row k.  uw is read from shared
// memory for each chunk, so the monomials are made anew after the adds of
// the chunk before and hold no registers through them.
template <int L, int C>
__device__ __forceinline__ void add_rows_chunk(int* acc, int RS, float* ysh, int CS,
                                               const float4* wst, const int* rowe, int qg0,
                                               int qg1, bool three, int lane,
                                               const MSplit<L>& M, const float4* uw) {
  constexpr int P = Layout<L>::P, lo = kWarp * C;
  constexpr int cnt = P - lo < kWarp ? P - lo : kWarp;
  const int c0 = max(qg0, lo), c1 = min(qg1, lo + cnt);
  if (c0 >= c1) return;                             // the same in every lane
  const float4 u = uw[lane];
  const sphere::EvenMonomials<L> ev(u.x, u.y, u.z);
  stage_chunk<L, C>(ysh + lane * CS, c0, qg0, qg1, M, ev, u.w,
                    std::make_integer_sequence<int, cnt>{});
  sphere::add_chunk(acc, RS, ysh, CS, wst, rowe, c0 - qg0, c1 - c0, three, lane);
}

// the chunks in order
template <int L, int... C>
__device__ __forceinline__ void add_chunks(int* acc, int RS, float* ysh, int CS,
                                           const float4* wst, const int* rowe, int qg0,
                                           int qg1, bool three, int lane,
                                           const MSplit<L>& M, const float4* uw,
                                           std::integer_sequence<int, C...>) {
  (add_rows_chunk<L, C>(acc, RS, ysh, CS, wst, rowe, qg0, qg1, three, lane, M, uw), ...);
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
coef_split_accumulate(const float* __restrict__ x, const float* __restrict__ mass,
                      long long n, const __grid_constant__ MSplit<L> M, Params q,
                      const float* __restrict__ tab, float* __restrict__ partial,
                      float* __restrict__ coef) {
  constexpr int P = Layout<L>::P;
  const int rows = sphere::table_rows(q), RS = rows | 1;
  const int nw = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const bool three = !q.hat;
  const int qg0 = M.qstart[blockIdx.y], qg1 = M.qstart[blockIdx.y + 1], R = qg1 - qg0;
  const int CS = sphere::stage_stride(R);

  extern __shared__ float4 sh4[];
  float4* wst = sh4 + warp * kWarp;                 // 32 x (3 weights, node)
  float4* uw = sh4 + (nw + warp) * kWarp;           // 32 x (unit vector, mass)
  float* stage = reinterpret_cast<float*>(sh4 + 2 * nw * kWarp);  // nw x 32 x CS
  float* ysh = stage + warp * kWarp * CS;
  int* acc = reinterpret_cast<int*>(stage + nw * kWarp * CS);  // (R, RS)
  int* rowe = acc + R * RS;          // each group row's packed row and exponent

  for (int e = threadIdx.x; e < R * RS; e += blockDim.x) acc[e] = 0;
  // tile t of 32 particles runs on block (t / nw) mod gridDim.x, warp t mod nw
  const long long ntiles = (n + kWarp - 1) / kWarp;
  const long long step = (long long)gridDim.x * nw;
  long long tile = (long long)blockIdx.x * nw + warp;
  const float W = block_mass(mass, n, tile, step, nw, stage);
  if (warp == 0)
    for (int qq = lane; qq < R; qq += kWarp)
      rowe[qq] = (qg0 + qq) | ((scale_exponent(W * M.bound[qg0 + qq]) + 128) << 8);
  __syncthreads();

  // a tile's positions and masses are loaded while the previous one is added
  float px = 0.0f, py = 0.0f, pz = 0.0f, pm = 0.0f;
  if (tile * kWarp + lane < n) {
    const long long i = tile * kWarp + lane;
    px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2], pm = mass[i];
  }
  for (; tile < ntiles; tile += step) {
    float wt[3] = {0.0f, 0.0f, 0.0f};
    int c = 0;                                      // first node + 1; 0: adds nothing
    float wm = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
    if (tile * kWarp + lane < n) {
      const float r = sphere::radius(px, py, pz);
      const float rs = r / q.scale;
      wm = (rs >= q.rmin && rs <= q.rmax) ? pm : 0.0f;
      if (wm != 0.0f) {
        const float rinv = 1.0f / r;
        ux = px * rinv, uy = py * rinv, uz = pz * rinv;
        c = sphere::radial_weights(sphere::ximap(rs, q), q, wt) + 1;
      }
    }
    wst[lane] = make_float4(wt[0], wt[1], wt[2], __int_as_float(c));
    uw[lane] = make_float4(ux, uy, uz, wm);
    const long long nxt = (tile + step) * kWarp + lane;
    if (nxt < n) px = x[3 * nxt], py = x[3 * nxt + 1], pz = x[3 * nxt + 2], pm = mass[nxt];
    add_chunks<L>(acc, RS, ysh, CS, wst, rowe, qg0, qg1, three, lane, M, uw,
                  std::make_integer_sequence<int, (P + kWarp - 1) / kWarp>{});
  }
  __syncthreads();

  // the sums back in f32: in place for one block of one group, which
  // contracts them itself, else into the block's partial at the packed rows
  sphere::group_finish(acc, RS, rowe, R, gridDim.x == 1 && gridDim.y == 1,
                       reinterpret_cast<int*>(stage), tab, q, partial, coef);
}

template <int L>
cudaError_t launch_split(const float* x, const float* mass, long long n, const float* Mh,
                         const int* qs, int ngroups, const float* tab, float* partial,
                         int nblocks, int nw, int finish_threads, int finish_staged,
                         float* coef, const Params& q, cudaStream_t stream) {
  constexpr int P = Layout<L>::P, NNZ = sphere::CoefSupport<L>::kNnz;
  if (ngroups < 1 || ngroups > P || ((nblocks > 1 || ngroups > 1) && partial == nullptr) ||
      finish_threads < 4 * q.nmax || finish_threads > kFinishThreads ||
      finish_threads % (kTree * kWarp) || qs[0] != 0 || qs[ngroups] != P)
    return cudaErrorInvalidValue;
  MSplit<L> M;
  std::memcpy(M.v, Mh, sizeof(M.v));
  std::memcpy(M.bound, Mh + NNZ, sizeof(M.bound));
  int R = 0;
  for (int g = 0; g <= ngroups; ++g) {
    M.qstart[g] = qs[g];
    if (g > 0) {
      if (qs[g] <= qs[g - 1]) return cudaErrorInvalidValue;
      R = max(R, qs[g] - qs[g - 1]);
    }
  }
  const int rows = sphere::table_rows(q);
  // K3's layout and a (unit vector, mass) record a lane
  // (ops/sphere_kernels.k1_split_smem)
  const size_t smem = sphere::block_smem(nw, R, rows) + sizeof(float4) * nw * kWarp;
  cudaError_t err = cudaFuncSetAttribute(coef_split_accumulate<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nblocks, ngroups);
  coef_split_accumulate<L><<<grid, nw * kWarp, smem, stream>>>(x, mass, n, M, q, tab,
                                                                 partial, coef);
  if ((err = cudaGetLastError()) != cudaSuccess || (nblocks == 1 && ngroups == 1)) return err;
  const size_t fsmem = sphere::finish_smem(q, finish_threads, finish_staged);
  err = cudaFuncSetAttribute(sphere::coef_reduce_slots,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fsmem);
  if (err != cudaSuccess) return err;
  sphere::coef_reduce_slots<<<P, finish_threads, fsmem, stream>>>(partial, nblocks, tab, q,
                                                                  finish_staged, coef);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 3), mass (n,), tab (rows, (lmax+1)*nmax) radial table (rows = nc + 2
// spline-prefiltered, or nc node values with hat = 1), coef (2, lmax+1,
// lmax+1, nmax) output: f32, contiguous, on the current device.  The plan
// (ops/sphere_kernels.k1_plan): nblocks blocks of nw warps; partial
// (nblocks, P, rows) f32 scratch when nblocks > 1 or ngroups > 1 (else
// unused, may be null).  ngroups = 0: the one-accumulator form (lmax
// 0..6), M_host the packed-row monomial matrix with fac (P, n_mono)
// followed by its row bounds (P).  ngroups >= 1: the split form (lmax
// 0..10), M_host the k1_support entries of that matrix (row-major)
// followed by the row bounds, qstart_host the ngroups + 1 group bounds in
// the packed order (0 = qstart[0] < ... < qstart[ngroups] = P), and the
// second kernel's threads and whether it stages the table.  M_host and
// qstart_host are f32 and int in host memory, copied into the launch's
// parameters.  Returns a cudaError_t.
int sphere_coef_launch(const void* x, const void* mass, long long n,
                       const void* M_host, const void* qstart_host, int ngroups,
                       const void* tab, void* partial, int nblocks, int nw,
                       int finish_threads, int finish_staged, void* coef, int lmax,
                       int nmax, int nc, int cmap, float xmin, float dxc, float rmin,
                       float rmax, float rmap, float scale, int hat, void* stream) {
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, 0.0f, hat};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto Mf = static_cast<const float*>(M_host);
  auto qs = static_cast<const int*>(qstart_host);
  auto tf = static_cast<const float*>(tab);
  auto pf = static_cast<float*>(partial);
  auto cf = static_cast<float*>(coef);
  if (nw < 1 || nw * kWarp > kMaxThreads || nblocks < 1) return cudaErrorInvalidValue;
  if (ngroups == 0) {
    switch (lmax) {
#define K1_CASE(L) \
      case L: return launch<L>(xf, mf, n, Mf, tf, pf, nblocks, nw, cf, q, s);
      K1_CASE(0) K1_CASE(1) K1_CASE(2) K1_CASE(3) K1_CASE(4) K1_CASE(5) K1_CASE(6)
#undef K1_CASE
      default: return cudaErrorInvalidValue;
    }
  }
  switch (lmax) {
#define K1_SPLIT(L)                                                                        \
    case L:                                                                                \
      return launch_split<L>(xf, mf, n, Mf, qs, ngroups, tf, pf, nblocks, nw,             \
                             finish_threads, finish_staged, cf, q, s);
    K1_SPLIT(0) K1_SPLIT(1) K1_SPLIT(2) K1_SPLIT(3) K1_SPLIT(4) K1_SPLIT(5) K1_SPLIT(6)
    K1_SPLIT(7) K1_SPLIT(8) K1_SPLIT(9) K1_SPLIT(10)
#undef K1_SPLIT
    default: return cudaErrorInvalidValue;
  }
}


const char* sphere_coef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
