// Sphere coefficient pass (K1) for Hopper, CUDA-core FP32 and integer
// shared-memory atomics.
//
// Replaces: exp_tpu/ops/pallas_sphere.py make_coef_kernel_poly (the TPU
// kernel at its pallas_call, :521), as selected by SphereSL's default
// pallas_harmonics='auto' at lmax <= 6 and by 'poly', for both
// pallas_interp='spline' and 'hat'.
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
#include <cstring>
#include <utility>

#include "sphere_common.cuh"

namespace {

using sphere::Params;
using sphere::mono_deg;
using sphere::nmono;

constexpr int kWarp = 32;
constexpr int kTree = 4;          // interleaved chains of the block partials
constexpr int kBatch = 4;         // particles whose adds go out together
constexpr int kMaxThreads = 512;
constexpr int kFinishThreads = 1024;


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
constexpr int kChains = 4;

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

// zeros into the slots of no packed row (m > l, or sin with m = 0)
__device__ __forceinline__ void zero_slots(const Params& q, float* coef) {
  const int L = q.lmax, nmax = q.nmax;
  for (int e = threadIdx.x; e < 2 * (L + 1) * (L + 1) * nmax; e += blockDim.x) {
    const int slot = e / nmax, m = slot % (L + 1), l = (slot / (L + 1)) % (L + 1);
    const int cs = slot / ((L + 1) * (L + 1));
    if (m > l || (cs == 1 && m == 0)) coef[e] = 0.0f;
  }
}

// The block's fixed-point scale: 2^e with W bound 2^e <= 2^30 (exponent
// clamped to the f32 range), W a bound of every sum the block adds into.
__device__ __forceinline__ int scale_exponent(float W) {
  if (!(W > 0.0f)) return 0;
  return max(-126, min(126, 30 - (ilogbf(fminf(W, 3.0e38f)) + 1)));
}

// 2^e for |e| <= 126, exactly
__device__ __forceinline__ float pow2(int e) { return __int_as_float((e + 127) << 23); }

// Sum over the block's rows of |mass| (rows past n count 0), in a fixed
// order: each lane its rows in tile order, a shuffle tree over the lanes,
// the warps in order.  Rows of zero mass after the live ones add exact
// zeros, so the sum, and the block's scales, do not change with them.
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

}  // namespace

extern "C" {

// x (n, 3), mass (n,), tab (rows, (lmax+1)*nmax) radial table (rows = nc + 2
// spline-prefiltered, or nc node values with hat = 1), coef (2, lmax+1,
// lmax+1, nmax) output: f32, contiguous, on the current device.  M_host
// the packed-row monomial matrix with fac (P, n_mono) followed by its row
// bounds sum_k |M[p, k]| (P), f32 in host memory (copied into the launch's
// parameters).  The plan (ops/sphere_kernels.
// k1_plan): nblocks blocks of nw warps; partial (nblocks, P, rows) f32
// scratch when nblocks > 1 (else unused, may be null).  Returns a
// cudaError_t.
int sphere_coef_launch(const void* x, const void* mass, long long n,
                       const void* M_host, const void* tab, void* partial,
                       int nblocks, int nw, void* coef, int lmax,
                       int nmax, int nc, int cmap, float xmin, float dxc, float rmin,
                       float rmax, float rmap, float scale, int hat, void* stream) {
  Params q{lmax, nmax, nc, cmap, xmin, dxc, rmin, rmax, rmap, scale, 0.0f, hat};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto mf = static_cast<const float*>(mass);
  auto Mf = static_cast<const float*>(M_host);
  auto tf = static_cast<const float*>(tab);
  auto pf = static_cast<float*>(partial);
  auto cf = static_cast<float*>(coef);
  switch (lmax) {
#define K1_CASE(L) \
    case L: return launch<L>(xf, mf, n, Mf, tf, pf, nblocks, nw, cf, q, s);
    K1_CASE(0) K1_CASE(1) K1_CASE(2) K1_CASE(3) K1_CASE(4) K1_CASE(5) K1_CASE(6)
#undef K1_CASE
    default: return cudaErrorInvalidValue;
  }
}


const char* sphere_coef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
