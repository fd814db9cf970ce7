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
// The sums, the chunk adds and the finish are in sphere_coef_sums.cuh,
// which K1's split form (sphere_coef.cu) shares.
//
// Measured (exp_tpu_torch/bench_kernels.py, 2^20 rows, NVIDIA H100 80GB
// HBM3 at 700 W, the first port in the same call): lmax 4 'spline' 0.092
// ms (0.240), 'hat' 0.090 (0.363), lmax 10 0.33 (2.02); 224 rows 0.015
// (0.043).  The atomic adds are about a third of the time at lmax 4 and
// 40% at lmax 10 (exp_tpu_torch/probe_rec_split.py `no_adds`).
#include <cstring>

#include "sphere_coef_sums.cuh"

namespace {

using sphere::add_chunk;
using sphere::block_mass;
using sphere::block_smem;
using sphere::coef_reduce_slots;
using sphere::finish_smem;
using sphere::kFinishThreads;
using sphere::kTree;
using sphere::Params;
using sphere::scale_exponent;
using sphere::stage_stride;

constexpr int kWarp = 32;
constexpr int kMaxL = 10;                        // ops/sphere_kernels.REC_LMAX
constexpr int kMaxP = sphere::npacked(kMaxL);
constexpr int kMaxThreads = 512;                 // ops/sphere_kernels.K3_WARPS

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

  // the sums back in f32: in place for one block, which contracts them
  // itself, else into the block's partial at the packed rows
  sphere::group_finish(acc, RS, rowe, R, ONE && gridDim.x == 1,
                       reinterpret_cast<int*>(stage), tab, q, partial, coef);
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
