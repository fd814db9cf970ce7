// Periodic-slab force pass (K10) for Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_slab.py make_slab_accel_kernel (the TPU
// kernel at its pallas_call, :286), SlabForce's pallas force pass for both
// pallas_interp='spline' (the default) and 'linear'.
//
// Computes, for particles x (N, 3), with u = x - floor(x) on the two
// horizontal axes and e_k = e^{+2 pi i (kx u_x + ky u_y)}:
//   inside (|z| <= zmax): T_k, T'_k interpolated at z on the coarse rows,
//     pot = Re sum T e, a_x = Im sum 2 pi kx T e, a_y = Im sum 2 pi ky T e,
//     a_z = -Re sum T' e;
//   outside: the vacuum continuation from the boundary values Tb_k, Td_k of
//     the full-resolution tables at z = +-zmax (the side of z): with
//     dz = |z| - zmax and att = e^{-2 pi |k| dz}, pot = Re sum Tb e att +
//     Td_0 dz sign(z), a_x, a_y = Im sum 2 pi k Tb e att, a_z = -Td_0 +
//     sign(z) sum 2 pi |k| Re(Tb e att).
// From tab (force_rows, H, KZ, 4), on each first z node j0 and half-lattice
// wavevector the coefficients of the profiles (Re T, Im T, Re T', Im T'),
// folded onto the half lattice (T_h + conj T_{-h}), as a polynomial in
// the particle's offset g = t - j0 (ops/slab_kernels.slab_force_table,
// force_poly: A + g B + g^2 C 'spline', A + g B 'linear'), and aux (H, 8),
// the folded boundary rows (top pot, bottom pot, top dPhi/dz, bottom
// dPhi/dz, each (re, im); slab_force_aux).  Since Re and Im of conj(z) are
// Re z and -Im z, the terms k and -k of every output sum to the folded term
// at k, and att depends on |k| only, so only the H half-lattice wavevectors
// are visited: 41 of 81 at nmax 4 x 4.
//
// What bounds it on an H100, at the slab bench's shapes (nmax 4 x 4,
// zrows = 128, N = 2^20, 'spline'): operations.  It moves 28 bytes a
// particle (12 read, 16 written: 29 MB, 9 us at 3.35 TB/s) and the table
// once (248 KB of polynomial rows); the function needs, per particle and
// half-lattice wavevector, e_h, the 4 profiles in g by Horner's rule (8
// FMAs) and the assembly, about 1.5 GFLOP at 2^20: 0.023 ms on the CUDA
// cores' FP32 rate (chip_smoke.py k10_work).
//
// The first version (to 153d877: a thread a particle in the input's order,
// the node rows z-major, 3 of them and their weights a wavevector) took
// 0.138-0.142 ms there.  Its split (exp_tpu_torch/
// probe_slab_accel_split.py --first, PERF.md §6): every particle's rows at
// one node saved 34%, the sheet sorted by z 26% (sorted within tiles of
// 1,024 rows, the same), the phases 1%, the stores 1-2%.  Its SASS issued
// ~48 instructions a particle and wavevector (the 2 pi k factors converted
// and scaled every term, the loops' counters, pointer arithmetic a load),
// ~0.07 ms of issue at 2^20; a warp's 32 particles read ~17 rows a load.
//
// Design.  A block takes tiles of particles (ops/slab_kernels.accel_plan:
// 1,024 at 2^20, two blocks an SM) and sorts each by the particle's first
// z node j0, two more bins taking the particles below -zmax and above
// +zmax: each warp's ranks by __match_any_sync and one shared atomic add a
// bin, the bins' first places by one warp's scan, each bin's count rounded
// up to even with a padding record (a copy of its last particle whose
// output is dropped).  A thread then walks two records of one bin at once:
// inside they share j0, so a wavevector's KZ rows of 16 bytes are read once
// for the pair (half the first version's loads a particle, from ~3 nodes a
// warp), each particle's profiles by Horner's rule in its own g (8 FMAs
// 'spline' against 12 with weights); beyond a face they share the boundary
// row.  The walk is unrolled along ky (NY = nmaxy a template argument):
// the powers of e^{2 pi i u_y} stay in registers, a pair (kx, +-ky) shares
// its products, the rows' loads take immediate offsets, and 2 pi kx and
// 2 pi ky are applied once (a_x from each kx row's sum, a_y by the unrolled
// ky, 2 pi at the end): ~21 instructions a particle and wavevector.  The
// next tile's x is copied into shared memory (cp.async) during the walk,
// and acc and pot go back at the particles' own places through shared
// memory, coalesced.  No sum crosses threads and a particle's arithmetic
// does not depend on its place, so the output is the same bit for bit on
// every run, whatever the atomics' order.  Rows past N are never staged.
// The launcher queries nothing: the plan comes from the wrapper.  No
// fast-math intrinsics.
//
// Measured (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W, the sheet at 2^20):
// 0.082 ms against the first version's 0.141, 'linear' 0.066 (0.101), a
// sample half beyond zmax 0.081 (0.124); 3.6x its bound.  Its split: the
// sort, staging and stores alone 0.023 ms, mostly under the other block's
// walk; the walk runs at about 45% of the issue rate, held by the latency
// of the table's loads (a whole-sheet sort, which keeps a block's rows in
// L1, would save 17%).
#include "slab_common.cuh"

namespace {

using slab::Params;

constexpr int kWarp = 32;
constexpr int kThreads = 256;      // threads a block, at most
constexpr int kBlocksPerSm = 2;    // the plan's blocks an SM; fit in registers
constexpr int kMaxTile = 1024;     // particles a tile, at most
constexpr int kPair = 2;           // particles a thread walks at once, in one bin

struct Geo {
  Params q;
  int H;       // half-lattice wavevectors
  int tile;    // particles a tile (a multiple of 32)
  int nbins;   // nzc first nodes, then below -zmax, above +zmax
  int nbp;     // nbins rounded up to 32
};

// The block's shared memory, carved in this order from the plan's tile and
// bins (ops/slab_kernels.k10_smem): the tile's records at their sorted
// places (x, y, z, the particle's place in the tile, or -1 for a bin's
// padding record), with room for one padding record a bin; the tile's x
// as it lies in memory, copied in while the block walks the tile before;
// its outputs at the particles' own places (acc, 3 a particle, then pot);
// each particle's key (bin | rank << 16); the bins' counts; their first
// places and, last, the tile's count of records.
struct Smem {
  float4* rec;
  float* xs;
  float* oacc;
  float* opot;
  int* key;
  int* cnt;
  int* start;
  size_t bytes;
  __host__ __device__ Smem(void* base, const Geo& g) {
    char* p = static_cast<char*>(base);
    rec = reinterpret_cast<float4*>(p);
    xs = reinterpret_cast<float*>(rec + g.tile + g.nbp);
    oacc = xs + 3 * g.tile;
    opot = oacc + 3 * g.tile;
    key = reinterpret_cast<int*>(opot + g.tile);
    cnt = key + g.tile;
    start = cnt + g.nbp;
    bytes = reinterpret_cast<char*>(start + g.nbp + 1) - p;
  }
};

// Rows [base, base + count) of x into xs by asynchronous copies (cp.async,
// 4 bytes each: x need not be 16-byte aligned), one group a thread; the
// caller waits for them (cp.async.wait_all) before a barrier.
__device__ __forceinline__ void stage_x(float* xs, const float* x, long long base, int count,
                                        int tid, int nthreads) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(xs));
  const float* src = x + 3 * base;
  for (int e = tid; e < 3 * count; e += nthreads)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4 * e), "l"(src + e));
  asm volatile("cp.async.commit_group;\n" ::);
}

// A particle's bin: its first z node (slab_common.cuh z_frac) inside,
// nzc below -zmax and nzc + 1 above +zmax.
template <int KZ>
__device__ __forceinline__ int bin_of(float z, const Params& q) {
  if (fmaxf(fabsf(z) - q.zmax, 0.0f) > 0.0f) return z >= 0.0f ? q.nzc + 1 : q.nzc;
  float g;
  return slab::z_frac<KZ>(slab::z_grid(z, q), q.nzc, g);
}

// The half lattice for P particles, a row of kx = a at a time: row 0 takes
// ky = 0..NY, rows a = 1..nx take ky = -NY..NY.  term(hrow, a, b, e, w)
// adds the wavevector h = hrow + b (hrow = a (2 NY + 1)) with e[j] =
// px_j^a py_j^b, and returns each particle's Im part for the horizontal
// force in w; lattice sums those into fx = sum a Im and fy = sum b Im
// (without 2 pi).  py^0..py^NY stay in registers, px steps along the rows
// by angle addition, and the pair (a, b), (a, -b) shares its products.
template <int NY, int P, class Term>
__device__ __forceinline__ void lattice(const float2 (&e1x)[P], const float2 (&e1y)[P], int nx,
                                        float (&fx)[P], float (&fy)[P], Term&& term) {
  constexpr int B2 = 2 * NY + 1;
  float2 py[P][NY + 1];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    py[j][0] = make_float2(1.0f, 0.0f);
#pragma unroll
    for (int b = 1; b <= NY; ++b) py[j][b] = cube::cmul(py[j][b - 1], e1y[j]);
  }
  float w[P];
  float2 e[P], em[P];
#pragma unroll
  for (int b = 0; b <= NY; ++b) {
#pragma unroll
    for (int j = 0; j < P; ++j) e[j] = py[j][b];
    term(0, 0.0f, b, e, w);
#pragma unroll
    for (int j = 0; j < P; ++j) fy[j] = fmaf((float)b, w[j], fy[j]);
  }
  float2 px[P];
#pragma unroll
  for (int j = 0; j < P; ++j) px[j] = e1x[j];
  for (int a = 1; a <= nx; ++a) {
    const int hrow = a * B2;
    const float af = (float)a;
    float srow[P], wm[P];
    term(hrow, af, 0, px, srow);
#pragma unroll
    for (int b = 1; b <= NY; ++b) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float q2 = px[j].y * py[j][b].y, q4 = px[j].y * py[j][b].x;
        e[j] = make_float2(fmaf(px[j].x, py[j][b].x, -q2), fmaf(px[j].x, py[j][b].y, q4));
        em[j] = make_float2(fmaf(px[j].x, py[j][b].x, q2), fmaf(-px[j].x, py[j][b].y, q4));
      }
      term(hrow, af, b, e, w);
      term(hrow, af, -b, em, wm);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        srow[j] += w[j] + wm[j];
        fy[j] = fmaf((float)b, w[j] - wm[j], fy[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      fx[j] = fmaf(af, srow[j], fx[j]);
      px[j] = cube::cmul(px[j], e1x[j]);
    }
  }
}

// A thread's kPair particles (acc, pot), all of one bin: inside on one
// first node, whose kz polynomial rows a wavevector they share, or beyond
// one face, whose boundary row they share.
template <int NY, int KZ>
__device__ __forceinline__ void walk(const float4 (&r)[kPair], const float4* __restrict__ tab,
                                     const float4* __restrict__ aux, const Geo& g,
                                     float4 (&o)[kPair]) {
  constexpr int P = kPair;
  const Params& q = g.q;
  float2 e1x[P], e1y[P];
  float pot[P], fx[P], fy[P], fz[P], dzp[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    e1x[j] = cube::unit_phase(cube::wrap(r[j].x), 1.0f);
    e1y[j] = cube::unit_phase(cube::wrap(r[j].y), 1.0f);
    dzp[j] = fmaxf(fabsf(r[j].z) - q.zmax, 0.0f);
    pot[j] = fx[j] = fy[j] = fz[j] = 0.0f;
  }
  if (dzp[0] > 0.0f) {
    const float szn = r[0].z >= 0.0f ? 1.0f : -1.0f;
    // aux as (H, 4) float2: top pot, bottom pot, top dPhi/dz, bottom dPhi/dz
    const float2* ab = reinterpret_cast<const float2*>(aux) + (r[0].z >= 0.0f ? 0 : 1);
    lattice<NY, P>(e1x, e1y, q.nx, fx, fy,
                   [&](int hrow, float af, int b, const float2 (&e)[P], float (&w)[P]) {
      const float2* u = ab + 4 * hrow;
      const float2 t = __ldg(u + 4 * b);
      const float km = cube::kTwoPi * sqrtf(fmaf(af, af, (float)(b * b)));
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float att = expf(-km * dzp[j]);
        const float tr = (t.x * e[j].x - t.y * e[j].y) * att;
        pot[j] += tr;
        fz[j] = fmaf(km, tr, fz[j]);
        w[j] = (t.x * e[j].y + t.y * e[j].x) * att;
      }
    });
    const float td = __ldg(ab + 2).x;              // k = 0, where e = 1
#pragma unroll
    for (int j = 0; j < P; ++j) {
      pot[j] += td * dzp[j] * szn;
      fz[j] = fmaf(szn, fz[j], -td);
    }
  } else {
    float gz[P];
    int j0 = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) j0 = slab::z_frac<KZ>(slab::z_grid(r[j].z, q), q.nzc, gz[j]);
    const float4* rows = tab + (size_t)j0 * g.H * KZ;
    lattice<NY, P>(e1x, e1y, q.nx, fx, fy,
                   [&](int hrow, float, int b, const float2 (&e)[P], float (&w)[P]) {
      const float4* t = rows + hrow * KZ;
      t += b * KZ;
      const float4 c0 = __ldg(t), c1 = __ldg(t + 1);
      const float4 c2 = KZ == 3 ? __ldg(t + 2) : c1;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float s = gz[j];
        float4 v = c1;
        if constexpr (KZ == 3) {
          v = make_float4(fmaf(s, c2.x, c1.x), fmaf(s, c2.y, c1.y), fmaf(s, c2.z, c1.z),
                          fmaf(s, c2.w, c1.w));
        }
        v = make_float4(fmaf(s, v.x, c0.x), fmaf(s, v.y, c0.y), fmaf(s, v.z, c0.z),
                        fmaf(s, v.w, c0.w));
        pot[j] = fmaf(v.x, e[j].x, pot[j]);
        pot[j] = fmaf(-v.y, e[j].y, pot[j]);
        fz[j] = fmaf(v.z, e[j].x, fz[j]);
        fz[j] = fmaf(-v.w, e[j].y, fz[j]);
        w[j] = fmaf(v.x, e[j].y, v.y * e[j].x);
      }
    });
#pragma unroll
    for (int j = 0; j < P; ++j) fz[j] = -fz[j];
  }
#pragma unroll
  for (int j = 0; j < P; ++j)
    o[j] = make_float4(cube::kTwoPi * fx[j], cube::kTwoPi * fy[j], fz[j], pot[j]);
}

template <int NY, int KZ>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
accel_kernel(const float* __restrict__ x, long long n, const float4* __restrict__ tab,
             const float4* __restrict__ aux, Geo g, float* __restrict__ acc,
             float* __restrict__ pot) {
  extern __shared__ float4 sh4[];
  const Smem sm(sh4, g);
  const int tid = threadIdx.x, lane = tid % kWarp, nthreads = blockDim.x;
  for (int b = tid; b < g.nbp; b += nthreads) sm.cnt[b] = 0;
  const long long stride = (long long)gridDim.x * g.tile;
  long long base = (long long)blockIdx.x * g.tile;
  if (base < n) stage_x(sm.xs, x, base, (int)(n - base < g.tile ? n - base : g.tile), tid, nthreads);

  for (; base < n; base += stride) {
    const int count = (int)(n - base < g.tile ? n - base : g.tile);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // A. each particle's bin and its rank in the bin: a warp's peers by
    // __match_any_sync, one atomic add a bin and warp
    for (int p0 = tid - lane; p0 < g.tile; p0 += nthreads) {
      const int p = p0 + lane;
      const int bin = p < count ? bin_of<KZ>(sm.xs[3 * p + 2], g.q) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      const int leader = __ffs(peers) - 1;
      int first = 0;
      if (lane == leader && bin >= 0) first = atomicAdd(sm.cnt + bin, __popc(peers));
      first = __shfl_sync(0xffffffffu, first, leader);
      sm.key[p] = bin < 0 ? -1 : bin | ((first + __popc(peers & ((1u << lane) - 1u))) << 16);
    }
    __syncthreads();
    // B. the bins' first places, each bin's count rounded up to even, by
    // warp 0's scan; the tile's count of records last
    if (tid < kWarp) {
      int carry = 0;
      for (int b0 = 0; b0 < g.nbp; b0 += kWarp) {
        const int c = sm.cnt[b0 + lane] + (sm.cnt[b0 + lane] & 1);
        int incl = c;
#pragma unroll
        for (int o = 1; o < kWarp; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        sm.start[b0 + lane] = carry + incl - c;
        carry += __shfl_sync(0xffffffffu, incl, kWarp - 1);
      }
      if (lane == 0) sm.start[g.nbp] = carry;
    }
    __syncthreads();
    // C. each particle's record at its sorted place, and after the last of
    // a bin of odd count a padding record, a copy of it with place -1
    for (int p = tid; p < count; p += nthreads) {
      const int k = sm.key[p], bin = k & 0xffff, rank = k >> 16;
      const float4 v =
          make_float4(sm.xs[3 * p], sm.xs[3 * p + 1], sm.xs[3 * p + 2], __int_as_float(p));
      const int pos = sm.start[bin] + rank;
      sm.rec[pos] = v;
      const int c = sm.cnt[bin];
      if ((c & 1) && rank == c - 1) sm.rec[pos + 1] = make_float4(v.x, v.y, v.z, __int_as_float(-1));
    }
    __syncthreads();
    // D. the next tile's x on its way; the walk: a thread the records 2s,
    // 2s + 1 of the sorted tile (one bin), the outputs at the particles'
    // own places; the counts cleared
    if (base + stride < n)
      stage_x(sm.xs, x, base + stride,
              (int)(n - base - stride < g.tile ? n - base - stride : g.tile), tid, nthreads);
    for (int b = tid; b < g.nbins; b += nthreads) sm.cnt[b] = 0;
    const int npair = sm.start[g.nbp] / kPair;
    for (int s = tid; s < npair; s += nthreads) {
      float4 r[kPair], o[kPair];
#pragma unroll
      for (int j = 0; j < kPair; ++j) r[j] = sm.rec[kPair * s + j];
      walk<NY, KZ>(r, tab, aux, g, o);
#pragma unroll
      for (int j = 0; j < kPair; ++j) {
        const int p = __float_as_int(r[j].w);
        if (p < 0) continue;
        sm.oacc[3 * p] = o[j].x;
        sm.oacc[3 * p + 1] = o[j].y;
        sm.oacc[3 * p + 2] = o[j].z;
        sm.opot[p] = o[j].w;
      }
    }
    __syncthreads();
    // E. the tile's outputs, coalesced
    for (int e = tid; e < 3 * count; e += nthreads) acc[3 * base + e] = sm.oacc[e];
    for (int e = tid; e < count; e += nthreads) pot[base + e] = sm.opot[e];
  }
}

template <int NY, int KZ>
cudaError_t launch(const float* x, long long n, const float4* tab, const float4* aux,
                   const Geo& g, float* acc, float* pot, int nblocks, int threads, int smem,
                   cudaStream_t stream) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(accel_kernel<NY, KZ>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  accel_kernel<NY, KZ><<<nblocks, threads, smem, stream>>>(x, n, tab, aux, g, acc, pot);
  return cudaGetLastError();
}

template <int KZ>
cudaError_t launch_ny(const float* x, long long n, const float4* tab, const float4* aux,
                      const Geo& g, float* acc, float* pot, int nblocks, int threads, int smem,
                      cudaStream_t stream) {
#define SLAB_ACCEL_NY(NY)                                                               \
  case NY:                                                                              \
    return launch<NY, KZ>(x, n, tab, aux, g, acc, pot, nblocks, threads, smem, stream);
  switch (g.q.ny) {
    SLAB_ACCEL_NY(0)
    SLAB_ACCEL_NY(1)
    SLAB_ACCEL_NY(2)
    SLAB_ACCEL_NY(3)
    SLAB_ACCEL_NY(4)
    SLAB_ACCEL_NY(5)
    SLAB_ACCEL_NY(6)
    SLAB_ACCEL_NY(7)
    SLAB_ACCEL_NY(8)
  }
#undef SLAB_ACCEL_NY
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (n, 3), tab (force_rows, H, KZ, 4) the folded z-profiles' polynomials
// (force_rows = nzc, KZ = 3 'spline'; nzc - 1 and 2 'linear'), aux (H, 8)
// boundary rows; outputs acc (n, 3) and pot (n,).  All f32, contiguous, on
// the current device, tab and aux 16-byte aligned; nmax 0..8 on each axis,
// nzc >= 2, zrows = nzc + 2 ('spline') or nzc ('linear') at most 128.  The
// plan (ops/slab_kernels.accel_plan): tiles of `tile` particles (a multiple
// of 32, at most kMaxTile), blocks of `threads` (a multiple of 32, at most
// kThreads), nblocks blocks and smem bytes of shared memory a block, at
// least what the layout carves.  Returns a cudaError_t.
int slab_accel_launch(const void* x, long long n, const void* tab, const void* aux,
                      void* acc, void* pot, int nmaxx, int nmaxy, int nzc, int spline,
                      float zmax, float dz, int tile, int threads, int nblocks, int smem,
                      void* stream) {
  if (nmaxx < 0 || nmaxx > 8 || nmaxy < 0 || nmaxy > 8 || nzc < 2 || tile < kWarp ||
      tile > kMaxTile || tile % kWarp || threads < kWarp || threads > kThreads ||
      threads % kWarp || nblocks < 1)
    return cudaErrorInvalidValue;
  Geo g;
  g.q = Params{nmaxx, nmaxy, nzc, spline ? nzc + 2 : nzc, zmax, dz};
  g.H = slab::half_count(nmaxx, nmaxy);
  g.tile = tile;
  g.nbins = nzc + 2;
  g.nbp = (g.nbins + kWarp - 1) / kWarp * kWarp;
  if (g.q.zrows > 128 || Smem(nullptr, g).bytes > (size_t)smem) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto tf = static_cast<const float4*>(tab);
  auto uf = static_cast<const float4*>(aux);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  return spline ? launch_ny<3>(xf, n, tf, uf, g, af, pf, nblocks, threads, smem, s)
                : launch_ny<2>(xf, n, tf, uf, g, af, pf, nblocks, threads, smem, s);
}

const char* slab_accel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
