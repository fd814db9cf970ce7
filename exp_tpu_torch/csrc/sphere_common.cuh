// Device helpers shared by the sphere kernels (sphere_coef.cu K1,
// sphere_accel.cu K2, sphere_coef_rec.cu K3, sphere_accel_poly.cu K6): the
// radial map, the quadratic-B-spline and hat weights, the packed
// harmonic-row order and the monomials of the poly harmonics.  Arithmetic
// follows exp_tpu/ops/pallas_sphere.py (_geometry, _ximap, _spline_rows, _hat_rows)
// operation by operation in f32, so the kernels and their plain PyTorch
// versions round alike.
#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace sphere {

// Parameters of the radial table and the particle mask (host doubles rounded
// to f32 once, as JAX rounds Python constants against f32 arrays).
struct Params {
  int lmax, nmax, nc, cmap;   // nc radial nodes (see table_rows)
  float xmin, dxc;            // first node and spacing of the xi grid
  float rmin, rmax;           // table support in scaled radius
  float rmap, scale;
  float rb;                   // rmax * scale (physical boundary radius)
  int hat;                    // 0: 'spline' interpolation, 1: 'hat'
};

// Rows of the radial table: nc + 2 ghost-extended spline coefficients, or nc
// plain node values for 'hat'.
__host__ __device__ inline int table_rows(const Params& q) {
  return q.hat ? q.nc : q.nc + 2;
}

__host__ __device__ constexpr int npacked(int L) { return (L + 1) * (L + 1); }
__host__ __device__ constexpr int ncos(int L) { return (L + 1) * (L + 2) / 2; }

// Packed harmonic rows (exp_tpu packed_rows): cos rows (l, m <= l) first,
// then sin rows (l, 1 <= m <= l); returns l and m of row p.
__host__ __device__ constexpr int row_l(int p, int L) {
  if (p < ncos(L)) {
    int l = 0;
    while ((l + 1) * (l + 2) / 2 <= p) ++l;
    return l;
  }
  int q = p - ncos(L), l = 1;
  while ((l + 1) * l / 2 <= q) ++l;
  return l;
}
__host__ __device__ constexpr int row_m(int p, int L) {
  if (p < ncos(L)) {
    int l = row_l(p, L);
    return p - l * (l + 1) / 2;
  }
  int q = p - ncos(L), l = row_l(p, L);
  return q - l * (l - 1) / 2 + 1;
}
__host__ __device__ constexpr int row_cs(int p, int L) { return p < ncos(L) ? 0 : 1; }
// the packed rows of (cos, l, m) and (sin, l, m >= 1)
__host__ __device__ constexpr int cos_row(int l, int m) { return l * (l + 1) / 2 + m; }
__host__ __device__ constexpr int sin_row(int l, int m, int L) {
  return ncos(L) + l * (l - 1) / 2 + m - 1;
}

// xi(rs): cmap 1 is the algebraic map, anything else the identity (the
// wrappers admit cmap 0 and 1 only).
__device__ __forceinline__ float ximap(float rs, const Params& q) {
  if (q.cmap == 1) return (rs / q.rmap - 1.0f) / (rs / q.rmap + 1.0f);
  return rs;
}

// r = |x| + 1e-10 with every product and sum rounded on its own, as the
// plain version and the JAX kernel round it (no FMA contraction): the hat
// cell and the pole terms depend on the last ulp.
__device__ __forceinline__ float radius(float px, float py, float pz) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                         __fmul_rn(pz, pz))) + 1e-10f;
}

// Grid position t = clip((xi - xmin)/dxc, 0, nc-1).
__device__ __forceinline__ float grid_t(float xi, const Params& q) {
  const float t = (xi - q.xmin) / q.dxc;
  return fminf(fmaxf(t, 0.0f), (float)(q.nc - 1));
}

// The three nonzero quadratic-B-spline weights at grid position t: nodes
// c-1, c, c+1 of the ghosted table with c = floor(t + 1.5), the node nearest
// s = t + 1.  Equal to _b2(j - 1 - t) on those nodes and zero elsewhere.
__device__ __forceinline__ int spline_weights(float xi, const Params& q,
                                              float w[3]) {
  const float t = grid_t(xi, q);
  int c = (int)floorf(t + 1.5f);
  c = min(max(c, 1), q.nc);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float u = fabsf((float)(c - 1 + k) - 1.0f - t);
    float inner = 0.75f - u * u;
    float outer = 0.5f * (1.5f - u) * (1.5f - u);
    w[k] = u <= 0.5f ? inner : (u <= 1.5f ? outer : 0.0f);
  }
  return c;
}

// The hat cell j0 = clip(floor t, 0, nc-2) and the two hat weights
// max(0, 1 - |j - t|) at its nodes j0, j0 + 1 (_hat_rows: every other node
// weighs 0).  The cell also decides the hat derivative, +-1/dxc at j0 + 1
// and j0, so t is rounded exactly as the plain version rounds it.
__device__ __forceinline__ int hat_weights(float xi, const Params& q,
                                           float w[2]) {
  const float t = grid_t(xi, q);
  const int j0 = (int)fminf(fmaxf(floorf(t), 0.0f), (float)(q.nc - 2));
  w[0] = fmaxf(0.0f, 1.0f - fabsf((float)j0 - t));
  w[1] = fmaxf(0.0f, 1.0f - fabsf((float)(j0 + 1) - t));
  return j0;
}

// The first table node a particle touches and its weights: nodes j0, j0+1,
// j0+2 ('spline') or j0, j0+1 ('hat', w[2] = 0).
__device__ __forceinline__ int radial_weights(float xi, const Params& q,
                                              float w[3]) {
  if (q.hat) {
    w[2] = 0.0f;
    return hat_weights(xi, q, w);
  }
  return spline_weights(xi, q, w) - 1;
}

// ---------------------------------------------------------------------------
// Monomials mono(u) in the order degree, then i descending, then j
// descending (exp_tpu solidharm.monomial_exponents).

__host__ __device__ constexpr int nmono(int L) {
  return (L + 1) * (L + 2) * (L + 3) / 6;
}
// the first monomial of degree d
__host__ __device__ constexpr int mono_start(int d) { return d == 0 ? 0 : nmono(d - 1); }
__host__ __device__ constexpr int mono_deg(int k) {
  int d = 0;
  while (nmono(d) <= k) ++d;
  return d;
}
__host__ __device__ constexpr int mono_i(int k) {
  int d = mono_deg(k), r = k - mono_start(d);
  int i = d;
  while (r > d - i) { r -= d - i + 1; --i; }
  return i;
}
__host__ __device__ constexpr int mono_j(int k) {
  int d = mono_deg(k), r = k - mono_start(d);
  int i = d;
  while (r > d - i) { r -= d - i + 1; --i; }
  return d - i - r;
}
// index of the monomial of degree d with exponents (i, j, d - i - j)
__host__ __device__ constexpr int mono_index(int d, int i, int j) {
  int k = mono_start(d);
  for (int a = d; a > i; --a) k += d - a + 1;
  return k + (d - i) - j;
}

// Monomial K is a lower-degree monomial times one component of u: split off
// the first axis with a nonzero exponent (solidharm.monomial_build_plan).
// Everything here is evaluated by the compiler's front end.
template <int K>
struct MonoStep {
  static constexpr int i = mono_i(K), j = mono_j(K), d = mono_deg(K);
  static constexpr int axis = i > 0 ? 0 : (j > 0 ? 1 : 2);
  static constexpr int src = mono_index(d - 1, i - (axis == 0), j - (axis == 1));
};

template <int... K>
__device__ __forceinline__ void monomials_seq(float* mono, float ux, float uy, float uz,
                                              std::integer_sequence<int, K...>) {
  mono[0] = 1.0f;
  ((mono[K + 1] = mono[MonoStep<K + 1>::src] *
                  (MonoStep<K + 1>::axis == 0 ? ux
                                              : (MonoStep<K + 1>::axis == 1 ? uy : uz))),
   ...);
}

// mono[0 .. nmono(L)) of u
template <int L>
__device__ __forceinline__ void monomials(float* mono, float ux, float uy, float uz) {
  monomials_seq(mono, ux, uy, uz, std::make_integer_sequence<int, nmono(L) - 1>{});
}

// ---------------------------------------------------------------------------
// The monomials in even form, for lmax 7..10, where the nmono(L) monomials
// (286 at lmax 10) do not fit a thread's registers: monomial K = x^i y^j z^k
// is b[c] q[a], with c = (i mod 2) + 2 (j mod 2) + 4 (k mod 2) its parity
// class, b[c] = x^(i mod 2) y^(j mod 2) z^(k mod 2), and q[a] the monomial
// (x^2)^(i/2) (y^2)^(j/2) (z^2)^(k/2) of degree <= L/2 (56 at lmax 10).  A
// harmonic row, and each of its gradient rows, holds monomials of one
// class (k1_support's parities), so a row is b[c] times a sum over q.

template <int K>
struct EvenSplit {
  static constexpr int i = mono_i(K), j = mono_j(K), k = mono_deg(K) - mono_i(K) - mono_j(K);
  static constexpr int cls = (i & 1) | ((j & 1) << 1) | ((k & 1) << 2);
  static constexpr int q = mono_index(i / 2 + j / 2 + k / 2, i / 2, j / 2);
};

template <int L>
struct EvenMonomials {
  float q[nmono(L / 2)];
  float b[8];
  __device__ __forceinline__ EvenMonomials(float ux, float uy, float uz) {
    monomials<L / 2>(q, ux * ux, uy * uy, uz * uz);
    b[0] = 1.0f, b[1] = ux, b[2] = uy, b[3] = ux * uy;
    b[4] = uz, b[5] = ux * uz, b[6] = uy * uz, b[7] = ux * uy * uz;
  }
};

// sum_e v[e] mono[cols[e]] over the entries E0 + e of one row of a
// pattern (Sup::col, monomial indices), from the even form; all entries
// of the row must be of one parity class
template <class Sup, int L, int E0, int... e>
__device__ __forceinline__ float even_row(const float* v, const EvenMonomials<L>& ev,
                                          std::integer_sequence<int, e...>) {
  if constexpr (sizeof...(e) == 0) {
    return 0.0f;
  } else {
    constexpr int c = EvenSplit<Sup::col[E0]>::cls;
    static_assert(((EvenSplit<Sup::col[E0 + e]>::cls == c) && ...),
                  "a row of the pattern mixes parity classes");
    float s = 0.0f;
    ((s += v[E0 + e] * ev.q[EvenSplit<Sup::col[E0 + e]>::q]), ...);
    return ev.b[c] * s;
  }
}

// row R of pattern Sup (start, col) from the even form
template <class Sup, int L, int R>
__device__ __forceinline__ float even_pattern_row(const float* v, const EvenMonomials<L>& ev) {
  constexpr int e0 = Sup::start[R], e1 = Sup::start[R + 1];
  return even_row<Sup, L, e0>(v, ev, std::make_integer_sequence<int, e1 - e0>{});
}

}  // namespace sphere
