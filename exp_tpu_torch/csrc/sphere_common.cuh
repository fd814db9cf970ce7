// Device helpers shared by the two sphere kernels (sphere_coef.cu,
// sphere_accel.cu): the radial map, the quadratic-B-spline weights and the
// packed harmonic-row order.  Arithmetic follows exp_tpu/ops/pallas_sphere.py
// (_geometry, _ximap, _spline_rows) operation by operation in f32, so the
// kernels and their plain PyTorch versions round alike.
#pragma once

#include <cuda_runtime.h>

namespace sphere {

// Parameters of the radial table and the particle mask (host doubles rounded
// to f32 once, as JAX rounds Python constants against f32 arrays).
struct Params {
  int lmax, nmax, nc, cmap;   // nc spline nodes; rows = nc + 2 ghosted
  float xmin, dxc;            // first node and spacing of the xi grid
  float rmin, rmax;           // table support in scaled radius
  float rmap, scale;
  float rb;                   // rmax * scale (physical boundary radius)
};

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

// xi(rs): cmap 1 is the algebraic map, anything else the identity (the
// wrapper admits cmap 0 and 1 only).
__device__ __forceinline__ float ximap(float rs, const Params& q) {
  if (q.cmap == 1) return (rs / q.rmap - 1.0f) / (rs / q.rmap + 1.0f);
  return rs;
}

// The three nonzero quadratic-B-spline weights at grid position
// t = clip((xi - xmin)/dxc, 0, nc-1): nodes c-1, c, c+1 of the ghosted
// table with c = floor(t + 1.5), the node nearest s = t + 1.  Equal to
// _b2(j - 1 - t) on those nodes and zero elsewhere.
__device__ __forceinline__ int spline_weights(float xi, const Params& q,
                                              float w[3]) {
  float t = (xi - q.xmin) / q.dxc;
  t = fminf(fmaxf(t, 0.0f), (float)(q.nc - 1));
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

}  // namespace sphere
