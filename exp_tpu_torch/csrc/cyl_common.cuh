// Device helpers shared by the two EOF cylinder kernels (cyl_coef.cu,
// cyl_accel.cu): the (R, z) -> (x, y) grid maps, the interpolation nodes
// and weights, and the cos/sin(m phi) rows.  Arithmetic follows
// exp_tpu/ops/pallas_cylinder.py (_cyl_maps, _grid_coords, _b2, _w3, _w2,
// _trig_rows) operation by operation in f32, so the kernels and their plain
// PyTorch versions (ops/cyl_kernels.py) round alike.
#pragma once

#include <cuda_runtime.h>

namespace cyl {

// Geometry of the coarse tables (host doubles rounded to f32 once, as JAX
// rounds Python constants against f32 arrays).
struct Params {
  int mmax, ncx, ncy;        // ncx coarse x nodes, ncy y nodes
  float acyl, hcyl;          // x = (R/a - 1)/(R/a + 1), y = asinh(z/h)
  float xmin, dxc;           // first x node and coarse spacing
  float ymin, dy;            // first y node and spacing
  float rmax_grid;           // table sphere: mass mask and continuation
};

// R = |(x, y)| + 1e-12 and r = |(R, z)| + 1e-12, each product and sum
// rounded on its own (no FMA contraction), as the JAX kernel rounds them.
__device__ __forceinline__ void cyl_maps(float px, float py, float pz, float& R,
                                         float& r) {
  R = sqrtf(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py))) + 1e-12f;
  r = sqrtf(__fadd_rn(__fmul_rn(R, R), __fmul_rn(pz, pz))) + 1e-12f;
}

// Grid positions tx in [0, ncx-1] and ty in [0, ncy-1].  asinh is the JAX
// kernel's log(u + sqrt(u^2 + 1)), with its rounding.
__device__ __forceinline__ void grid_coords(float R, float z, const Params& q,
                                            float& tx, float& ty) {
  const float xg = (R / q.acyl - 1.0f) / (R / q.acyl + 1.0f);
  const float u = z / q.hcyl;
  const float yg = logf(u + sqrtf(__fadd_rn(__fmul_rn(u, u), 1.0f)));
  tx = fminf(fmaxf((xg - q.xmin) / q.dxc, 0.0f), (float)(q.ncx - 1));
  ty = fminf(fmaxf((yg - q.ymin) / q.dy, 0.0f), (float)(q.ncy - 1));
}

// Number of x nodes a particle touches: 3 spline weights or 2 hats.
template <bool SPLINE>
struct XNodes {
  static constexpr int K = SPLINE ? 3 : 2;
};

// The nonzero x weights at tx and their table rows.  'spline': the three
// prefiltered quadratic-B-spline weights _b2(j - 1 - tx) on the ghosted
// rows j = c-1, c, c+1, c = floor(tx + 1.5) (rows 0 and ncx+1 are real
// spline coefficients).  'linear': hats max(0, 1 - |j - tx|) on rows
// i0 = floor(tx) and i0 + 1; past the last row the weight is 0 and the row
// index is held in range.
template <bool SPLINE>
__device__ __forceinline__ void x_weights(float tx, int ncx, int j[], float w[]) {
  if constexpr (SPLINE) {
    int c = (int)floorf(tx + 1.5f);
    c = min(max(c, 1), ncx);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      j[k] = c - 1 + k;
      const float u = fabsf((float)j[k] - 1.0f - tx);
      const float inner = 0.75f - u * u;
      const float outer = 0.5f * (1.5f - u) * (1.5f - u);
      w[k] = u <= 0.5f ? inner : (u <= 1.5f ? outer : 0.0f);
    }
  } else {
    const int i0 = min((int)floorf(tx), ncx - 1);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int jj = i0 + k;
      w[k] = jj < ncx ? fmaxf(0.0f, 1.0f - fabsf((float)jj - tx)) : 0.0f;
      j[k] = min(jj, ncx - 1);
    }
  }
}

// y is always hat-interpolated (the JAX kernels call _w2 without interp):
// rows i0 = floor(ty) and i0 + 1.  At ty == ncy-1 the second row is the
// TPU's zero pad row; here its weight is 0 and its index is held in range.
__device__ __forceinline__ void y_weights(float ty, int ncy, int j[2], float w[2]) {
  const int i0 = min((int)floorf(ty), ncy - 1);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int jj = i0 + k;
    w[k] = jj < ncy ? fmaxf(0.0f, 1.0f - fabsf((float)jj - ty)) : 0.0f;
    j[k] = min(jj, ncy - 1);
  }
}

// cos(m phi), sin(m phi) for m = 0..M by angle addition (no
// transcendentals), in the JAX kernel's order of operations.
template <int M>
__device__ __forceinline__ void trig_rows(float cphi, float sphi, float c[M + 1],
                                          float s[M + 1]) {
  c[0] = 1.0f;
  s[0] = 0.0f;
#pragma unroll
  for (int m = 1; m <= M; ++m) {
    c[m] = __fsub_rn(__fmul_rn(c[m - 1], cphi), __fmul_rn(s[m - 1], sphi));
    s[m] = __fadd_rn(__fmul_rn(s[m - 1], cphi), __fmul_rn(c[m - 1], sphi));
  }
}

}  // namespace cyl
