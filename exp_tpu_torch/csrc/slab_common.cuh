// Device helpers shared by the two slab kernels (slab_coef.cu,
// slab_accel.cu): the geometry, the z grid position and the z interpolation
// nodes and weights (K9), or the node and the offset from it (K10).  The
// (kx, ky) phase rows come from cube_common.cuh.
//
// Arithmetic follows exp_tpu/ops/pallas_slab.py operation by operation in
// f32 (t = clip((z + zmax) / dz, 0, nzc - 1), the weights of
// pallas_cylinder._w2), so the kernels and their plain PyTorch versions
// (ops/slab_kernels.py z_grid, z_nodes, z_frac) pick the same nodes.
#pragma once

#include "cube_common.cuh"

namespace slab {

// Static geometry (host doubles rounded to f32 once, as JAX rounds Python
// constants against f32 arrays).
struct Params {
  int nx, ny;         // nmax per horizontal axis
  int nzc, zrows;     // coarse z nodes; table rows (nzc + 2 'spline', nzc 'linear')
  float zmax, dz;     // slab half height; node spacing 2 zmax / (nzc - 1)
};

// Half-lattice wavevectors (kx > 0, or kx = 0 and ky >= 0), h = kx B2 + ky
// with B2 = 2 ny + 1: H = (C + 1) / 2 of the C = (2 nx + 1) B2.
__host__ __device__ __forceinline__ int half_count(int nx, int ny) {
  return ((2 * nx + 1) * (2 * ny + 1) + 1) / 2;
}

// Grid position of z in [0, nzc - 1].
__device__ __forceinline__ float z_grid(float z, const Params& q) {
  return fminf(fmaxf((z + q.zmax) / q.dz, 0.0f), (float)(q.nzc - 1));
}

// The first of a particle's KZ contiguous table rows, j0, and its offset
// g = t - j0, in which the interpolation is a polynomial.  KZ = 3
// ('spline'): j0 = floor(t + 1.5) - 1 held in 0..nzc-1 (rows 0 and nzc + 1
// are ghost spline coefficients), g in [-0.5, 0.5], the weights 0.5 (0.5 -
// g)^2, 0.75 - g^2, 0.5 (0.5 + g)^2 of rows j0..j0+2.  KZ = 2 ('linear'):
// j0 = floor(t) held in 0..nzc-2, so that the window stays in the table,
// g in [0, 1], the weights 1 - g and g of rows j0, j0 + 1.
template <int KZ>
__device__ __forceinline__ int z_frac(float t, int nzc, float& g) {
  int j0;
  if constexpr (KZ == 3) {
    j0 = min(max((int)floorf(t + 1.5f), 1), nzc) - 1;
  } else {
    j0 = min((int)floorf(t), nzc - 2);
  }
  g = t - (float)j0;
  return j0;
}

// The first node (z_frac) and the weights of the KZ rows from it.  KZ = 3:
// the prefiltered quadratic-B-spline weights b2(j - 1 - t); KZ = 2: the
// hats max(0, 1 - |j - t|) (at t = nzc - 1 the first weight is 0).  The
// weights are those of every other row of the TPU's dense (rows, B) weight
// matrix, which are 0.
template <int KZ>
__device__ __forceinline__ int z_nodes(float t, int nzc, float w[KZ]) {
  float g;
  const int j0 = z_frac<KZ>(t, nzc, g);
  if constexpr (KZ == 3) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float u = fabsf((float)(j0 + k) - 1.0f - t);
      const float inner = 0.75f - u * u;
      const float outer = 0.5f * (1.5f - u) * (1.5f - u);
      w[k] = u <= 0.5f ? inner : (u <= 1.5f ? outer : 0.0f);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) w[k] = fmaxf(0.0f, 1.0f - fabsf((float)(j0 + k) - t));
  }
  return j0;
}

}  // namespace slab
