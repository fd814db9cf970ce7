// What the tensor-core cube kernels (cube_coef.cu K7, cube_accel.cu K8)
// share: the half (kx, ky) lattice, a particle's x and y phase rows, and
// its kz phases folded into cosines and sines, split for the tensor cores.
//
// Real masses (K7) and real outputs (K8) let both kernels sum over half the
// (kx, ky) lattice: kx = 0 with ky = 0..nmaxy first, then kx = 1..nmaxx
// with every ky.  The kz axis folds into the 2 nmaxz + 1 phases [c_0..c_nz,
// s_1..s_nz], c_q = cos 2 pi q uz and s_q = sin 2 pi q uz.
#pragma once

#include "cube_common.cuh"
#include "tf32_mma.cuh"

namespace cube {

// (a, b) of pair q of the half lattice
__device__ __forceinline__ void half_pair(int q, int nmaxy, int& a, int& b) {
  if (q <= nmaxy) {
    a = 0;
    b = q;
  } else {
    const int ky = 2 * nmaxy + 1;
    const int r = q - (nmaxy + 1);
    a = 1 + r / ky;
    b = r % ky - nmaxy;
  }
}

// A particle's phase rows, element k at r[k stride]: ex^a for a = 0..nmaxx,
// then ey^b for b = -nmaxy..nmaxy (the negative b the conjugates), powers
// by angle addition as cube::powers and cube::axis_row make them.
__device__ __forceinline__ void xy_rows(float2 ex, float2 ey, int nmaxx, int nmaxy, float2* r,
                                        int stride) {
  float2 pw = make_float2(1.0f, 0.0f);
  r[0] = pw;
  for (int a = 1; a <= nmaxx; ++a) {
    pw = cmul(pw, ex);
    r[a * stride] = pw;
  }
  float2* ry = r + (nmaxx + 1 + nmaxy) * stride;
  pw = make_float2(1.0f, 0.0f);
  ry[0] = pw;
  for (int b = 1; b <= nmaxy; ++b) {
    pw = cmul(pw, ey);
    ry[b * stride] = pw;
    ry[-b * stride] = conj(pw);
  }
}

// A particle's fold columns w c_0, w c_1..w c_nz, w s_1..w s_nz of ez =
// e^{2 pi i uz}, then zeros up to COLS, each split into TF32 hi + lo at
// hi[c stride] and lo[c stride].
template <int COLS>
__device__ __forceinline__ void fold_columns(float2 ez, int nmaxz, float w, float* hi, float* lo,
                                             int stride) {
  float2 pw = make_float2(1.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    float v = 0.0f;
    if (c == 0) {
      v = w;
    } else if (c <= nmaxz) {
      pw = cmul(pw, ez);
      v = w * pw.x;
    } else if (c <= 2 * nmaxz) {
      if (c == nmaxz + 1) pw = make_float2(1.0f, 0.0f);
      pw = cmul(pw, ez);
      v = w * pw.y;
    }
    const tf32::Split q = tf32::split(v);
    hi[c * stride] = __uint_as_float(q.hi);
    lo[c * stride] = __uint_as_float(q.lo);
  }
}

}  // namespace cube
