// Device helpers of the plane-wave kernels (cube_coef.cu, cube_accel.cu; the
// slab's kernels are to include this header too): the periodic wrap and the
// per-axis phase rows e^{sign 2 pi i k u}, k = -nmax..nmax.
//
// The phases: one sincospif(2u) a particle and axis, then the powers by
// angle addition, e^{i k t} = e^{i (k-1) t} e^{i t} (the reference's
// cudaCube.cu recurrence).  sincospif reduces its argument exactly and 2u is
// exact in f32, so e^{i t} is correctly rounded to within an ulp; the k-th
// power carries about k ulps more.  Negative k take the conjugate of the
// positive power, so a row is conjugate-symmetric exactly.  The plain
// versions (ops/cube_kernels.py) and the JAX kernels compute cos/sin of the
// rounded angle (2 pi)(k u) instead, whose rounding (|angle| up to 2 pi nmax)
// is the larger error: about 2e-6 absolute at nmax = 6.
//
// No fast-math intrinsics (__sinf, __cosf) anywhere: their error grows with
// the argument.
#pragma once

#include <cuda_runtime.h>

namespace cube {

constexpr float kTwoPi = 6.28318530717958647692f;

// u = x - floor(x) in [0, 1], floor-based as the JAX kernels wrap
// (u - jnp.floor(u)), so negative x wraps up (fmod would not).  Positions
// are not wrapped in the state, so |x| grows over a run.
__device__ __forceinline__ float wrap(float x) { return x - floorf(x); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj(float2 a) { return make_float2(a.x, -a.y); }

// e^{sign 2 pi i u} for sign = +1 or -1
__device__ __forceinline__ float2 unit_phase(float u, float sign) {
  float s, c;
  sincospif(2.0f * u, &s, &c);
  return make_float2(c, sign * s);
}

// row[k] = e1^k for k = 0..nmax (nonnegative wavenumbers only)
__device__ __forceinline__ void powers(float2 e1, int nmax, float2* row) {
  float2 p = make_float2(1.0f, 0.0f);
  row[0] = p;
  for (int k = 1; k <= nmax; ++k) {
    p = cmul(p, e1);
    row[k] = p;
  }
}

// row[nmax + k] = w e1^k and row[nmax - k] = w conj(e1^k), k = 0..nmax
__device__ __forceinline__ void axis_row(float2 e1, int nmax, float w, float2* row) {
  float2 p = make_float2(1.0f, 0.0f);
  row[nmax] = make_float2(w, 0.0f);
  for (int k = 1; k <= nmax; ++k) {
    p = cmul(p, e1);
    row[nmax + k] = make_float2(w * p.x, w * p.y);
    row[nmax - k] = make_float2(w * p.x, -(w * p.y));
  }
}

// The same row in registers, for a row length K = 2 nmax + 1 fixed at
// compile time.
template <int K>
__device__ __forceinline__ void axis_row(float2 e1, float2 (&row)[K]) {
  constexpr int N = (K - 1) / 2;
  float2 p = make_float2(1.0f, 0.0f);
  row[N] = p;
#pragma unroll
  for (int k = 1; k <= N; ++k) {
    p = cmul(p, e1);
    row[N + k] = p;
    row[N - k] = conj(p);
  }
}

}  // namespace cube
