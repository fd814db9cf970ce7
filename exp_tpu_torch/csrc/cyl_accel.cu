// EOF cylinder force pass (K5) for Hopper, CUDA-core FP32.
//
// Replaces: exp_tpu/ops/pallas_cylinder.py make_cyl_accel_kernel (the TPU
// kernel at its pallas_call, :257), CylinderForce's pallas force pass for
// both pallas_interp='spline' (the default) and 'linear'.
//
// Computes, for particles x (N, 3) and the coefficient-contracted coarse
// table Ct (xrows, ncy, SP) (ops/cyl_kernels.contract_coef_tables: per node
// S = 6(M+1) values v[q(M+1) + m], q over pot, dU/dR, dU/dz x cos, sin,
// padded to SP = a multiple of 4):
//   (R, z) shrunk onto the table sphere by rmax_grid / r beyond it,
//   v = the x (3 spline or 2 hat weights) and y (2 hats) interpolation of
//       Ct at the shrunk point,
//   pot = sum_m v_pot,c cos + v_pot,s sin, F_R, F_z likewise with minus
//   signs, F_phi = sum_m m (v_pot,c sin - v_pot,s cos) / R (unshrunk R),
// assembled into Cartesian (ax, ay, az) and pot, with the monopole
// continuation Phi_b r_b / r beyond rmax_grid.
//
// What bounds it on an H100, at the disk bench's shapes (mmax=6, xrows=66,
// ncy=128, N = 2^20, 'spline'): operations.  It moves 28 bytes a particle
// (12 read, 16 written) and the table once: 30.8 MB, 9.2 us at 3.35 TB/s;
// the function needs at least about 754 FP32 operations a particle (the 6
// node weights once, then 6 FMAs for each of the 42 values, the geometry,
// arcsinh, weights, trig and the 7-term assembly): 0.79 GFLOP, 11.8 us at
// 67 TFLOP/s.  This kernel spends 3 more operations a value, as the TPU
// kernel's order wx (wy0 b0 + wy1 b1) does.  The table (1.5 MB) stays in
// L2; each particle gathers 6 rows.
//
// Design: one thread per particle, grid-stride over a grid sized to fill
// the card once.  Only the 6 nonzero (x, y) nodes are read (the TPU
// multiplied the whole (xrows * Sp, ncyp) table by a dense (ncyp, B) weight
// matrix), each as SP/4 16-byte loads of one contiguous row, through the
// read-only cache.  The template on MMAX keeps v, the trig rows and the
// assembly in registers.  The y node past the last row (ty == ncy - 1, the
// TPU's zero pad row) has weight 0 and an index held in range.
#include "cyl_common.cuh"

namespace {

using cyl::Params;

constexpr int kThreads = 256;

template <int MMAX>
struct Layout {
  static constexpr int M1 = MMAX + 1;
  static constexpr int S = 6 * M1;
  static constexpr int SP = (S + 3) / 4 * 4;
};

template <int MMAX, bool SPLINE>
__global__ void __launch_bounds__(kThreads)
accel_kernel(const float* __restrict__ x, long long n, const float* __restrict__ Ct,
             Params q, float* __restrict__ acc, float* __restrict__ pot) {
  constexpr int M1 = Layout<MMAX>::M1, SP = Layout<MMAX>::SP;
  constexpr int KX = cyl::XNodes<SPLINE>::K;
  const int ncy = q.ncy;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2];
    float R, r;
    cyl::cyl_maps(px, py, pz, R, r);
    const float cphi = px / R, sphi = py / R;
    const bool outside = r > q.rmax_grid;
    const float shrink = outside ? q.rmax_grid / r : 1.0f;
    float tx, ty;
    cyl::grid_coords(R * shrink, pz * shrink, q, tx, ty);
    int jx[KX], jy[2];
    float wx[KX], wy[2];
    cyl::x_weights<SPLINE>(tx, q.ncx, jx, wx);
    cyl::y_weights(ty, ncy, jy, wy);

    // v = sum_a wx_a (wy_0 Ct[jx_a, jy_0] + wy_1 Ct[jx_a, jy_1]), the TPU's
    // (Ct @ Wy) then the x-weighted sum
    float v[SP];
#pragma unroll
    for (int k = 0; k < SP; ++k) v[k] = 0.0f;
#pragma unroll
    for (int a = 0; a < KX; ++a) {
      const float4* r0 = reinterpret_cast<const float4*>(Ct + ((long long)jx[a] * ncy + jy[0]) * SP);
      const float4* r1 = reinterpret_cast<const float4*>(Ct + ((long long)jx[a] * ncy + jy[1]) * SP);
#pragma unroll
      for (int k = 0; k < SP / 4; ++k) {
        const float4 b0 = __ldg(r0 + k), b1 = __ldg(r1 + k);
        v[4 * k + 0] += wx[a] * (wy[0] * b0.x + wy[1] * b1.x);
        v[4 * k + 1] += wx[a] * (wy[0] * b0.y + wy[1] * b1.y);
        v[4 * k + 2] += wx[a] * (wy[0] * b0.z + wy[1] * b1.z);
        v[4 * k + 3] += wx[a] * (wy[0] * b0.w + wy[1] * b1.w);
      }
    }

    float c[M1], s[M1];
    cyl::trig_rows<MMAX>(cphi, sphi, c, s);
    float p = 0.0f, FR = 0.0f, Fz = 0.0f, Fp = 0.0f;
#pragma unroll
    for (int m = 0; m < M1; ++m) {
      const float cmn = v[m], smn = v[M1 + m];
      p += cmn * c[m] + smn * s[m];
      FR -= v[2 * M1 + m] * c[m] + v[3 * M1 + m] * s[m];
      Fz -= v[4 * M1 + m] * c[m] + v[5 * M1 + m] * s[m];
      if (m) Fp += (float)m * (cmn * s[m] - smn * c[m]);
    }
    Fp = Fp / R;

    // monopole continuation beyond the table sphere: Phi -> Phi_b r_b / r
    float ax, ay, az;
    if (outside) {
      const float Fr_out = p * shrink / r;
      ax = Fr_out * px / r;
      ay = Fr_out * py / r;
      az = Fr_out * pz / r;
      p = p * shrink;
    } else {
      ax = FR * cphi - Fp * sphi;
      ay = FR * sphi + Fp * cphi;
      az = Fz;
    }
    acc[3 * i] = ax;
    acc[3 * i + 1] = ay;
    acc[3 * i + 2] = az;
    pot[i] = p;
  }
}

template <int MMAX, bool SPLINE>
cudaError_t launch(const float* x, long long n, const float* Ct, const Params& q,
                   float* acc, float* pot, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, accel_kernel<MMAX, SPLINE>, kThreads, 0)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long full = (long long)nsm * per_sm;
  const int grid = (int)(need < full ? need : full);
  accel_kernel<MMAX, SPLINE><<<grid, kThreads, 0, stream>>>(x, n, Ct, q, acc, pot);
  return cudaGetLastError();
}

template <bool SPLINE>
cudaError_t dispatch(const float* x, long long n, const float* Ct, const Params& q,
                     float* acc, float* pot, cudaStream_t s) {
  switch (q.mmax) {
    case 0: return launch<0, SPLINE>(x, n, Ct, q, acc, pot, s);
    case 1: return launch<1, SPLINE>(x, n, Ct, q, acc, pot, s);
    case 2: return launch<2, SPLINE>(x, n, Ct, q, acc, pot, s);
    case 3: return launch<3, SPLINE>(x, n, Ct, q, acc, pot, s);
    case 4: return launch<4, SPLINE>(x, n, Ct, q, acc, pot, s);
    case 5: return launch<5, SPLINE>(x, n, Ct, q, acc, pot, s);
    case 6: return launch<6, SPLINE>(x, n, Ct, q, acc, pot, s);
    case 7: return launch<7, SPLINE>(x, n, Ct, q, acc, pot, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (n, 3), Ct (xrows, ncy, SP) contracted table with SP = 6(mmax+1) rounded
// up to a multiple of 4 and xrows = ncx + 2 ('spline') or ncx ('linear');
// outputs acc (n, 3) and pot (n,).  All f32, contiguous, on the current
// device (Ct 16-byte aligned).  Returns a cudaError_t.
int cyl_accel_launch(const void* x, long long n, const void* Ct, void* acc, void* pot,
                     int spline, int mmax, int ncx, int ncy, float acyl,
                     float hcyl, float xmin, float dxc, float ymin, float dy,
                     float rmax_grid, void* stream) {
  Params q{mmax, ncx, ncy, acyl, hcyl, xmin, dxc, ymin, dy, rmax_grid};
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto cf = static_cast<const float*>(Ct);
  auto af = static_cast<float*>(acc);
  auto pf = static_cast<float*>(pot);
  return spline ? dispatch<true>(xf, n, cf, q, af, pf, s)
                : dispatch<false>(xf, n, cf, q, af, pf, s);
}

const char* cyl_accel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
