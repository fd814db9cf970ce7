// Accumulation probe of the tensor cores (probe_cube_split.py): how an
// mma.sync f32 accumulator rounds a long sum of TF32 products, with and
// without promotion into an f32 register sum every `period` k-steps,
// against sequential f32 FMAs.  Not on any simulation path; built only by
// the probe.
//
// Each warp computes one trial D = A B with A (16, K) row-major and B (K, 8)
// row-major, over K / 8 k-steps of m16n8k8:
//   mode 0  one TF32 pass of the inputs as given (tf32::round; inputs that are
//           already TF32 values are taken exactly);
//   mode 1  the three split passes (tf32_mma.cuh mma3) into one accumulator;
//   mode 2  the three split passes, the two small ones into a second
//           accumulator;
//   mode 3  f32 FMAs on the CUDA cores, each lane its four outputs, k in
//           order.
// With period > 0 the accumulators are added into an f32 register sum and
// zeroed after every `period` k-steps (modes 0-2).
#include "tf32_mma.cuh"

namespace {

__global__ void accum_kernel(const float* __restrict__ A, const float* __restrict__ B,
                             float* __restrict__ D, int K, int mode, int period) {
  const int lane = threadIdx.x % 32;
  const long long trial = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const float* a = A + trial * 16 * K;
  const float* b = B + trial * (long long)K * 8;
  const int g = lane / 4, t = lane % 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, small[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (mode == 3) {
    for (int k = 0; k < K; ++k) {
      sum[0] = fmaf(a[g * K + k], b[k * 8 + 2 * t], sum[0]);
      sum[1] = fmaf(a[g * K + k], b[k * 8 + 2 * t + 1], sum[1]);
      sum[2] = fmaf(a[(g + 8) * K + k], b[k * 8 + 2 * t], sum[2]);
      sum[3] = fmaf(a[(g + 8) * K + k], b[k * 8 + 2 * t + 1], sum[3]);
    }
  } else {
    for (int s = 0; s < K / 8; ++s) {
      const int k0 = 8 * s;
      const float av[4] = {a[g * K + k0 + t], a[(g + 8) * K + k0 + t],
                           a[g * K + k0 + t + 4], a[(g + 8) * K + k0 + t + 4]};
      const float bv[2] = {b[(k0 + t) * 8 + g], b[(k0 + t + 4) * 8 + g]};
      uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const tf32::Split q = tf32::split(av[i]);
        ah[i] = q.hi;
        al[i] = q.lo;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const tf32::Split q = tf32::split(bv[i]);
        bh[i] = q.hi;
        bl[i] = q.lo;
      }
      if (mode == 0) {
        tf32::mma(acc, ah, bh);
      } else if (mode == 1) {
        tf32::mma3(acc, ah, al, bh, bl);
      } else {
        tf32::mma(small, al, bh);
        tf32::mma(small, ah, bl);
        tf32::mma(acc, ah, bh);
      }
      if (period > 0 && (s + 1) % period == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sum[i] += acc[i] + small[i];
          acc[i] = 0.0f;
          small[i] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sum[i] += acc[i] + small[i];
  }
  float* d = D + trial * 128;
  d[g * 8 + 2 * t] = sum[0];
  d[g * 8 + 2 * t + 1] = sum[1];
  d[(g + 8) * 8 + 2 * t] = sum[2];
  d[(g + 8) * 8 + 2 * t + 1] = sum[3];
}

}  // namespace

extern "C" {

// A (trials, 16, K), B (trials, K, 8), D (trials, 16, 8), f32, contiguous;
// K a multiple of 8, trials a multiple of 4.  Returns a cudaError_t.
int probe_tf32_accum_launch(const void* A, const void* B, void* D, int trials, int K,
                            int mode, int period, void* stream) {
  if (trials < 4 || trials % 4 || K < 8 || K % 8 || mode < 0 || mode > 3 || period < 0)
    return cudaErrorInvalidValue;
  accum_kernel<<<trials / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B), static_cast<float*>(D), K,
      mode, period);
  return cudaGetLastError();
}

const char* probe_tf32_accum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
