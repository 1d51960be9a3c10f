// Minimum-statistics noise-floor tracker over T frames in one launch.
//
// Replaces the JAX package's TPU kernel ops/pallas/floor.py (floor_scan_pallas
// -> _kernel):  floor[t] = min(floor[t-1] + rise, lb[t]),  over [T, B, nb].
//
// Bound on this card: bytes. Each element of lb is read once and each floor
// written once, 4 + 4 bytes per (t, b, band) and no reuse; the arithmetic is
// one add and one min. Design: one thread per (b, band) column, the carried
// floor in a register for the whole T loop, so the recurrence itself touches
// no memory; neighbouring threads take neighbouring bands, so every load and
// store of a warp is one contiguous 128-byte line.
//
// The result is bit-identical to the plain version: rise is a float (not a
// double), and fminf(f + rise, lb) is the same single-precision add and min
// (no multiply, so no contraction into an FMA). lb is never NaN here (it is a
// log of a sum plus a positive epsilon), where fminf and torch.minimum differ.

#include <cuda_runtime.h>

__global__ void floor_scan_kernel(const float* __restrict__ lb,
                                  const float* __restrict__ floor0,
                                  float* __restrict__ floors,
                                  float* __restrict__ floor_final,
                                  int T, int BN, float rise) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BN) return;
  float f = floor0[i];
  for (int t = 0; t < T; ++t) {
    f = fminf(__fadd_rn(f, rise), lb[(size_t)t * BN + i]);
    floors[(size_t)t * BN + i] = f;
  }
  floor_final[i] = f;
}

extern "C" int koala_floor_scan(const void* lb, const void* floor0, void* floors,
                                void* floor_final, int T, int BN, float rise,
                                void* stream) {
  const int threads = 128;
  const int blocks = (BN + threads - 1) / threads;
  if (blocks > 0) {
    floor_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)lb, (const float*)floor0, (float*)floors,
        (float*)floor_final, T, BN, rise);
  }
  return (int)cudaGetLastError();
}
