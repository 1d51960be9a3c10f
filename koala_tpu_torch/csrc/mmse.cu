// The mmse model's gain recurrence over T frames in one launch
// (models/mmse.py, ops/kernels/mmse.py):
//
//   gamma = clamp(power / max(noise, 1e-10), 0, cap)          power = re^2 + im^2
//   xi    = clamp(beta prev + (1 - beta) max(gamma - 1, 0), 0, cap)
//   gain  = xi / (1 + xi);  mask = max(gain, floor)
//   noise = max(noise + boot / (1 + xi) (power - noise), 1e-10)
//   prev  = clamp(gain gain gamma, 0, cap);  count += 1
//   boot  = clamp(1 / (count + 1), 1 - alpha, 1)     (count before the frame)
//
// It replaces no TPU kernel: the JAX package runs this rule as a lax.scan of
// plain jnp, outside any Pallas kernel. Here its plain version is a Python
// loop of about 29 elementwise launches a frame, so the host, not the card,
// paced a corpus wash.
//
// Bound on this card: bytes. re and im are read once and the mask written
// once, [N, T, K] f32 each, the state [N, K] both ways; about 40 operations
// and four divisions an element against 12 bytes. At the wash's
// [8192, 375, 257] that is 9.51 GB, 2.84 ms at 3.35 TB/s.
//
// Design: the recurrence is elementwise in (stream, bin), so a thread owns
// one column (n, k), indexed n K + k: a warp reads 32 neighbouring bins of
// one frame, and walks t = 0 .. T-1 with the state in registers. What a
// column-per-thread loop pays is the latency of T loads in a row: each
// thread copies its own column's frames into its own slots of shared memory
// with cp.async, MMSE_SEG frames a segment and MMSE_STAGES segments in its
// ring, so three segments are in flight while it takes the fourth; no thread
// reads another's slots, so no barrier. (A register ring of the next frames
// read 1.4 times slower: the divisions' branches kept the loads from running
// ahead.) Measured on an NVIDIA H100 80GB HBM3 at 700 W: 4.72 ms at [8192,
// 375, 257], 60% of the bound. What is left is __fdiv_rn's range check and
// its branch, four a frame; dividing without them read 4.17 ms, but moved a
// corpus wash by 0.3%, inside its runs' spread.
//
// Numerics: the same bits as the plain chain (ops/kernels/mmse.py
// gain_frame) on the card. Every product, sum and difference is written with
// the _rn intrinsics, so nvcc contracts nothing into an FMA; divisions are
// IEEE, as torch's true division and reciprocal are; clamp is
// min(max(v, lo), hi) and passes a NaN through, as torch's does; the
// operations keep the plain chain's order; the scalars arrive as floats,
// rounded once from Python's doubles as torch rounds a Python scalar.

#include <cuda_runtime.h>

#include "resident.cuh"

namespace {

constexpr int MMSE_THREADS = 256;
constexpr int MMSE_SEG = 8;      // frames a segment
constexpr int MMSE_STAGES = 4;   // segments in a thread's ring: one taken, three arriving
// [stage][frame][re | im][thread]
constexpr size_t MMSE_SMEM = (size_t)MMSE_STAGES * MMSE_SEG * 2 * MMSE_THREADS * sizeof(float);

struct GainRule {
  float beta, one_minus_beta, boot_min, gain_floor, snr_cap, noise_min;
};

__device__ __forceinline__ float clamp_both(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_low(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// One frame of the rule; the mask is returned.
__device__ __forceinline__ float frame(float r, float i, float& noise, float& prev, float& count,
                                       const GainRule& g) {
  const float power = __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i));
  const float next_count = __fadd_rn(count, 1.0f);
  const float boot = clamp_both(__fdiv_rn(1.0f, next_count), g.boot_min, 1.0f);
  const float gamma = clamp_both(__fdiv_rn(power, clamp_low(noise, g.noise_min)), 0.0f, g.snr_cap);
  const float xi = clamp_both(
      __fadd_rn(__fmul_rn(prev, g.beta),
                __fmul_rn(clamp_low(__fsub_rn(gamma, 1.0f), 0.0f), g.one_minus_beta)),
      0.0f, g.snr_cap);
  const float xi_1 = __fadd_rn(xi, 1.0f);
  const float gain = __fdiv_rn(xi, xi_1);
  const float rate = __fdiv_rn(boot, xi_1);
  noise = clamp_low(__fadd_rn(noise, __fmul_rn(rate, __fsub_rn(power, noise))), g.noise_min);
  prev = clamp_both(__fmul_rn(__fmul_rn(gain, gain), gamma), 0.0f, g.snr_cap);
  count = next_count;
  return clamp_low(gain, g.gain_floor);
}

__global__ void __launch_bounds__(MMSE_THREADS)
    mmse_gain_kernel(const float* __restrict__ re, const float* __restrict__ im,
                     const float* __restrict__ noise0, const float* __restrict__ prev0,
                     const float* __restrict__ count0, float* __restrict__ mask,
                     float* __restrict__ noise_out, float* __restrict__ prev_out,
                     float* __restrict__ count_out, int N, int T, int K, GainRule g) {
  extern __shared__ __align__(16) float slots[];
  const int tid = threadIdx.x;
  const long long col = (long long)blockIdx.x * MMSE_THREADS + tid;
  if (col >= (long long)N * K) return;
  const int n = (int)(col / K), k = (int)(col - (long long)n * K);
  const size_t base = (size_t)n * T * K + k;
  const float* r_in = re + base;
  const float* i_in = im + base;
  float* m_out = mask + base;
  float noise = noise0[col], prev = prev0[col], count = count0[n];
  const int segments = (T + MMSE_SEG - 1) / MMSE_SEG;
  auto slot = [&](int seg, int f, int part) {
    return slots + (((seg % MMSE_STAGES) * MMSE_SEG + f) * 2 + part) * MMSE_THREADS + tid;
  };
  // one group a segment, an empty one past the last, so that the waits count alike
  auto load = [&](int seg) {
    if (seg < segments) {
      const int t0 = seg * MMSE_SEG, frames = min(MMSE_SEG, T - t0);
      for (int f = 0; f < frames; ++f) {
        koala::cp_async4(slot(seg, f, 0), r_in + (size_t)(t0 + f) * K, 4);
        koala::cp_async4(slot(seg, f, 1), i_in + (size_t)(t0 + f) * K, 4);
      }
    }
    koala::cp_async_commit();
  };
  auto step = [&](int seg, int f) {
    const float m = frame(*slot(seg, f, 0), *slot(seg, f, 1), noise, prev, count, g);
    __stcs(m_out + (size_t)(seg * MMSE_SEG + f) * K, m);
  };

#pragma unroll
  for (int s = 0; s < MMSE_STAGES - 1; ++s) load(s);
  for (int seg = 0; seg < segments; ++seg) {
    // the slot of segment seg + 3 is the one segment seg - 1 left
    load(seg + MMSE_STAGES - 1);
    koala::cp_async_wait<MMSE_STAGES - 1>();
    const int frames = min(MMSE_SEG, T - seg * MMSE_SEG);
    if (frames == MMSE_SEG) {
#pragma unroll
      for (int f = 0; f < MMSE_SEG; ++f) step(seg, f);
    } else {
      for (int f = 0; f < frames; ++f) step(seg, f);
    }
  }
  noise_out[col] = noise;
  prev_out[col] = prev;
  if (k == 0) count_out[n] = count;
}

}  // namespace

// re, im, mask [N, T, K] f32; noise0, prev0, noise, prev [N, K]; count0,
// count [N]; all contiguous, the outputs apart from the inputs. T = 0 copies
// the state.
extern "C" int koala_mmse_gain(const void* re, const void* im, const void* noise0,
                               const void* prev0, const void* count0, void* mask, void* noise,
                               void* prev, void* count, int N, int T, int K, float beta,
                               float one_minus_beta, float boot_min, float gain_floor,
                               float snr_cap, float noise_min, void* stream) {
  if (N < 0 || T < 0 || K < 0) return (int)cudaErrorInvalidValue;
  const long long cols = (long long)N * K;
  if (cols == 0) return (int)cudaGetLastError();
  const cudaError_t err = cudaFuncSetAttribute(
      mmse_gain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MMSE_SMEM);
  if (err != cudaSuccess) return (int)err;
  const GainRule g{beta, one_minus_beta, boot_min, gain_floor, snr_cap, noise_min};
  const long long blocks = (cols + MMSE_THREADS - 1) / MMSE_THREADS;
  mmse_gain_kernel<<<(unsigned)blocks, MMSE_THREADS, MMSE_SMEM, (cudaStream_t)stream>>>(
      (const float*)re, (const float*)im, (const float*)noise0, (const float*)prev0,
      (const float*)count0, (float*)mask, (float*)noise, (float*)prev, (float*)count, N, T, K,
      g);
  return (int)cudaGetLastError();
}
