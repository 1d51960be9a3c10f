// Whole L-layer GRU recurrence over T steps in one launch.
//
// Replaces the JAX package's TPU kernel ops/pallas/gru.py (gru_stack_pallas ->
// _kernel), forward only. Per step t and layer l, with x_0 = x[t]:
//   xp = bf16(x_l) @ wx_l + bx_l,  hp = bf16(h_l) @ wh_l + bh_l  (f32 sums)
//   h_l' = gates(h_l, hp, xp);  x_{l+1} = x_l + h_l' (f32), re-cast to bf16
//   y[t] = x_L (bf16)
//
// Bound on this card: at the main path's shapes (B = 64, T = 376, H = 384,
// L = 2) the least time is set by operations, the bf16 products on the
// tensor cores (85 GFLOP, about 86 us); the bytes (x in, y out, h in and
// out, the 3.5 MB of bf16 weights once) take about 12 us. What actually
// limits this design is the weights: the recurrence is sequential in t, and
// each block reads all 2L weight matrices from L2 on every step.
// Design: streams never interact, so one block owns ROWS = 16 stream rows
// for the whole T x L loop. Its hidden state (L x 16 x H f32, 48 KB at
// H = 384, L = 2), the residual stream and the bf16 operands stay in shared
// memory; the products run on the tensor cores (WMMA, bf16 in, f32 sums)
// with the weights read as bf16 straight from device memory, where the L2
// keeps them resident. It does not copy the TPU design of all weights held
// in one core's fast memory: 3.5 MB does not fit one SM. Rows past B are
// zero and never stored, so any B >= 1 is taken.

#include "common.cuh"

using namespace koala;

constexpr int GRU_WARPS = 12;

static size_t gru_smem_bytes(int H, int L) {
  return align128((size_t)L * ROWS * H * 4)     // h, f32, per layer
         + align128((size_t)ROWS * H * 4)       // residual stream x_f, f32
         + 2 * align128((size_t)ROWS * H * 2)   // x_bf, h_bf
         + align128((size_t)GRU_WARPS * 4 * 256 * 4);  // per-warp gate staging
}

__global__ void __launch_bounds__(GRU_WARPS * 32)
    gru_stack_kernel(const bf16* __restrict__ x, const float* __restrict__ h0,
                     const bf16* __restrict__ wx, const float* __restrict__ bx,
                     const bf16* __restrict__ wh, const float* __restrict__ bh,
                     bf16* __restrict__ y, float* __restrict__ h_final, int T, int B, int H,
                     int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* h_s = reinterpret_cast<float*>(smem);
  float* xf_s = reinterpret_cast<float*>(smem + align128((size_t)L * ROWS * H * 4));
  bf16* xbf_s = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(xf_s) +
                                        align128((size_t)ROWS * H * 4));
  bf16* hbf_s = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(xbf_s) +
                                        align128((size_t)ROWS * H * 2));
  float* stage = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(hbf_s) +
                                          align128((size_t)ROWS * H * 2));

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthreads / 32;
  const int row0 = blockIdx.x * ROWS;
  const int RH = ROWS * H;

  for (int i = tid; i < L * RH; i += nthreads) {
    const int l = i / RH, r = (i / H) % ROWS, j = i % H;
    const int b = row0 + r;
    h_s[i] = b < B ? h0[((size_t)l * B + b) * H + j] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < RH; i += nthreads) {
      const int b = row0 + i / H;
      const bf16 v = b < B ? x[((size_t)t * B + b) * H + i % H] : __float2bfloat16(0.0f);
      xbf_s[i] = v;
      xf_s[i] = __bfloat162float(v);
    }
    for (int l = 0; l < L; ++l) {
      float* hl = h_s + (size_t)l * RH;
      for (int i = tid; i < RH; i += nthreads) hbf_s[i] = __float2bfloat16(hl[i]);
      __syncthreads();
      gru_layer16(xbf_s, hbf_s, hl, xf_s, wx + (size_t)l * H * 3 * H, bx + (size_t)l * 3 * H,
                  wh + (size_t)l * H * 3 * H, bh + (size_t)l * 3 * H, H, stage, warp, nwarps,
                  lane);
      __syncthreads();
      for (int i = tid; i < RH; i += nthreads) xbf_s[i] = __float2bfloat16(xf_s[i]);
    }
    __syncthreads();
    for (int i = tid; i < RH; i += nthreads) {
      const int b = row0 + i / H;
      if (b < B) y[((size_t)t * B + b) * H + i % H] = xbf_s[i];
    }
  }
  for (int i = tid; i < L * RH; i += nthreads) {
    const int l = i / RH, r = (i / H) % ROWS, j = i % H;
    const int b = row0 + r;
    if (b < B) h_final[((size_t)l * B + b) * H + j] = h_s[i];
  }
}

extern "C" int koala_gru_stack(const void* x, const void* h0, const void* wx, const void* bx,
                               const void* wh, const void* bh, void* y, void* h_final, int T,
                               int B, int H, int L, void* stream) {
  const size_t smem = gru_smem_bytes(H, L);
  cudaError_t err = cudaFuncSetAttribute(gru_stack_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + ROWS - 1) / ROWS;
  gru_stack_kernel<<<blocks, GRU_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)h0, (const bf16*)wx, (const float*)bx, (const bf16*)wh,
      (const float*)bh, (bf16*)y, (float*)h_final, T, B, H, L);
  return (int)cudaGetLastError();
}
