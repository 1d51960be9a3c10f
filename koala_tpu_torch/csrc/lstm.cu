// One layer-step of an LSTM over many independent rows, with its gates:
//
//   [x_t | h_{t-1}] @ W + b -> i, f, g, o;  c' = sig(f) c + sig(i) tanh(g);  h' = sig(o) tanh(c')
//
// It replaces no TPU kernel: the JAX package has no LSTM. It serves both
// recurrences of FullSubNet (models/fullsubnet.py): the sub-band LSTM on
// B x 257 rows (hidden 384) and the full-band LSTM on B rows (hidden 512).
// Numerics: x and h rounded to bf16 as they enter the product, W bf16, f32
// sums (tensor cores), f32 bias, gates, c and h.
//
// Bound on this card: at the sub-band's 526,336 rows (B = 2048) a layer-step
// is a [526336 x 416] @ [416 x 1536] or [526336 x 768] @ [768 x 1536]
// product, 0.67 or 1.24 TFLOP, beside 3.3 or 4.1 GB of f32 rows and states
// read and written: the two take about as long. Written unfused, the gates
// ([rows, 4H] f32) would go to device memory and back, another 6.5 GB.
//
// Design: the tiled product of tile_gemm.cuh, its epilogue the cell. A block
// takes 64 rows: it reads [x | 0 | h] once from device memory into shared
// memory as bf16 (x padded with zeros to a multiple of 16), then runs passes
// of 128 columns. The columns of a pass are the four gates of 32 hidden
// units: warp column wn gathers W's 8-column groups (gate ni, units u0 + 8 wn
// .. + 7) for ni = 0..3, so each thread ends the pass holding i, f, g and o of
// the same (row, unit) pairs in registers, and writes c' and h' (float2) with
// no gate leaving the SM. W stays in PyTorch's order ([K, 4H], gate blocks i,
// f, g, o): the pass's column functor does the gathering. Where the rows are
// few (the full-band's B, a stream's 257), blockIdx.y splits the passes over
// more blocks. A row's sums run over k in the same order whatever the row
// count and the split, so a stream's bits do not depend on the batch.

#include "tile_gemm.cuh"

namespace koala {
namespace {

constexpr int UNITS = NC / 4;   // hidden units of a pass

struct LstmArgs {
  const float* x;       // [M, kx] rows, stride ldx
  const float* h;       // [M, H], stride ldh
  const float* c;       // [M, H], stride ldc
  float* h_out;         // [M, H], stride ldho
  float* c_out;         // [M, H], stride ldco
  const bf16* w;        // [kxp + H, 4H]: rows 0..kx-1 W_ih^T, kx..kxp-1 zeros, then W_hh^T
  const float* bias;    // [4H]: b_ih + b_hh
  long long ldx, ldh, ldc, ldho, ldco;
  int M, kx, kxp, H, passes_per_block;
};

size_t lstm_smem(int K) {
  return align128((size_t)MT * (K + A_PAD) * sizeof(bf16)) + W_STAGES_BYTES;
}

// Rows m0 .. m0 + MT - 1 of a [M, width] f32 matrix into columns col0 ..
// col0 + width - 1 of the A tile as bf16; rows past M as zeros. Four columns
// at a time where the rows are 16-byte aligned.
__device__ __forceinline__ void load_rows(bf16* a_s, int lda, int col0, const float* src,
                                          long long ld, int width, long long m0, int M) {
  const bool vec = ((reinterpret_cast<size_t>(src) & 15) == 0) && (ld % 4 == 0) &&
                   (width % 4 == 0);
  if (vec) {
    const int q = width / 4;
    for (int i = threadIdx.x; i < MT * q; i += GEMM_THREADS) {
      const int r = i / q, k = (i % q) * 4;
      const long long m = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) v = __ldg(reinterpret_cast<const float4*>(src + m * ld + k));
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(a_s + r * lda + col0 + k);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
    for (int i = threadIdx.x; i < MT * width; i += GEMM_THREADS) {
      const int r = i / width, k = i % width;
      const long long m = m0 + r;
      a_s[r * lda + col0 + k] = __float2bfloat16(m < M ? __ldg(src + m * ld + k) : 0.0f);
    }
  }
}

__global__ void __launch_bounds__(GEMM_THREADS, 2) lstm_cell_kernel(const LstmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, K = a.kxp + H, lda = K + A_PAD;
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = reinterpret_cast<bf16*>(smem + align128((size_t)MT * lda * sizeof(bf16)));
  const long long m0 = (long long)blockIdx.x * MT;
  const int tid = threadIdx.x, wn = (tid >> 5) & 3, lane = tid & 31;

  load_rows(a_s, lda, 0, a.x, a.ldx, a.kx, m0, a.M);
  for (int i = tid; i < MT * (a.kxp - a.kx); i += GEMM_THREADS) {
    const int pad = a.kxp - a.kx;
    a_s[(i / pad) * lda + a.kx + i % pad] = __float2bfloat16(0.0f);
  }
  load_rows(a_s, lda, a.kxp, a.h, a.ldh, H, m0, a.M);
  // gemm_pass's first barrier orders these writes before the tile is read

  const int passes = (H + UNITS - 1) / UNITS;
  const int p_end = min(passes, (int)(blockIdx.y + 1) * a.passes_per_block);
  float acc[2][4][4];
  for (int p = blockIdx.y * a.passes_per_block; p < p_end; ++p) {
    const int u0 = p * UNITS;
    auto cols = [&](int g) {
      const int u = u0 + (g >> 2) * 8;
      return u < H ? (g & 3) * H + u : -1;
    };
    const bool active = u0 + wn * 8 < H;
    gemm_pass(acc, a_s, lda, K, a.w, 4 * H, cols, w_s, active);
    if (!active) continue;
    const int u = u0 + wn * 8 + acc_col(lane);
    const float bi0 = a.bias[u], bi1 = a.bias[u + 1];
    const float bf0 = a.bias[H + u], bf1 = a.bias[H + u + 1];
    const float bg0 = a.bias[2 * H + u], bg1 = a.bias[2 * H + u + 1];
    const float bo0 = a.bias[3 * H + u], bo1 = a.bias[3 * H + u + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + tile_row(mi, half);
        if (m >= a.M) continue;
        const int e = 2 * half;
        const float2 c = *reinterpret_cast<const float2*>(a.c + m * a.ldc + u);
        const float i0 = sigmoidf(acc[mi][0][e] + bi0), i1 = sigmoidf(acc[mi][0][e + 1] + bi1);
        const float f0 = sigmoidf(acc[mi][1][e] + bf0), f1 = sigmoidf(acc[mi][1][e + 1] + bf1);
        const float g0 = tanhf(acc[mi][2][e] + bg0), g1 = tanhf(acc[mi][2][e + 1] + bg1);
        const float o0 = sigmoidf(acc[mi][3][e] + bo0), o1 = sigmoidf(acc[mi][3][e + 1] + bo1);
        const float c0 = f0 * c.x + i0 * g0, c1 = f1 * c.y + i1 * g1;
        *reinterpret_cast<float2*>(a.c_out + m * a.ldco + u) = make_float2(c0, c1);
        *reinterpret_cast<float2*>(a.h_out + m * a.ldho + u) =
            make_float2(o0 * tanhf(c0), o1 * tanhf(c1));
      }
  }
}

}  // namespace
}  // namespace koala

using koala::LstmArgs;

// One layer-step; grid (row tiles, pass groups) as the caller plans it.
extern "C" int koala_lstm_cell(const void* x, const void* h, const void* c, void* h_out,
                               void* c_out, const void* w, const void* bias, long long ldx,
                               long long ldh, long long ldc, long long ldho, long long ldco, int M,
                               int kx, int kxp, int H, int passes_per_block, int grid_y,
                               void* stream) {
  if (M < 1 || kx < 1 || kxp < kx || kxp % 16 || H < 16 || H % 16 || passes_per_block < 1 ||
      grid_y < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = koala::lstm_smem(kxp + H);
  // the attribute is set once a device, for the largest ask so far
  static size_t set_to[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > set_to[dev]) {
    err = cudaFuncSetAttribute(koala::lstm_cell_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    set_to[dev] = smem;
  }
  LstmArgs a{static_cast<const float*>(x), static_cast<const float*>(h),
             static_cast<const float*>(c), static_cast<float*>(h_out),
             static_cast<float*>(c_out), static_cast<const koala::bf16*>(w),
             static_cast<const float*>(bias), ldx, ldh, ldc, ldho, ldco, M, kx, kxp, H,
             passes_per_block};
  const dim3 grid((unsigned)((M + koala::MT - 1) / koala::MT), (unsigned)grid_y);
  koala::lstm_cell_kernel<<<grid, koala::GEMM_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
