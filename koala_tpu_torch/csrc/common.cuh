// Device helpers of the 16-row tiling: the fused engine kernel
// (engine_fused.cu) is built from them. The GRU-stack kernel (gru.cu) is a
// persistent column-split grid built from resident.cuh and takes only the
// types and align128 from here.
//
// The fused kernel gives one thread block a tile of ROWS = 16 stream rows for
// the whole T loop (streams never interact), keeps that tile's activations
// and state in shared memory, and runs every product on the tensor cores
// through the warp-level WMMA interface: A = activations as bf16 in shared memory,
// B = weights as bf16 read from device memory (they stay resident in the
// 50 MB L2 across the T loop), f32 accumulators. That is the numerics of the
// JAX package's compute_dtype=bfloat16 products: both operands rounded to
// bf16, products summed in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace koala {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int ROWS = 16;   // stream rows per block (= the WMMA tile height)
constexpr int TILE = 16;   // WMMA tile width and depth

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// jax.nn.gelu's default form (approximate=True): the tanh approximation.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

// Round up to a multiple of 32 floats (128 bytes), for shared-memory carving.
__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// C[16][N] = A[16][K] @ W[K][N]. A: bf16 in shared memory, row stride lda.
// W: bf16 in device memory, row stride ldw. C: f32 in shared memory, row
// stride ldc. K and N are multiples of 16; the N/16 output tiles are dealt
// round-robin to the block's warps. No block-wide barrier inside.
__device__ __forceinline__ void mm_rows16(const bf16* A, int lda, const bf16* __restrict__ W,
                                          int ldw, int K, int N, float* C, int ldc, int warp,
                                          int nwarps) {
  for (int nt = warp; nt < N / TILE; nt += nwarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
    for (int k = 0; k < K / TILE; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + k * TILE, lda);
      wmma::load_matrix_sync(b, W + (size_t)k * TILE * ldw + nt * TILE, ldw);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + nt * TILE, acc, ldc, wmma::mem_row_major);
  }
}

// One GRU layer for the block's 16 rows, gate math as in the JAX package's
// _gru_gates (z, r, n order in the 3H columns):
//   z = sig(xz + hz), r = sig(xr + hr), n = tanh(xn + r * hn),
//   h' = (1 - z) n + z h,  then the residual x_f += h'.
// x_bf, h_bf: [16][H] bf16 (shared), the layer's inputs. h: [16][H] f32
// (shared), updated in place. x_f: [16][H] f32 (shared), updated in place.
// wx, wh: [H][3H] bf16, bx, bh: [3H] f32 (device). stage: 4 x 256 floats per
// warp (shared). Each warp owns whole 16-column tiles of h, so no element
// is touched by two warps. The caller brackets the call with barriers.
__device__ __forceinline__ void gru_layer16(const bf16* x_bf, const bf16* h_bf, float* h,
                                            float* x_f, const bf16* __restrict__ wx,
                                            const float* __restrict__ bx,
                                            const bf16* __restrict__ wh,
                                            const float* __restrict__ bh, int H, float* stage,
                                            int warp, int nwarps, int lane) {
  const int H3 = 3 * H;
  float* st = stage + warp * 4 * 256;
  for (int jt = warp; jt < H / TILE; jt += nwarps) {
    // accumulators: z (x and h parts together), r (likewise), xn, hn
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> az, ar, axn, ahn;
    wmma::fill_fragment(az, 0.0f);
    wmma::fill_fragment(ar, 0.0f);
    wmma::fill_fragment(axn, 0.0f);
    wmma::fill_fragment(ahn, 0.0f);
    const int cz = jt * TILE, cr = H + jt * TILE, cn = 2 * H + jt * TILE;
#pragma unroll 2
    for (int k = 0; k < H / TILE; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ax, ah;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(ax, x_bf + k * TILE, H);
      wmma::load_matrix_sync(ah, h_bf + k * TILE, H);
      const bf16* wxk = wx + (size_t)k * TILE * H3;
      const bf16* whk = wh + (size_t)k * TILE * H3;
      wmma::load_matrix_sync(b, wxk + cz, H3);
      wmma::mma_sync(az, ax, b, az);
      wmma::load_matrix_sync(b, whk + cz, H3);
      wmma::mma_sync(az, ah, b, az);
      wmma::load_matrix_sync(b, wxk + cr, H3);
      wmma::mma_sync(ar, ax, b, ar);
      wmma::load_matrix_sync(b, whk + cr, H3);
      wmma::mma_sync(ar, ah, b, ar);
      wmma::load_matrix_sync(b, wxk + cn, H3);
      wmma::mma_sync(axn, ax, b, axn);
      wmma::load_matrix_sync(b, whk + cn, H3);
      wmma::mma_sync(ahn, ah, b, ahn);
    }
    wmma::store_matrix_sync(st, az, TILE, wmma::mem_row_major);
    wmma::store_matrix_sync(st + 256, ar, TILE, wmma::mem_row_major);
    wmma::store_matrix_sync(st + 512, axn, TILE, wmma::mem_row_major);
    wmma::store_matrix_sync(st + 768, ahn, TILE, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / TILE, j = jt * TILE + e % TILE;
      const float z = sigmoidf(st[e] + bx[j] + bh[j]);
      const float rg = sigmoidf(st[256 + e] + bx[H + j] + bh[H + j]);
      const float n = tanhf(st[512 + e] + bx[2 * H + j] + rg * (st[768 + e] + bh[2 * H + j]));
      const float hp = h[r * H + j];
      const float hn = (1.0f - z) * n + z * hp;
      h[r * H + j] = hn;
      x_f[r * H + j] += hn;
    }
    __syncwarp();
  }
}

}  // namespace koala
