// The tiled product that the frame-local stages of the fused engine are made
// of (engine_fused.cu):  acc[MT rows, NC columns] = A[MT, K] @ W[K, columns].
//
//  - A: the block's MT = 64 rows as bf16 in shared memory, whole depth K,
//    rows padded so that the 8 rows of an ldmatrix fall into 8 different
//    16-byte bank groups;
//  - W: bf16 [K, ldw] in device memory (it stays in L2: every block reads the
//    same weights), streamed through two stages of KC = 64 rows x NC = 128
//    columns in shared memory with cp.async: stage c + 1 is in flight while
//    stage c is multiplied. Which 8-column groups of W a stage holds is the
//    caller's choice (a functor), so a pass can gather columns from two
//    places (the re and the im half of a spectrum) or zero-fill what lies
//    past the matrix's edge;
//  - 8 warps as 2 (rows) x 4 (columns): a warp owns 32 rows x 32 columns,
//    eight m16n8k16 tensor-core products (bf16 in, f32 sums) per 16 deep, A
//    through ldmatrix, W through ldmatrix.trans (W lies [k][n] in shared
//    memory, the product wants its fragments by column);
//  - the sums stay in registers (32 a thread): the caller's epilogue reads
//    them there (acc_rows / acc_cols say where an element lies).
// A row's sum runs over k in the same order whatever the row's place in the
// tile and whatever else the tile holds, so a frame's result does not depend
// on how a call's frames are cut into tiles.

#pragma once

#include "resident.cuh"

namespace koala {

constexpr int GEMM_THREADS = 256;
constexpr int MT = 64;           // rows of a tile
constexpr int NC = 128;          // columns of a pass
constexpr int KC = 64;           // rows of W in one stage
constexpr int WS = NC + 8;       // padded row of a stage (elements)
constexpr int A_PAD = 8;         // padding of an A row (elements)
constexpr size_t W_STAGES_BYTES = (size_t)2 * KC * WS * sizeof(bf16);

// Two B fragments (16 deep x 8 columns each, columns n .. n + 7 in b[0..1] and
// n + 8 .. n + 15 in b[2..3]) of the m16n8k16 product from W stored [k][n].
// tile: element [k0][n] in shared memory; stride: elements per row.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&b)[4], const bf16* tile, int stride,
                                                  int lane) {
  const bf16* p = tile + (lane & 15) * stride + (lane >> 4) * 8;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(addr));
}

// Where this thread's accumulators lie in the block's MT x NC tile:
// acc[mi][ni][2 * half + q] is row tile_row(mi, half), column tile_col(ni) + q.
__device__ __forceinline__ int tile_row(int mi, int half) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 2) * 32 + mi * 16 + acc_row(lane, half);
}
__device__ __forceinline__ int tile_col(int ni) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp & 3) * 32 + ni * 8 + acc_col(lane);
}

// One pass: acc = A @ W[:, the pass's columns], for all 256 threads of the
// block together. a_s: [MT][lda] bf16 in shared memory, written before the
// call (the pass's first barrier orders it). cols(g): the first column in W
// of the stage's 8-column group g (0 .. 15), or -1 for a group of zeros.
// w_s: W_STAGES_BYTES of shared memory. active: whether this warp's 32
// columns hold anything (a warp-uniform flag; an idle warp still copies and
// meets the barriers). K is a multiple of 16. Ends with a barrier: a_s and
// w_s are free when it returns.
template <class Cols>
__device__ __forceinline__ void gemm_pass(float (&acc)[2][4][4], const bf16* a_s, int lda, int K,
                                          const bf16* __restrict__ w, int ldw, Cols cols,
                                          bf16* w_s, bool active) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  // a thread copies the same column group in every stage: rows tid / 16, + 16, ...
  const int group = tid & 15, first_row = tid >> 4;
  const int col = cols(group);
  auto load = [&](int c) {
    const int k0 = c * KC, depth = min(KC, K - k0);
    bf16* dst = w_s + (size_t)(c & 1) * KC * WS + group * 8;
    for (int r = first_row; r < depth; r += GEMM_THREADS / 16)
      cp_async16(dst + r * WS, w + (col >= 0 ? (size_t)(k0 + r) * ldw + col : 0),
                 col >= 0 ? 16 : 0);
    cp_async_commit();
  };

  const int chunks = (K + KC - 1) / KC;
  load(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      load(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const bf16* ws = w_s + (size_t)(c & 1) * KC * WS + wn * 32;
      const bf16* as = a_s + (size_t)(wm * 32) * lda + c * KC;
      const int steps = min(KC, K - c * KC) / 16;
#pragma unroll 2
      for (int kk = 0; kk < steps; ++kk) {
        unsigned a0[4], a1[4], b0[4], b1[4];
        ldmatrix_x4(a0, as + kk * 16, lda, lane);
        ldmatrix_x4(a1, as + (size_t)16 * lda + kk * 16, lda, lane);
        ldmatrix_x4_trans(b0, ws + (size_t)kk * 16 * WS, WS, lane);
        ldmatrix_x4_trans(b1, ws + (size_t)kk * 16 * WS + 16, WS, lane);
        const uint2 b[4] = {make_uint2(b0[0], b0[1]), make_uint2(b0[2], b0[3]),
                            make_uint2(b1[0], b1[1]), make_uint2(b1[2], b1[3])};
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[0][ni], a0, b[ni]);
          mma_bf16(acc[1][ni], a1, b[ni]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace koala
