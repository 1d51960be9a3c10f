// Device helpers for persistent, weight-stationary kernels: a grid of blocks
// that are all resident at once, each keeping a slice of the weights on its
// SM (in registers or shared memory) for the whole launch and exchanging
// small activations with the other blocks through device memory (they stay
// in L2).
//
//   grid_barrier_  a barrier over a group of co-resident blocks: one counter
//   arrive, _wait  in device memory that only ever grows, so it is never
//                  reset during a launch. The launch must be cooperative
//                  (cudaLaunchCooperativeKernel), which is refused for a
//                  grid that is not resident as a whole.
//   cp_async16     16-byte asynchronous copies into shared memory that read
//                  through L2 only (.cg): what another block published before
//                  a barrier is what arrives, never a stale L1 line.
//   cp_async4      the 4-byte form (.ca), for rows that are not 16-byte
//                  aligned.
//   ldmatrix_x4,   the warp-level tensor-core product m16n8k16 (bf16 in, f32
//   mma_bf16       sums) with A taken from padded rows in shared memory and B
//                  from fragments that the caller keeps (acc_row / acc_col
//                  say where an accumulator element lies in its tile).
//   sigmoid_fast,  the gate functions from the fast exponential.
//   tanh_fast
//
// The GRU-stack kernel (gru.cu) is built from these; the tiled product of
// the fused engine (tile_gemm.cuh) and the floor tracker (floor_scan.cuh)
// take the copies and the tensor-core wrappers, the fixed-order product
// (rowmm.cu) the copies alone.

#pragma once

#include "common.cuh"

namespace koala {

// A block that waits this many polls at a barrier traps: a fault in the
// barrier's accounting then surfaces as an error of the launch, not a hang.
constexpr unsigned BARRIER_SPIN_LIMIT = 1u << 24;

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the group arrives and waits the same number of times; the
// k-th wait passes target = k * (blocks in the group). What a block wrote to
// device memory before it arrived is visible to every block after its wait,
// for reads that go to L2 (cp_async16, __ldcg, volatile). Between the two
// calls a block may do work that depends on no other block.
__device__ __forceinline__ void grid_barrier_arrive(unsigned* counter) {
  __syncthreads();
  // release at gpu scope: the block's writes, ordered before this by the
  // barrier above, are visible to whoever acquires the count
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" :: "l"(counter) : "memory");
}

__device__ __forceinline__ void grid_barrier_wait(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned spins = 0;
    while (ld_acquire_gpu(counter) < target) {
      if (++spins > BARRIER_SPIN_LIMIT) __trap();
    }
  }
  __syncthreads();
}

// Copy 16 bytes from device memory (through L2) into shared memory; with
// src_bytes = 0 nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4-byte form of cp_async16, for rows that are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// A fragment (16 rows x 16 deep, bf16, row-major) of the m16n8k16 product.
// tile: element [0][0] of the tile in shared memory; stride: elements per
// row, a multiple of 8 (rows 16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const bf16* tile, int stride,
                                            int lane) {
  const bf16* p = tile + (lane & 15) * stride + (lane >> 4) * 8;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// c[16x8] += a[16x16] @ b[16x8]; bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Sigmoid and tanh from the fast exponential and division: absolute error
// about 1e-7, far below the bf16 rounding of the products they feed.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

// Position of accumulator pair `half` (0: row lane / 4, 1: that row + 8) of
// `lane` in a 16 x 8 accumulator tile: its row, and its first column (the
// pair is columns col, col + 1).
__device__ __forceinline__ int acc_row(int lane, int half) { return (lane >> 2) + half * 8; }
__device__ __forceinline__ int acc_col(int lane) { return (lane & 3) * 2; }

}  // namespace koala
