// The floor tracker's kernel and its launcher, shared by floor.cu (the
// stand-alone floor_scan) and engine_fused.cu (the floor stage of the fused
// engine):  floor[t] = min(floor[t-1] + rise, lb[t])  over lb [T, BN].
//
// Bound on this card: bytes (lb read once, floors written once, one add and
// one min per element). What a simple column-per-thread loop pays instead is
// memory latency: T loads and stores in a row on few SMs. Design:
//  - a block owns FLOOR_COLS = 32 neighbouring columns, so B x nb columns
//    spread over BN / 32 blocks;
//  - warp 0 does nothing but the recurrence: it scans a slab [FLOOR_SEG rows,
//    32 columns] in shared memory, a lane per column with the carried floor
//    in a register, and leaves the floors in place. It reads 16 rows ahead
//    into registers, so the chain is the add and the min alone;
//  - the other three warps move the data: they bring the slabs of lb into
//    shared memory two segments ahead with every copy of a slab in flight at
//    once (cp.async, 16 bytes each where BN and the addresses allow, else 4)
//    and store the slab that was scanned before with 16-byte stores. Four
//    slabs go round, and one barrier a segment hands them over: neither
//    loads nor stores nor their address arithmetic are on the chain.
// The recurrence stays sequential in T and its arithmetic is untouched:
// fminf(__fadd_rn(f, rise), lb) is the plain version's single-precision add
// and min (no multiply, so nothing contracts into an FMA; rise crosses as a
// float), hence bit-identical results. lb is never NaN here (a log of a sum
// plus a positive epsilon), where fminf and torch.minimum differ.

#pragma once

#include <cstdint>

#include "resident.cuh"

namespace koala {

constexpr int FLOOR_COLS = 32;      // columns of a block: one lane each
constexpr int FLOOR_SEG = 64;       // rows of a slab
constexpr int FLOOR_SLABS = 4;       // the scanned one, the one being stored, two arriving
constexpr int FLOOR_THREADS = 128;
constexpr int FLOOR_MOVERS = FLOOR_THREADS - FLOOR_COLS;   // threads that copy and store

// vec: BN is a multiple of 4 and lb, floors are 16-byte aligned.
static __global__ void __launch_bounds__(FLOOR_THREADS)
    floor_scan_kernel(const float* __restrict__ lb, const float* __restrict__ floor0,
                      float* __restrict__ floors, float* __restrict__ floor_final, int T, int BN,
                      float rise, int vec) {
  __shared__ __align__(16) float slab[FLOOR_SLABS][FLOOR_SEG][FLOOR_COLS];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * FLOOR_COLS;
  const int cols = min(FLOOR_COLS, BN - c0);
  const int segments = (T + FLOOR_SEG - 1) / FLOOR_SEG;
  float f = tid < cols ? floor0[c0 + tid] : 0.0f;

  if (tid >= FLOOR_COLS) {
    // ---- the movers
    const int mover = tid - FLOOR_COLS;
    // all copies of one slab, in flight together (a group even where there is
    // no such segment, so that the waits count alike); dead columns are zero
    auto load = [&](int seg) {
      const int t0 = seg * FLOOR_SEG, rows = min(FLOOR_SEG, T - t0);
      float* dst = &slab[seg % FLOOR_SLABS][0][0];
      if (vec) {
        for (int i = mover; i < rows * (FLOOR_COLS / 4); i += FLOOR_MOVERS) {
          const int r = i / (FLOOR_COLS / 4), q = (i % (FLOOR_COLS / 4)) * 4;
          const bool live = q < cols;
          cp_async16(dst + r * FLOOR_COLS + q,
                     lb + (size_t)(t0 + r) * BN + c0 + (live ? q : 0), live ? 16 : 0);
        }
      } else {
        for (int i = mover; i < rows * FLOOR_COLS; i += FLOOR_MOVERS) {
          const int r = i / FLOOR_COLS, q = i % FLOOR_COLS;
          const bool live = q < cols;
          cp_async4(dst + r * FLOOR_COLS + q,
                    lb + (size_t)(t0 + r) * BN + c0 + (live ? q : 0), live ? 4 : 0);
        }
      }
      cp_async_commit();
    };
    auto store = [&](int seg) {
      const int t0 = seg * FLOOR_SEG, rows = min(FLOOR_SEG, T - t0);
      const float (*s)[FLOOR_COLS] = slab[seg % FLOOR_SLABS];
      if (vec) {
        for (int i = mover; i < rows * (FLOOR_COLS / 4); i += FLOOR_MOVERS) {
          const int r = i / (FLOOR_COLS / 4), q = (i % (FLOOR_COLS / 4)) * 4;
          if (q < cols)
            *reinterpret_cast<float4*>(floors + (size_t)(t0 + r) * BN + c0 + q) =
                *reinterpret_cast<const float4*>(&s[r][q]);
        }
      } else {
        for (int i = mover; i < rows * FLOOR_COLS; i += FLOOR_MOVERS) {
          const int r = i / FLOOR_COLS, q = i % FLOOR_COLS;
          if (q < cols) floors[(size_t)(t0 + r) * BN + c0 + q] = s[r][q];
        }
      }
    };
    // in the round of segment seg: segment seg + 2 sets out into the slab
    // that segment seg - 2 left (stored in the round before), segment
    // seg - 1 goes out, and segment seg + 1 must have arrived by the barrier
    load(0);
    load(1);
    cp_async_wait<1>();
    __syncthreads();
    for (int seg = 0; seg < segments; ++seg) {
      load(seg + 2);
      if (seg > 0) store(seg - 1);
      cp_async_wait<1>();
      __syncthreads();
    }
    if (segments > 0) store(segments - 1);
    return;
  }

  // ---- the scanning warp
  constexpr int AHEAD = 16;   // rows held in registers ahead of the chain
  __syncthreads();
  for (int seg = 0; seg < segments; ++seg) {
    const int rows = min(FLOOR_SEG, T - seg * FLOOR_SEG);
    float* col = &slab[seg % FLOOR_SLABS][0][tid];
    float cur[AHEAD], next[AHEAD];
    int r = 0;
    if (rows >= AHEAD) {
#pragma unroll
      for (int j = 0; j < AHEAD; ++j) cur[j] = col[j * FLOOR_COLS];
    }
    for (; r + AHEAD <= rows; r += AHEAD) {
      const bool more = r + 2 * AHEAD <= rows;
      if (more) {
#pragma unroll
        for (int j = 0; j < AHEAD; ++j) next[j] = col[(r + AHEAD + j) * FLOOR_COLS];
      }
#pragma unroll
      for (int j = 0; j < AHEAD; ++j) {
        f = fminf(__fadd_rn(f, rise), cur[j]);
        col[(r + j) * FLOOR_COLS] = f;
      }
      if (more) {
#pragma unroll
        for (int j = 0; j < AHEAD; ++j) cur[j] = next[j];
      }
    }
    for (; r < rows; ++r) {
      f = fminf(__fadd_rn(f, rise), col[r * FLOOR_COLS]);
      col[r * FLOOR_COLS] = f;
    }
    __syncthreads();
  }
  if (tid < cols) floor_final[c0 + tid] = f;
}

// Launch the tracker over lb [T, BN] on `stream`; T = 0 copies floor0.
static inline cudaError_t launch_floor_scan(const float* lb, const float* floor0, float* floors,
                                            float* floor_final, int T, int BN, float rise,
                                            cudaStream_t stream) {
  if (BN <= 0) return cudaGetLastError();
  const int vec = BN % 4 == 0 && reinterpret_cast<uintptr_t>(lb) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(floors) % 16 == 0;
  const int blocks = (BN + FLOOR_COLS - 1) / FLOOR_COLS;
  floor_scan_kernel<<<blocks, FLOOR_THREADS, 0, stream>>>(lb, floor0, floors, floor_final, T, BN,
                                                          rise, vec);
  return cudaGetLastError();
}

}  // namespace koala
