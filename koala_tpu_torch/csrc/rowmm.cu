// Fixed-order float32 product C[M, N] = A[M, K] @ B[K, N].
//
// Replaces no TPU kernel: in the JAX package the frame-local products (the
// STFT and iSTFT bases, the band and cepstral pools, the encoder, decoder and
// gate, the scan branch's GRU projections) are jnp matmuls outside any Pallas
// kernel. It exists for one property that a library GEMM does not promise: a
// row of C has the same bits whatever M is and wherever the row lies in its
// tile. cuBLAS picks its algorithm, and so the order of its sums, by the
// shape, so one stream's spectrum came out of a 365-frame call with other
// bits than out of a 1-frame or a 32-frame one, and the recurrences carried
// the difference on.
//
// Arithmetic, the promise of every kernel in this file: each element of C is
// summed by one thread, in one f32 register, as fmaf(a[k], b[k], acc) for
// k = 0, 1, ..., K - 1 in that order, from acc = +0. No split-K, no tree, no
// atomics, no tensor cores, no TF32: true float32, as the port's STFT
// promises (the bf16-operand products hand it values already rounded to
// bf16). Whatever the tile, the thread mapping, the staging or the pipeline
// depth, a kernel that keeps that chain gives the same bits, so the kernels
// below give the bits of one another and of rowmm_simple_kernel, the first
// design, kept as the yardstick that the card tests hold them to. Elements of
// K past its end are never summed (each chunk sums only its kc live k).
//
// Bound on this card. Many rows (process_chunk: M = B x T = 24064, K and N of
// 1 to 512): operations, 2 M N K f32 FMA work on the CUDA cores (67 TFLOP/s):
// the nine products of a call are about 38.6 GFLOP, 0.58 ms; their bytes
// about 0.1 ms. One row (the step): B's bytes (3.2 MB for the nine, 0.96 us)
// and the chain of K dependent FMAs a thread (about 4.4 cycles each: about
// 1.1 us at K = 512), besides a launch.
//
// Design. The kernel, tile and grid are a plain function of (M, N, K) on the
// host (ops/kernels/rowmm.py ``plan``); the kernels read A's rows through
// two strides, so a permuted view [B, T, K] of a [T, B, K] tensor needs no
// copy. Operands move by cp.async in a ring of K chunks that runs ahead of
// the sums, with one barrier a chunk. What bounds them here, as the times of
// every variant on an H100 show (scripts/rowmm_variants_torch.py): at one
// row each chunk of the ring costs about 0.3 us, whatever its bytes, and at
// many rows the copy instructions compete with the FMAs; so few rows want
// few, long chunks spread over many SMs, and many rows want few copy
// instructions for their FMAs.
//  - rowmm_narrow_kernel (up to 64 rows): 8 columns a block, 64 or 128 k a
//    chunk.
//  - rowmm_row_kernel (65 to 1024 rows): 32 columns and 16 rows a block.
//  - rowmm_col_kernel (N = 1 at more rows): a thread a row.
//  - rowmm_tile_kernel (over 1024 rows): a 128 x 64, 128 x 32 or 64 x 64
//    tile of 8 x 8 or 4 x 8 elements a thread, A by 16-byte copies.
//  - rowmm_fused_kernel, rowmm_fused_narrow_kernel (the fused entry,
//    Demucs's bf16 products: over 1024 rows and at most): the 128 x 64
//    tile's and the narrow kernel's main loops and chains (tile_product,
//    narrow_product), A rounded to bf16 on load, and an epilogue of bias,
//    ReLU, GLU and bf16 rounding applied to each element after its chain;
//    instantiations of their own, so the plain kernels are as they were.

#include <cstdint>

#include "resident.cuh"

namespace {

using koala::cp_async16;
using koala::cp_async4;
using koala::cp_async_commit;
using koala::cp_async_wait;

// ---------------------------------------------------------------------------
// rowmm_simple_kernel: the first design (a 64 x 64 tile of 256 threads, 4 x 4
// elements a thread, 16-wide K chunks staged by plain loads, two barriers a
// chunk). Off the main path: the card tests and chip_smoke.py hold the
// variants below to it bit for bit.

constexpr int RM_BM = 64;                     // rows of C a block owns
constexpr int RM_BN = 64;                     // columns of C a block owns
constexpr int RM_BK = 16;                     // k of a shared-memory chunk
constexpr int RM_TM = 4;                      // rows of C a thread owns
constexpr int RM_TN = 4;                      // columns of C a thread owns
constexpr int RM_THREADS = (RM_BM / RM_TM) * (RM_BN / RM_TN);   // 256

__global__ void __launch_bounds__(RM_THREADS)
    rowmm_simple_kernel(const float* __restrict__ A, const float* __restrict__ B,
                        float* __restrict__ C, int M, int N, int K) {
  // A's chunk, transposed (As[k][m]); 4 floats of padding a row keep the
  // transposing stores from falling into one bank and the float4 reads aligned
  __shared__ __align__(16) float As[RM_BK][RM_BM + 4];
  __shared__ __align__(16) float Bs[RM_BK][RM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % (RM_BN / RM_TN);
  const int ty = tid / (RM_BN / RM_TN);
  const int m0 = blockIdx.x * RM_BM;
  const int n0 = blockIdx.y * RM_BN;

  float acc[RM_TM][RM_TN];
#pragma unroll
  for (int i = 0; i < RM_TM; ++i)
#pragma unroll
    for (int j = 0; j < RM_TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += RM_BK) {
    // outside the matrices the tiles hold zeros; they are never summed (kn)
    for (int e = tid; e < RM_BM * RM_BK; e += RM_THREADS) {
      const int r = e / RM_BK, c = e % RM_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? __ldg(A + (size_t)gm * K + gk) : 0.0f;
    }
    for (int e = tid; e < RM_BK * RM_BN; e += RM_THREADS) {
      const int r = e / RM_BN, c = e % RM_BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? __ldg(B + (size_t)gk * N + gn) : 0.0f;
    }
    __syncthreads();
    const int kn = min(RM_BK, K - k0);
#pragma unroll
    for (int kk = 0; kk < RM_BK; ++kk) {
      if (kk < kn) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * RM_TM]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * RM_TN]);
        const float av[RM_TM] = {a.x, a.y, a.z, a.w};
        const float bv[RM_TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < RM_TM; ++i)
#pragma unroll
          for (int j = 0; j < RM_TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM_TM; ++i) {
    const int gm = m0 + ty * RM_TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < RM_TN; ++j) {
      const int gn = n0 + tx * RM_TN + j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// A's rows: row r starts at a + (r / inner) * s_outer + (r % inner) * s_inner
// floats (a contiguous [M, K]: inner = M, s_inner = K). Its K elements are
// contiguous.
struct RowsOfA {
  const float* a;
  int inner;
  long long s_outer, s_inner;

  __device__ __forceinline__ const float* row(int r) const {
    return a + (long long)(r / inner) * s_outer + (long long)(r % inner) * s_inner;
  }
};

// 16-byte copies of rows that are not 16-byte aligned. A row segment of n
// floats at any 4-byte offset lies inside a 16-byte-aligned span of n + 4
// floats (32 floats: SPAN = 36, PIECES = 9 pieces of 16 bytes): the span is
// copied whole, and the segment read at its offset in the span (span_off). A piece that reaches past
// ``end`` (the operand's last element + 1) copies only what lies before it and
// fills the rest with zeros; a span may begin up to 12 bytes before the
// operand, inside its 16-byte-aligned allocation (the wrapper checks that).

constexpr int SPAN = 36;
constexpr int PIECES = SPAN / 4;

__device__ __forceinline__ const float* span_start(const float* p) {
  return reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));
}

__device__ __forceinline__ int span_off(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// piece q of the span of p into dst (16-byte aligned)
__device__ __forceinline__ void copy_piece(float* dst, const float* p, int q, const float* end) {
  const float* src = span_start(p) + 4 * q;
  const long long left = end - src;
  cp_async16(dst + 4 * q, src, left >= 4 ? 16 : left > 0 ? (int)left * 4 : 0);
}

// ---------------------------------------------------------------------------
// rowmm_row_kernel<RB, W>: some rows (a round of 8 frames, one stream's
// 376). Block: W warps over RB * W rows and 32 columns; warp w owns rows
// w * RB + i (i < RB), lane l column n0 + l, so a k reads one coalesced
// segment of B's row. The copies of a chunk are spread over all W warps
// (4-byte cp.async, 32 / W a thread for B's [32 k, 32 columns] panel, a warp
// its own rows of A); a warp first reads its column's 32 values of B into
// registers, then runs its RB chains over them.

constexpr int ROW_KC = 32;        // k of a chunk
constexpr int ROW_STAGES = 6;     // chunks in the ring (five in flight)

template <int RB, int W>
__global__ void __launch_bounds__(32 * W)
    rowmm_row_kernel(RowsOfA A, const float* __restrict__ B, float* __restrict__ C, int M,
                     int N, int K) {
  constexpr int R = RB * W;
  __shared__ __align__(16) float Bs[ROW_STAGES][ROW_KC][32];
  __shared__ __align__(16) float As[ROW_STAGES][R][ROW_KC];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int r0 = blockIdx.x * R, n0 = blockIdx.y * 32;
  const int n = n0 + lane;
  const bool col_live = n < N;
  const bool has_rows = r0 + w * RB < M;       // the same for the whole warp: rows past M
                                               // only copy
  const float* arow[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int r = r0 + w * RB + i;
    arow[i] = r < M ? A.row(r) : nullptr;
  }
  const int chunks = (K + ROW_KC - 1) / ROW_KC;

  // Copies of chunk c into its stage. Elements outside the matrices are not
  // copied: their stale values reach only sums that are never stored (rows
  // past M, columns past N) or k that are never summed.
  auto issue = [&](int c) {
    const int s = c % ROW_STAGES, k0 = c * ROW_KC;
#pragma unroll
    for (int j = 0; j < ROW_KC / W; ++j) {
      const int kk = w + j * W, k = k0 + kk;
      if (col_live && k < K) cp_async4(&Bs[s][kk][lane], B + (size_t)k * N + n, 4);
    }
    const int k = k0 + lane;
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if (arow[i] != nullptr && k < K) cp_async4(&As[s][w * RB + i][lane], arow[i] + k, 4);
  };

  float acc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int c = 0; c < ROW_STAGES - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    // chunk c has landed (this thread's copies, then everyone's), and every
    // warp has summed chunk c - 1, whose stage the next issue refills
    cp_async_wait<ROW_STAGES - 2>();
    __syncthreads();
    if (c + ROW_STAGES - 1 < chunks) issue(c + ROW_STAGES - 1);
    cp_async_commit();
    if (!has_rows) continue;
    const int s = c % ROW_STAGES;
    const int kc = min(ROW_KC, K - c * ROW_KC);
    if (kc == ROW_KC) {
      float b[ROW_KC];
#pragma unroll
      for (int kk = 0; kk < ROW_KC; ++kk) b[kk] = Bs[s][kk][lane];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
#pragma unroll
        for (int q = 0; q < ROW_KC; q += 4) {
          const float4 a = *reinterpret_cast<const float4*>(&As[s][w * RB + i][q]);
          acc[i] = fmaf(a.x, b[q], acc[i]);
          acc[i] = fmaf(a.y, b[q + 1], acc[i]);
          acc[i] = fmaf(a.z, b[q + 2], acc[i]);
          acc[i] = fmaf(a.w, b[q + 3], acc[i]);
        }
      }
    } else {
      for (int kk = 0; kk < kc; ++kk) {
        const float b = Bs[s][kk][lane];
#pragma unroll
        for (int i = 0; i < RB; ++i) acc[i] = fmaf(As[s][w * RB + i][kk], b, acc[i]);
      }
    }
  }
  cp_async_wait<0>();

  if (col_live) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int r = r0 + w * RB + i;
      if (r < M) C[(size_t)r * N + n] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// rowmm_narrow_kernel<ROWS, KC, STAGES>: the fewest rows (the step, live
// rounds). At one row the chain is short (K FMAs) and the time goes to
// moving B into the SMs: every chunk of the ring costs a fixed share of it,
// so chunks are long (64 or 128 k), and B is spread over as many SMs as the
// columns allow: a block owns 8 columns (N = 257: 33 blocks) and ROWS rows.
// Its NAR_WARPS warps all copy; lane l of warp w runs the chain of column
// n0 + l % 8 and row 4 w + l / 8; a warp whose rows lie past M only copies.

constexpr int NAR_COLS = 8;
constexpr int NAR_SLOTS = 32 / NAR_COLS;     // row slots a warp
constexpr int NAR_WARPS = 4;
constexpr int NAR_THREADS = 32 * NAR_WARPS;
// a GLU's value and gate columns interleave in blocks of this many
// (ops/kernels/rowmm.py pair_glu): gate column n + GLU_HALF is value n's
constexpr int GLU_HALF = 32;

template <int ROWS, int KC, int STAGES>
__global__ void __launch_bounds__(NAR_THREADS)
    rowmm_narrow_kernel(RowsOfA A, const float* __restrict__ B, float* __restrict__ C, int M,
                        int N, int K) {
  constexpr int W = NAR_WARPS, R = ROWS, THREADS = NAR_THREADS;
  constexpr int A_COPIES = (R + W - 1) / W;                      // rows of A a warp copies
  static_assert(R % NAR_SLOTS == 0 && R <= W * NAR_SLOTS, "rows");
  constexpr int B_COPIES = KC * NAR_COLS / THREADS;
  // KC + 4 floats a row of A's chunk: aligned float4 reads, a warp's four rows
  // in distinct banks
  constexpr int LDA = KC + 4;
  static_assert(B_COPIES * THREADS == KC * NAR_COLS && KC % 32 == 0, "copies");
  __shared__ __align__(16) float Bs[STAGES][KC][NAR_COLS];
  __shared__ __align__(16) float As[STAGES][R][LDA];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = lane % NAR_COLS, row = w * NAR_SLOTS + lane / NAR_COLS;
  const int r0 = blockIdx.x * R, n0 = blockIdx.y * NAR_COLS, n = n0 + col;
  const bool warp_rows = w * NAR_SLOTS < R && r0 + w * NAR_SLOTS < M;   // the whole warp's
  // a warp copies whole 32-k rows of A (rows w + j W), a lane a k
  const float* arow[A_COPIES];
#pragma unroll
  for (int j = 0; j < A_COPIES; ++j) {
    const int r = r0 + w + j * W;
    arow[j] = w + j * W < R && r < M ? A.row(r) : nullptr;
  }
  const int chunks = (K + KC - 1) / KC;

  auto issue = [&](int c) {
    const int s = c % STAGES, k0 = c * KC;
#pragma unroll
    for (int j = 0; j < B_COPIES; ++j) {
      const int e = threadIdx.x + j * THREADS, kk = e / NAR_COLS, cc = e % NAR_COLS;
      const int k = k0 + kk;
      if (k < K && n0 + cc < N) cp_async4(&Bs[s][kk][cc], B + (size_t)k * N + n0 + cc, 4);
    }
#pragma unroll
    for (int h = 0; h < KC / 32; ++h) {
      const int k = k0 + 32 * h + lane;
#pragma unroll
      for (int j = 0; j < A_COPIES; ++j)
        if (arow[j] != nullptr && k < K)
          cp_async4(&As[s][w + j * W][32 * h + lane], arow[j] + k, 4);
    }
  };

  float acc = 0.0f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < chunks) issue(c + STAGES - 1);
    cp_async_commit();
    if (!warp_rows) continue;
    const int s = c % STAGES;
    const int kc = min(KC, K - c * KC);
    if (kc == KC) {
      // 32 k at a time: the column's values into registers, then the chains
#pragma unroll
      for (int h = 0; h < KC; h += 32) {
        float b[32];
#pragma unroll
        for (int kk = 0; kk < 32; ++kk) b[kk] = Bs[s][h + kk][col];
#pragma unroll
        for (int q = 0; q < 32; q += 4) {
          const float4 a = *reinterpret_cast<const float4*>(&As[s][row][h + q]);
          acc = fmaf(a.x, b[q], acc);
          acc = fmaf(a.y, b[q + 1], acc);
          acc = fmaf(a.z, b[q + 2], acc);
          acc = fmaf(a.w, b[q + 3], acc);
        }
      }
    } else {
      for (int kk = 0; kk < kc; ++kk) {
        acc = fmaf(As[s][row][kk], Bs[s][kk][col], acc);
      }
    }
  }
  cp_async_wait<0>();

  if (n < N && row < R && r0 + row < M) C[(size_t)(r0 + row) * N + n] = acc;
}

// narrow_product<ROWS, KC, STAGES, NC>: rowmm_narrow_kernel's main loop for
// the fused entry's narrow kernel. Each thread sums NC chains of its row:
// chain c that of B's column nb + c GLU_HALF + l % 8 (one chain, or a GLU's
// value and its gate). With round_a each thread rounds the elements of A it
// copied to bf16, in shared memory, once a chunk, before the barrier that
// publishes them. The plain kernel keeps its own source: run through this
// function (the rounding compiled out) it compiled to other code and ran
// 2-8% slower at one to 64 rows on an H100.
template <int ROWS, int KC, int STAGES, int NC>
__device__ __forceinline__ void narrow_product(const RowsOfA& A, const float* __restrict__ B,
                                               int M, int N, int K, int nb, bool round_a,
                                               float (&acc)[NC]) {
  constexpr int W = NAR_WARPS, R = ROWS, THREADS = NAR_THREADS;
  constexpr int A_COPIES = (R + W - 1) / W;                      // rows of A a warp copies
  static_assert(R % NAR_SLOTS == 0 && R <= W * NAR_SLOTS, "rows");
  constexpr int BC = NAR_COLS * NC;                              // columns of B's panel
  constexpr int B_COPIES = KC * BC / THREADS;
  // KC + 4 floats a row of A's chunk: aligned float4 reads, a warp's four rows
  // in distinct banks
  constexpr int LDA = KC + 4;
  static_assert(B_COPIES * THREADS == KC * BC && KC % 32 == 0, "copies");
  __shared__ __align__(16) float Bs[STAGES][KC][BC];
  __shared__ __align__(16) float As[STAGES][R][LDA];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = lane % NAR_COLS, row = w * NAR_SLOTS + lane / NAR_COLS;
  const int r0 = blockIdx.x * R;
  const bool warp_rows = w * NAR_SLOTS < R && r0 + w * NAR_SLOTS < M;   // the whole warp's
  // a warp copies whole 32-k rows of A (rows w + j W), a lane a k
  const float* arow[A_COPIES];
#pragma unroll
  for (int j = 0; j < A_COPIES; ++j) {
    const int r = r0 + w + j * W;
    arow[j] = w + j * W < R && r < M ? A.row(r) : nullptr;
  }
  const int chunks = (K + KC - 1) / KC;

  auto issue = [&](int c) {
    const int s = c % STAGES, k0 = c * KC;
#pragma unroll
    for (int j = 0; j < B_COPIES; ++j) {
      const int e = threadIdx.x + j * THREADS, kk = e / BC, cc = e % BC;
      const int k = k0 + kk;
      int n = nb + cc;
      if constexpr (NC > 1) n = nb + (cc / NAR_COLS) * GLU_HALF + cc % NAR_COLS;
      if (k < K && n < N) cp_async4(&Bs[s][kk][cc], B + (size_t)k * N + n, 4);
    }
#pragma unroll
    for (int h = 0; h < KC / 32; ++h) {
      const int k = k0 + 32 * h + lane;
#pragma unroll
      for (int j = 0; j < A_COPIES; ++j)
        if (arow[j] != nullptr && k < K)
          cp_async4(&As[s][w + j * W][32 * h + lane], arow[j] + k, 4);
    }
  };

#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    if (round_a) {
      // this thread's copies of chunk c have landed: round them in place
      const int s = c % STAGES, k0 = c * KC;
#pragma unroll
      for (int h = 0; h < KC / 32; ++h)
#pragma unroll
        for (int j = 0; j < A_COPIES; ++j)
          if (arow[j] != nullptr && k0 + 32 * h + lane < K) {
            float& v = As[s][w + j * W][32 * h + lane];
            v = koala::round_bf16(v);
          }
    }
    __syncthreads();
    if (c + STAGES - 1 < chunks) issue(c + STAGES - 1);
    cp_async_commit();
    if (!warp_rows) continue;
    const int s = c % STAGES;
    const int kc = min(KC, K - c * KC);
    if (kc == KC) {
      // 32 k at a time: the columns' values into registers, then the chains
#pragma unroll
      for (int h = 0; h < KC; h += 32) {
        float b[NC][32];
#pragma unroll
        for (int q = 0; q < NC; ++q)
#pragma unroll
          for (int kk = 0; kk < 32; ++kk) b[q][kk] = Bs[s][h + kk][q * NAR_COLS + col];
#pragma unroll
        for (int q = 0; q < 32; q += 4) {
          const float4 a = *reinterpret_cast<const float4*>(&As[s][row][h + q]);
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            acc[i] = fmaf(a.x, b[i][q], acc[i]);
            acc[i] = fmaf(a.y, b[i][q + 1], acc[i]);
            acc[i] = fmaf(a.z, b[i][q + 2], acc[i]);
            acc[i] = fmaf(a.w, b[i][q + 3], acc[i]);
          }
        }
      }
    } else {
      for (int kk = 0; kk < kc; ++kk) {
#pragma unroll
        for (int i = 0; i < NC; ++i)
          acc[i] = fmaf(As[s][row][kk], Bs[s][kk][i * NAR_COLS + col], acc[i]);
      }
    }
  }
  cp_async_wait<0>();
}


// ---------------------------------------------------------------------------
// rowmm_col_kernel: N = 1. A thread per row, COL_ROWS rows a block; each
// row's 32 k of a chunk and B's column arrive as 16-byte copies of their
// spans, spread over the block.

constexpr int COL_ROWS = 64;
constexpr int COL_KC = 32;
constexpr int COL_STAGES = 4;

__global__ void __launch_bounds__(COL_ROWS)
    rowmm_col_kernel(RowsOfA A, const float* __restrict__ B, float* __restrict__ C, int M,
                     int K, long long a_extent) {
  // [row][span]: 36 floats a row (16-byte aligned for the copies); a warp's
  // reads at one k fall four rows to a bank, a small cost beside the copies
  __shared__ __align__(16) float As[COL_STAGES][COL_ROWS][SPAN];
  __shared__ __align__(16) float Bs[COL_STAGES][SPAN];
  __shared__ const float* rowp[COL_ROWS];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * COL_ROWS;
  rowp[tid] = r0 + tid < M ? A.row(r0 + tid) : nullptr;
  __syncthreads();
  const float* a_end = A.a + a_extent;
  const float* b_end = B + K;
  const int chunks = (K + COL_KC - 1) / COL_KC;
  // the rows whose pieces this thread copies: piece e = tid + j COL_ROWS of
  // the block's COL_ROWS * PIECES is piece e % PIECES of row e / PIECES (a
  // thread copies PIECES pieces a chunk)
  const float* prow[PIECES];
#pragma unroll
  for (int j = 0; j < PIECES; ++j) prow[j] = rowp[(tid + j * COL_ROWS) / PIECES];

  auto issue = [&](int c) {
    const int s = c % COL_STAGES, k0 = c * COL_KC;
#pragma unroll
    for (int j = 0; j < PIECES; ++j) {
      const int e = tid + j * COL_ROWS;
      if (prow[j] != nullptr)
        copy_piece(&As[s][e / PIECES][0], prow[j] + k0, e % PIECES, a_end);
    }
    if (tid < PIECES) copy_piece(&Bs[s][0], B + k0, tid, b_end);
  };

  // every chunk starts at a multiple of 32 floats: the offsets are the rows'
  const int a_off = rowp[tid] != nullptr ? span_off(rowp[tid]) : 0;
  const int b_off = span_off(B);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < COL_STAGES - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<COL_STAGES - 2>();
    __syncthreads();
    if (c + COL_STAGES - 1 < chunks) issue(c + COL_STAGES - 1);
    cp_async_commit();
    const int s = c % COL_STAGES;
    const int kc = min(COL_KC, K - c * COL_KC);
#pragma unroll
    for (int kk = 0; kk < COL_KC; ++kk)
      if (kk < kc) acc = fmaf(As[s][tid][a_off + kk], Bs[s][b_off + kk], acc);
  }
  cp_async_wait<0>();
  if (r0 + tid < M) C[r0 + tid] = acc;
}

// ---------------------------------------------------------------------------
// rowmm_tile_kernel<BM, BN, TM, TN, BK, STAGES>: the tile with A staged row
// by row: each row's BK k of a chunk arrive as 16-byte copies of their span
// (BK + 4 floats, PA pieces), a third of the 4-byte copies' instructions; a
// thread reads its TM rows (ty + TY i) one float a k at their offsets. B as
// in rowmm_tile_kernel.

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), (BM / TM) * (BN / TN) >= 256 ? 2 : 3)
    rowmm_tile_kernel(RowsOfA A, const float* __restrict__ B, float* __restrict__ C, int M,
                       int N, int K, long long a_extent) {
  constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  constexpr int GN = TN / 4;
  constexpr int LDA = BK + 4, PA = LDA / 4;               // floats and pieces a row's span
  constexpr int A_COPIES = (BM * PA + THREADS - 1) / THREADS;
  static_assert(TN % 4 == 0 && BK % 4 == 0, "tile");
  static_assert((BK * BN) % THREADS == 0 && (BK * BN / 4) % THREADS == 0, "copies of B");
  __shared__ __align__(16) float As[STAGES][BM][LDA];
  __shared__ __align__(16) float Bs[STAGES][BK][BN];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float* a_end = A.a + a_extent;
  // the rows whose pieces this thread copies, as offsets from A (-1: past M)
  int acopy[A_COPIES];
#pragma unroll
  for (int j = 0; j < A_COPIES; ++j) {
    const int e = tid + j * THREADS, r = m0 + e / PA;
    acopy[j] = e < BM * PA && r < M ? (int)(A.row(r) - A.a) : -1;
  }
  // where this thread's rows sit in their spans (every chunk starts BK floats,
  // a multiple of 16 bytes, past the last)
  int aread[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + TY * i;
    aread[i] = r < M ? span_off(A.row(r)) : 0;
  }
  const bool b16 = N % 4 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  const int chunks = (K + BK - 1) / BK;

  auto issue = [&](int c) {
    const int s = c % STAGES, k0 = c * BK;
#pragma unroll
    for (int j = 0; j < A_COPIES; ++j) {
      const int e = tid + j * THREADS;
      if (acopy[j] >= 0) copy_piece(&As[s][e / PA][0], A.a + acopy[j] + k0, e % PA, a_end);
    }
    if (b16) {
#pragma unroll
      for (int j = 0; j < BK * BN / 4 / THREADS; ++j) {
        const int e = tid + j * THREADS, kk = e / (BN / 4), nn = 4 * (e % (BN / 4));
        const int k = k0 + kk, n = n0 + nn;
        if (k < K) cp_async16(&Bs[s][kk][nn], B + (size_t)k * N + n, n < N ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK * BN / THREADS; ++j) {
        const int e = tid + j * THREADS, kk = e / BN, nn = e % BN;
        const int k = k0 + kk, n = n0 + nn;
        if (k < K && n < N) cp_async4(&Bs[s][kk][nn], B + (size_t)k * N + n, 4);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < chunks) issue(c + STAGES - 1);
    cp_async_commit();
    const int s = c % STAGES;
    const int kc = min(BK, K - c * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk < kc) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[s][ty + TY * i][aread[i] + kk];
#pragma unroll
        for (int g = 0; g < GN; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(&Bs[s][kk][g * (BN / GN) + tx * 4]);
          b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + TY * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * (BN / GN) + tx * 4 + j % 4;
      if (n < N) C[(size_t)r * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// tile_product<BM, BN, TM, TN, BK, STAGES>: rowmm_tile_kernel's main loop
// for the fused entry's tile: each thread sums its TM x TN elements (columns
// (j / 4) (BN / GN) + 4 tx + j % 4) into acc. With round_a (the fused
// entry's bf16 operands) each thread rounds the pieces of A it copied, in
// shared memory, once a chunk, before the barrier that publishes them. The
// plain kernel keeps its own source: run through this function (the
// rounding compiled out) it compiled to other code and ran 0.8% slower at
// mmse's STFT shape on an H100 (32.52-32.75 ms against 32.40-32.48 in five
// alternating runs each).

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
__device__ __forceinline__ void tile_product(const RowsOfA& A, const float* __restrict__ B, int M,
                                             int N, int K, long long a_extent, bool round_a,
                                             float (&acc)[TM][TN]) {
  constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  constexpr int GN = TN / 4;
  constexpr int LDA = BK + 4, PA = LDA / 4;               // floats and pieces a row's span
  constexpr int A_COPIES = (BM * PA + THREADS - 1) / THREADS;
  static_assert(TN % 4 == 0 && BK % 4 == 0, "tile");
  static_assert((BK * BN) % THREADS == 0 && (BK * BN / 4) % THREADS == 0, "copies of B");
  __shared__ __align__(16) float As[STAGES][BM][LDA];
  __shared__ __align__(16) float Bs[STAGES][BK][BN];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float* a_end = A.a + a_extent;
  // the rows whose pieces this thread copies, as offsets from A (-1: past M)
  int acopy[A_COPIES];
#pragma unroll
  for (int j = 0; j < A_COPIES; ++j) {
    const int e = tid + j * THREADS, r = m0 + e / PA;
    acopy[j] = e < BM * PA && r < M ? (int)(A.row(r) - A.a) : -1;
  }
  // where this thread's rows sit in their spans (every chunk starts BK floats,
  // a multiple of 16 bytes, past the last)
  int aread[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + TY * i;
    aread[i] = r < M ? span_off(A.row(r)) : 0;
  }
  const bool b16 = N % 4 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  const int chunks = (K + BK - 1) / BK;

  auto issue = [&](int c) {
    const int s = c % STAGES, k0 = c * BK;
#pragma unroll
    for (int j = 0; j < A_COPIES; ++j) {
      const int e = tid + j * THREADS;
      if (acopy[j] >= 0) copy_piece(&As[s][e / PA][0], A.a + acopy[j] + k0, e % PA, a_end);
    }
    if (b16) {
#pragma unroll
      for (int j = 0; j < BK * BN / 4 / THREADS; ++j) {
        const int e = tid + j * THREADS, kk = e / (BN / 4), nn = 4 * (e % (BN / 4));
        const int k = k0 + kk, n = n0 + nn;
        if (k < K) cp_async16(&Bs[s][kk][nn], B + (size_t)k * N + n, n < N ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BK * BN / THREADS; ++j) {
        const int e = tid + j * THREADS, kk = e / BN, nn = e % BN;
        const int k = k0 + kk, n = n0 + nn;
        if (k < K && n < N) cp_async4(&Bs[s][kk][nn], B + (size_t)k * N + n, 4);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    if (round_a) {
      // this thread's copies of chunk c have landed: round them in place
      const int s = c % STAGES;
#pragma unroll
      for (int j = 0; j < A_COPIES; ++j) {
        const int e = tid + j * THREADS;
        if (acopy[j] >= 0) {
          float4* q = reinterpret_cast<float4*>(&As[s][e / PA][4 * (e % PA)]);
          float4 v = *q;
          v.x = koala::round_bf16(v.x);
          v.y = koala::round_bf16(v.y);
          v.z = koala::round_bf16(v.z);
          v.w = koala::round_bf16(v.w);
          *q = v;
        }
      }
    }
    __syncthreads();
    if (c + STAGES - 1 < chunks) issue(c + STAGES - 1);
    cp_async_commit();
    const int s = c % STAGES;
    const int kc = min(BK, K - c * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk < kc) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[s][ty + TY * i][aread[i] + kk];
#pragma unroll
        for (int g = 0; g < GN; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(&Bs[s][kk][g * (BN / GN) + tx * 4]);
          b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
}


// ---------------------------------------------------------------------------
// The fused entry (ops/kernels/rowmm.py ``fused``), for the bf16 products of
// Demucs's U-Net: a product (A rounded to bf16 on load where round_a), then,
// per element and in this order, each the IEEE f32 operation of the PyTorch
// op it stands for:
//   + bias[n];
//   ReLU (relu);
//   GLU (GLU): value x sigmoid(gate), the gate of the value in column
//     64 b + j (j < 32) being column 64 b + 32 + j (the caller lays the
//     weight's columns out so: ``rowmm.pair_glu``), summed by the same
//     thread; output column 32 b + j;
//   a bf16 round of the stored value (round_out; held as f32).
// The result goes where e.out's rows lie (as RowsOfA: a slice of a skip
// buffer). So the passes over an activation that PyTorch would make after
// the product (the bias add, ReLU, sigmoid, product of halves, rounding,
// copy into the buffer) and the rounded copy of the operand before it are
// never made. Two kernels, as the plain entry's plan: the 128 x 64 tile's
// (rowmm_fused_kernel, over ROW_MAX rows) and the narrow kernel's
// (rowmm_fused_narrow_kernel, at most ROW_MAX rows: one stream's hop), each
// with its plain kernel's main loop and chain.

struct Epilogue {
  const float* bias;      // [N]
  float* out;             // rows: (r / inner) s_outer + (r % inner) s_inner floats past out
  int inner;
  long long s_outer, s_inner;
  int relu, round_out, vec;

  __device__ __forceinline__ float* row(int r) const {
    return out + (long long)(r / inner) * s_outer + (long long)(r % inner) * s_inner;
  }

  // one element's output from its sum and bias (no GLU)
  __device__ __forceinline__ float one(float acc, float b) const {
    float x = __fadd_rn(acc, b);
    if (relu) x = koala::relu_keep_nan(x);
    return round_out ? koala::round_bf16(x) : x;
  }

  // a GLU's output from its value's and its gate's sums and biases
  __device__ __forceinline__ float glu(float value, float vb, float gate, float gb) const {
    const float x = __fmul_rn(__fadd_rn(value, vb), koala::sigmoidf(__fadd_rn(gate, gb)));
    return round_out ? koala::round_bf16(x) : x;
  }
};

constexpr int FUSED_BM = 128, FUSED_BN = 64, FUSED_THREADS = 128;

template <bool GLU>
__global__ void __launch_bounds__(FUSED_THREADS, 3)
    rowmm_fused_kernel(RowsOfA A, const float* __restrict__ B, Epilogue e, int M, int N, int K,
                       long long a_extent, int round_a) {
  constexpr int BM = FUSED_BM, BN = FUSED_BN, TM = 8, TN = 8, TX = BN / TN, TY = BM / TM;
  static_assert(BN == 2 * GLU_HALF, "a GLU's value and gate in one block");
  float acc[TM][TN];
  tile_product<BM, BN, TM, TN, 16, 3>(A, B, M, N, K, a_extent, round_a != 0, acc);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int m0 = blockIdx.x * BM;
  int col[TN];
  float bias[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    col[j] = blockIdx.y * BN + (j / 4) * (BN / 2) + tx * 4 + j % 4;
    bias[j] = col[j] < N ? __ldg(e.bias + col[j]) : 0.0f;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + TY * i;
    if (r >= M) continue;
    float* o = e.row(r);
    if (GLU) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = e.glu(acc[i][j], bias[j], acc[i][j + 4], bias[j + 4]);
      float* dst = o + blockIdx.y * (BN / 2) + tx * 4;
      if (e.vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[j] = v[j];
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = e.one(acc[i][4 * h + q], bias[4 * h + q]);
        if (e.vec && col[4 * h] < N) {
          *reinterpret_cast<float4*>(o + col[4 * h]) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col[4 * h + q] < N) o[col[4 * h + q]] = v[q];
        }
      }
    }
  }
}

// rowmm_fused_narrow_kernel<ROWS, KC, STAGES, GLU>: the narrow kernel's
// block (8 output columns, ROWS rows), a thread one output element: a chain
// (its column's), or with GLU two (its value's and its gate's, columns
// nb + l % 8 and nb + GLU_HALF + l % 8).

template <int ROWS, int KC, int STAGES, bool GLU>
__global__ void __launch_bounds__(NAR_THREADS)
    rowmm_fused_narrow_kernel(RowsOfA A, const float* __restrict__ B, Epilogue e, int M, int N,
                              int K, int round_a) {
  constexpr int NC = GLU ? 2 : 1;
  const int o0 = blockIdx.y * NAR_COLS;                 // the block's first output column
  const int nb = GLU ? 2 * GLU_HALF * (o0 / GLU_HALF) + o0 % GLU_HALF : o0;
  float acc[NC];
  narrow_product<ROWS, KC, STAGES, NC>(A, B, M, N, K, nb, round_a != 0, acc);
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = lane % NAR_COLS, row = w * NAR_SLOTS + lane / NAR_COLS;
  const int r = blockIdx.x * ROWS + row;
  if (row >= ROWS || r >= M || o0 + col >= (GLU ? N / 2 : N)) return;
  float* o = e.row(r) + o0 + col;
  if constexpr (GLU)
    *o = e.glu(acc[0], __ldg(e.bias + nb + col), acc[1], __ldg(e.bias + nb + GLU_HALF + col));
  else
    *o = e.one(acc[0], __ldg(e.bias + nb + col));
}


// ---------------------------------------------------------------------------
// The variants, by the number the host's plan gives (ops/kernels/rowmm.py
// VARIANTS mirrors this table; koala_rowmm_variant reports it).

struct Variant {
  int rows, cols, threads;
};

constexpr Variant VARIANTS[] = {
    {4, NAR_COLS, NAR_THREADS},       // 0 narrow<4,128,4>: up to 4 rows, 128 k a chunk
    {16, NAR_COLS, NAR_THREADS},      // 1 narrow<16,64,6>: 64 k a chunk
    {16, 32, 128},                    // 2 row<4,4>
    {COL_ROWS, 1, COL_ROWS},          // 3 col (N = 1)
    {128, 64, 128},                   // 4 tile<128,64>: 8 x 8 a thread, BK 16
    {128, 32, 128},                   // 5 tile<128,32>: 8 x 4, BK 16
    {64, 64, 128},                    // 6 tile<64,64>: 4 x 8, BK 16
};
constexpr int N_VARIANTS = sizeof(VARIANTS) / sizeof(VARIANTS[0]);
constexpr int COL = 3;

}  // namespace

// rowmm_simple_kernel: A [M, K], B [K, N], C [M, N], all float32,
// contiguous, row-major.
extern "C" int koala_rowmm_simple(const void* a, const void* b, void* c, int M, int N, int K,
                                  void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + RM_BM - 1) / RM_BM, (N + RM_BN - 1) / RM_BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  rowmm_simple_kernel<<<grid, RM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, M, N, K);
  return (int)cudaGetLastError();
}

// Rows, columns and threads of a variant's block: out[0..2]. Nonzero for a
// variant that does not exist.
extern "C" int koala_rowmm_variant(int variant, int* out) {
  if (variant < 0 || variant >= N_VARIANTS) return (int)cudaErrorInvalidValue;
  out[0] = VARIANTS[variant].rows;
  out[1] = VARIANTS[variant].cols;
  out[2] = VARIANTS[variant].threads;
  return 0;
}

// C [M, N] (contiguous) = A @ B (B [K, N] contiguous; A's rows as RowsOfA
// says: inner, s_outer, s_inner; a_extent floats from A's first element past
// its last), by ``variant`` on a grid of grid_rows x grid_cols blocks, which
// must cover C as the variant's block does.
extern "C" int koala_rowmm(const void* a, const void* b, void* c, int M, int N, int K,
                           int a_inner, long long a_outer_stride, long long a_inner_stride,
                           long long a_extent, int variant, int grid_rows, int grid_cols,
                           void* stream) {
  if (M < 1 || N < 1 || K < 0 || a_inner < 1 || variant < 0 || variant >= N_VARIANTS)
    return (int)cudaErrorInvalidValue;
  const Variant v = VARIANTS[variant];
  if (grid_rows != (M + v.rows - 1) / v.rows || grid_cols != (N + v.cols - 1) / v.cols ||
      grid_cols > 65535 || (variant == COL && N != 1) || a_extent >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const RowsOfA A{(const float*)a, a_inner, a_outer_stride, a_inner_stride};
  const float* B = (const float*)b;
  float* C = (float*)c;
  const dim3 grid(grid_rows, grid_cols);
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: rowmm_narrow_kernel<4, 128, 4><<<grid, v.threads, 0, s>>>(A, B, C, M, N, K); break;
    case 1: rowmm_narrow_kernel<16, 64, 6><<<grid, v.threads, 0, s>>>(A, B, C, M, N, K); break;
    case 2: rowmm_row_kernel<4, 4><<<grid, v.threads, 0, s>>>(A, B, C, M, N, K); break;
    case 3: rowmm_col_kernel<<<grid, v.threads, 0, s>>>(A, B, C, M, K, a_extent); break;
    case 4:
      rowmm_tile_kernel<128, 64, 8, 8, 16, 3><<<grid, v.threads, 0, s>>>(A, B, C, M, N, K,
                                                                         a_extent);
      break;
    case 5:
      rowmm_tile_kernel<128, 32, 8, 4, 16, 3><<<grid, v.threads, 0, s>>>(A, B, C, M, N, K,
                                                                         a_extent);
      break;
    default:
      rowmm_tile_kernel<64, 64, 4, 8, 16, 3><<<grid, v.threads, 0, s>>>(A, B, C, M, N, K,
                                                                        a_extent);
      break;
  }
  return (int)cudaGetLastError();
}

// The fused entry: out = epilogue(A @ B) by ``variant`` (0: the fused
// narrow<4,128,4>; 1: narrow<16,64,5>, five stages, so that a GLU's panel of
// 16 columns of B fits 48 KiB of static shared memory; 2: the tile<128,64>;
// ops/kernels/rowmm.py FUSED_VARIANTS mirrors these). A's rows as in
// koala_rowmm, out's likewise (out_inner, out_outer_stride,
// out_inner_stride; its columns contiguous: N of them, N / 2 with glu); bias
// [N]. glu takes N a multiple of 64 and no relu. Nonzero for what it does
// not take or a refused launch.
extern "C" int koala_rowmm_fused(const void* a, const void* b, const void* bias, void* out, int M,
                                 int N, int K, int a_inner, long long a_outer_stride,
                                 long long a_inner_stride, long long a_extent, int out_inner,
                                 long long out_outer_stride, long long out_inner_stride,
                                 int variant, int round_a, int glu, int relu, int round_out,
                                 void* stream) {
  if (M < 1 || N < 1 || K < 0 || a_inner < 1 || out_inner < 1 || a_extent >= (1ll << 31) ||
      variant < 0 || variant > 2 || (glu && (N % FUSED_BN != 0 || relu)))
    return (int)cudaErrorInvalidValue;
  const int rows = variant == 0 ? 4 : variant == 1 ? 16 : FUSED_BM;
  const int n_cols = variant == 2 ? N : glu ? N / 2 : N;        // columns the grid covers
  const int block_cols = variant == 2 ? FUSED_BN : NAR_COLS;
  const dim3 grid((M + rows - 1) / rows, (n_cols + block_cols - 1) / block_cols);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0 && out_outer_stride % 4 == 0 &&
                   out_inner_stride % 4 == 0 && (glu || N % 4 == 0);
  const RowsOfA A{(const float*)a, a_inner, a_outer_stride, a_inner_stride};
  const Epilogue e{(const float*)bias, (float*)out, out_inner, out_outer_stride, out_inner_stride,
                   relu, round_out, vec ? 1 : 0};
  const float* B = (const float*)b;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant * 2 + (glu ? 1 : 0)) {
    case 0:
      rowmm_fused_narrow_kernel<4, 128, 4, false><<<grid, NAR_THREADS, 0, s>>>(A, B, e, M, N, K,
                                                                                round_a);
      break;
    case 1:
      rowmm_fused_narrow_kernel<4, 128, 4, true><<<grid, NAR_THREADS, 0, s>>>(A, B, e, M, N, K,
                                                                               round_a);
      break;
    case 2:
      rowmm_fused_narrow_kernel<16, 64, 5, false><<<grid, NAR_THREADS, 0, s>>>(A, B, e, M, N, K,
                                                                                round_a);
      break;
    case 3:
      rowmm_fused_narrow_kernel<16, 64, 5, true><<<grid, NAR_THREADS, 0, s>>>(A, B, e, M, N, K,
                                                                               round_a);
      break;
    case 4:
      rowmm_fused_kernel<false><<<grid, FUSED_THREADS, 0, s>>>(A, B, e, M, N, K, a_extent,
                                                               round_a);
      break;
    default:
      rowmm_fused_kernel<true><<<grid, FUSED_THREADS, 0, s>>>(A, B, e, M, N, K, a_extent,
                                                              round_a);
      break;
  }
  return (int)cudaGetLastError();
}
