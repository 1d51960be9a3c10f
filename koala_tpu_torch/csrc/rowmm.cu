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
// Arithmetic: each element of C is summed by one thread, in one f32
// register, as fmaf(a[k], b[k], acc) for k = 0, 1, ..., K - 1 in that order,
// from acc = 0. No split-K, no tree, no tensor cores, no TF32: true float32,
// as the port's STFT promises, and the bf16-operand products hand it values
// already rounded to bf16. The tile shape, the K chunk and the loop are
// compile-time constants; M and N only decide how many tiles there are.
//
// Bound on this card: at the main path's shapes (M = B x T = 24064 rows,
// K and N of 1 to 512) the work is operations (2 M N K f32 FMA work on the
// CUDA cores, 67 TFLOP/s): the nine products of a process_chunk call are
// about 38 GFLOP, 0.58 ms; their bytes (each operand once, C once) take
// about 0.1 ms. The design is the plain SIMT tiling that keeps the order
// fixed: a block of 256 threads owns a 64 x 64 tile of C, stages 16-wide
// K chunks of A (transposed) and B in shared memory, and each thread keeps
// a 4 x 4 block of C in registers, reading a float4 of each operand per k.
// Faster layouts (wgmma would change the order) are later work.

#include "common.cuh"

namespace {

constexpr int RM_BM = 64;                     // rows of C a block owns
constexpr int RM_BN = 64;                     // columns of C a block owns
constexpr int RM_BK = 16;                     // k of a shared-memory chunk
constexpr int RM_TM = 4;                      // rows of C a thread owns
constexpr int RM_TN = 4;                      // columns of C a thread owns
constexpr int RM_THREADS = (RM_BM / RM_TM) * (RM_BN / RM_TN);   // 256

__global__ void __launch_bounds__(RM_THREADS)
    rowmm_kernel(const float* __restrict__ A, const float* __restrict__ B,
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

}  // namespace

// A [M, K], B [K, N], C [M, N], all float32, contiguous, row-major.
extern "C" int koala_rowmm(const void* a, const void* b, void* c, int M, int N, int K,
                           void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + RM_BM - 1) / RM_BM, (N + RM_BN - 1) / RM_BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  rowmm_kernel<<<grid, RM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, M, N, K);
  return (int)cudaGetLastError();
}
