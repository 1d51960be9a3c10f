// The tail of a transposed convolution of kernel 8 and stride 4 (Demucs's
// decoder, models/demucs.py), in one pass over its product.
//
// Replaces no TPU kernel: the JAX package has no Demucs. The product p [rows,
// n, 2, 4, C] (ops/kernels/rowmm.py: input position i's two halves of 4
// output positions each) comes from rowmm; what follows it were five or six
// PyTorch passes over a full activation: the overlap-add, the bias, ReLU, the
// next level's skip add, the bf16 rounding of the next product's operand,
// and the copy of the carried overlap. Here each output element is made by
// one thread in one read of p, with the same IEEE f32 operations in the same
// order:
//
//   out[s, 4 i + q, c] = round(relu((p[s, i, 0, q, c] + prev) + bias[c]) + skip[s, 4 i + q, c])
//   prev = p[s, i - 1, 1, q, c] for i > 0, carry[s, q, c] for i = 0
//   carry'[s, q, c]    = p[s, n - 1, 1, q, c]
//
// ReLU, the skip and the rounding each only where asked for (the last level
// has none of them). Bound on this card: bytes (p read once, the skip read
// and out written once: at Demucs's level 2, 2048 streams and a block of 8
// hops, 2.1 + 1.1 + 1.1 GB, ~1.3 ms at 3.35 TB/s). A thread takes 4
// channels with 16-byte loads and stores where C and the pointers allow,
// else one.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int S = 4;           // output positions an input position makes a half
constexpr int THREADS = 256;

template <int V>
__device__ __forceinline__ void load(float (&x)[V], const float* p) {
  if (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// Thread t makes out elements V t .. V t + V - 1 of [rows, S n, C]
// (``total`` = rows S n C / V threads).
template <int V>
__global__ void __launch_bounds__(THREADS)
    overlap_add_kernel(const float* __restrict__ p, const float* __restrict__ carry,
                       const float* __restrict__ bias, const float* __restrict__ skip,
                       float* __restrict__ out, float* __restrict__ carry_out, int n, int C,
                       int total, long long skip_stride, int relu, int round_out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int e = (int)t * V;
  const int c = e % C, pos = (e / C) % (S * n), s = e / C / (S * n);
  const int i = pos / S, q = pos % S;
  const long long first = (((long long)s * n + i) * 2 * S + q) * C + c;    // p[s, i, 0, q, c]
  float x0[V], x1[V], b[V];
  load<V>(x0, p + first);
  if (i > 0)
    load<V>(x1, p + first - S * C);                                         // p[s, i - 1, 1, q, c]
  else
    load<V>(x1, carry + ((long long)s * S + q) * C + c);
  load<V>(b, bias + c);
  float y[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    y[v] = __fadd_rn(__fadd_rn(x0[v], x1[v]), b[v]);
    if (relu) y[v] = koala::relu_keep_nan(y[v]);
  }
  if (skip != nullptr) {
    float k[V];
    load<V>(k, skip + (long long)s * skip_stride + (long long)pos * C + c);
#pragma unroll
    for (int v = 0; v < V; ++v) y[v] = __fadd_rn(y[v], k[v]);
  }
  if (round_out) {
#pragma unroll
    for (int v = 0; v < V; ++v) y[v] = koala::round_bf16(y[v]);
  }
  store<V>(out + e, y);
  if (i == n - 1) {
    float z[V];
    load<V>(z, p + first + S * C);                                          // p[s, n - 1, 1, q, c]
    store<V>(carry_out + ((long long)s * S + q) * C + c, z);
  }
}

}  // namespace

// p [rows, n, 2, 4, C], carry and carry_out [rows, 4, C], bias [C], out
// [rows, 4 n, C], all float32 and contiguous; skip (or null) [rows, 4 n, C]
// with rows skip_stride floats apart. Nonzero for what it does not take or a
// refused launch.
extern "C" int koala_overlap_add(const void* p, const void* carry, const void* bias,
                                 const void* skip, void* out, void* carry_out, int rows, int n,
                                 int C, long long skip_stride, int relu, int round_out,
                                 void* stream) {
  if (rows < 1 || n < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long elems = (long long)rows * S * n * C;
  if (elems * 2 >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(carry) |
                         reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(skip) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(carry_out)) & 15) == 0;
  const bool vec = C % 4 == 0 && skip_stride % 4 == 0 && aligned;
  const int total = (int)(vec ? elems / 4 : elems);
  const dim3 grid((total + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  const float* P = (const float*)p;
  if (vec)
    overlap_add_kernel<4><<<grid, THREADS, 0, st>>>(
        P, (const float*)carry, (const float*)bias, (const float*)skip, (float*)out,
        (float*)carry_out, n, C, total, skip_stride, relu, round_out);
  else
    overlap_add_kernel<1><<<grid, THREADS, 0, st>>>(
        P, (const float*)carry, (const float*)bias, (const float*)skip, (float*)out,
        (float*)carry_out, n, C, total, skip_stride, relu, round_out);
  return (int)cudaGetLastError();
}
