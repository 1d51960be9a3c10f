// Types and small device functions that every kernel of the package shares:
// the bf16 type, the activation functions in the forms the JAX package uses
// (the sigmoid is also PyTorch's float form, 1 / (1 + exp(-x))), PyTorch's
// bf16 rounding and ReLU, and the 128-byte rounding of shared-memory carving. The tensor-core and
// copy helpers are in resident.cuh, the tiled product in tile_gemm.cuh.
//
// Every product of the package has the numerics of the JAX package's
// compute_dtype=bfloat16 products: both operands rounded to bf16, products
// summed in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace koala {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// PyTorch's t.bfloat16().float(): round to the nearest bf16, ties to even.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// PyTorch's relu on a float (clamp_min(x, 0)): a NaN stays a NaN.
__device__ __forceinline__ float relu_keep_nan(float x) { return isnan(x) ? x : fmaxf(x, 0.0f); }

// jax.nn.gelu's default form (approximate=True): the tanh approximation.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

// Round up to a multiple of 32 floats (128 bytes), for shared-memory carving.
__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

}  // namespace koala
