// Type helpers of the decode attention bodies: the bf16/f32 split body
// (decode_split.cuh, decode_attention and paged_decode_attention) and the
// int8 split body (decode_int8_split.cuh, decode_attention_int8 and
// paged_decode_attention_int8) read q and K/V as float32 and write the
// output in q's type through these. Arithmetic is float32 throughout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace decode_attention_detail {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace decode_attention_detail
