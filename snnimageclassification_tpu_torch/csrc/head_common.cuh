// Shared by the whole-network head kernels (fused_head.cu: forward;
// fused_head_bwd.cu: backward): weight-type conversions and the integer
// spike test of the two encodings.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float w) { return w; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

// float -> the weights' type, round to nearest even (as torch's .to()).
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// x rounded through the weights' type, back in float.
template <typename W>
__device__ __forceinline__ float round_w(float x) {
  W w;
  from_f32(x, &w);
  return to_f32(w);
}

// Spike of a feature with latency L at step t.  TTFS: one spike at t == L
// (a latency outside [0, T) never fires).  Periodic: period clamped to
// [1, T-1], spike where t >= p and (t - p) % p == 0, in integers, with
// x % 0 == 0 as in ops/encoding.py.
__device__ __forceinline__ bool fires(int L, int t, int T, int periodic) {
  if (!periodic) return L == t;
  int p = min(max(L, 1), T - 1);
  int d = t - p;
  if (d < 0) return false;
  return p <= 0 ? true : (d % p) == 0;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

}  // namespace
