// Shared by every kernel source of the port: weight-type conversions, the
// integer spike test and spike key of the two encodings, sums over the set
// bits of a spike mask and the readout step of the head kernels.
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

// A pair of adjacent entries (row, col) and (row, col + 1) at p: one 8- or
// 4-byte access where `two` and p is aligned to it (a stacked replica's
// trace starts at s T B H elements, odd when T B H is), else one at a time.
template <typename W>
__device__ __forceinline__ void store_pair(W* p, float x0, float x1,
                                           bool two) {
  if (two && reinterpret_cast<uintptr_t>(p) % (2 * sizeof(W)) == 0) {
    if constexpr (sizeof(W) == 4) {
      *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
    }
    return;
  }
  from_f32(x0, p);
  if (two) from_f32(x1, p + 1);
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

// The key of a feature with latency L, or -1: it never fires.  TTFS the
// latency (it fires at t = L iff 0 <= L < T); periodic the clamped period p
// (it fires at t = p, 2p, ..; at T = 1 the period is 0 and the one step
// fires).
__device__ __forceinline__ int enc_key(int L, int T, int periodic) {
  if (periodic) return T >= 2 ? min(max(L, 1), T - 1) : 0;
  return (L >= 0 && L < T) ? L : -1;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Sum of w[j * stride] over the set bits j of mask words m[0..nw), in
// ascending j.
template <typename W>
__device__ __forceinline__ float masked_sum(const unsigned* m, int nw,
                                            const W* w, int stride) {
  float acc = 0.f;
  for (int k = 0; k < nw; ++k) {
    unsigned bits = m[k];
    while (bits) {
      const int j = (k << 5) + __ffs(bits) - 1;
      bits &= bits - 1u;
      acc += to_f32(w[j * stride]);
    }
  }
  return acc;
}

// Readout of one row at one step: r = z @ W_out + b, v_r = kappa v_r + r,
// running max with strict > (the first maximal step wins, as torch.max);
// in training also the step of that max.
template <bool TRAIN, typename W>
__device__ __forceinline__ void readout_row(int O, float kappa,
                                            const W* s_wout, const float* s_b,
                                            const unsigned* zmask, int nw,
                                            float* vr, float* m, int* ts,
                                            int step, int lane) {
  for (int o = lane; o < O; o += 32) {
    const float r = masked_sum(zmask, nw, s_wout + o, O) + s_b[o];
    const float v = kappa * vr[o] + r;
    vr[o] = v;
    if (v > m[o]) {
      m[o] = v;
      if (TRAIN) ts[o] = step;
    }
  }
}

}  // namespace
