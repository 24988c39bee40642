// The LIF/ALIF cell of the forward kernels: its constants, its state and
// the traces it stores, as a cell policy of head_fwd.cuh's per-unit kernel
// (fused_head.cu) and as the two layers of fused2.cu (LifCell), and of the
// tensor-core body head_mma_fwd.cuh (LifMmaCell).
#pragma once

#include "head_common.cuh"

namespace {

struct LifParams {
  const float* beta;  // ALIF's adaptation strength, on the device
  float alpha, rho, threshold;
  void* z;      // (T, B, H) weights' type, first-layer mode
  void* delta;  // (T, B, H) weights' type or null: v - thr (v where res_is_v)
  void* a_tr;   // (T, B, H) weights' type or null: ALIF's adaptation trace
  int res_is_v;

  // Replica s of a stacked launch: its beta and its traces, n elements
  // (T B H) a replica.
  template <typename W>
  __device__ LifParams at_replica(int s, size_t n) const {
    LifParams p = *this;
    if (p.beta) p.beta += s;
    if (p.z) p.z = static_cast<W*>(p.z) + s * n;
    if (p.delta) p.delta = static_cast<W*>(p.delta) + s * n;
    if (p.a_tr) p.a_tr = static_cast<W*>(p.a_tr) + s * n;
    return p;
  }
};

// LIF (ALIF = false) or ALIF: v' = (alpha v + cur)(1 - z(t-1)), z' =
// [v' - thr >= 0] with thr = threshold (+ beta a', a' = rho a + z(t-1)).
// Returns v' - thr; the one copy of the cell's arithmetic (LifCell and the
// tensor-core head body, LifMmaCell).
template <bool ALIF>
__device__ __forceinline__ float lif_update(const LifParams& p, float beta,
                                            float cur, float zp, float& v,
                                            float& ad) {
  v = (p.alpha * v + cur) * (1.f - zp);
  float thr = p.threshold;
  if (ALIF) {
    ad = p.rho * ad + zp;
    thr = p.threshold + beta * ad;
  }
  return v - thr;
}

template <bool ALIF>
struct LifCell {
  using Params = LifParams;
  float beta, v = 0.f, ad = 0.f, delta = 0.f;

  __device__ explicit LifCell(const Params& p) : beta(ALIF ? *p.beta : 0.f) {}

  __device__ bool step(const Params& p, float cur, float zp) {
    delta = lif_update<ALIF>(p, beta, cur, zp, v, ad);
    return delta >= 0.f;
  }

  template <bool TRAIN, bool HEAD, typename W>
  __device__ void store(const Params& p, size_t at, bool z) const {
    if (!HEAD) from_f32(z ? 1.f : 0.f, static_cast<W*>(p.z) + at);
    if (TRAIN) {
      // Rounded to the weights' type once, here; the head's backward
      // recomputes z = (delta >= 0) from the stored value (the sign
      // survives).
      const float keep = (!HEAD && p.res_is_v) ? v : delta;
      if (p.delta) from_f32(keep, static_cast<W*>(p.delta) + at);
      if (ALIF && p.a_tr) from_f32(ad, static_cast<W*>(p.a_tr) + at);
    }
  }
};

// The cell policy of the tensor-core body (head_mma_fwd.cuh): the same
// step, one State a (row, unit) entry in the accumulator layout; training
// stores the residual (delta, or v for a first layer where res_is_v, as
// LifCell) and a for ALIF with Phi in the weights' type; a first layer's z
// trace is p.z.
template <bool ALIF>
struct LifMmaCell {
  using Params = LifParams;
  struct State {
    float v, ad, delta;
  };
  float beta;

  __device__ explicit LifMmaCell(const Params& p)
      : beta(ALIF ? *p.beta : 0.f) {}

  __device__ State start(const Params&) const { return State{0.f, 0.f, 0.f}; }

  __device__ bool step(const Params& p, State& s, float cur, float zp) const {
    s.delta = lif_update<ALIF>(p, beta, cur, zp, s.v, s.ad);
    return s.delta >= 0.f;
  }

  template <typename W>
  __device__ void store(const Params& p, const State& s0, const State& s1,
                        size_t at, bool two) const {
    if (p.delta) {
      W* out = static_cast<W*>(p.delta) + at;
      from_f32(p.res_is_v ? s0.v : s0.delta, out);
      if (two) from_f32(p.res_is_v ? s1.v : s1.delta, out + 1);
    }
    if (ALIF && p.a_tr) {
      from_f32(s0.ad, static_cast<W*>(p.a_tr) + at);
      if (two) from_f32(s1.ad, static_cast<W*>(p.a_tr) + at + 1);
    }
  }

  template <typename W>
  __device__ W* z_out(const Params& p) const {
    return static_cast<W*>(p.z);
  }
};

}  // namespace
