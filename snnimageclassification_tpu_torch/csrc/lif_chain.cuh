// The LIF/ALIF chains as policies of the tensor-core chain body
// (chain_mma.cuh:bwd_chain_mma_kernel), the arithmetic of
// bwd_common.cuh:bwd_chain_kernel per (row, unit) entry:
//   LifChain  the head mode (fused_head_bwd.cu, fused_mid_bwd.cu's head
//             mode, fused2_bwd.cu's layer 1): z(t) = [delta(t) >= 0];
//   ZChain    the z-layer mode (fused_layer0_bwd.cu, fused_mid_bwd.cu's
//             z-emitting mode, and fused2_bwd.cu's layer 0 with ZD): dz(t)
//             = g_z(t) (+ g_counts) + dcur(t+1) @ W_rec^T; z as stored, or
//             (ZD) the residual's sign; the residual the membrane v where
//             res_is_v.
#pragma once

#include "chain_mma.cuh"

namespace {

// Per entry the residual delta of step t and dcur(t+1).
template <typename W>
struct LifChain {
  static constexpr bool HEAD = true;
  using Args = ::Args;
  struct State {
    float d_t, dcur;
  };
  const W* delta;
  const W* a_tr;
  float beta;

  __device__ explicit LifChain(const Args& a)
      : delta(static_cast<const W*>(a.delta)),
        a_tr(static_cast<const W*>(a.a_tr)),
        beta(a.a_tr ? *a.beta : 0.f) {}

  __device__ State start(const Args& a, size_t at, bool ok) const {
    return State{
        ok ? to_f32(delta[(size_t)(a.T - 1) * a.B * a.H + at]) : 0.f, 0.f};
  }

  __device__ float step(const Args& a, State& s, float dz, int t, size_t at,
                        bool ok, bool& z) const {
    const size_t step_stride = (size_t)a.B * a.H;
    const float d_prev =
        ok && t > 0 ? to_f32(delta[(size_t)(t - 1) * step_stride + at]) : -1.f;
    float thr = a.threshold;
    if (a_tr)
      thr = a.threshold +
            beta * (ok ? to_f32(a_tr[(size_t)t * step_stride + at]) : 0.f);
    const float surr = surrogate(a.phi, s.d_t, thr, a.gamma);
    const float dv = dz * surr + a.alpha * s.dcur;
    const float zp = d_prev >= 0.f ? 1.f : 0.f;
    s.dcur = ok ? dv * (1.f - zp) : 0.f;
    z = ok && s.d_t >= 0.f;
    s.d_t = d_prev;
    return s.dcur;
  }
};

// Per entry the residual of step t, z(t), dcur(t+1) and g_z(t), each loaded
// a step ahead (at step t + 1) off the serial chain.  g_z is read as GZ
// (float32 for fused2's layer 0, else the weights' type).
template <typename W, typename GZ, bool ZD>
struct ZChain {
  static constexpr bool HEAD = false;
  using Args = ::Args;
  struct State {
    float d_t, dcur, gz;
    bool z_t;
  };
  const W* res;
  const W* a_tr;
  const W* z_tr;
  const GZ* g_z;
  float beta;

  __device__ explicit ZChain(const Args& a)
      : res(static_cast<const W*>(a.delta)),
        a_tr(static_cast<const W*>(a.a_tr)),
        z_tr(static_cast<const W*>(a.z)),
        g_z(static_cast<const GZ*>(a.g_z)),
        beta(a.a_tr ? *a.beta : 0.f) {}

  __device__ State start(const Args& a, size_t at, bool ok) const {
    const size_t last = (size_t)(a.T - 1) * a.B * a.H + at;
    State s{0.f, 0.f, 0.f, false};
    if (ok) {
      s.d_t = to_f32(res[last]);
      s.z_t = ZD ? s.d_t >= 0.f : to_f32(z_tr[last]) != 0.f;
      s.gz = to_f32(g_z[last]);
    }
    return s;
  }

  __device__ float input(const State& s) const { return s.gz; }

  __device__ float step(const Args& a, State& s, float dz, int t, size_t at,
                        bool ok, bool& z) const {
    const size_t step_stride = (size_t)a.B * a.H;
    const bool prev = ok && t > 0;
    const size_t at_prev = prev ? (size_t)(t - 1) * step_stride + at : 0;
    const float d_prev = prev ? to_f32(res[at_prev]) : -1.f;
    const bool z_prev =
        ZD ? d_prev >= 0.f : prev && to_f32(z_tr[at_prev]) != 0.f;
    const float gz_prev = prev ? to_f32(g_z[at_prev]) : 0.f;
    float thr = a.threshold;
    if (a_tr)
      thr = a.threshold +
            beta * (ok ? to_f32(a_tr[(size_t)t * step_stride + at]) : 0.f);
    const float dlt = a.res_is_v ? s.d_t - thr : s.d_t;
    const float surr = surrogate(a.phi, dlt, thr, a.gamma);
    const float dv = dz * surr + a.alpha * s.dcur;
    const float zp = z_prev ? 1.f : 0.f;
    s.dcur = ok ? dv * (1.f - zp) : 0.f;
    z = ok && s.z_t;
    s.d_t = d_prev;
    s.z_t = z_prev;
    s.gz = gz_prev;
    return s.dcur;
  }
};

}  // namespace
