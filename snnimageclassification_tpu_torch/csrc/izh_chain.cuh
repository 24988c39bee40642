// The Izhikevich chains as policies of the tensor-core chain body
// (chain_mma.cuh:bwd_chain_mma_kernel), each stepping with
// izh_common.cuh:izh_chain_step as the per-unit izh_chain_kernel does: the
// head's IzhChain and the z-layer mode's IzhZChain (fused_izh_bwd.cu), and
// IzhScanChain, IzhZChain under a name of its own for profiles
// (izh_scan.cu: a layer past the first).
#pragma once

#include "chain_mma.cuh"
#include "izh_common.cuh"

namespace {

// The head's Izhikevich chain as a policy of the tensor-core body
// (chain_mma.cuh): per entry v(t) and the carries dv(t+1), du(t+1), stepped
// by izh_chain_step as izh_chain_kernel does, with z(t) = v(t) >= v_peak.
struct IzhChain {
  static constexpr bool HEAD = true;
  using Args = IzhChainArgs;
  struct State {
    float v, dv, du;
  };

  __device__ explicit IzhChain(const Args&) {}

  __device__ State start(const Args& a, size_t at, bool ok) const {
    return State{ok ? a.v[(size_t)(a.T - 1) * a.B * a.H + at] : 0.f, 0.f,
                 0.f};
  }

  __device__ float step(const Args& a, State& s, float dz, int t, size_t at,
                        bool ok, bool& z) const {
    const IzhBwd& p = a.p;
    const bool prev = ok && t > 0;
    const float v_prev =
        prev ? a.v[(size_t)(t - 1) * a.B * a.H + at] : 0.f;
    const bool z_prev = prev && v_prev >= p.v_peak;
    z = ok && s.v >= p.v_peak;
    float dv = s.dv, du = s.du;
    const float gi = izh_chain_step(p, s.v, z, z_prev, dz, dv, du);
    s.dv = ok ? dv : 0.f;
    s.du = ok ? du : 0.f;
    s.v = v_prev;
    return ok ? gi : 0.f;
  }
};

// A first layer's Izhikevich chain as a policy of the tensor-core body in
// its z-layer mode (O = 0): per entry v(t), z(t) as stored and g_z(t), each
// loaded a step ahead (at step t + 1) off the serial chain, and the carries
// dv(t+1), du(t+1), stepped by izh_chain_step as izh_chain_kernel's
// first-layer mode does; dz(t) = g_z(t) + round(gi(t+1)) @ W_rec^T.
struct IzhZChain {
  static constexpr bool HEAD = false;
  using Args = IzhChainArgs;
  struct State {
    float v, dv, du, gz;
    bool z_t;
  };

  __device__ explicit IzhZChain(const Args&) {}

  __device__ State start(const Args& a, size_t at, bool ok) const {
    const size_t last = (size_t)(a.T - 1) * a.B * a.H + at;
    State s{0.f, 0.f, 0.f, 0.f, false};
    if (ok) {
      s.v = a.v[last];
      s.z_t = a.z[last] != 0.f;
      s.gz = a.g_z[last];
    }
    return s;
  }

  __device__ float input(const State& s) const { return s.gz; }

  __device__ float step(const Args& a, State& s, float dz, int t, size_t at,
                        bool ok, bool& z) const {
    const bool prev = ok && t > 0;
    const size_t at_prev = prev ? (size_t)(t - 1) * a.B * a.H + at : 0;
    const float v_prev = prev ? a.v[at_prev] : 0.f;
    const bool z_prev = prev && a.z[at_prev] != 0.f;
    const float gz_prev = prev ? a.g_z[at_prev] : 0.f;
    z = ok && s.z_t;
    float dv = s.dv, du = s.du;
    const float gi = izh_chain_step(a.p, s.v, s.z_t, z_prev, dz, dv, du);
    s.dv = ok ? dv : 0.f;
    s.du = ok ? du : 0.f;
    s.v = v_prev;
    s.z_t = z_prev;
    s.gz = gz_prev;
    return ok ? gi : 0.f;
  }
};

// izh_scan_bwd's chain: IzhZChain's arithmetic; the body writes the
// float32 g_i (T, B, H) of the launch's Args and no dcur
// (chain_mma.cuh:ScanOut): gbits_mma reads g_i itself (izh_scan.cu).
struct IzhScanChain : IzhZChain {
  static constexpr bool SCAN_OUT = true;
  using IzhZChain::IzhZChain;
};

}  // namespace
