// The Izhikevich cell as a policy of the forward bodies: IzhCell of the
// per-unit template (head_fwd.cuh) and IzhMmaCell of the tensor-core body
// (head_mma_fwd.cuh), both stepping with izh_common.cuh:izh_step.
// fused_izh.cu runs them for the head and the first layer, izh_scan.cu
// IzhMmaCell for a layer past the first (its currents given).
#pragma once

#include "izh_common.cuh"

namespace {

struct IzhCellParams {
  IzhParams p;
  float* z;     // (T, B, H) float32, first-layer mode
  float* v_tr;  // (T, B, H) float32 or null: the membrane after each step

  // Replica s of a stacked launch: its traces, n elements (T B H) a
  // replica (float32 whatever the weights' type W).
  template <typename W>
  __device__ IzhCellParams at_replica(int s, size_t n) const {
    IzhCellParams q = *this;
    if (q.z) q.z += s * n;
    if (q.v_tr) q.v_tr += s * n;
    return q;
  }
};

// v starts at v_rest and u at 0; z = [v >= v_peak] after the step.
struct IzhCell {
  using Params = IzhCellParams;
  float v, u = 0.f;

  __device__ explicit IzhCell(const Params& q) : v(q.p.v_rest) {}

  __device__ bool step(const Params& q, float cur, float zp) {
    izh_step(q.p, cur, zp, v, u);
    return v >= q.p.v_peak;
  }

  template <bool TRAIN, bool HEAD, typename W>
  __device__ void store(const Params& q, size_t at, bool z) const {
    if (!HEAD) q.z[at] = z ? 1.f : 0.f;
    if (TRAIN && q.v_tr) q.v_tr[at] = v;
  }
};

// The cell policy of the tensor-core body (head_mma_fwd.cuh): IzhCell's
// step on one (v, u) State a (row, unit) entry; training stores v in
// float32, each lane its two adjacent units of a row as one 8-byte store
// where their address is 8-byte aligned; a first layer's z trace, float32
// whatever the weights' type, is q.z.
struct IzhMmaCell {
  using Params = IzhCellParams;
  struct State {
    float v, u;
  };

  __device__ explicit IzhMmaCell(const Params&) {}

  __device__ State start(const Params& q) const {
    return State{q.p.v_rest, 0.f};
  }

  __device__ bool step(const Params& q, State& s, float cur, float zp) const {
    izh_step(q.p, cur, zp, s.v, s.u);
    return s.v >= q.p.v_peak;
  }

  template <typename W>
  __device__ void store(const Params& q, const State& s0, const State& s1,
                        size_t at, bool two) const {
    if (q.v_tr) store_pair(q.v_tr + at, s0.v, s1.v, two);
  }

  template <typename W>
  __device__ float* z_out(const Params& q) const {
    return q.z;
  }
};

}  // namespace
