// Izhikevich whole-network head and first layer, forward: latencies -> spike
// rows -> W_in -> (recurrent) Izhikevich scan [-> readout kappa-integrator ->
// first-argmax max over time].
//
// One template, three modes:
//   * head, inference (HEAD, !TRAIN): only the logits leave the kernel;
//   * head, training (HEAD, TRAIN): the same arithmetic in the same order,
//     so bitwise-equal logits, plus the membrane trace v (T, B, H) in float32
//     whatever the weights' type (the backward recomputes z = v >= v_peak
//     from it), the argmax step tstar (B, O) and on request the spike counts
//     (B, H);
//   * first layer of a deeper network (!HEAD): the spike trace z (T, B, H)
//     in float32 and, for training, v (T, B, H) float32.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused_izh.py:_izh_fwd_kernel
// (pl.pallas_call in _izh_fwd_call: head=True at :464, head=False at :484),
// the forward of fused_encode_izh_scan[_head[_counts]], and the head's
// stacked-replica mode (:371-374, :450-463): S seeds of an ensemble in one
// launch, one block per (row tile, replica), the latencies shared.
//
// The kernel, its shared-memory layout and its launch are head_fwd.cuh's
// (shared with fused_head.cu, so bounds and design are those of the LIF/ALIF
// kernels: the latency of the serial T-chain); the Izhikevich cell is the
// IzhCell policy below, its step izh_common.cuh's izh_step.

#include "izh_common.cuh"
#include "head_fwd.cuh"

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

}  // namespace

extern "C" {

// Rows per block and shared-memory bytes for a shape on `device` (O == 0:
// the first-layer mode).  Returns 0 when the shape fits, 1 when it does
// not, or a CUDA error code.
int snn_fused_izh_plan(int F, int H, int O, int rec, int bf16, int device,
                       int* rows_out, int* smem_out) {
  return plan(F, H, O, rec, bf16, device, rows_out, smem_out);
}

// The head: logits, and where any of v_tr, tstar, counts is not null (the
// training kernel) each of those that is not.  S stacked replicas (S = 1:
// one network; head_fwd.cuh): weights (S, ...), outputs and v (S, ...).
int snn_fused_izh_fwd(const int* lat, const void* w_in, const void* w_rec,
                      const void* w_out, const float* b_out, float* logits,
                      float* v_tr, int* tstar, float* counts, int B, int F,
                      int H, int O, int T, int periodic, int bf16, float dt,
                      float C, float v_rest, float v_th, float k, float a_,
                      float b_, float c, float d, float v_peak, float kappa,
                      int rows, int S, int device, void* stream) {
  FwdArgs<IzhCellParams> a{
      lat, w_in, w_rec, w_out, b_out, logits, tstar, counts, B, F, H, O, T,
      periodic, kappa,
      {IzhParams{dt, C, v_rest, v_th, k, a_, b_, c, d, v_peak}, nullptr,
       v_tr}};
  const bool train = v_tr || tstar || counts;
  return train
             ? run<IzhCell, true, true>(a, bf16, rows, device, stream, S)
             : run<IzhCell, false, true>(a, bf16, rows, device, stream, S);
}

// The first layer of a deeper network: z (T, B, H), and v (T, B, H) where
// v_tr is not null.
int snn_fused_izh_layer0_fwd(const int* lat, const void* w_in,
                             const void* w_rec, float* z, float* v_tr, int B,
                             int F, int H, int T, int periodic, int bf16,
                             float dt, float C, float v_rest, float v_th,
                             float k, float a_, float b_, float c, float d,
                             float v_peak, int rows, int device,
                             void* stream) {
  FwdArgs<IzhCellParams> a{
      lat, w_in, w_rec, nullptr, nullptr, nullptr, nullptr, nullptr, B, F, H,
      0, T, periodic, 0.f,
      {IzhParams{dt, C, v_rest, v_th, k, a_, b_, c, d, v_peak}, z, v_tr}};
  return v_tr ? run<IzhCell, true, false>(a, bf16, rows, device, stream)
              : run<IzhCell, false, false>(a, bf16, rows, device, stream);
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
