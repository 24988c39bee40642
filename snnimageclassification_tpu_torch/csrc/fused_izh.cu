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
// Two bodies, as the LIF/ALIF head's (fused_head.cu).  Every mode takes the
// tensor-core body of head_mma_fwd.cuh (head_sort_kernel + head_mma_kernel)
// with the IzhMmaCell policy (izh_cell.cuh) wherever it fits (O <= 16, O =
// 0 the first layer, H <= 256, W_rec's bf16 pieces within a block's shared
// memory): a warp owns 16 rows x 32 units, each entry's v and u in
// registers in the accumulator layout, z(t-1) @ W_rec and z(t-1) @ W_out
// on tensor cores, the input current from each row's features sorted by
// spike key once; the first layer without the readout, its z(t) written
// from the tile's exchange buffer in 16-byte float4 stores.  What bounds it
// on an H100 is the serial T-chain, whose step the body keeps on tensor
// cores and in registers; the Izhikevich step has about twice the LIF
// step's element-wise work.  Other shapes take the per-unit body,
// head_fwd.cuh's kernel with the IzhCell policy (one thread a (row, unit),
// the sums as walks over spike bits).  Both step the cell with
// izh_common.cuh's izh_step.

#include "head_mma_fwd.cuh"
#include "izh_cell.cuh"

namespace {

// One launch of the head (HEAD) for S replicas or of the first layer
// (!HEAD, S = 1) on the body the plan gives the shape (run_head_body).
template <bool TRAIN, bool HEAD>
int run_head(const FwdArgs<IzhCellParams>& a, int bf16, void* lists, int S,
             int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_head_body(
      a, bf16, lists, S, device,
      [&](uint16_t* l) {
        return bf16
                   ? run_mma_body<IzhMmaCell, TRAIN, HEAD, __nv_bfloat16>(
                         a, l, S, device, s)
                   : run_mma_body<IzhMmaCell, TRAIN, HEAD, float>(
                         a, l, S, device, s);
      },
      [&](int rows) {
        return run<IzhCell, TRAIN, HEAD>(a, bf16, rows, device, stream, S);
      });
}

}  // namespace

extern "C" {

// Whether the Izhikevich kernels take a shape on `device`, and with which
// body (O == 0: the first-layer mode): 0 when they do (*mma_out = 1: the
// mma body, which needs the list scratch; 0: the per-unit body), 1 when
// they do not, or a CUDA error code.
int snn_fused_izh_plan(int F, int H, int O, int rec, int bf16, int device,
                       int* mma_out) {
  int rows = 0, smem = 0;
  return head_plan(F, H, O, rec, bf16, device, &rows, &smem, mma_out);
}

// The head: logits, and where any of v_tr, tstar, counts is not null (the
// training kernel) each of those that is not.  S stacked replicas (S = 1:
// one network): weights (S, ...), outputs and v (S, ...).  `lists`: the mma
// body's scratch (snn_fused_izh_plan), null for the per-unit body.
int snn_fused_izh_fwd(const int* lat, const void* w_in, const void* w_rec,
                      const void* w_out, const float* b_out, float* logits,
                      float* v_tr, int* tstar, float* counts, void* lists,
                      int B, int F, int H, int O, int T, int periodic,
                      int bf16, float dt, float C, float v_rest, float v_th,
                      float k, float a_, float b_, float c, float d,
                      float v_peak, float kappa, int S, int device,
                      void* stream) {
  if (O < 1) return (int)cudaErrorInvalidValue;
  FwdArgs<IzhCellParams> a{
      lat, w_in, w_rec, w_out, b_out, logits, tstar, counts, B, F, H, O, T,
      periodic, kappa,
      {IzhParams{dt, C, v_rest, v_th, k, a_, b_, c, d, v_peak}, nullptr,
       v_tr}};
  const bool train = v_tr || tstar || counts;
  return train ? run_head<true, true>(a, bf16, lists, S, device, stream)
               : run_head<false, true>(a, bf16, lists, S, device, stream);
}

// The first layer of a deeper network: z (T, B, H), and v (T, B, H) where
// v_tr is not null.  `lists`: the mma body's scratch (snn_fused_izh_plan
// with O = 0), null for the per-unit body.
int snn_fused_izh_layer0_fwd(const int* lat, const void* w_in,
                             const void* w_rec, float* z, float* v_tr,
                             void* lists, int B, int F, int H, int T,
                             int periodic, int bf16, float dt, float C,
                             float v_rest, float v_th, float k, float a_,
                             float b_, float c, float d, float v_peak,
                             int device, void* stream) {
  FwdArgs<IzhCellParams> a{
      lat, w_in, w_rec, nullptr, nullptr, nullptr, nullptr, nullptr, B, F, H,
      0, T, periodic, 0.f,
      {IzhParams{dt, C, v_rest, v_th, k, a_, b_, c, d, v_peak}, z, v_tr}};
  return v_tr ? run_head<true, false>(a, bf16, lists, 1, device, stream)
              : run_head<false, false>(a, bf16, lists, 1, device, stream);
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
