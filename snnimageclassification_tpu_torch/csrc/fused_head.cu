// Whole-network head forward for single-hidden-layer LIF/ALIF classifiers:
// latencies -> spike rows -> W_in -> (recurrent) LIF/ALIF scan -> readout
// kappa-integrator -> first-argmax max over time.
//
// Two kernels from one template.  fused_head_fwd (TRAIN = false): only the
// logits leave the kernel.  fused_head_fwd_train (TRAIN = true): the same
// arithmetic in the same order, so its logits are bitwise equal, plus what
// the backward (fused_head_bwd.cu) needs: the residual delta = V' - thr
// (and the adaptation trace a for ALIF with the Phi surrogate) as (T, B, H)
// in the weights' type, the argmax step tstar (B, O), and on request the
// spike counts (B, H).  A warp holds 32 consecutive units of one row, so
// each residual store of a warp is one contiguous segment.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused.py:_fused_fwd_kernel
// (head=True; pl.pallas_call in _fused_fwd_call): store_traces=False is the
// inference primal of fused_encode_{rec,ff}_scan_head, store_traces=True
// the training forward of those and of their _counts variants.
//
// A third kernel from the same template, fused_layer0_fwd (HEAD = false):
// the first layer of a deeper network, the same arithmetic with the readout
// compiled out, so its spikes are bitwise the spikes inside the head.  It
// writes the spike trace z (T, B, H) in the weights' type and, for training,
// the residual of the TPU kernel's head=False mode: delta for ALIF with the
// FastSigmoid surrogate, the membrane v otherwise (and a for ALIF with Phi).
// It replaces that mode of the same TPU kernel (fused_encode_{rec,ff}_scan).
//
// The cell, its state and its traces are the LifCell policy of
// lif_cell.cuh (shared with the two-layer kernel, fused2.cu); the
// kernel, its shared-memory layout and its launch are head_fwd.cuh's,
// shared with the Izhikevich kernels (fused_izh.cu).

#include "head_fwd.cuh"
#include "lif_cell.cuh"

namespace {

template <bool TRAIN, bool HEAD>
int run_lif(const FwdArgs<LifParams>& a, int alif, int bf16, int rows,
            int device, void* stream) {
  return alif ? run<LifCell<true>, TRAIN, HEAD>(a, bf16, rows, device, stream)
              : run<LifCell<false>, TRAIN, HEAD>(a, bf16, rows, device,
                                                 stream);
}

}  // namespace

extern "C" {

// Rows per block and shared-memory bytes for a shape on `device`.
// Returns 0 when the shape fits, 1 when it does not, or a CUDA error code.
int snn_fused_head_plan(int F, int H, int O, int rec, int bf16, int device,
                        int* rows_out, int* smem_out) {
  if (O < 1) return 1;
  return plan(F, H, O, rec, bf16, device, rows_out, smem_out);
}

int snn_fused_layer0_plan(int F, int H, int rec, int bf16, int device,
                          int* rows_out, int* smem_out) {
  return plan(F, H, 0, rec, bf16, device, rows_out, smem_out);
}

int snn_fused_head_fwd(const int* lat, const void* w_in, const void* w_rec,
                       const float* beta, const void* w_out,
                       const float* b_out, float* logits, int B, int F, int H,
                       int O, int T, int periodic, int alif, int bf16,
                       float alpha, float rho, float threshold, float kappa,
                       int rows, int device, void* stream) {
  FwdArgs<LifParams> a{lat, w_in, w_rec, w_out, b_out, logits, nullptr,
                       nullptr, B, F, H, O, T, periodic, kappa,
                       {beta, alpha, rho, threshold, nullptr, nullptr,
                        nullptr, 0}};
  return run_lif<false, true>(a, alif, bf16, rows, device, stream);
}

// The training forward: also writes delta, a_tr, tstar and counts, each
// where its pointer is not null.
int snn_fused_head_fwd_train(const int* lat, const void* w_in,
                             const void* w_rec, const float* beta,
                             const void* w_out, const float* b_out,
                             float* logits, void* delta, void* a_tr,
                             int* tstar, float* counts, int B, int F, int H,
                             int O, int T, int periodic, int alif, int bf16,
                             float alpha, float rho, float threshold,
                             float kappa, int rows, int device,
                             void* stream) {
  FwdArgs<LifParams> a{lat, w_in, w_rec, w_out, b_out, logits, tstar,
                       counts, B, F, H, O, T, periodic, kappa,
                       {beta, alpha, rho, threshold, nullptr, delta, a_tr,
                        0}};
  return run_lif<true, true>(a, alif, bf16, rows, device, stream);
}

// The first layer of a deeper network: writes z (T, B, H) and, where `res`
// is not null (training), the residual `res` (v where res_is_v, else
// v - thr) and `a_tr` where that is not null.
int snn_fused_layer0_fwd(const int* lat, const void* w_in, const void* w_rec,
                         const float* beta, void* z, void* res, void* a_tr,
                         int B, int F, int H, int T, int periodic, int alif,
                         int bf16, int res_is_v, float alpha, float rho,
                         float threshold, int rows, int device,
                         void* stream) {
  FwdArgs<LifParams> a{lat, w_in, w_rec, nullptr, nullptr, nullptr,
                       nullptr, nullptr, B, F, H, 0, T, periodic, 0.f,
                       {beta, alpha, rho, threshold, z, res, a_tr,
                        res_is_v}};
  return res ? run_lif<true, false>(a, alif, bf16, rows, device, stream)
             : run_lif<false, false>(a, alif, bf16, rows, device, stream);
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
