// Whole-network head forward for single-hidden-layer LIF/ALIF classifiers:
// latencies -> spike rows -> W_in -> (recurrent) LIF/ALIF scan -> readout
// kappa-integrator -> first-argmax max over time.
//
// Two kernels.  fused_head_fwd (TRAIN = false): only the logits leave the
// kernel.  fused_head_fwd_train (TRAIN = true): the same arithmetic in the
// same order, so its logits are bitwise equal, plus what the backward
// (fused_head_bwd.cu) needs: the residual delta = V' - thr (and the
// adaptation trace a for ALIF with the Phi surrogate) as (T, B, H) in the
// weights' type, the argmax step tstar (B, O), and on request the spike
// counts (B, H).
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused.py:_fused_fwd_kernel
// (head=True; pl.pallas_call in _fused_fwd_call): store_traces=False is the
// inference primal of fused_encode_{rec,ff}_scan_head, store_traces=True
// the training forward of those and of their _counts variants.
//
// Both head kernels also run S stacked replicas in one launch (an ensemble
// of seeds on one batch): weights (S, ...), beta (S), logits (S, B, O),
// traces (S, T, B, H); the latencies are shared.  That replaces the
// stacked mode of the same TPU kernel (w_in.ndim == 3,
// pallas_fused.py:596-702), the forward of the ensemble's
// forward_logits_pixels_stacked.  A block takes one replica (grid y) and
// offsets its weights, beta, outputs and traces by the replica's stride, so
// a replica's arithmetic is a single launch's, bit for bit.
//
// The mma body (head_mma_fwd.cuh: head_sort_kernel + head_mma_kernel, the
// LIF/ALIF cell lif_cell.cuh:LifMmaCell; every shape with O <= 16, H <= 256
// and W_rec's bf16 pieces within a block's shared memory): a warp owns 16
// rows x 32 units in registers, the recurrent and readout products of z
// on tensor cores, the input current from each row's features sorted by
// spike key once.  What bounds it on an H100 is the serial T-chain; the
// design keeps each step on tensor cores and in registers.
// The per-unit body (head_fwd.cuh, one thread a (row, unit), the recurrent
// and readout sums as walks over spike bits on CUDA cores) takes the other
// shapes the plan accepts: O > 16, H > 256, float32 W_rec past H ~ 160.
//
// A third kernel, fused_layer0_fwd (HEAD = false): the first layer of a
// deeper network, the head's body with the readout compiled out.  It
// writes the spike trace z (T, B, H) in the weights' type and, for
// training, the residual of the TPU kernel's head=False mode: delta for
// ALIF with the FastSigmoid surrogate, the membrane v otherwise (and a for
// ALIF with Phi).  It replaces that mode of the same TPU kernel
// (fused_encode_{rec,ff}_scan).  Its shapes take the mma body as the
// head's do (O = 0: no W_out pieces in shared memory; each tile's z(t)
// leaves from its exchange buffer in 16-byte stores, off the serial step),
// so its spikes are those of fused2.cu's layer 0, the same code; the
// per-unit body (head_fwd.cuh) takes H > 256 and float32 W_rec past H ~
// 160.

#include "head_mma_fwd.cuh"
#include "lif_cell.cuh"

namespace {

template <bool TRAIN, bool HEAD>
int run_lif(const FwdArgs<LifParams>& a, int alif, int bf16, int rows,
            int device, void* stream, int S = 1) {
  return alif ? run<LifCell<true>, TRAIN, HEAD>(a, bf16, rows, device, stream,
                                                S)
              : run<LifCell<false>, TRAIN, HEAD>(a, bf16, rows, device,
                                                 stream, S);
}

template <bool TRAIN, bool HEAD, typename W>
cudaError_t run_mma(const FwdArgs<LifParams>& a, int alif, uint16_t* lists,
                    int S, int device, cudaStream_t s) {
  return alif ? run_mma_body<LifMmaCell<true>, TRAIN, HEAD, W>(a, lists, S,
                                                               device, s)
              : run_mma_body<LifMmaCell<false>, TRAIN, HEAD, W>(a, lists, S,
                                                                device, s);
}

// One launch of a head kernel (HEAD; TRAIN: the training forward) for S
// replicas, or of the first layer (!HEAD, S = 1; TRAIN: with its
// residuals), on the body the plan gives the shape (run_head_body).
template <bool TRAIN, bool HEAD>
int run_head(const FwdArgs<LifParams>& a, int alif, int bf16, void* lists,
             int S, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return run_head_body(
      a, bf16, lists, S, device,
      [&](uint16_t* l) {
        return bf16 ? run_mma<TRAIN, HEAD, __nv_bfloat16>(a, alif, l, S,
                                                          device, s)
                    : run_mma<TRAIN, HEAD, float>(a, alif, l, S, device, s);
      },
      [&](int rows) {
        return run_lif<TRAIN, HEAD>(a, alif, bf16, rows, device, stream, S);
      });
}

}  // namespace

extern "C" {

// Whether the head kernels take a shape on `device`, and with which body:
// 0 when they do (*mma_out = 1: the mma body, which needs the list scratch;
// 0: the per-unit body), 1 when they do not, or a CUDA error code.
int snn_fused_head_plan(int F, int H, int O, int rec, int bf16, int device,
                        int* mma_out) {
  if (O < 1) return 1;
  int rows = 0, smem = 0;
  return head_plan(F, H, O, rec, bf16, device, &rows, &smem, mma_out);
}

// 16-bit words a batch row of the mma body's list scratch takes.
int snn_fused_head_list_words(int F) { return list_row_words(F); }

// The mma body's per-row feature lists alone (the first launch of its
// forward), for tests.
int snn_fused_head_lists(const int* lat, void* lists, int B, int F, int T,
                         int periodic, int device, void* stream) {
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = launch_sort(lat, static_cast<uint16_t*>(lists), B, F, T, periodic,
                      device, static_cast<cudaStream_t>(stream));
  return (int)err;
}

// The first layer's plan, as snn_fused_head_plan's (*mma_out = 1: the mma
// body, which needs the list scratch).
int snn_fused_layer0_plan(int F, int H, int rec, int bf16, int device,
                          int* mma_out) {
  int rows = 0, smem = 0;
  return head_plan(F, H, 0, rec, bf16, device, &rows, &smem, mma_out);
}

// S replicas (S = 1: one network; beta holds S values).  `lists`: the
// mma body's scratch, null for the per-unit body.
int snn_fused_head_fwd(const int* lat, const void* w_in, const void* w_rec,
                       const float* beta, const void* w_out,
                       const float* b_out, float* logits, void* lists, int B,
                       int F, int H, int O, int T, int periodic, int alif,
                       int bf16, float alpha, float rho, float threshold,
                       float kappa, int S, int device, void* stream) {
  FwdArgs<LifParams> a{lat, w_in, w_rec, w_out, b_out, logits, nullptr,
                       nullptr, B, F, H, O, T, periodic, kappa,
                       {beta, alpha, rho, threshold, nullptr, nullptr,
                        nullptr, 0}};
  return run_head<false, true>(a, alif, bf16, lists, S, device, stream);
}

// The training forward: also writes delta, a_tr, tstar and counts, each
// where its pointer is not null; S replicas and `lists` as above.
int snn_fused_head_fwd_train(const int* lat, const void* w_in,
                             const void* w_rec, const float* beta,
                             const void* w_out, const float* b_out,
                             float* logits, void* delta, void* a_tr,
                             int* tstar, float* counts, void* lists, int B,
                             int F, int H, int O, int T, int periodic,
                             int alif, int bf16, float alpha, float rho,
                             float threshold, float kappa, int S, int device,
                             void* stream) {
  FwdArgs<LifParams> a{lat, w_in, w_rec, w_out, b_out, logits, tstar,
                       counts, B, F, H, O, T, periodic, kappa,
                       {beta, alpha, rho, threshold, nullptr, delta, a_tr,
                        0}};
  return run_head<true, true>(a, alif, bf16, lists, S, device, stream);
}

// The first layer of a deeper network: writes z (T, B, H) and, where `res`
// is not null (training), the residual `res` (v where res_is_v, else
// v - thr) and `a_tr` where that is not null.  `lists`: the mma body's
// scratch (snn_fused_layer0_plan), null for the per-unit body.
int snn_fused_layer0_fwd(const int* lat, const void* w_in, const void* w_rec,
                         const float* beta, void* z, void* res, void* a_tr,
                         void* lists, int B, int F, int H, int T,
                         int periodic, int alif, int bf16, int res_is_v,
                         float alpha, float rho, float threshold, int device,
                         void* stream) {
  FwdArgs<LifParams> a{lat, w_in, w_rec, nullptr, nullptr, nullptr,
                       nullptr, nullptr, B, F, H, 0, T, periodic, 0.f,
                       {beta, alpha, rho, threshold, z, res, a_tr,
                        res_is_v}};
  return res ? run_head<true, false>(a, alif, bf16, lists, 1, device, stream)
             : run_head<false, false>(a, alif, bf16, lists, 1, device,
                                      stream);
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
