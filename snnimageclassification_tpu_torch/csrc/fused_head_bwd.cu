// Whole-network head backward: reverse-time surrogate-gradient BPTT of the
// training forward in fused_head.cu, from the logits' (and the spike
// counts') cotangent to the weight gradients.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused.py:_fused_bwd_kernel
// (head=True; pl.pallas_call in _fused_bwd_call), the backward of
// fused_encode_{rec,ff}_scan_head and of their _counts variants, and its
// stacked-replica mode (w_in.ndim == 3, pallas_fused.py:958-1114): S seeds
// of an ensemble in one launch, gridDim.z = S on every function, the slabs
// (S, blocks, ...) summed per replica by the host (bwd_common.cuh).
//
// The recurrence, the split into __global__ functions (the chain, bwd_gwin,
// gbits_mma for g_W_rec (gbits_mma.cuh), bwd_gout) and what bounds them on
// an H100 are set out in bwd_common.cuh, which this source instantiates for
// the head: the
// dense count is 2 B T (F H + 2 H H + 2 H O) FLOP, but spikes are 0/1, so
// only dcur @ W_rec^T and s @ W_out^T are real products; the rest are sums
// of selected rows.
//
// The chain's mma body (chain_mma.cuh: bwd_chain_mma_kernel with the
// LifChain policy of lif_chain.cuh; O <= 16, H <= 256 and the weights'
// bf16 pieces within a block's shared memory; other shapes take
// bwd_common.cuh's per-unit chain): a warp owns 16 rows x 32 units in registers and walks t
// down, dz = s @ W_out^T (+ g_counts) + dcur(t+1) @ W_rec^T on tensor
// cores, the element-wise chain the per-unit chain's arithmetic.  dcur
// (B, T, H) and the z bits (B, T + 1, HP / 32) leave as before, so the
// three gradient functions keep their inputs.

#include "gbits_mma.cuh"
#include "lif_chain.cuh"
#include "gout_mma.cuh"

namespace {

struct Plan {
  int rows, smem_chain, mma;
  GwinPlan gw;
  GbitsPlan gb;
  GoutPlan go;
};

// 0 when the shape fits, 1 when it does not, else a CUDA error code.
int make_plan(int B, int F, int H, int O, int T, int rec, int bf16,
              int periodic, int device, Plan* p) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32;
  if (H < 1 || O < 1 || F < 1 || T < 1 || T > 32767 || HP > 1024) return 1;
  const int G = 512 / HP > 0 ? 512 / HP : 1;
  p->rows = chain_rows(H, O, HP, G, rec, bf16 ? 2 : 4, lim.max_smem,
                       &p->smem_chain);
  if (p->rows == 0) return 1;
  p->mma = chain_mma_fits(H, O, rec, bf16, lim.max_smem);
  p->gb.groups = 0;
  if (gwin_plan(B, F, H, T, periodic, bf16 ? 2 : 4, lim, &p->gw) != 0 ||
      gout_plan(B, H, O, T, lim, &p->go) != 0 ||
      (rec && (bf16 ? gbits_plan_rows<__nv_bfloat16>(B, T, H, H, lim, &p->gb)
                    : gbits_plan_rows<float>(B, T, H, H, lim, &p->gb)) != 0))
    return 1;
  return 0;
}

template <bool REC, typename W>
cudaError_t launch_all(const Args& a, const Plan& p, int S, int device,
                       cudaStream_t s) {
  const int HP = (a.H + 31) / 32 * 32;
  cudaError_t err;
  if (p.mma) {
    err = launch_chain_mma<LifChain<W>, REC, W>(a, S, device, s);
  } else {
    err = opt_in(bwd_chain_kernel<REC, true, W>, p.smem_chain);
    if (err != cudaSuccess) return err;
    bwd_chain_kernel<REC, true, W>
        <<<dim3((a.B + p.rows - 1) / p.rows, 1, S), dim3(HP, p.rows),
           p.smem_chain, s>>>(a, p.rows);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  if ((err = launch_gwin<W>(a, p.gw, S, s)) != cudaSuccess) return err;
  if (REC) {
    // Mask row t of zmask holds z(t - 1), the left operand of g_W_rec.
    const int HW = HP / 32;
    err = launch_gbits_rows<W>(a.dcur, a.zmask, a.slab_rec, a.B, a.T, a.H,
                               a.H, a.T + 1, HW,
                               (long long)a.B * (a.T + 1) * HW, p.gb, S, s);
    if (err != cudaSuccess) return err;
  }
  return launch_gout<W>(a, p.go, S, s);
}

}  // namespace

extern "C" {

// Slab counts for a shape on `device`: out[0] = blocks of g_W_in slabs,
// out[1] = of g_W_rec slabs (0 without recurrence), out[2] = of
// g_W_out/g_b slabs; out[3] = 1 where the chain takes its mma body; out[4]
// and out[5] = rows a batch of bwd_gwin and of bwd_gout (each block walks
// the batches blockIdx.x + k blocks, ascending); out[6] = 1 where bwd_gwin
// streams dcur through its TMA ring, 0 where the threads copy its stage;
// out[7] the same for gbits_mma (g_W_rec; its block y takes batch rows
// [y B / out[1], (y + 1) B / out[1])).
// Returns 0 when the shape fits the kernels, 1 when it does not, or a CUDA
// error code.
int snn_fused_head_bwd_plan(int B, int F, int H, int O, int T, int rec,
                            int bf16, int periodic, int device, int* out) {
  Plan p;
  const int rc = make_plan(B, F, H, O, T, rec, bf16, periodic, device, &p);
  if (rc == 0) {
    out[0] = p.gw.groups;
    out[1] = p.gb.groups;
    out[2] = p.go.groups;
    out[3] = p.mma;
    out[4] = p.gw.R;
    out[5] = p.go.R;
    out[6] = p.gw.tma;
    out[7] = p.gb.tma;
  }
  return rc;
}

// How bwd_gwin (every backward with an encoded first layer launches it)
// reads dcur at a shape on `device`: *stage = 0 through its TMA ring, 1 a
// stage copied by the threads as H * itemsize is not a multiple of 16 bytes
// (TMA's strides), 2 the same as no two stages of the ring fit in a block's
// shared memory.  Returns 0, 1 when the shape does not fit bwd_gwin, or a
// CUDA error code.
int snn_gwin_stage(int F, int H, int T, int bf16, int periodic, int device,
                   int* stage) {
  Limits lim;
  const cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  GwinPlan p;
  const int wsize = bf16 ? 2 : 4;
  if (gwin_plan(1, F, H, T, periodic, wsize, lim, &p) != 0) return 1;
  *stage = p.tma ? 0 : ((size_t)H * wsize) % 16 ? 1 : 2;
  return 0;
}

// S stacked replicas (S = 1: one network): every per-replica input, the
// scratch and the slabs carry a leading S (beta holds S values); the
// latencies are shared.
int snn_fused_head_bwd(const float* g_logits, const int* tstar,
                       const float* g_counts, const void* delta,
                       const void* a_tr, const int* lat, const void* w_rec,
                       const void* w_out, const float* beta, void* dcur,
                       void* zmask, float* slab_in, float* slab_rec,
                       float* slab_out, int B, int F, int H, int O, int T,
                       int periodic, int phi, int bf16, float alpha,
                       float threshold, float gamma, float kappa, int S,
                       int device, void* stream) {
  Plan p;
  const int rec = w_rec != nullptr;
  const int rc = make_plan(B, F, H, O, T, rec, bf16, periodic, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidConfiguration;
  if (B == 0) return 0;
  Args a{g_logits, tstar, g_counts, nullptr, nullptr, delta, a_tr, lat, w_rec,
         w_out, beta, dcur, static_cast<unsigned*>(zmask), slab_in, slab_rec,
         slab_out, B, F, H, O, T, periodic, phi, 0, alpha, threshold, gamma,
         kappa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = rec ? launch_all<true, __nv_bfloat16>(a, p, S, device, s)
              : launch_all<false, __nv_bfloat16>(a, p, S, device, s);
  else
    err = rec ? launch_all<true, float>(a, p, S, device, s)
              : launch_all<false, float>(a, p, S, device, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
