// Backward of the first layer of a deeper network: reverse-time
// surrogate-gradient BPTT of fused_layer0_fwd (fused_head.cu), from the
// cotangent of its spike trace z (T, B, H) to g_W_in and g_W_rec.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused.py:_fused_bwd_kernel
// (head=False; pl.pallas_call in _fused_bwd_call), the backward of
// fused_encode_{rec,ff}_scan.
//
// One call launches, in this order:
//   1. the chain in its z-layer mode: dz(t) = g_z(t) + dcur(t+1) @ W_rec^T,
//      z(t-1) as stored, the surrogate from the residual the forward kept
//      (delta for ALIF with FastSigmoid, the membrane v otherwise, with a
//      for ALIF with Phi); dcur (B, T, H) in the weights' type and the bits
//      of z.  Where chain_mma_fits (H <= 256, the weights' bf16 pieces
//      within a block's shared memory) the tensor-core body
//      (chain_mma.cuh:bwd_chain_mma_kernel with lif_chain.cuh's ZChain, z as
//      stored, as Layer0Chain: the mid layer's z-emitting mode and the
//      two-layer pair's layer 0 run the same body), else bwd_common.cuh's
//      per-unit bwd_chain_kernel.  A feedforward layer takes the same body
//      without the product.
//   2. bwd_gwin (bwd_common.cuh): g_W_in through the per-row table.
//   3. gbits_mma (gbits_mma.cuh, tensor cores): g_W_rec from the bits of
//      z(t-1).
// Slabs, no atomics.
// What bounds it on an H100: as the head's backward, the serial chain (a
// step's dcur(t+1) @ W_rec^T on tensor cores, one named barrier a step among
// a tile's warps); the traces it reads are 3-4 (T, B, H) tensors against the
// head's one.

#include "gbits_mma.cuh"
#include "lif_chain.cuh"

namespace {

// ZChain (z as stored) under a name of its own, so that a profile tells
// layer 0's chain from a mid layer's z-emitting one, the same instance
// otherwise.
template <typename W>
struct Layer0Chain : ZChain<W, W, false> {
  using ZChain<W, W, false>::ZChain;
};

struct Plan {
  int rows, smem_chain, mma;
  GwinPlan gw;
  GbitsPlan gb;
};

// 0 when the shape fits, 1 when it does not, else a CUDA error code.
int make_plan(int B, int F, int H, int T, int rec, int bf16, int periodic,
              int device, Plan* p) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32;
  if (H < 1 || F < 1 || T < 1 || T > 32767 || HP > 1024) return 1;
  const int G = 512 / HP > 0 ? 512 / HP : 1;
  p->rows = chain_rows(H, 0, HP, G, rec, bf16 ? 2 : 4, lim.max_smem,
                       &p->smem_chain);
  if (p->rows == 0) return 1;
  p->mma = chain_mma_fits(H, 0, rec, bf16, lim.max_smem);
  p->gb.groups = 0;
  if (gwin_plan(B, F, H, T, periodic, bf16 ? 2 : 4, lim, &p->gw) != 0 ||
      (rec && (bf16 ? gbits_plan_rows<__nv_bfloat16>(B, T, H, H, lim, &p->gb)
                    : gbits_plan_rows<float>(B, T, H, H, lim, &p->gb)) != 0))
    return 1;
  return 0;
}

template <bool REC, typename W>
cudaError_t launch_all(const Args& a, const Plan& p, int device,
                       cudaStream_t s) {
  const int HP = (a.H + 31) / 32 * 32;
  cudaError_t err;
  if (p.mma) {
    err = launch_chain_mma<Layer0Chain<W>, REC, W>(a, 1, device, s);
  } else {
    if ((err = opt_in(bwd_chain_kernel<REC, false, W>, p.smem_chain)) !=
        cudaSuccess)
      return err;
    bwd_chain_kernel<REC, false, W>
        <<<dim3((a.B + p.rows - 1) / p.rows), dim3(HP, p.rows), p.smem_chain,
           s>>>(a, p.rows);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  if ((err = launch_gwin<W>(a, p.gw, 1, s)) != cudaSuccess) return err;
  if (REC) {
    // Mask row t of zmask holds z(t - 1), the left operand of g_W_rec.
    const int HW = HP / 32;
    err = launch_gbits_rows<W>(a.dcur, a.zmask, a.slab_rec, a.B, a.T, a.H,
                               a.H, a.T + 1, HW, 0, p.gb, 1, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan for a shape on `device`: out[0] = blocks of g_W_in slabs,
// out[1] = of g_W_rec slabs (0 without recurrence); out[2] = 1 where the
// chain takes its tensor-core body; out[3] = rows a batch of bwd_gwin.
// Returns 0 when the shape fits the kernels, 1 when it does not, or a CUDA
// error code.
int snn_fused_layer0_bwd_plan(int B, int F, int H, int T, int rec, int bf16,
                              int periodic, int device, int* out) {
  Plan p;
  const int rc = make_plan(B, F, H, T, rec, bf16, periodic, device, &p);
  if (rc == 0) {
    out[0] = p.gw.groups;
    out[1] = p.gb.groups;
    out[2] = p.mma;
    out[3] = p.gw.R;
  }
  return rc;
}

int snn_fused_layer0_bwd(const void* g_z, const void* z, const void* res,
                         const void* a_tr, const int* lat, const void* w_rec,
                         const float* beta, void* dcur, void* zmask,
                         float* slab_in, float* slab_rec, int B, int F, int H,
                         int T, int periodic, int phi, int bf16, int res_is_v,
                         float alpha, float threshold, float gamma,
                         int device, void* stream) {
  Plan p;
  const int rec = w_rec != nullptr;
  const int rc = make_plan(B, F, H, T, rec, bf16, periodic, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (B == 0) return 0;
  Args a{nullptr, nullptr, nullptr, g_z, z, res, a_tr, lat, w_rec, nullptr,
         beta, dcur, static_cast<unsigned*>(zmask), slab_in, slab_rec,
         nullptr, B, F, H, 0, T, periodic, phi, res_is_v, alpha, threshold,
         gamma, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = rec ? launch_all<true, __nv_bfloat16>(a, p, device, s)
              : launch_all<false, __nv_bfloat16>(a, p, device, s);
  else
    err = rec ? launch_all<true, float>(a, p, device, s)
              : launch_all<false, float>(a, p, device, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
