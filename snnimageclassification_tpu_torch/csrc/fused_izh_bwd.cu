// Izhikevich whole-network head and first layer, backward: reverse-time
// surrogate-gradient BPTT of fused_izh.cu's training forward, from the
// cotangent of the logits (and the spike counts) or of the spike trace z to
// g_W_in, g_W_rec and, for the head, g_W_out and g_b.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused_izh.py:_izh_bwd_kernel
// (pl.pallas_call in _izh_bwd_call, :631), the backward of
// fused_encode_izh_scan[_head[_counts]], and the head's stacked-replica
// mode (:506-507, :621, :641): S seeds of an ensemble in one launch,
// gridDim.z = S on every function, slabs (S, blocks, ...) summed per
// replica by the host.
//
// The two-carry chain: the head reads only the float32 v trace and
// recomputes z = v >= v_peak, a first layer reads v, z and g_z.  It writes
// gi, the input current's cotangent, rounded to the weights' type into a
// (B, T, H) buffer, and the bits of z; from there the LIF/ALIF functions of
// bwd_common.cuh take over unchanged: bwd_gwin (g_W_in through the per-row
// period table), gbits_mma (g_W_rec), bwd_gout (g_W_out, g_b).  Partial
// sums go to per-block slabs that the host adds in a fixed order: no
// atomics, equal bits on every run.  What bounds it on an H100: as
// fused_head_bwd.cu, the serial chain with its dense gi @ W_rec^T and s @
// W_out^T per step; the rest are sums of selected rows.
//
// The chain takes the tensor-core body (chain_mma.cuh:bwd_chain_mma_kernel)
// wherever it fits (O <= 16, H <= 256, the weights' bf16 pieces within a
// block's shared memory): the head with the IzhChain policy
// (izh_chain.cuh), dz = s @ W_out^T (+ g_counts) + round(gi(t+1)) @
// W_rec^T; a first layer with IzhZChain, the z-layer mode (O = 0), dz =
// g_z(t) + round(gi(t+1)) @ W_rec^T.  dv(t+1) and du(t+1) sit in registers
// in the accumulator layout, the products on tensor cores (float32
// weights: the six split products), the rest is izh_chain_kernel's
// arithmetic (all three step with izh_common.cuh:izh_chain_step).  The
// other shapes take izh_chain_kernel (izh_common.cuh), one thread a (row,
// unit).

#include "gbits_mma.cuh"
#include "izh_chain.cuh"

namespace {

struct Plan {
  int rows, smem_chain, mma;
  GwinPlan gw;
  GbitsPlan gb;
  GoutPlan go;
};

// O == 0: the first-layer mode.  0 when the shape fits, 1 when it does not,
// else a CUDA error code.
int make_plan(int B, int F, int H, int O, int T, int rec, int bf16,
              int periodic, int device, Plan* p) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32;
  if (H < 1 || O < 0 || F < 1 || T < 1 || T > 32767 || HP > 1024) return 1;
  const int G = 512 / HP > 0 ? 512 / HP : 1;
  p->rows = chain_rows(H, O, HP, G, rec, bf16 ? 2 : 4, lim.max_smem,
                       &p->smem_chain);
  if (p->rows == 0) return 1;
  p->mma = chain_mma_fits(H, O, rec, bf16, lim.max_smem);
  p->gb.groups = 0;
  if (gwin_plan(B, F, H, T, periodic, bf16 ? 2 : 4, lim, &p->gw) != 0 ||
      (rec && (bf16 ? gbits_plan_rows<__nv_bfloat16>(B, T, H, H, lim, &p->gb)
                    : gbits_plan_rows<float>(B, T, H, H, lim, &p->gb)) != 0))
    return 1;
  p->go.groups = 0;
  if (O > 0 && gout_plan(B, H, O, T, lim, &p->go) != 0) return 1;
  return 0;
}

// S stacked replicas of the head (S = 1: one network) on gridDim.z.
template <bool REC, bool HEAD, typename W>
cudaError_t launch_all(const IzhChainArgs& c, const Args& g, const Plan& p,
                       int S, int device, cudaStream_t s) {
  const int HP = (c.H + 31) / 32 * 32;
  cudaError_t err;
  if (p.mma) {
    using Chain =
        typename std::conditional<HEAD, IzhChain, IzhZChain>::type;
    err = launch_chain_mma<Chain, REC, W>(c, S, device, s);
  } else {
    err = opt_in(izh_chain_kernel<REC, HEAD, W>, p.smem_chain);
    if (err != cudaSuccess) return err;
    izh_chain_kernel<REC, HEAD, W>
        <<<dim3((c.B + p.rows - 1) / p.rows, 1, S), dim3(HP, p.rows),
           p.smem_chain, s>>>(c, p.rows);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  if ((err = launch_gwin<W>(g, p.gw, S, s)) != cudaSuccess) return err;
  if (REC) {
    // Mask row t of zmask holds z(t - 1), the left operand of g_W_rec.
    const int HW = HP / 32;
    err = launch_gbits_rows<W>(g.dcur, g.zmask, g.slab_rec, g.B, g.T, g.H,
                               g.H, g.T + 1, HW,
                               (long long)g.B * (g.T + 1) * HW, p.gb, S, s);
    if (err != cudaSuccess) return err;
  }
  if (HEAD) {
    if ((err = launch_gout<W>(g, p.go, S, s)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool HEAD, typename W>
cudaError_t launch_rec(const IzhChainArgs& c, const Args& g, const Plan& p,
                       int S, int device, cudaStream_t s) {
  return c.w_rec ? launch_all<true, HEAD, W>(c, g, p, S, device, s)
                 : launch_all<false, HEAD, W>(c, g, p, S, device, s);
}

}  // namespace

extern "C" {

// The plan for a shape on `device` (O == 0: the first-layer mode), as
// snn_fused_head_bwd_plan gives the LIF/ALIF head's: out[0] = blocks of
// g_W_in slabs, out[1] = of g_W_rec slabs (0 without recurrence), out[2] =
// of g_W_out/g_b slabs (0 for a first layer); out[3] = 1 where the chain
// takes its mma body; out[4] and out[5] = rows a batch of bwd_gwin and of
// bwd_gout; out[6] and out[7] = 1 where bwd_gwin and gbits_mma stream
// their d through a TMA ring.  Returns 0 when the shape fits the kernels,
// 1 when it does not, or a CUDA error code.
int snn_fused_izh_bwd_plan(int B, int F, int H, int O, int T, int rec,
                           int bf16, int periodic, int device, int* out) {
  Plan p;
  const int rc = make_plan(B, F, H, O, T, rec, bf16, periodic, device, &p);
  if (rc == 0) {
    out[0] = p.gw.groups;
    out[1] = p.gb.groups;
    out[2] = p.go.groups;
    out[3] = p.mma;
    out[4] = p.gw.R;
    out[5] = O > 0 ? p.go.R : 0;
    out[6] = p.gw.tma;
    out[7] = p.gb.tma;
  }
  return rc;
}

// The head where w_out is not null (g_logits, tstar, optional g_counts;
// z from v), else the first layer (g_z and z).  dcur (B, T, H) in the
// weights' type and zmask (B, T + 1, HP / 32) are the call's scratch.  The
// head takes S stacked replicas (S = 1: one network), each per-replica
// input, the scratch and the slabs with a leading S; a first layer S = 1.
int snn_fused_izh_bwd(const float* g_logits, const int* tstar,
                      const float* g_counts, const float* g_z, const float* z,
                      const float* v, const int* lat, const void* w_rec,
                      const void* w_out, void* dcur, void* zmask,
                      float* slab_in, float* slab_rec, float* slab_out, int B,
                      int F, int H, int O, int T, int periodic, int phi,
                      int bf16, float dtC, float c1, float c2, float c3,
                      float v_rest, float v_th, float v_peak, float gamma,
                      float kappa, int S, int device, void* stream) {
  const int head = w_out != nullptr;
  if (!head) O = 0;
  Plan p;
  const int rc = make_plan(B, F, H, O, T, w_rec != nullptr, bf16, periodic,
                           device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (S < 1 || S > 65535 || (!head && S != 1))
    return (int)cudaErrorInvalidConfiguration;
  if (B == 0) return 0;
  unsigned* bits = static_cast<unsigned*>(zmask);
  IzhChainArgs c{g_logits, tstar, g_counts, g_z, z, v, w_rec, w_out,
                 nullptr, dcur, bits, B, H, O, T,
                 IzhBwd{dtC, c1, c2, c3, v_rest, v_th, v_peak, gamma, phi},
                 kappa};
  Args g{g_logits, tstar, g_counts, nullptr, nullptr, nullptr, nullptr, lat,
         w_rec, w_out, nullptr, dcur, bits, slab_in, slab_rec, slab_out, B,
         F, H, O, T, periodic, phi, 0, 0.f, 0.f, gamma, kappa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = head ? launch_rec<true, __nv_bfloat16>(c, g, p, S, device, s)
               : launch_rec<false, __nv_bfloat16>(c, g, p, S, device, s);
  else
    err = head ? launch_rec<true, float>(c, g, p, S, device, s)
               : launch_rec<false, float>(c, g, p, S, device, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
