// Izhikevich whole-network head and first layer, backward: reverse-time
// surrogate-gradient BPTT of fused_izh.cu's training forward, from the
// cotangent of the logits (and the spike counts) or of the spike trace z to
// g_W_in, g_W_rec and, for the head, g_W_out and g_b.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused_izh.py:_izh_bwd_kernel
// (pl.pallas_call in _izh_bwd_call, :631), the backward of
// fused_encode_izh_scan[_head[_counts]].
//
// The two-carry chain is izh_chain (izh_common.cuh): the head reads only the
// float32 v trace and recomputes z = v >= v_peak, a first layer reads v, z
// and g_z.  It writes gi, the input current's cotangent, rounded to the
// weights' type into a (B, T, H) buffer, and the bits of z; from there the
// LIF/ALIF functions of bwd_common.cuh take over unchanged: bwd_gwin (g_W_in
// through the per-row period table), bwd_gbits (g_W_rec), bwd_gout (g_W_out,
// g_b).  Partial sums go to per-block slabs that the host adds in a fixed
// order: no atomics, equal bits on every run.  What bounds it on an H100:
// as fused_head_bwd.cu, the serial chain with its dense gi @ W_rec^T and
// s @ W_out^T per step; the rest are sums of selected rows.

#include "izh_common.cuh"

namespace {

struct Plan {
  int rows, smem_chain, G, smem_in, smem_rec, smem_out, n_f, n_j, n_in, n_rec,
      n_out;
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
  if (O > G * NACC || O > G * HP) return 1;
  p->rows = chain_rows(H, O, HP, G, rec, bf16 ? 2 : 4, lim.max_smem,
                       &p->smem_chain);
  if (p->rows == 0) return 1;
  p->G = G;
  p->smem_in = (int)in_layout(T, HP, G, periodic).total;
  p->smem_rec = (int)bits_layout(T, HP, T + 1, HP / 32).total;
  p->smem_out = O > 0 ? (int)out_layout(T, HP, O).total : 0;
  if (p->smem_in > lim.max_smem || p->smem_rec > lim.max_smem ||
      p->smem_out > lim.max_smem)
    return 1;
  p->n_f = (F + G * NACC - 1) / (G * NACC);
  p->n_j = rec ? (HP / 32 + G - 1) / G : 0;
  p->n_in = row_groups(lim.sms, lim.sm_smem, p->smem_in, HP * G, p->n_f, B);
  p->n_rec = rec ? row_groups(lim.sms, lim.sm_smem, p->smem_rec, HP * G,
                              p->n_j, B)
                 : 0;
  p->n_out = O > 0 ? row_groups(lim.sms, lim.sm_smem, p->smem_out, HP * G, 1,
                                B)
                   : 0;
  return 0;
}

template <bool REC, bool HEAD, typename W>
cudaError_t launch_all(const IzhChainArgs& c, const Args& g, const Plan& p,
                       cudaStream_t s) {
  const int HP = (c.H + 31) / 32 * 32;
  cudaError_t err = opt_in(izh_chain_kernel<REC, HEAD, W>, p.smem_chain);
  if (err != cudaSuccess) return err;
  izh_chain_kernel<REC, HEAD, W>
      <<<dim3((c.B + p.rows - 1) / p.rows), dim3(HP, p.rows), p.smem_chain,
         s>>>(c, p.rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = opt_in(bwd_gwin_kernel<W>, p.smem_in)) != cudaSuccess)
    return err;
  bwd_gwin_kernel<W>
      <<<dim3(p.n_in, p.n_f), dim3(HP, p.G), p.smem_in, s>>>(g, p.G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (REC) {
    if ((err = opt_in(bwd_gbits_kernel<W>, p.smem_rec)) != cudaSuccess)
      return err;
    // Mask row t of zmask holds z(t - 1), the left operand of g_W_rec.
    bwd_gbits_kernel<W>
        <<<dim3(p.n_rec, p.n_j), dim3(HP, p.G), p.smem_rec, s>>>(
            g.dcur, g.zmask, g.slab_rec, g.B, g.T, g.H, g.H, g.T + 1,
            HP / 32, p.G);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (HEAD) {
    if ((err = opt_in(bwd_gout_kernel<W>, p.smem_out)) != cudaSuccess)
      return err;
    bwd_gout_kernel<W>
        <<<dim3(p.n_out), dim3(HP, p.G), p.smem_out, s>>>(g, p.G);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool HEAD, typename W>
cudaError_t launch_rec(const IzhChainArgs& c, const Args& g, const Plan& p,
                       cudaStream_t s) {
  return c.w_rec ? launch_all<true, HEAD, W>(c, g, p, s)
                 : launch_all<false, HEAD, W>(c, g, p, s);
}

}  // namespace

extern "C" {

// Slab counts for a shape on `device` (O == 0: the first-layer mode):
// out[0] = blocks of g_W_in slabs, out[1] = of g_W_rec slabs (0 without
// recurrence), out[2] = of g_W_out/g_b slabs (0 for a first layer).
// Returns 0 when the shape fits the kernels, 1 when it does not, or a CUDA
// error code.
int snn_fused_izh_bwd_plan(int B, int F, int H, int O, int T, int rec,
                           int bf16, int periodic, int device, int* out) {
  Plan p;
  const int rc = make_plan(B, F, H, O, T, rec, bf16, periodic, device, &p);
  if (rc == 0) {
    out[0] = p.n_in;
    out[1] = p.n_rec;
    out[2] = p.n_out;
  }
  return rc;
}

// The head where w_out is not null (g_logits, tstar, optional g_counts;
// z from v), else the first layer (g_z and z).  dcur (B, T, H) in the
// weights' type and zmask (B, T + 1, HP / 32) are the call's scratch.
int snn_fused_izh_bwd(const float* g_logits, const int* tstar,
                      const float* g_counts, const float* g_z, const float* z,
                      const float* v, const int* lat, const void* w_rec,
                      const void* w_out, void* dcur, void* zmask,
                      float* slab_in, float* slab_rec, float* slab_out, int B,
                      int F, int H, int O, int T, int periodic, int phi,
                      int bf16, float dtC, float c1, float c2, float c3,
                      float v_rest, float v_th, float v_peak, float gamma,
                      float kappa, int device, void* stream) {
  const int head = w_out != nullptr;
  if (!head) O = 0;
  Plan p;
  const int rc = make_plan(B, F, H, O, T, w_rec != nullptr, bf16, periodic,
                           device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
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
    err = head ? launch_rec<true, __nv_bfloat16>(c, g, p, s)
               : launch_rec<false, __nv_bfloat16>(c, g, p, s);
  else
    err = head ? launch_rec<true, float>(c, g, p, s)
               : launch_rec<false, float>(c, g, p, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
