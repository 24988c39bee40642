// Whole-network head backward: reverse-time surrogate-gradient BPTT of the
// training forward in fused_head.cu, from the logits' (and the spike
// counts') cotangent to the weight gradients.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused.py:_fused_bwd_kernel
// (head=True; pl.pallas_call in _fused_bwd_call), the backward of
// fused_encode_{rec,ff}_scan_head and of their _counts variants.
//
// The recurrence, the split into __global__ functions (bwd_chain, bwd_gwin,
// bwd_gbits for g_W_rec, bwd_gout) and what bounds them on an H100 are set
// out in bwd_common.cuh, which this source instantiates for the head: the
// dense count is 2 B T (F H + 2 H H + 2 H O) FLOP, but spikes are 0/1, so
// only dcur @ W_rec^T and s @ W_out^T are real products; the rest are sums
// of selected rows.

#include "bwd_common.cuh"

namespace {

struct Plan {
  int rows, smem_chain, G, smem_in, smem_rec, smem_out, n_f, n_j, n_in, n_rec,
      n_out;
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
  // The readout block keeps g_W_out[h, o] for NACC o per thread and walks
  // the s chain on one thread per output.
  if (O > G * NACC || O > G * HP) return 1;
  p->rows = chain_rows(H, O, HP, G, rec, bf16 ? 2 : 4, lim.max_smem,
                       &p->smem_chain);
  if (p->rows == 0) return 1;
  p->G = G;
  p->smem_in = (int)in_layout(T, HP, G, periodic).total;
  p->smem_rec = (int)bits_layout(T, HP, T + 1, HP / 32).total;
  p->smem_out = (int)out_layout(T, HP, O).total;
  if (p->smem_in > lim.max_smem || p->smem_rec > lim.max_smem ||
      p->smem_out > lim.max_smem)
    return 1;
  p->n_f = (F + G * NACC - 1) / (G * NACC);
  p->n_j = rec ? (HP / 32 + G - 1) / G : 0;
  // As many blocks as the card holds at once (by shared memory and by
  // threads); each walks its share of the rows in ascending order.
  p->n_in = row_groups(lim.sms, lim.sm_smem, p->smem_in, HP * G, p->n_f, B);
  p->n_rec = rec ? row_groups(lim.sms, lim.sm_smem, p->smem_rec, HP * G,
                              p->n_j, B)
                 : 0;
  p->n_out = row_groups(lim.sms, lim.sm_smem, p->smem_out, HP * G, 1, B);
  return 0;
}

template <bool REC, typename W>
cudaError_t launch_all(const Args& a, const Plan& p, cudaStream_t s) {
  const int HP = (a.H + 31) / 32 * 32;
  cudaError_t err = opt_in(bwd_chain_kernel<REC, true, W>, p.smem_chain);
  if (err != cudaSuccess) return err;
  bwd_chain_kernel<REC, true, W>
      <<<dim3((a.B + p.rows - 1) / p.rows), dim3(HP, p.rows), p.smem_chain,
         s>>>(a, p.rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = opt_in(bwd_gwin_kernel<W>, p.smem_in)) != cudaSuccess)
    return err;
  bwd_gwin_kernel<W>
      <<<dim3(p.n_in, p.n_f), dim3(HP, p.G), p.smem_in, s>>>(a, p.G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (REC) {
    if ((err = opt_in(bwd_gbits_kernel<W>, p.smem_rec)) != cudaSuccess)
      return err;
    // Mask row t of zmask holds z(t - 1), the left operand of g_W_rec.
    bwd_gbits_kernel<W>
        <<<dim3(p.n_rec, p.n_j), dim3(HP, p.G), p.smem_rec, s>>>(
            a.dcur, a.zmask, a.slab_rec, a.B, a.T, a.H, a.H, a.T + 1, HP / 32,
            p.G);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = opt_in(bwd_gout_kernel<W>, p.smem_out)) != cudaSuccess)
    return err;
  bwd_gout_kernel<W><<<dim3(p.n_out), dim3(HP, p.G), p.smem_out, s>>>(a, p.G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Slab counts for a shape on `device`: out[0] = blocks of g_W_in slabs,
// out[1] = of g_W_rec slabs (0 without recurrence), out[2] = of
// g_W_out/g_b slabs.  Returns 0 when the shape fits the kernels, 1 when it
// does not, or a CUDA error code.
int snn_fused_head_bwd_plan(int B, int F, int H, int O, int T, int rec,
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

int snn_fused_head_bwd(const float* g_logits, const int* tstar,
                       const float* g_counts, const void* delta,
                       const void* a_tr, const int* lat, const void* w_rec,
                       const void* w_out, const float* beta, void* dcur,
                       void* zmask, float* slab_in, float* slab_rec,
                       float* slab_out, int B, int F, int H, int O, int T,
                       int periodic, int phi, int bf16, float alpha,
                       float threshold, float gamma, float kappa, int device,
                       void* stream) {
  Plan p;
  const int rec = w_rec != nullptr;
  const int rc = make_plan(B, F, H, O, T, rec, bf16, periodic, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (B == 0) return 0;
  Args a{g_logits, tstar, g_counts, nullptr, nullptr, delta, a_tr, lat, w_rec,
         w_out, beta, dcur, static_cast<unsigned*>(zmask), slab_in, slab_rec,
         slab_out, B, F, H, O, T, periodic, phi, 0, alpha, threshold, gamma,
         kappa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = rec ? launch_all<true, __nv_bfloat16>(a, p, s)
              : launch_all<false, __nv_bfloat16>(a, p, s);
  else
    err = rec ? launch_all<true, float>(a, p, s)
              : launch_all<false, float>(a, p, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
