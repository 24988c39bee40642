// Two-hidden-layer whole-network backward: reverse-time surrogate-gradient
// BPTT of the training forward in fused2.cu, from the logits' (and both
// layers' spike counts') cotangent to the six weight gradients.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused2.py:_fused2_bwd_kernel
// (pl.pallas_call in _fused2_bwd_call), the backward of fused2_{rec,ff}_head
// and of their _counts variants.
//
// One C entry point launches, in this order (the gradient functions are
// bwd_common.cuh's; z(-1) = 0 for both layers):
//   1. the chain, head mode, layer 1: s(t) = kappa s(t+1) + g [t == tstar],
//      dz1(t) = s(t) W_out^T + g_counts1 + dcur1(t+1) W1r^T,
//      dcur1(t) = (dz1 surr(delta1) + alpha dcur1(t+1)) (1 - z1(t-1)), with
//      z1 = [delta1 >= 0]: dcur1 (B, T, H2) and the bits of z1.
//   2. gzin_mma (gzin_mma.cuh, tensor cores): dz0_in(t) = dcur1(t) W1^T
//      into a (T, B, H1) float32 scratch (the TPU kernel's dz0 pipe, which
//      it keeps in float32 too).
//   3. the chain, fused2's layer-0 mode: dz0(t) = dz0_in(t) + g_counts0 +
//      dcur0(t+1) W0r^T, the same step, z0 = [delta0 >= 0] (the forward
//      stores delta for LIF too, so z0 is rebuilt from the sign, as in the
//      head; the z-emitting layers of the composed pair keep v instead):
//      dcur0 (B, T, H1) and the bits of z0, mask row k = z0(k - 1).
//   Both chains run the tensor-core body (chain_mma.cuh:bwd_chain_mma_kernel
//   with lif_chain.cuh's LifChain for layer 1, ZChain<., float, true> for
//   layer 0) where chain_mma_fits holds for both layers, else
//   bwd_common.cuh's per-unit bwd_chain_kernel.
//   4. bwd_gwin: g_W0 from the latencies and dcur0 (the per-row period
//      table under periodic encoding).
//   5. gbits_mma (gbits_mma.cuh, tensor cores) three times: g_W0r = sum_t
//      z0(t-1)^T dcur0(t) (z0's mask
//      rows as stored), g_W1 = sum_t z0(t)^T dcur1(t) (the same masks one
//      row on: z0 at the same step t as dcur1(t), the layer's input at step
//      t; the TPU kernel's one-block offset between its two stages is
//      scheduling only), g_W1r = sum_t z1(t-1)^T dcur1(t).
//   6. bwd_gout: g_W_out and g_b from z1's bits and the s chain.
// Every block writes partial sums to a slab of its own, the host adds the
// slabs in a fixed order: no atomics, a repeated call gives the same bits.
// What bounds it on an H100: the two serial chains, then the one dense
// product dz0_in, 2 B T H1 H2 FLOP (26.8 GFLOP at B=8192, T=100, 128 x 128;
// x6 for float32's pieces), and the traces: two residuals, dcur0, dcur1 and
// the float32 dz0_in scratch.

#include "gbits_mma.cuh"
#include "gzin_mma.cuh"
#include "lif_chain.cuh"

namespace {

struct Plan2 {
  int rows0, smem_chain0, rows1, smem_chain1, mma;
  GwinPlan gw;
  GbitsPlan grec0, gw1, grec1;
  GoutPlan go;
};

// 0 when the shape fits, 1 when it does not, else a CUDA error code.
int make_plan2(int B, int F, int H1, int H2, int O, int T, int rec, int bf16,
               int periodic, int device, Plan2* p) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const int HP0 = (H1 + 31) / 32 * 32, HP1 = (H2 + 31) / 32 * 32;
  if (H1 < 1 || H2 < 1 || O < 1 || F < 1 || T < 1 || T > 32767 ||
      HP0 > 1024 || HP1 > 1024)
    return 1;
  const int G0 = 512 / HP0 > 0 ? 512 / HP0 : 1;
  const int G1 = 512 / HP1 > 0 ? 512 / HP1 : 1;
  const int wsize = bf16 ? 2 : 4;
  p->rows1 = chain_rows(H2, O, HP1, G1, rec, wsize, lim.max_smem,
                        &p->smem_chain1);
  p->rows0 = chain_rows(H1, 0, HP0, G0, rec, wsize, lim.max_smem,
                        &p->smem_chain0);
  if (p->rows0 == 0 || p->rows1 == 0) return 1;
  p->mma = chain_mma_fits(H2, O, rec, bf16, lim.max_smem) &&
           chain_mma_fits(H1, 0, rec, bf16, lim.max_smem);
  if (!gzin_fits(H2, H1, bf16, lim.max_smem)) return 1;
  auto plan = [&](int J, int H, GbitsPlan* g) {
    return bf16 ? gbits_plan_rows<__nv_bfloat16>(B, T, J, H, lim, g)
                : gbits_plan_rows<float>(B, T, J, H, lim, g);
  };
  p->grec0.groups = p->grec1.groups = 0;
  if (gwin_plan(B, F, H1, T, periodic, wsize, lim, &p->gw) != 0 ||
      gout_plan(B, H2, O, T, lim, &p->go) != 0 ||
      plan(H1, H2, &p->gw1) != 0 ||
      (rec && (plan(H1, H1, &p->grec0) != 0 || plan(H2, H2, &p->grec1) != 0)))
    return 1;
  return 0;
}

struct Extra2 {
  const void* w1;  // (H1, H2)
  float* dz0;      // (T, B, H1) float32 scratch: dcur1 @ W1^T
  float* slab_w1;  // (n_w1, H1 * H2)
};

// a0: layer 0 (z-layer fields, F, lat, slab_in = g_W0, slab_rec = g_W0r);
// a1: layer 1 (head fields, slab_rec = g_W1r, slab_out = g_W_out, g_b).
template <bool REC, typename W>
cudaError_t launch_all2(const Args& a0, const Args& a1, const Extra2& x,
                        const Plan2& p, int device, cudaStream_t s) {
  const int HP0 = (a0.H + 31) / 32 * 32, HP1 = (a1.H + 31) / 32 * 32;
  const int HW0 = HP0 / 32, HW1 = HP1 / 32;
  const int B = a0.B, T = a0.T;
  cudaError_t err;
  if (p.mma) {
    err = launch_chain_mma<LifChain<W>, REC, W>(a1, 1, device, s);
  } else {
    if ((err = opt_in(bwd_chain_kernel<REC, true, W>, p.smem_chain1)) !=
        cudaSuccess)
      return err;
    bwd_chain_kernel<REC, true, W>
        <<<dim3((B + p.rows1 - 1) / p.rows1), dim3(HP1, p.rows1),
           p.smem_chain1, s>>>(a1, p.rows1);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  err = launch_gzin_mma<W, float>(a1.dcur, x.w1, x.dz0, B, T, a1.H, a0.H,
                                  device, s);
  if (err != cudaSuccess) return err;
  if (p.mma) {
    err = launch_chain_mma<ZChain<W, float, true>, REC, W>(a0, 1, device, s);
  } else {
    if ((err = opt_in(bwd_chain_kernel<REC, false, W, true, float>,
                      p.smem_chain0)) != cudaSuccess)
      return err;
    bwd_chain_kernel<REC, false, W, true, float>
        <<<dim3((B + p.rows0 - 1) / p.rows0), dim3(HP0, p.rows0),
           p.smem_chain0, s>>>(a0, p.rows0);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  if ((err = launch_gwin<W>(a0, p.gw, 1, s)) != cudaSuccess) return err;
  if (REC) {
    // Mask row t of z0's masks holds z0(t - 1), the left operand of g_W0r.
    err = launch_gbits_rows<W>(a0.dcur, a0.zmask, a0.slab_rec, B, T, a0.H,
                               a0.H, T + 1, HW0, 0, p.grec0, 1, s);
    if (err != cudaSuccess) return err;
  }
  // The same masks one row on: row t holds z0(t), the left operand of g_W1
  // (the buffer has one mask row of padding past its last batch row).
  err = launch_gbits_rows<W>(a1.dcur, a0.zmask + HW0, x.slab_w1, B, T,
                             a0.H, a1.H, T + 1, HW0, 0, p.gw1, 1, s);
  if (err != cudaSuccess) return err;
  if (REC) {
    err = launch_gbits_rows<W>(a1.dcur, a1.zmask, a1.slab_rec, B, T, a1.H,
                               a1.H, T + 1, HW1, 0, p.grec1, 1, s);
    if (err != cudaSuccess) return err;
  }
  return launch_gout<W>(a1, p.go, 1, s);
}

}  // namespace

extern "C" {

// Slab counts for a shape on `device`: out[0] = blocks of g_W0 slabs, out[1]
// = of g_W0r slabs, out[2] = of g_W1 slabs, out[3] = of g_W1r slabs (0 and 0
// without recurrence), out[4] = of g_W_out/g_b slabs; out[5] = 1 where both
// chains take the tensor-core body; out[6] and out[7] = rows a batch of
// bwd_gwin and of bwd_gout.  Returns 0 when the shape fits the kernels, 1
// when it does not, or a CUDA error code.
int snn_fused2_bwd_plan(int B, int F, int H1, int H2, int O, int T, int rec,
                        int bf16, int periodic, int device, int* out) {
  Plan2 p;
  const int rc =
      make_plan2(B, F, H1, H2, O, T, rec, bf16, periodic, device, &p);
  if (rc == 0) {
    out[0] = p.gw.groups;
    out[1] = p.grec0.groups;
    out[2] = p.gw1.groups;
    out[3] = p.grec1.groups;
    out[4] = p.go.groups;
    out[5] = p.mma;
    out[6] = p.gw.R;
    out[7] = p.go.R;
  }
  return rc;
}

// g_cnt0 / g_cnt1 may be null (no cotangent for that layer's counts); a0
// and a1 (ALIF with Phi) are both given or both null; w0r and w1r likewise.
// zmask0 holds B * (T + 1) + 1 mask rows of H1 / 32 words, zmask1 B * (T + 1)
// rows of H2 / 32 words.
int snn_fused2_bwd(const float* g_logits, const int* tstar,
                   const float* g_cnt0, const float* g_cnt1, const void* d0,
                   const void* a0, const void* d1, const void* a1,
                   const int* lat, const void* w0r, const void* w1,
                   const void* w1r, const void* w_out, const float* beta0,
                   const float* beta1, void* dcur0, void* dcur1, void* zmask0,
                   void* zmask1, float* dz0, float* slab_w0, float* slab_w0r,
                   float* slab_w1, float* slab_w1r, float* slab_out, int B,
                   int F, int H1, int H2, int O, int T, int periodic, int phi,
                   int bf16, float alpha, float threshold, float gamma,
                   float kappa, int device, void* stream) {
  Plan2 p;
  if ((w0r == nullptr) != (w1r == nullptr)) return (int)cudaErrorInvalidValue;
  const int rec = w0r != nullptr;
  const int rc =
      make_plan2(B, F, H1, H2, O, T, rec, bf16, periodic, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (B == 0) return 0;
  Args l0{nullptr, nullptr, g_cnt0, dz0, nullptr, d0, a0, lat, w0r, nullptr,
          beta0, dcur0, static_cast<unsigned*>(zmask0), slab_w0, slab_w0r,
          nullptr, B, F, H1, 0, T, periodic, phi, 0, alpha, threshold, gamma,
          0.f};
  Args l1{g_logits, tstar, g_cnt1, nullptr, nullptr, d1, a1, nullptr, w1r,
          w_out, beta1, dcur1, static_cast<unsigned*>(zmask1), nullptr,
          slab_w1r, slab_out, B, F, H2, O, T, periodic, phi, 0, alpha,
          threshold, gamma, kappa};
  Extra2 x{w1, dz0, slab_w1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = rec ? launch_all2<true, __nv_bfloat16>(l0, l1, x, p, device, s)
              : launch_all2<false, __nv_bfloat16>(l0, l1, x, p, device, s);
  else
    err = rec ? launch_all2<true, float>(l0, l1, x, p, device, s)
              : launch_all2<false, float>(l0, l1, x, p, device, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
