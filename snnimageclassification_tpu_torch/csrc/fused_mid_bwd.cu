// Backward of the hidden layers past the first: reverse-time
// surrogate-gradient BPTT of fused_mid_fwd (fused_mid.cu), z-emitting mode
// (from the cotangent of z) and head mode (from the logits' and the spike
// counts' cotangent), to the cotangent of the input spike trace and the
// weight gradients.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused_mid.py:_mid_bwd_kernel
// (pl.pallas_call in _mid_bwd_call), the backward of fused_mid_{rec,ff}_scan
// and of fused_mid_{rec,ff}_scan_head[_counts].
//
// One call launches, in this order (the recurrence and the shared functions
// are set out in bwd_common.cuh):
//   1. pack_bits: z_in (T, B, Hin), 0/1 in the weights' type, to bit masks
//      (B, T, Hin / 32), one contiguous slab per batch row.
//   2. bwd_chain, head or z-layer mode: dcur (B, T, H) and the bits of z.
//   3. bwd_gzin: g_z_in(t) = dcur(t) @ W_in^T, a dense (B T, H) x (H, Hin)
//      product on the CUDA cores: 128 x 64 tiles in shared memory, 8 x 4
//      outputs a thread, float32 accumulation, the result rounded once to
//      the weights' type (the type of z_in) and written (T, B, Hin).
//   4. gbits_mma (gbits_mma.cuh, tensor cores) twice: g_W_in = sum_t
//      z_in(t)^T dcur(t) from the packed bits and g_W_rec = sum_t z(t-1)^T
//      dcur(t) from the bits of z.
//   5. bwd_gout (head): g_W_out and g_b.
// What bounds it on an H100: the chain as in the head's backward (serial,
// dcur @ W_rec^T from shared memory); bwd_gzin is the one dense product, 2 B
// T H Hin FLOP (26.8 GFLOP at B=8192, T=100, 128 x 128: 0.4 ms at the float32
// peak, 0.03 ms at the bf16 tensor-core peak that this version does not use);
// the traces read and written are 3-5 (T, B, H) tensors, ~0.5 ms at the
// memory rate in f32.

#include "bwd_common.cuh"
#include "gbits_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// 1. z_in -> bit masks
// ---------------------------------------------------------------------------
// One warp a mask word: task id = (t * B + b) * BW + word, so consecutive
// warps read consecutive 32-element pieces of z_in.
template <typename W>
__global__ void pack_bits_kernel(const void* z_in_, unsigned* bits, int T,
                                 int B, int Hin, int BW) {
  const W* z_in = static_cast<const W*>(z_in_);
  const int lane = threadIdx.x & 31;
  const size_t task =
      (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (task >= (size_t)T * B * BW) return;  // whole warps leave together
  const int word = (int)(task % BW);
  const size_t tb = task / BW;
  const int b = (int)(tb % B), t = (int)(tb / B);
  const int j = word * 32 + lane;
  const bool on = j < Hin && to_f32(z_in[tb * Hin + j]) != 0.f;
  const unsigned m = __ballot_sync(0xffffffffu, on);
  if (lane == 0) bits[((size_t)b * T + t) * BW + word] = m;
}

struct Plan {
  int rows, smem_chain;
  GbitsPlan gin, grec;
  GoutPlan go;
};

// 0 when the shape fits, 1 when it does not, else a CUDA error code.
// O == 0: the z-layer mode.
int make_plan(int B, int Hin, int H, int O, int T, int rec, int bf16,
              int device, Plan* p) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32, HinW = (Hin + 31) / 32;
  if (H < 1 || O < 0 || Hin < 1 || T < 1 || T > 32767 || HP > 1024) return 1;
  const int G = 512 / HP > 0 ? 512 / HP : 1;
  p->rows = chain_rows(H, O, HP, G, rec, bf16 ? 2 : 4, lim.max_smem,
                       &p->smem_chain);
  if (p->rows == 0) return 1;
  auto plan = [&](int J, GbitsPlan* g) {
    return bf16 ? gbits_plan_rows<__nv_bfloat16>(B, T, J, H, lim, g)
                : gbits_plan_rows<float>(B, T, J, H, lim, g);
  };
  p->grec.groups = 0;
  if (plan(Hin, &p->gin) != 0 || (rec && plan(H, &p->grec) != 0)) return 1;
  p->go.groups = 0;
  if (O > 0 && gout_plan(B, H, O, T, lim, &p->go) != 0) return 1;
  return 0;
}

struct MidArgs {
  const void* z_in;   // (T, B, Hin) weights' type
  const void* w_in;   // (Hin, H)
  unsigned* zinmask;  // (B, T, Hin / 32) scratch
  void* g_z_in;       // (T, B, Hin) weights' type
  int Hin;
};

template <bool REC, bool HEAD, typename W>
cudaError_t launch_all(const Args& a, const MidArgs& m, const Plan& p,
                       cudaStream_t s) {
  const int HP = (a.H + 31) / 32 * 32, HinW = (m.Hin + 31) / 32;
  const size_t words = (size_t)a.T * a.B * HinW;
  pack_bits_kernel<W><<<(unsigned)((words + 7) / 8), 256, 0, s>>>(
      m.z_in, m.zinmask, a.T, a.B, m.Hin, HinW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = opt_in(bwd_chain_kernel<REC, HEAD, W>, p.smem_chain)) !=
      cudaSuccess)
    return err;
  bwd_chain_kernel<REC, HEAD, W>
      <<<dim3((a.B + p.rows - 1) / p.rows), dim3(HP, p.rows), p.smem_chain,
         s>>>(a, p.rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t M = (size_t)a.B * a.T;
  bwd_gzin_kernel<W>
      <<<dim3((unsigned)((M + GM - 1) / GM), (m.Hin + GN - 1) / GN), 256, 0,
         s>>>(a.dcur, m.w_in, m.g_z_in, a.B, a.T, a.H, m.Hin);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // Mask row t of zinmask holds z_in(t), the left operand of g_W_in.
  err = launch_gbits_rows<W>(a.dcur, m.zinmask, a.slab_in, a.B, a.T, m.Hin,
                             a.H, a.T, HinW, 0, p.gin, 1, s);
  if (err != cudaSuccess) return err;
  if (REC) {
    // Mask row t of zmask holds z(t - 1), the left operand of g_W_rec.
    err = launch_gbits_rows<W>(a.dcur, a.zmask, a.slab_rec, a.B, a.T, a.H,
                               a.H, a.T + 1, HP / 32, 0, p.grec, 1, s);
    if (err != cudaSuccess) return err;
  }
  if (HEAD) {
    if ((err = launch_gout<W>(a, p.go, 1, s)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename W>
cudaError_t launch_modes(const Args& a, const MidArgs& m, const Plan& p,
                         int rec, int head, cudaStream_t s) {
  if (head)
    return rec ? launch_all<true, true, W>(a, m, p, s)
               : launch_all<false, true, W>(a, m, p, s);
  return rec ? launch_all<true, false, W>(a, m, p, s)
             : launch_all<false, false, W>(a, m, p, s);
}

}  // namespace

extern "C" {

// Slab counts for a shape on `device` (O == 0: the z-layer mode): out[0] =
// blocks of g_W_in slabs, out[1] = of g_W_rec slabs (0 without recurrence),
// out[2] = of g_W_out/g_b slabs (0 in the z-layer mode).  Returns 0 when the
// shape fits the kernels, 1 when it does not, or a CUDA error code.
int snn_fused_mid_bwd_plan(int B, int Hin, int H, int O, int T, int rec,
                           int bf16, int device, int* out) {
  Plan p;
  const int rc = make_plan(B, Hin, H, O, T, rec, bf16, device, &p);
  if (rc == 0) {
    out[0] = p.gin.groups;
    out[1] = p.grec.groups;
    out[2] = p.go.groups;
  }
  return rc;
}

// Head mode where `w_out` is not null (g_logits, tstar, g_counts), else the
// z-layer mode (g_z, z).
int snn_fused_mid_bwd(const float* g_logits, const int* tstar,
                      const float* g_counts, const void* g_z, const void* z,
                      const void* res, const void* a_tr, const void* z_in,
                      const void* w_in, const void* w_rec, const void* w_out,
                      const float* beta, void* dcur, void* zmask,
                      void* zinmask, void* g_z_in, float* slab_in,
                      float* slab_rec, float* slab_out, int B, int Hin, int H,
                      int O, int T, int phi, int bf16, int res_is_v,
                      float alpha, float threshold, float gamma, float kappa,
                      int device, void* stream) {
  Plan p;
  const int rec = w_rec != nullptr, head = w_out != nullptr;
  if (!head) O = 0;
  const int rc = make_plan(B, Hin, H, O, T, rec, bf16, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (B == 0) return 0;
  Args a{g_logits, tstar, g_counts, g_z, z, res, a_tr, nullptr, w_rec, w_out,
         beta, dcur, static_cast<unsigned*>(zmask), slab_in, slab_rec,
         slab_out, B, Hin, H, O, T, 0, phi, res_is_v, alpha, threshold, gamma,
         kappa};
  MidArgs m{z_in, w_in, static_cast<unsigned*>(zinmask), g_z_in, Hin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_modes<__nv_bfloat16>(a, m, p, rec, head, s)
           : launch_modes<float>(a, m, p, rec, head, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
