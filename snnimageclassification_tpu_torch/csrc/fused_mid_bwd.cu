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
//   2. the chain, head or z-layer mode: dcur (B, T, H) and the bits of z.
//      Where chain_mma_fits (O <= 16, H <= 256, the weights' bf16 pieces
//      within a block's shared memory) the tensor-core body
//      (chain_mma.cuh:bwd_chain_mma_kernel with lif_chain.cuh's LifChain in
//      head mode, ZChain in z-layer mode), else bwd_common.cuh's per-unit
//      bwd_chain_kernel.
//   3. gzin_mma (gzin_mma.cuh): g_z_in(t) = dcur(t) @ W_in^T, a dense
//      (B T, H) x (H, Hin) product on tensor cores (float32 weights as three
//      bf16 pieces), rounded once to the weights' type (the type of z_in)
//      and written (T, B, Hin).
//   4. gbits_mma (gbits_mma.cuh, tensor cores) twice: g_W_in = sum_t
//      z_in(t)^T dcur(t) from the packed bits and g_W_rec = sum_t z(t-1)^T
//      dcur(t) from the bits of z.
//   5. bwd_gout (head): g_W_out and g_b.
// What bounds it on an H100: the serial chain (a step's products on tensor
// cores, one named barrier a step among a tile's warps); g_z_in, 2 B T H Hin
// FLOP (26.8 GFLOP at B=8192, T=100, 128 x 128; x6 for float32's pieces),
// reads dcur and writes g_z_in once; the traces read and written are 3-5
// (T, B, H) tensors, ~0.5 ms at the memory rate in f32.

#include "gbits_mma.cuh"
#include "gzin_mma.cuh"
#include "lif_chain.cuh"

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
  int rows, smem_chain, mma;
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
  p->mma = chain_mma_fits(H, O, rec, bf16, lim.max_smem);
  if (!gzin_fits(H, Hin, bf16, lim.max_smem)) return 1;
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
                       int device, cudaStream_t s) {
  const int HP = (a.H + 31) / 32 * 32, HinW = (m.Hin + 31) / 32;
  const size_t words = (size_t)a.T * a.B * HinW;
  pack_bits_kernel<W><<<(unsigned)((words + 7) / 8), 256, 0, s>>>(
      m.z_in, m.zinmask, a.T, a.B, m.Hin, HinW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using Chain = typename std::conditional<HEAD, LifChain<W>,
                                          ZChain<W, W, false>>::type;
  if (p.mma) {
    err = launch_chain_mma<Chain, REC, W>(a, 1, device, s);
  } else {
    if ((err = opt_in(bwd_chain_kernel<REC, HEAD, W>, p.smem_chain)) !=
        cudaSuccess)
      return err;
    bwd_chain_kernel<REC, HEAD, W>
        <<<dim3((a.B + p.rows - 1) / p.rows), dim3(HP, p.rows), p.smem_chain,
           s>>>(a, p.rows);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  err = launch_gzin_mma<W, W>(a.dcur, m.w_in, m.g_z_in, a.B, a.T, a.H, m.Hin,
                              device, s);
  if (err != cudaSuccess) return err;
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
                         int rec, int head, int device, cudaStream_t s) {
  if (head)
    return rec ? launch_all<true, true, W>(a, m, p, device, s)
               : launch_all<false, true, W>(a, m, p, device, s);
  return rec ? launch_all<true, false, W>(a, m, p, device, s)
             : launch_all<false, false, W>(a, m, p, device, s);
}

}  // namespace

extern "C" {

// Slab counts for a shape on `device` (O == 0: the z-layer mode): out[0] =
// blocks of g_W_in slabs, out[1] = of g_W_rec slabs (0 without recurrence),
// out[2] = of g_W_out/g_b slabs (0 in the z-layer mode); out[3] = 1 where
// the chain takes its tensor-core body; out[4] = rows a batch of bwd_gout.
// Returns 0 when the shape fits the kernels, 1 when it does not, or a CUDA
// error code.
int snn_fused_mid_bwd_plan(int B, int Hin, int H, int O, int T, int rec,
                           int bf16, int device, int* out) {
  Plan p;
  const int rc = make_plan(B, Hin, H, O, T, rec, bf16, device, &p);
  if (rc == 0) {
    out[0] = p.gin.groups;
    out[1] = p.grec.groups;
    out[2] = p.go.groups;
    out[3] = p.mma;
    out[4] = O > 0 ? p.go.R : 0;
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
      bf16 ? launch_modes<__nv_bfloat16>(a, m, p, rec, head, device, s)
           : launch_modes<float>(a, m, p, rec, head, device, s);
  return (int)err;
}

// gzin_mma alone: out (T, B, N) = dcur (B, T, K) @ w (N, K)^T, dcur and w
// in the weights' type (bf16 or float32), out in that type or (out_f32)
// float32.
int snn_gzin(const void* dcur, const void* w, void* out, int B, int T, int K,
             int N, int bf16, int out_f32, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    err = out_f32 ? launch_gzin_mma<__nv_bfloat16, float>(dcur, w, out, B, T,
                                                          K, N, device, s)
                  : launch_gzin_mma<__nv_bfloat16, __nv_bfloat16>(
                        dcur, w, out, B, T, K, N, device, s);
  else
    err = launch_gzin_mma<float, float>(dcur, w, out, B, T, K, N, device, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
