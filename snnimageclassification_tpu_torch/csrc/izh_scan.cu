// Izhikevich scan over precomputed input currents, forward and backward:
// currents (T, B, H) float32 [+ z(t-1) @ masked W_rec] -> z, v (T, B, H)
// float32; backward g_z -> g_i (T, B, H) float32 and g_W_rec.  A hidden
// Izhikevich layer past the first takes it, on currents z_in @ W_in that
// one torch.matmul computes for all steps.
//
// Replaces the TPU kernels
// snnimageclassification_tpu/ops/pallas_izh.py:_fwd_kernel (pl.pallas_call
// in _fwd_call, :157) and _bwd_kernel (in _bwd_call, :211), izh_scan.
//
// What bounds it on an H100: the forward reads the currents once (419 MB in
// float32 at B = 8192, T = 100, H = 128: 0.13 ms at the memory rate) and
// writes z and v; the backward reads g_z, z and v and writes g_i.  Both are
// bound by the latency of the serial T-chain, not by those bytes.
//
// Two bodies each way.  Where it fits (H <= 256, W_rec's bf16 pieces within
// a block's shared memory) the forward is the tensor-core body of the first
// layers (head_mma_fwd.cuh:head_mma_kernel, HEAD = false, with
// izh_cell.cuh:IzhMmaCell): a warp owns 16 rows x 32 units, v and u in
// registers in the accumulator layout, z(t-1) @ W_rec on tensor cores from
// the tile's exchange buffer, the input current the DenseCurrent policy
// (the lane's entries of cur, a step ahead), z(t) in 16-byte stores from
// the exchange buffer, v by the cell; the backward's chain is the
// tensor-core chain body (chain_mma.cuh:bwd_chain_mma_kernel) with
// izh_chain.cuh:IzhScanChain, v, z and g_z loaded a step ahead,
// round(gi(t+1)) @ W_rec^T on tensor cores, g_i written in float32 and the
// z bits for g_W_rec.  Past those limits the per-unit kernels: the forward
// below (thread (h, r) owns unit h of row r, loads its current of step t+1
// while it computes step t, takes the recurrent current as the sum of
// W_rec's rows (shared memory) over the set bits of z(t-1), one block
// barrier a step) and izh_common.cuh:izh_chain_kernel.  g_W_rec is
// gbits_mma (gbits_mma.cuh) on the chain's float32 g_i read step-major
// (row t B + b) and rounded to W's type as it is read: no (B, T, H) dcur
// scratch.  Slabs, no atomics.  Built with
// --fmad=false: the cell rounds as the plain PyTorch version.

#include "gbits_mma.cuh"
#include "head_mma_fwd.cuh"
#include "izh_cell.cuh"
#include "izh_chain.cuh"

namespace {

struct ScanArgs {
  const float* cur;   // (T, B, H)
  const void* w_rec;  // (H, H) or null
  float* z;           // (T, B, H)
  float* v;           // (T, B, H) or null
  int B, H, T;
  IzhParams p;
};

struct ScanLayout {
  size_t wrec, zm, total;
};

__host__ __device__ inline ScanLayout scan_layout(int H, int rows, int HP,
                                                  int rec, int wsize) {
  ScanLayout L;
  size_t off = 0;
  L.wrec = off;
  off = align16(off + (rec ? (size_t)H * H * wsize : 0));
  L.zm = off;  // two buffers of z bitmasks, (rows, HP / 32) words each
  off = align16(off + (size_t)2 * rows * (HP / 32) * 4);
  L.total = off;
  return L;
}

template <bool REC, typename W>
__global__ void __launch_bounds__(1024)
    izh_scan_fwd_kernel(ScanArgs a, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = blockDim.x, HW = HP >> 5;
  const int H = a.H, T = a.T;
  const ScanLayout L = scan_layout(H, rows, HP, REC, sizeof(W));
  W* s_wrec = reinterpret_cast<W*>(smem + L.wrec);
  unsigned* s_zm = reinterpret_cast<unsigned*>(smem + L.zm);

  const int h = threadIdx.x, r = threadIdx.y;
  const int tid = r * HP + h, nthreads = HP * rows;
  const int row = blockIdx.x * rows + r;
  if (REC) {
    const W* g = static_cast<const W*>(a.w_rec);
    for (int i = tid; i < H * H; i += nthreads) s_wrec[i] = g[i];
  }
  for (int i = tid; i < 2 * rows * HW; i += nthreads) s_zm[i] = 0u;
  const IzhParams p = a.p;
  const bool mine = row < a.B && h < H;
  const size_t stride = (size_t)a.B * H, at0 = (size_t)row * H + h;
  float v = p.v_rest, u = 0.f;
  float cur_next = mine ? a.cur[at0] : 0.f;
  __syncthreads();

  // z_t lives in mask buffer (t + 1) & 1; z_{-1} = 0 in buffer 0.
  for (int t = 0; t < T; ++t) {
    const unsigned* zr = s_zm + (t & 1) * rows * HW + r * HW;
    const float cin = cur_next;
    if (mine && t + 1 < T) cur_next = a.cur[(size_t)(t + 1) * stride + at0];
    bool z_new = false;
    if (mine) {
      const float cur = REC ? cin + masked_sum(zr, HW, s_wrec + h, H) : cin;
      const float zp = (zr[h >> 5] >> (h & 31)) & 1u ? 1.f : 0.f;
      izh_step(p, cur, zp, v, u);
      z_new = v >= p.v_peak;
      const size_t at = (size_t)t * stride + at0;
      a.z[at] = z_new ? 1.f : 0.f;
      if (a.v) a.v[at] = v;
    }
    // Each warp holds 32 consecutive units of one row: one mask word.
    const unsigned word = __ballot_sync(0xffffffffu, z_new);
    if ((h & 31) == 0)
      s_zm[((t + 1) & 1) * rows * HW + r * HW + (h >> 5)] = word;
    __syncthreads();
  }
}

template <bool REC, typename W>
cudaError_t launch_fwd(const ScanArgs& a, int rows, int HP, size_t smem,
                       cudaStream_t s) {
  cudaError_t err = opt_in(izh_scan_fwd_kernel<REC, W>, (int)smem);
  if (err != cudaSuccess) return err;
  izh_scan_fwd_kernel<REC, W>
      <<<dim3((a.B + rows - 1) / rows), dim3(HP, rows), smem, s>>>(a, rows);
  return cudaGetLastError();
}

// The tensor-core body: head_mma_kernel without the readout, its input
// current a.cur (DenseCurrent), no lists.
template <bool REC, typename W>
cudaError_t launch_fwd_mma(const ScanArgs& a, int device, cudaStream_t s) {
  FwdArgs<IzhCellParams> f{nullptr, nullptr, a.w_rec, nullptr, nullptr,
                           nullptr, nullptr, nullptr, a.B, 0, a.H, 0, a.T,
                           0, 0.f, {a.p, a.z, a.v}};
  f.cur = a.cur;
  return a.v ? launch_mma<IzhMmaCell, REC, true, false, W, DenseCurrent>(
                   f, nullptr, 1, device, s)
             : launch_mma<IzhMmaCell, REC, false, false, W, DenseCurrent>(
                   f, nullptr, 1, device, s);
}

struct BwdPlan {
  int rows, smem_chain, mma;
  GbitsPlan gb;
};

int make_bwd_plan(int B, int H, int T, int rec, int bf16, int device,
                  BwdPlan* p) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32;
  if (H < 1 || T < 1 || HP > 1024) return 1;
  const int G = 512 / HP > 0 ? 512 / HP : 1;
  p->rows = chain_rows(H, 0, HP, G, rec, bf16 ? 2 : 4, lim.max_smem,
                       &p->smem_chain);
  if (p->rows == 0) return 1;
  p->mma = chain_mma_fits(H, 0, rec, bf16, lim.max_smem);
  p->gb.groups = 0;
  if (rec && gbits_plan(B > 0 ? B : 1, T, H, H, 4, bf16 ? 1 : 3, lim,
                        &p->gb) != 0)
    return 1;
  return 0;
}

template <bool REC, typename W>
cudaError_t launch_bwd(const IzhChainArgs& c, float* slab_rec,
                       const BwdPlan& p, int device, cudaStream_t s) {
  const int HP = (c.H + 31) / 32 * 32;
  cudaError_t err;
  if (p.mma) {
    err = launch_chain_mma<IzhScanChain, REC, W>(c, 1, device, s);
  } else {
    err = opt_in(izh_chain_kernel<REC, false, W>, p.smem_chain);
    if (err != cudaSuccess) return err;
    izh_chain_kernel<REC, false, W>
        <<<dim3((c.B + p.rows - 1) / p.rows), dim3(HP, p.rows),
           p.smem_chain, s>>>(c, p.rows);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || !REC) return err;
  // Mask row b (T + 1) + t of zmask holds z(t - 1) of row b, the left
  // operand of g_W_rec; d row (b, t) is g_i(t) of row b, row t B + b of
  // g_i (T, B, H).
  const int HW = HP / 32;
  const GbitsArgs g{c.g_i, c.zmask, slab_rec, c.B, c.T, 1, c.B, c.T + 1, 1,
                    0, HW, c.H, c.H};
  return launch_gbits<float, W>(g, p.gb, 1, s);
}

}  // namespace

extern "C" {

// The forward's body for a shape on `device`: *mma_out = 1 the tensor-core
// body, 0 the per-unit body with *rows_out rows a block and *smem_out
// bytes of shared memory.  Returns 0 when the shape fits, 1 when it does
// not, or a CUDA error code.
int snn_izh_scan_plan(int H, int rec, int bf16, int device, int* rows_out,
                      int* smem_out, int* mma_out) {
  int max_smem = 0;
  const int err = max_smem_of(device, &max_smem);
  if (err != 0) return err;
  const int HP = (H + 31) / 32 * 32;
  if (H < 1 || HP > 1024) return 1;
  *mma_out = mma_fits(H, 0, rec, bf16, max_smem) ? 1 : 0;
  *rows_out = *smem_out = 0;
  for (int rows = 512 / HP > 0 ? 512 / HP : 1; rows >= 1; rows /= 2) {
    const size_t smem = scan_layout(H, rows, HP, rec, bf16 ? 2 : 4).total;
    if (smem <= (size_t)max_smem) {
      *rows_out = rows;
      *smem_out = (int)smem;
      return 0;
    }
  }
  return *mma_out ? 0 : 1;
}

// z (T, B, H), and v (T, B, H) where v is not null (training), on the body
// snn_izh_scan_plan gives (mma; else the per-unit body at `rows`).
int snn_izh_scan_fwd(const float* cur, const void* w_rec, float* z, float* v,
                     int B, int H, int T, int bf16, float dt, float C,
                     float v_rest, float v_th, float k, float a_, float b_,
                     float c, float d, float v_peak, int rows, int mma,
                     int device, void* stream) {
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ScanArgs a{cur, w_rec, z, v, B, H, T,
             IzhParams{dt, C, v_rest, v_th, k, a_, b_, c, d, v_peak}};
  const int HP = (H + 31) / 32 * 32;
  const int rec = w_rec != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (!rec) err = launch_fwd_mma<false, float>(a, device, s);
    else if (bf16) err = launch_fwd_mma<true, __nv_bfloat16>(a, device, s);
    else err = launch_fwd_mma<true, float>(a, device, s);
    return (int)err;
  }
  const size_t smem = scan_layout(H, rows, HP, rec, bf16 ? 2 : 4).total;
  if (!rec) err = launch_fwd<false, float>(a, rows, HP, smem, s);
  else if (bf16) err = launch_fwd<true, __nv_bfloat16>(a, rows, HP, smem, s);
  else err = launch_fwd<true, float>(a, rows, HP, smem, s);
  return (int)err;
}

// out[0] = blocks of g_W_rec slabs (0 without recurrence), out[1] = 1
// where the chain takes the tensor-core chain body (0: the per-unit chain).
// Returns 0 when the shape fits, 1 when it does not, or a CUDA error code.
int snn_izh_scan_bwd_plan(int B, int H, int T, int rec, int bf16, int device,
                          int* out) {
  BwdPlan p;
  const int rc = make_bwd_plan(B, H, T, rec, bf16, device, &p);
  if (rc == 0) {
    out[0] = p.gb.groups;
    out[1] = p.mma;
  }
  return rc;
}

// g_i (T, B, H) float32 and, with w_rec, g_W_rec's slabs; zmask (B, T + 1,
// HP / 32) is the call's scratch (unused without w_rec).
int snn_izh_scan_bwd(const float* g_z, const float* z, const float* v,
                     const void* w_rec, float* g_i, void* zmask,
                     float* slab_rec, int B, int H, int T, int phi, int bf16,
                     float dtC, float c1, float c2, float c3, float v_rest,
                     float v_th, float v_peak, float gamma, int device,
                     void* stream) {
  const int rec = w_rec != nullptr;
  BwdPlan p;
  const int rc = make_bwd_plan(B, H, T, rec, bf16, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (B == 0) return 0;
  IzhChainArgs c{nullptr, nullptr, nullptr, g_z, z, v, w_rec, nullptr, g_i,
                 nullptr, rec ? static_cast<unsigned*>(zmask) : nullptr, B, H,
                 0, T,
                 IzhBwd{dtC, c1, c2, c3, v_rest, v_th, v_peak, gamma, phi},
                 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!rec) err = launch_bwd<false, float>(c, slab_rec, p, device, s);
  else if (bf16)
    err = launch_bwd<true, __nv_bfloat16>(c, slab_rec, p, device, s);
  else err = launch_bwd<true, float>(c, slab_rec, p, device, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
