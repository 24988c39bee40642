// Hidden layers past the first: input product + (recurrent) LIF/ALIF scan,
// and for the last hidden layer also the readout kappa-integrator and the
// first-argmax max over time.
//
// One template, kernel fused_mid_fwd.  Z-emitting mode (HEAD = false): the
// spike trace z (T, B, H) leaves in the weights' type and, for training
// (TRAIN = true), the residual the backward needs: delta = V' - thr for ALIF
// with the FastSigmoid surrogate, the membrane V' otherwise (and the
// adaptation trace a for ALIF with Phi).  Head mode (HEAD = true): only the
// logits leave; for training also delta (and a for ALIF with Phi), the argmax
// step tstar (B, O) and on request the spike counts (B, H).  Inference and
// training run the same arithmetic in the same order: equal bits.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused_mid.py:_mid_fwd_kernel
// (pl.pallas_call in _mid_fwd_call): fused_mid_{rec,ff}_scan and
// fused_mid_{rec,ff}_scan_head[_counts], primal and training forward.
//
// What bounds it on an H100: the inputs are the (T, B, Hin) spike trace of
// the layer before (419 MB in f32 at B=8192, T=100, Hin=128: 0.13 ms at the
// memory rate) and the dense work 2 B T H (Hin + H + O) FLOP, but every step
// depends on the one before, so the kernel is bound by the latency of the
// serial T-chain, as the whole-network head is (fused_head.cu).  The design
// is that kernel's with another source of input current:
//   * z_in(t) is 0/1, so the input current is the sum of the rows of W_in
//     that it selects: the block turns its rows' z_in(t) into bit masks (one
//     ballot a warp) and every thread walks the set bits in ascending index;
//     the recurrent current and the readout are the same walk over the bits
//     of z(t-1) and z(t);
//   * W_in, W_rec and W_out sit in shared memory (133 KB in f32 at
//     128-128-10, so one block of up to 1024 threads an SM; three blocks in
//     bf16);
//   * a thread loads its part of z_in(t+1) before it computes step t, so the
//     load's latency hides behind the sums (at most NPRE values a thread:
//     Hin <= NPRE * H, both rounded up to 32);
//   * the readout of step t-1 runs on other warps' time, as in the head.
// All sums are f32 in a fixed order (ascending index); the file is built
// with --fmad=false so a*b+c rounds twice, as in the plain PyTorch version.
// Layout: one block = `rows` batch rows x HP threads (HP = H rounded up to a
// warp multiple); thread (h, r) owns hidden unit h of row r, and each warp
// holds 32 consecutive units of one row.

#include "head_common.cuh"

namespace {

constexpr int NPRE = 4;  // input spikes a thread stages a step, at most

struct Layout {
  size_t win, wrec, wout, b, zm, zin, vr, m, ts, total;
};

// Shared-memory layout of one block; the host uses it to size the launch.
__host__ __device__ inline Layout layout(int Hin, int H, int O, int rows,
                                         int HP, int HinP, int rec,
                                         int wsize) {
  Layout L;
  size_t off = 0;
  L.win = off;
  off = align16(off + (size_t)Hin * H * wsize);
  L.wrec = off;
  off = align16(off + (rec ? (size_t)H * H * wsize : 0));
  L.wout = off;
  off = align16(off + (size_t)H * O * wsize);
  L.b = off;
  off = align16(off + (size_t)O * 4);
  L.zm = off;  // two buffers of z bitmasks, (rows, HP / 32) words each
  off = align16(off + (size_t)2 * rows * (HP / 32) * 4);
  L.zin = off;  // z_in(t) bitmasks, (rows, HinP / 32) words
  off = align16(off + (size_t)rows * (HinP / 32) * 4);
  L.vr = off;
  off = align16(off + (size_t)rows * O * 4);
  L.m = off;
  off = align16(off + (size_t)rows * O * 4);
  L.ts = off;  // argmax step of the running max, (rows, O) int
  off = align16(off + (size_t)rows * O * 4);
  L.total = off;
  return L;
}

struct Args {
  const void* z_in;  // (T, B, Hin) weights' type, 0/1
  const void* w_in;  // (Hin, H)
  const void* w_rec;
  const float* beta;
  const void* w_out;   // head
  const float* b_out;  // head
  void* z;             // (T, B, H) weights' type, z-emitting mode
  // Training outputs, each optional (null: not written).
  void* res;      // (T, B, H) weights' type: delta, or v where res_is_v
  void* a_tr;     // (T, B, H) weights' type, ALIF only
  float* logits;  // (B, O) head
  int* tstar;     // (B, O) head
  float* counts;  // (B, H) head
  int B, Hin, H, O, T, res_is_v;
  float alpha, rho, threshold, kappa;
};

template <bool REC, bool ALIF, bool TRAIN, bool HEAD, typename W>
__global__ void __launch_bounds__(1024) fused_mid_fwd_kernel(Args a,
                                                             int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = blockDim.x, HW = HP >> 5;
  const int H = a.H, O = HEAD ? a.O : 0, Hin = a.Hin, T = a.T;
  const int HinP = (Hin + 31) / 32 * 32, HinW = HinP >> 5;
  const Layout L = layout(Hin, H, O, rows, HP, HinP, REC, sizeof(W));
  W* s_win = reinterpret_cast<W*>(smem + L.win);
  W* s_wrec = reinterpret_cast<W*>(smem + L.wrec);
  W* s_wout = reinterpret_cast<W*>(smem + L.wout);
  float* s_b = reinterpret_cast<float*>(smem + L.b);
  unsigned* s_zm = reinterpret_cast<unsigned*>(smem + L.zm);
  unsigned* s_zin = reinterpret_cast<unsigned*>(smem + L.zin);
  float* s_vr = reinterpret_cast<float*>(smem + L.vr);
  float* s_m = reinterpret_cast<float*>(smem + L.m);
  int* s_ts = reinterpret_cast<int*>(smem + L.ts);

  const int h = threadIdx.x, r = threadIdx.y;
  const int tid = r * HP + h, nthreads = HP * rows;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int row0 = blockIdx.x * rows;

  {
    const W* g = static_cast<const W*>(a.w_in);
    for (int i = tid; i < Hin * H; i += nthreads) s_win[i] = g[i];
  }
  if (REC) {
    const W* g = static_cast<const W*>(a.w_rec);
    for (int i = tid; i < H * H; i += nthreads) s_wrec[i] = g[i];
  }
  if (HEAD) {
    const W* g = static_cast<const W*>(a.w_out);
    for (int i = tid; i < H * O; i += nthreads) s_wout[i] = g[i];
    for (int i = tid; i < O; i += nthreads) s_b[i] = a.b_out[i];
  }
  for (int i = tid; i < 2 * rows * HW; i += nthreads) s_zm[i] = 0u;
  for (int i = tid; i < rows * O; i += nthreads) {
    s_vr[i] = 0.f;
    s_m[i] = -INFINITY;
    s_ts[i] = 0;
  }
  const float beta = ALIF ? *a.beta : 0.f;
  const bool mine = (row0 + r < a.B) && (h < H);
  float v = 0.f, ad = 0.f, n_spikes = 0.f;

  // This thread's part of the block's (rows, HinP) input spikes: elements
  // e = k * nthreads + tid.  A warp's 32 elements are one mask word of one
  // row (nthreads and HinP are multiples of 32).
  const W* z_in = static_cast<const W*>(a.z_in);
  const int n_in = rows * HinP;
  const size_t in_stride = (size_t)a.B * Hin;
  unsigned in_at[NPRE];  // offset inside a step's (B, Hin) slab, or NONE
  constexpr unsigned NONE = 0xffffffffu;
  bool pre[NPRE];
#pragma unroll
  for (int k = 0; k < NPRE; ++k) {
    const int e = k * nthreads + tid;
    const int rr = e / HinP, j = e % HinP;
    const bool ok = e < n_in && row0 + rr < a.B && j < Hin;
    in_at[k] = ok ? (unsigned)(row0 + rr) * Hin + j : NONE;
    pre[k] = ok && to_f32(z_in[in_at[k]]) != 0.f;  // z_in(0)
  }
  __syncthreads();

  // z_t lives in mask buffer (t + 1) & 1; z_{-1} = 0 in buffer 0.
  for (int t = 0; t <= T; ++t) {
    const unsigned* z_prev = s_zm + (t & 1) * rows * HW;
    // Readout of step t-1 (its z is z_prev), spread over the warps.
    if (HEAD && t > 0) {
      for (int rr = 0; rr < rows; ++rr) {
        if ((rows + rr) % nwarps != warp || row0 + rr >= a.B) continue;
        readout_row<TRAIN, W>(O, a.kappa, s_wout, s_b, z_prev + rr * HW, HW,
                              s_vr + rr * O, s_m + rr * O, s_ts + rr * O,
                              t - 1, lane);
      }
    }
    if (t == T) break;
    // The staged z_in(t) as bit masks.
#pragma unroll
    for (int k = 0; k < NPRE; ++k) {
      const unsigned word = __ballot_sync(0xffffffffu, pre[k]);
      const int e = k * nthreads + tid;
      if (lane == 0 && e < n_in) s_zin[e >> 5] = word;
    }
    __syncthreads();
    // Stage z_in(t + 1): in flight while this step's sums run.
    if (t + 1 < T) {
#pragma unroll
      for (int k = 0; k < NPRE; ++k)
        pre[k] = in_at[k] != NONE &&
                 to_f32(z_in[(size_t)(t + 1) * in_stride + in_at[k]]) != 0.f;
    }
    bool z_new = false;
    if (mine) {
      const float cin = masked_sum(s_zin + r * HinW, HinW, s_win + h, H);
      const unsigned* zr = z_prev + r * HW;
      const float cur = REC ? cin + masked_sum(zr, HW, s_wrec + h, H) : cin;
      const float zp = (zr[h >> 5] >> (h & 31)) & 1u ? 1.f : 0.f;
      v = (a.alpha * v + cur) * (1.f - zp);
      float thr = a.threshold;
      if (ALIF) {
        ad = a.rho * ad + zp;
        thr = a.threshold + beta * ad;
      }
      const float delta = v - thr;
      z_new = delta >= 0.f;
      const size_t at = ((size_t)t * a.B + row0 + r) * H + h;
      if (!HEAD) from_f32(z_new ? 1.f : 0.f, static_cast<W*>(a.z) + at);
      if (TRAIN) {
        // Rounded to the weights' type once, here.
        const float keep = (!HEAD && a.res_is_v) ? v : delta;
        if (a.res) from_f32(keep, static_cast<W*>(a.res) + at);
        if (ALIF && a.a_tr) from_f32(ad, static_cast<W*>(a.a_tr) + at);
        if (z_new) n_spikes += 1.f;
      }
    }
    // Each warp holds 32 consecutive units of one row: one mask word.
    const unsigned word = __ballot_sync(0xffffffffu, z_new);
    if (lane == 0) s_zm[((t + 1) & 1) * rows * HW + r * HW + (h >> 5)] = word;
    __syncthreads();
  }
  // The readout warp of each row wrote its s_m entries; it writes them out.
  for (int rr = 0; HEAD && rr < rows; ++rr) {
    if ((rows + rr) % nwarps != warp || row0 + rr >= a.B) continue;
    for (int o = lane; o < O; o += 32)
      a.logits[(size_t)(row0 + rr) * O + o] = s_m[rr * O + o];
    if (TRAIN && a.tstar) {
      for (int o = lane; o < O; o += 32)
        a.tstar[(size_t)(row0 + rr) * O + o] = s_ts[rr * O + o];
    }
  }
  if (HEAD && TRAIN && a.counts && mine)
    a.counts[(size_t)(row0 + r) * H + h] = n_spikes;
}

template <bool REC, bool ALIF, bool TRAIN, bool HEAD, typename W>
cudaError_t launch(const Args& a, int rows, int HP, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mid_fwd_kernel<REC, ALIF, TRAIN, HEAD, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 block(HP, rows);
  dim3 grid((a.B + rows - 1) / rows);
  fused_mid_fwd_kernel<REC, ALIF, TRAIN, HEAD, W>
      <<<grid, block, smem, stream>>>(a, rows);
  return cudaGetLastError();
}

template <bool TRAIN, bool HEAD, typename W>
cudaError_t dispatch(const Args& a, int rec, int alif, int rows, int HP,
                     size_t smem, cudaStream_t s) {
  if (rec && alif)
    return launch<true, true, TRAIN, HEAD, W>(a, rows, HP, smem, s);
  if (rec) return launch<true, false, TRAIN, HEAD, W>(a, rows, HP, smem, s);
  if (alif) return launch<false, true, TRAIN, HEAD, W>(a, rows, HP, smem, s);
  return launch<false, false, TRAIN, HEAD, W>(a, rows, HP, smem, s);
}

template <bool TRAIN, bool HEAD>
cudaError_t dispatch_w(const Args& a, int rec, int alif, int bf16, int rows,
                       int HP, size_t smem, cudaStream_t s) {
  return bf16 ? dispatch<TRAIN, HEAD, __nv_bfloat16>(a, rec, alif, rows, HP,
                                                     smem, s)
              : dispatch<TRAIN, HEAD, float>(a, rec, alif, rows, HP, smem, s);
}

}  // namespace

extern "C" {

// Rows per block and shared-memory bytes for a shape on `device` (O == 0:
// the z-emitting mode).  Returns 0 when the shape fits, 1 when it does not,
// or a CUDA error code.
int snn_fused_mid_plan(int Hin, int H, int O, int rec, int bf16, int device,
                       int* rows_out, int* smem_out) {
  int max_smem = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32, HinP = (Hin + 31) / 32 * 32;
  if (H < 1 || O < 0 || Hin < 1 || HP > 1024 || HinP > NPRE * HP) return 1;
  const int wsize = bf16 ? 2 : 4;
  // Weights that leave room for one block an SM only: up to 1024 threads a
  // block; else up to 512, so that two or more blocks share an SM.  Fewer
  // rows where shared memory is short.
  const size_t one = layout(Hin, H, O, 1, HP, HinP, rec, wsize).total;
  const int threads = 2 * one > (size_t)max_smem ? 1024 : 512;
  for (int rows = threads / HP > 0 ? threads / HP : 1; rows >= 1; rows /= 2) {
    const size_t smem = layout(Hin, H, O, rows, HP, HinP, rec, wsize).total;
    if (smem <= (size_t)max_smem) {
      *rows_out = rows;
      *smem_out = (int)smem;
      return 0;
    }
  }
  return 1;
}

// Head mode where `w_out` is not null (writes logits; z is not written),
// else the z-emitting mode (writes z).  The training outputs res, a_tr,
// tstar and counts are written where their pointers are not null.
int snn_fused_mid_fwd(const void* z_in, const void* w_in, const void* w_rec,
                      const float* beta, const void* w_out,
                      const float* b_out, void* z, void* res, void* a_tr,
                      float* logits, int* tstar, float* counts, int B, int Hin,
                      int H, int O, int T, int alif, int bf16, int res_is_v,
                      float alpha, float rho, float threshold, float kappa,
                      int rows, int device, void* stream) {
  if (B == 0) return 0;
  // The kernel keeps 32-bit offsets inside one step's (B, Hin) slab.
  if ((size_t)B * Hin >= 0xffffffffu) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int head = w_out != nullptr;
  Args a{z_in, w_in, w_rec, beta, w_out, b_out, z, res, a_tr, logits, tstar,
         counts, B, Hin, H, head ? O : 0, T, res_is_v, alpha, rho, threshold,
         kappa};
  const int HP = (H + 31) / 32 * 32, HinP = (Hin + 31) / 32 * 32;
  const int rec = w_rec != nullptr;
  const int train = res != nullptr || counts != nullptr || tstar != nullptr;
  const size_t smem =
      layout(Hin, H, a.O, rows, HP, HinP, rec, bf16 ? 2 : 4).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head)
    err = train ? dispatch_w<true, true>(a, rec, alif, bf16, rows, HP, smem, s)
                : dispatch_w<false, true>(a, rec, alif, bf16, rows, HP, smem,
                                          s);
  else
    err = train
              ? dispatch_w<true, false>(a, rec, alif, bf16, rows, HP, smem, s)
              : dispatch_w<false, false>(a, rec, alif, bf16, rows, HP, smem,
                                         s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
