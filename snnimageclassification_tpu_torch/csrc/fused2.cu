// Two-hidden-layer whole-network forward: latencies -> spike rows -> W0 ->
// (recurrent) LIF/ALIF layer 0 -> W1 -> (recurrent) LIF/ALIF layer 1 ->
// readout kappa-integrator -> first-argmax max over time, in one __global__
// function.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused2.py:_fused2_fwd_kernel
// (pl.pallas_call in _fused2_fwd_call): the inference primal of
// fused2_{rec,ff}_head (TRAIN = false: only the logits leave) and the
// training forward of those and of their _counts variants (TRAIN = true:
// the same arithmetic in the same order, so bitwise-equal logits, plus each
// layer's residual delta = V' - thr (and the adaptation trace a for ALIF
// with the Phi surrogate) as (T, B, H1) and (T, B, H2) in the weights' type,
// the argmax step tstar (B, O) and on request both layers' spike counts).
//
// What it keeps out of device memory: z0.  Layer 0's spikes of step t go to
// layer 1 as a bit mask in shared memory; no (T, B, H1) trace exists (the
// composed pair, fused_layer0_fwd + fused_mid_fwd, writes and reads one).
//
// Same sums as the composed pair, so the same bits: layer 0's input current
// is head_fwd.cuh's (the step's features compacted in ascending f, the
// period-1 rows summed once under periodic encoding), its recurrent current
// the walk of z0(t-1)'s set bits over W0r's rows; layer 1's input current is
// the walk of z0(t)'s set bits over W1's rows in ascending index, as
// fused_mid_fwd walks z_in(t); its recurrent sum and the readout the same
// walks over z1's bits.  Both layers are lif_cell.cuh's LifCell.
//
// Schedule (the Hopper analogue of the TPU kernel's software pipeline,
// pallas_fused2.py:5-17): layer 1 runs one step behind layer 0 on the same
// threads, so a loop iteration t holds
//   A: the readout of step t-2 (on the warps after the compaction warps)
//      and the compaction of step t's firing features;        barrier
//   B: layer 0 at step t and layer 1 at step t-1 (two independent chains
//      for each thread), each ballots its spikes into a mask;  barrier
// two barriers a step, as the single-layer head; T + 2 iterations.
//
// What bounds it on an H100: as the head (fused_head.cu), the latency of the
// serial T-chain, not bytes or FLOPs.  W0r, W1, W1r and W_out sit in shared
// memory (197 KB in f32 at 784-128-128-10: one block of up to 1024 threads
// an SM; 99 KB in bf16: two of 512), W0 in L2.
// All sums are f32 in a fixed order; built with --fmad=false so a*b+c rounds
// twice, as in the plain PyTorch version.
// Layout: one block = `rows` batch rows x HP threads (HP = max(H1, H2)
// rounded up to a warp multiple); thread (h, r) owns unit h of both layers
// of row r, and each warp holds 32 consecutive units of one row.

#include "head_fwd.cuh"
#include "lif_cell.cuh"

namespace {

struct Layout2 {
  size_t w0r, w1, w1r, wout, b, z0m, z1m, vr, m, cnt, lat, list, ts, total;
};

// Shared-memory layout of one block; the host uses it to size the launch.
__host__ __device__ inline Layout2 layout2(int F, int H1, int H2, int O,
                                           int rows, int HW, int rec,
                                           int wsize) {
  Layout2 L;
  size_t off = 0;
  L.w0r = off;
  off = align16(off + (rec ? (size_t)H1 * H1 * wsize : 0));
  L.w1 = off;
  off = align16(off + (size_t)H1 * H2 * wsize);
  L.w1r = off;
  off = align16(off + (rec ? (size_t)H2 * H2 * wsize : 0));
  L.wout = off;
  off = align16(off + (size_t)H2 * O * wsize);
  L.b = off;
  off = align16(off + (size_t)O * 4);
  L.z0m = off;  // two buffers of z0 bitmasks, (rows, HW) words each
  off = align16(off + (size_t)2 * rows * HW * 4);
  L.z1m = off;  // two buffers of z1 bitmasks
  off = align16(off + (size_t)2 * rows * HW * 4);
  L.vr = off;
  off = align16(off + (size_t)rows * O * 4);
  L.m = off;
  off = align16(off + (size_t)rows * O * 4);
  L.cnt = off;
  off = align16(off + (size_t)rows * 4);
  L.lat = off;  // latencies clamped to [-1, T], (rows, F) int16
  off = align16(off + (size_t)rows * F * 2);
  L.list = off;  // firing feature indices, (rows, F) uint16
  off = align16(off + (size_t)rows * F * 2);
  L.ts = off;  // argmax step of the running max, (rows, O) int
  off = align16(off + (size_t)rows * O * 4);
  L.total = off;
  return L;
}

struct Args2 {
  const int* lat;      // (B, F)
  const void* w0;      // (F, H1)
  const void* w0r;     // (H1, H1) masked, or null (then w1r is null too)
  const void* w1;      // (H1, H2)
  const void* w1r;     // (H2, H2) masked, or null
  const void* w_out;   // (H2, O)
  const float* b_out;  // (O)
  float* logits;       // (B, O)
  int* tstar;          // (B, O) or null, training
  float* cnt0;         // (B, H1) or null, training
  float* cnt1;         // (B, H2) or null, training
  int B, F, H1, H2, O, T, periodic;
  float kappa;
  LifParams p0, p1;  // each layer's beta, constants and residual traces
};

template <bool REC, bool ALIF, bool TRAIN, typename W>
__global__ void __launch_bounds__(1024) fused2_fwd_kernel(Args2 a, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = blockDim.x, HW = HP >> 5;
  const int H1 = a.H1, H2 = a.H2, O = a.O, F = a.F, T = a.T;
  const int HW0 = (H1 + 31) >> 5, HW1 = (H2 + 31) >> 5;
  const Layout2 L = layout2(F, H1, H2, O, rows, HW, REC, sizeof(W));
  W* s_w0r = reinterpret_cast<W*>(smem + L.w0r);
  W* s_w1 = reinterpret_cast<W*>(smem + L.w1);
  W* s_w1r = reinterpret_cast<W*>(smem + L.w1r);
  W* s_wout = reinterpret_cast<W*>(smem + L.wout);
  float* s_b = reinterpret_cast<float*>(smem + L.b);
  unsigned* s_z0m = reinterpret_cast<unsigned*>(smem + L.z0m);
  unsigned* s_z1m = reinterpret_cast<unsigned*>(smem + L.z1m);
  float* s_vr = reinterpret_cast<float*>(smem + L.vr);
  float* s_m = reinterpret_cast<float*>(smem + L.m);
  int* s_cnt = reinterpret_cast<int*>(smem + L.cnt);
  int16_t* s_lat = reinterpret_cast<int16_t*>(smem + L.lat);
  uint16_t* s_list = reinterpret_cast<uint16_t*>(smem + L.list);
  int* s_ts = reinterpret_cast<int*>(smem + L.ts);

  const int h = threadIdx.x, r = threadIdx.y;
  const int tid = r * HP + h, nthreads = HP * rows;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int row0 = blockIdx.x * rows;
  const W* w0 = static_cast<const W*>(a.w0);

  if (REC) {
    const W* g0 = static_cast<const W*>(a.w0r);
    for (int i = tid; i < H1 * H1; i += nthreads) s_w0r[i] = g0[i];
    const W* g1 = static_cast<const W*>(a.w1r);
    for (int i = tid; i < H2 * H2; i += nthreads) s_w1r[i] = g1[i];
  }
  {
    const W* g = static_cast<const W*>(a.w1);
    for (int i = tid; i < H1 * H2; i += nthreads) s_w1[i] = g[i];
    const W* go = static_cast<const W*>(a.w_out);
    for (int i = tid; i < H2 * O; i += nthreads) s_wout[i] = go[i];
    for (int i = tid; i < O; i += nthreads) s_b[i] = a.b_out[i];
  }
  for (int i = tid; i < 2 * rows * HW; i += nthreads) {
    s_z0m[i] = 0u;
    s_z1m[i] = 0u;
  }
  for (int i = tid; i < rows * O; i += nthreads) {
    s_vr[i] = 0.f;
    s_m[i] = -INFINITY;
    s_ts[i] = 0;
  }
  // Clamping to [-1, T] keeps every spike time of both encodings (the host
  // requires T <= 32767).
  for (int i = tid; i < rows * F; i += nthreads) {
    const int b = row0 + i / F;
    const int L0 = b < a.B ? a.lat[(size_t)row0 * F + i] : -1;
    s_lat[i] = (int16_t)min(max(L0, -1), T);
  }
  const bool live = row0 + r < a.B;
  const bool mine0 = live && h < H1, mine1 = live && h < H2;
  LifCell<ALIF> c0(a.p0), c1(a.p1);
  float n0 = 0.f, n1 = 0.f;
  __syncthreads();

  const int periodic = a.periodic;
  const bool every_step = periodic && T >= 2;
  const float cin_every =
      every_step ? every_step_sum(s_lat, s_list, s_cnt, F, rows, row0, a.B,
                                  warp, lane, mine0, r, w0, H1, h)
                 : 0.f;

  // z0(k) lives in z0 mask buffer (k + 1) & 1, z1(k) in z1 buffer
  // (k + 1) & 1; z(-1) = 0 in buffer 0 of each.
  for (int t = 0; t <= T + 1; ++t) {
    // A.  Readout of step t-2 (its z1 is in z1 buffer (t - 1) & 1), on the
    // warps after the rows' compaction warps.
    if (t >= 2) {
      const unsigned* z1s = s_z1m + ((t - 1) & 1) * rows * HW;
      for (int rr = 0; rr < rows; ++rr) {
        if ((rows + rr) % nwarps != warp || row0 + rr >= a.B) continue;
        readout_row<TRAIN, W>(O, a.kappa, s_wout, s_b, z1s + rr * HW, HW1,
                              s_vr + rr * O, s_m + rr * O, s_ts + rr * O,
                              t - 2, lane);
      }
    }
    if (t == T + 1) break;
    if (t < T)
      list_step(s_lat, s_list, s_cnt, F, rows, row0, a.B, warp, lane, t, T,
                periodic, every_step);
    __syncthreads();
    // B.  z0(t-1) is in z0 buffer t & 1: layer 0's reset and recurrence at
    // step t, and layer 1's input at step t-1.
    const unsigned* z0p = s_z0m + (t & 1) * rows * HW + r * HW;
    bool z0n = false, z1n = false;
    if (t < T && mine0) {
      const float cin = add_rows(t >= 1 ? cin_every : 0.f, s_list + r * F,
                                 s_cnt[r], w0, H1, h);
      const float cur = REC ? cin + masked_sum(z0p, HW0, s_w0r + h, H1) : cin;
      const float zp = (z0p[h >> 5] >> (h & 31)) & 1u ? 1.f : 0.f;
      z0n = c0.step(a.p0, cur, zp);
      c0.template store<TRAIN, true, W>(
          a.p0, ((size_t)t * a.B + row0 + r) * H1 + h, z0n);
      if (TRAIN && z0n) n0 += 1.f;
    }
    if (t >= 1 && t <= T && mine1) {
      // Layer 1 at step s = t - 1: z1(s-1) is in z1 buffer (t - 1) & 1.
      const unsigned* z1p = s_z1m + ((t - 1) & 1) * rows * HW + r * HW;
      const float cin = masked_sum(z0p, HW0, s_w1 + h, H2);
      const float cur = REC ? cin + masked_sum(z1p, HW1, s_w1r + h, H2) : cin;
      const float zp = (z1p[h >> 5] >> (h & 31)) & 1u ? 1.f : 0.f;
      z1n = c1.step(a.p1, cur, zp);
      c1.template store<TRAIN, true, W>(
          a.p1, ((size_t)(t - 1) * a.B + row0 + r) * H2 + h, z1n);
      if (TRAIN && z1n) n1 += 1.f;
    }
    // Each warp holds 32 consecutive units of one row: one mask word.
    const unsigned w0bits = __ballot_sync(0xffffffffu, z0n);
    const unsigned w1bits = __ballot_sync(0xffffffffu, z1n);
    if (lane == 0) {
      const int at = r * HW + (h >> 5);
      if (t < T) s_z0m[((t + 1) & 1) * rows * HW + at] = w0bits;
      if (t >= 1) s_z1m[(t & 1) * rows * HW + at] = w1bits;
    }
    __syncthreads();
  }
  // The readout warp of each row wrote its s_m entries; it writes them out.
  for (int rr = 0; rr < rows; ++rr) {
    if ((rows + rr) % nwarps != warp || row0 + rr >= a.B) continue;
    for (int o = lane; o < O; o += 32)
      a.logits[(size_t)(row0 + rr) * O + o] = s_m[rr * O + o];
    if (TRAIN && a.tstar) {
      for (int o = lane; o < O; o += 32)
        a.tstar[(size_t)(row0 + rr) * O + o] = s_ts[rr * O + o];
    }
  }
  if (TRAIN && a.cnt0 && mine0) a.cnt0[(size_t)(row0 + r) * H1 + h] = n0;
  if (TRAIN && a.cnt1 && mine1) a.cnt1[(size_t)(row0 + r) * H2 + h] = n1;
}

template <bool REC, bool ALIF, bool TRAIN, typename W>
cudaError_t launch2(const Args2& a, int rows, int HP, size_t smem,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused2_fwd_kernel<REC, ALIF, TRAIN, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 block(HP, rows);
  dim3 grid((a.B + rows - 1) / rows);
  fused2_fwd_kernel<REC, ALIF, TRAIN, W><<<grid, block, smem, stream>>>(a,
                                                                      rows);
  return cudaGetLastError();
}

template <bool TRAIN, typename W>
cudaError_t dispatch2(const Args2& a, int rec, int alif, int rows, int HP,
                      size_t smem, cudaStream_t s) {
  if (rec && alif) return launch2<true, true, TRAIN, W>(a, rows, HP, smem, s);
  if (rec) return launch2<true, false, TRAIN, W>(a, rows, HP, smem, s);
  if (alif) return launch2<false, true, TRAIN, W>(a, rows, HP, smem, s);
  return launch2<false, false, TRAIN, W>(a, rows, HP, smem, s);
}

inline int hp_of(int H1, int H2) {
  return ((H1 > H2 ? H1 : H2) + 31) / 32 * 32;
}

}  // namespace

extern "C" {

// Rows per block and shared-memory bytes for a shape on `device`.
// Returns 0 when the shape fits, 1 when it does not, or a CUDA error code.
int snn_fused2_plan(int F, int H1, int H2, int O, int rec, int bf16,
                    int device, int* rows_out, int* smem_out) {
  int max_smem = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (H1 < 1 || H2 < 1 || O < 1 || F < 1 || F > 65535) return 1;
  const int HP = hp_of(H1, H2);
  if (HP > 1024) return 1;
  const int wsize = bf16 ? 2 : 4;
  // Weights that leave room for one block an SM only: up to 1024 threads a
  // block; else up to 512, so that two or more blocks share an SM.  Fewer
  // rows where shared memory is short.
  const size_t one = layout2(F, H1, H2, O, 1, HP / 32, rec, wsize).total;
  const int threads = 2 * one > (size_t)max_smem ? 1024 : 512;
  for (int rows = threads / HP > 0 ? threads / HP : 1; rows >= 1; rows /= 2) {
    const size_t smem = layout2(F, H1, H2, O, rows, HP / 32, rec, wsize).total;
    if (smem <= (size_t)max_smem) {
      *rows_out = rows;
      *smem_out = (int)smem;
      return 0;
    }
  }
  return 1;
}

// The training kernel where any of d0, tstar, cnt0, cnt1 is not null (each
// output written where its pointer is not null), else the inference kernel
// (logits only).  w0r and w1r are both given (recurrent) or both null.
int snn_fused2_fwd(const int* lat, const void* w0, const void* w0r,
                   const float* beta0, const void* w1, const void* w1r,
                   const float* beta1, const void* w_out, const float* b_out,
                   float* logits, void* d0, void* a0, void* d1, void* a1,
                   int* tstar, float* cnt0, float* cnt1, int B, int F, int H1,
                   int H2, int O, int T, int periodic, int alif, int bf16,
                   float alpha, float rho, float threshold, float kappa,
                   int rows, int device, void* stream) {
  if (B == 0) return 0;
  if ((w0r == nullptr) != (w1r == nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args2 a{lat, w0, w0r, w1, w1r, w_out, b_out, logits, tstar, cnt0, cnt1,
          B, F, H1, H2, O, T, periodic, kappa,
          {beta0, alpha, rho, threshold, nullptr, d0, a0, 0},
          {beta1, alpha, rho, threshold, nullptr, d1, a1, 0}};
  const int HP = hp_of(H1, H2);
  const int rec = w0r != nullptr;
  const int train = d0 != nullptr || tstar != nullptr || cnt0 != nullptr ||
                    cnt1 != nullptr;
  const size_t smem =
      layout2(F, H1, H2, O, rows, HP / 32, rec, bf16 ? 2 : 4).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (train)
    err = bf16 ? dispatch2<true, BF>(a, rec, alif, rows, HP, smem, s)
               : dispatch2<true, float>(a, rec, alif, rows, HP, smem, s);
  else
    err = bf16 ? dispatch2<false, BF>(a, rec, alif, rows, HP, smem, s)
               : dispatch2<false, float>(a, rec, alif, rows, HP, smem, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
