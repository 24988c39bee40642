// Whole-network head forward for single-hidden-layer LIF/ALIF classifiers:
// latencies -> spike rows -> W_in -> (recurrent) LIF/ALIF scan -> readout
// kappa-integrator -> first-argmax max over time.
//
// Two kernels from one template.  fused_head_fwd (TRAIN = false): only the
// logits leave the kernel.  fused_head_fwd_train (TRAIN = true): the same
// arithmetic in the same order, so its logits are bitwise equal, plus what
// the backward (fused_head_bwd.cu) needs: the residual delta = V' - thr
// (and the adaptation trace a for ALIF with the Phi surrogate) as (T, B, H)
// in the weights' type, the argmax step tstar (B, O), and on request the
// spike counts (B, H).  A warp holds 32 consecutive units of one row, so
// each residual store of a warp is one contiguous segment.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused.py:_fused_fwd_kernel
// (head=True; pl.pallas_call in _fused_fwd_call): store_traces=False is the
// inference primal of fused_encode_{rec,ff}_scan_head, store_traces=True
// the training forward of those and of their _counts variants.
//
// A third kernel from the same template, fused_layer0_fwd (HEAD = false):
// the first layer of a deeper network, the same arithmetic with the readout
// compiled out, so its spikes are bitwise the spikes inside the head.  It
// writes the spike trace z (T, B, H) in the weights' type and, for training,
// the residual of the TPU kernel's head=False mode: delta for ALIF with the
// FastSigmoid surrogate, the membrane v otherwise (and a for ALIF with Phi).
// It replaces that mode of the same TPU kernel (fused_encode_{rec,ff}_scan).
//
// What bounds it on an H100: neither bytes nor peak FLOPs.  The inputs are
// ~13 MB (latencies) and the dense work ~97 GFLOP at B=4096, T=100,
// 784-128-10, but every step of the scan depends on the previous one, so the
// kernel is bound by the latency of the serial T-chain.  The design keeps
// that chain short and on chip:
//   * spikes are 0/1, so every product with them is a sum of selected weight
//     rows: the input current is a sum over the features that fire at step t
//     (compacted in ascending f by one warp per row with a ballot), the
//     recurrent current and the readout sums over the hidden units that
//     spiked, found from a bitmask of z;
//   * the block's latencies (as int16), W_rec and W_out sit in shared
//     memory, W_in (400 KB in f32) in L2;
//   * the readout of step t-1 runs on other warps while step t's spike list
//     is compacted, so each step costs two block barriers;
//   * under periodic encoding a feature of period 1 fires at every step
//     t >= 1 (at the production tau that is every supra-threshold pixel), so
//     the sum of those features' weight rows is taken once per row and the
//     per-step lists hold the other features only.
// All sums are f32 in a fixed order (ascending index); the file is built
// with --fmad=false so a*b+c rounds twice, as in the plain PyTorch version.
// Layout: one block = `rows` batch rows x HP threads (HP = H rounded up to a
// warp multiple); thread (h, r) owns hidden unit h of row r, and each warp
// holds 32 consecutive units of one row.

#include "head_common.cuh"

namespace {

struct Layout {
  size_t wrec, wout, b, zm, vr, m, cnt, lat, list, ts, total;
};

// Shared-memory layout of one block; the host uses it to size the launch.
__host__ __device__ inline Layout layout(int F, int H, int O, int rows,
                                         int HP, int rec, int wsize) {
  Layout L;
  size_t off = 0;
  L.wrec = off;
  off = align16(off + (rec ? (size_t)H * H * wsize : 0));
  L.wout = off;
  off = align16(off + (size_t)H * O * wsize);
  L.b = off;
  off = align16(off + (size_t)O * 4);
  L.zm = off;  // two buffers of z bitmasks, (rows, HP / 32) words each
  off = align16(off + (size_t)2 * rows * (HP / 32) * 4);
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

struct Args {
  const int* lat;
  const void* w_in;
  const void* w_rec;
  const float* beta;
  const void* w_out;
  const float* b_out;
  float* logits;
  // Training outputs, each optional (null: not written).
  void* delta;    // (T, B, H) weights' type
  void* a_tr;     // (T, B, H) weights' type, ALIF only
  int* tstar;     // (B, O)
  float* counts;  // (B, H)
  int B, F, H, O, T, periodic;
  float alpha, rho, threshold, kappa;
  // Layer-0 mode (HEAD = false): the spike trace, always written, and
  // whether `delta` keeps v instead of v - thr.
  void* z;  // (T, B, H) weights' type
  int res_is_v;
};

// One warp writes the features f of a row whose latency passes `pick` to
// `lst`, in ascending f, and returns how many (the same on every lane).  A
// row past the batch (`live` false) lists nothing.
template <typename Pick>
__device__ __forceinline__ int compact(const int16_t* lrow, uint16_t* lst,
                                       int F, int lane, bool live,
                                       Pick pick) {
  int n = 0;
  if (live) {
    for (int f0 = 0; f0 < F; f0 += 32) {
      const int f = f0 + lane;
      const bool fire = f < F && pick(lrow[f]);
      const unsigned bal = __ballot_sync(0xffffffffu, fire);
      if (fire) lst[n + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)f;
      n += __popc(bal);
    }
  }
  return n;
}

template <bool REC, bool ALIF, bool TRAIN, bool HEAD, typename W>
__global__ void __launch_bounds__(1024)
    fused_head_fwd_kernel(Args a, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = blockDim.x, HW = HP >> 5;
  const int H = a.H, O = HEAD ? a.O : 0, F = a.F, T = a.T;
  const Layout L = layout(F, H, O, rows, HP, REC, sizeof(W));
  W* s_wrec = reinterpret_cast<W*>(smem + L.wrec);
  W* s_wout = reinterpret_cast<W*>(smem + L.wout);
  float* s_b = reinterpret_cast<float*>(smem + L.b);
  unsigned* s_zm = reinterpret_cast<unsigned*>(smem + L.zm);
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
  const W* w_in = static_cast<const W*>(a.w_in);

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
  // Clamping to [-1, T] keeps every spike time of both encodings (the
  // host requires T <= 32767).
  for (int i = tid; i < rows * F; i += nthreads) {
    const int b = row0 + i / F;
    const int L0 = b < a.B ? a.lat[(size_t)row0 * F + i] : -1;
    s_lat[i] = (int16_t)min(max(L0, -1), T);
  }
  const float beta = ALIF ? *a.beta : 0.f;
  const bool mine = (row0 + r < a.B) && (h < H);
  float v = 0.f, ad = 0.f, n_spikes = 0.f;
  __syncthreads();

  // Periodic encoding: the features of period 1 (latency <= 1; the clamp
  // to [1, T-1] needs T >= 2) fire at every t >= 1.  Their weight rows are
  // summed once, in ascending f, and added first at each of those steps.
  const int periodic = a.periodic;
  const bool every_step = periodic && T >= 2;
  float cin_every = 0.f;
  if (every_step) {
    if (warp < rows) {
      const int n = compact(s_lat + warp * F, s_list + warp * F, F, lane,
                            row0 + warp < a.B, [](int L) { return L <= 1; });
      if (lane == 0) s_cnt[warp] = n;
    }
    __syncthreads();
    if (mine) {
      const int n = s_cnt[r];
      const uint16_t* lst = s_list + r * F;
#pragma unroll 4
      for (int k = 0; k < n; ++k)
        cin_every += to_f32(w_in[(size_t)lst[k] * H + h]);
    }
    __syncthreads();
  }

  // z_t lives in mask buffer (t + 1) & 1; z_{-1} = 0 in buffer 0.
  for (int t = 0; t <= T; ++t) {
    const unsigned* z_prev = s_zm + (t & 1) * rows * HW;
    // Readout of step t-1 (its z is z_prev), on the warp after the rows'
    // compaction warps, so it overlaps the compaction below.
    if (HEAD && t > 0) {
      for (int rr = 0; rr < rows; ++rr) {
        if ((rows + rr) % nwarps != warp || row0 + rr >= a.B) continue;
        readout_row<TRAIN, W>(O, a.kappa, s_wout, s_b, z_prev + rr * HW, HW,
                              s_vr + rr * O, s_m + rr * O, s_ts + rr * O,
                              t - 1, lane);
      }
    }
    if (t == T) break;
    // Features firing at step t (but those of every step), ascending, one
    // warp per row.
    if (warp < rows) {
      const int n = compact(
          s_lat + warp * F, s_list + warp * F, F, lane, row0 + warp < a.B,
          [t, T, periodic, every_step](int L) {
            return fires(L, t, T, periodic) && !(every_step && L <= 1);
          });
      if (lane == 0) s_cnt[warp] = n;
    }
    __syncthreads();
    bool z_new = false;
    if (mine) {
      float cin = t >= 1 ? cin_every : 0.f;
      const int n = s_cnt[r];
      const uint16_t* lst = s_list + r * F;
#pragma unroll 4
      for (int k = 0; k < n; ++k) cin += to_f32(w_in[(size_t)lst[k] * H + h]);
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
        // Rounded to the weights' type once, here; the head's backward
        // recomputes z = (delta >= 0) from the stored value (the sign
        // survives).
        const float keep = (!HEAD && a.res_is_v) ? v : delta;
        if (a.delta) from_f32(keep, static_cast<W*>(a.delta) + at);
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
  if (TRAIN && a.counts && mine)
    a.counts[(size_t)(row0 + r) * H + h] = n_spikes;
}

template <bool REC, bool ALIF, bool TRAIN, bool HEAD, typename W>
cudaError_t launch(const Args& a, int rows, int HP, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_head_fwd_kernel<REC, ALIF, TRAIN, HEAD, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 block(HP, rows);
  dim3 grid((a.B + rows - 1) / rows);
  fused_head_fwd_kernel<REC, ALIF, TRAIN, HEAD, W>
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
int run(Args a, int alif, int bf16, int rows, int device, void* stream) {
  if (a.B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int HP = (a.H + 31) / 32 * 32;
  const int rec = a.w_rec != nullptr;
  const size_t smem =
      layout(a.F, a.H, HEAD ? a.O : 0, rows, HP, rec, bf16 ? 2 : 4).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? dispatch<TRAIN, HEAD, __nv_bfloat16>(a, rec, alif, rows, HP,
                                                    smem, s)
             : dispatch<TRAIN, HEAD, float>(a, rec, alif, rows, HP, smem, s);
  return (int)err;
}

// Rows per block and shared-memory bytes for a shape on `device` (O == 0:
// the layer-0 mode).  0 when it fits, 1 when not, or a CUDA error code.
int plan(int F, int H, int O, int rec, int bf16, int device, int* rows_out,
         int* smem_out) {
  int max_smem = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32;
  if (H < 1 || O < 0 || F < 1 || F > 65535 || HP > 1024) return 1;
  const int wsize = bf16 ? 2 : 4;
  // Up to 512 threads a block; fewer rows where shared memory is short.
  for (int rows = 512 / HP > 0 ? 512 / HP : 1; rows >= 1; rows /= 2) {
    const size_t smem = layout(F, H, O, rows, HP, rec, wsize).total;
    if (smem <= (size_t)max_smem) {
      *rows_out = rows;
      *smem_out = (int)smem;
      return 0;
    }
  }
  return 1;
}

}  // namespace

extern "C" {

// Rows per block and shared-memory bytes for a shape on `device`.
// Returns 0 when the shape fits, 1 when it does not, or a CUDA error code.
int snn_fused_head_plan(int F, int H, int O, int rec, int bf16, int device,
                        int* rows_out, int* smem_out) {
  if (O < 1) return 1;
  return plan(F, H, O, rec, bf16, device, rows_out, smem_out);
}

int snn_fused_layer0_plan(int F, int H, int rec, int bf16, int device,
                          int* rows_out, int* smem_out) {
  return plan(F, H, 0, rec, bf16, device, rows_out, smem_out);
}

int snn_fused_head_fwd(const int* lat, const void* w_in, const void* w_rec,
                       const float* beta, const void* w_out,
                       const float* b_out, float* logits, int B, int F, int H,
                       int O, int T, int periodic, int alif, int bf16,
                       float alpha, float rho, float threshold, float kappa,
                       int rows, int device, void* stream) {
  Args a{lat, w_in, w_rec, beta, w_out, b_out, logits, nullptr, nullptr,
         nullptr, nullptr, B, F, H, O, T, periodic, alpha, rho, threshold,
         kappa, nullptr, 0};
  return run<false, true>(a, alif, bf16, rows, device, stream);
}

// The training forward: also writes delta, a_tr, tstar and counts, each
// where its pointer is not null.
int snn_fused_head_fwd_train(const int* lat, const void* w_in,
                             const void* w_rec, const float* beta,
                             const void* w_out, const float* b_out,
                             float* logits, void* delta, void* a_tr,
                             int* tstar, float* counts, int B, int F, int H,
                             int O, int T, int periodic, int alif, int bf16,
                             float alpha, float rho, float threshold,
                             float kappa, int rows, int device,
                             void* stream) {
  Args a{lat, w_in, w_rec, beta, w_out, b_out, logits, delta, a_tr, tstar,
         counts, B, F, H, O, T, periodic, alpha, rho, threshold, kappa,
         nullptr, 0};
  return run<true, true>(a, alif, bf16, rows, device, stream);
}

// The first layer of a deeper network: writes z (T, B, H) and, where `res`
// is not null (training), the residual `res` (v where res_is_v, else
// v - thr) and `a_tr` where that is not null.
int snn_fused_layer0_fwd(const int* lat, const void* w_in, const void* w_rec,
                         const float* beta, void* z, void* res, void* a_tr,
                         int B, int F, int H, int T, int periodic, int alif,
                         int bf16, int res_is_v, float alpha, float rho,
                         float threshold, int rows, int device,
                         void* stream) {
  Args a{lat, w_in, w_rec, beta, nullptr, nullptr, nullptr, res, a_tr,
         nullptr, nullptr, B, F, H, 0, T, periodic, alpha, rho, threshold,
         0.f, z, res_is_v};
  return res ? run<true, false>(a, alif, bf16, rows, device, stream)
             : run<false, false>(a, alif, bf16, rows, device, stream);
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
