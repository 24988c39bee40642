// The whole-network forward template shared by fused_head.cu (LIF/ALIF) and
// fused_izh.cu (Izhikevich): latencies -> spike rows -> W_in -> (recurrent)
// scan of one cell -> readout kappa-integrator -> first-argmax max over time.
// It is the per-unit body: the heads run the tensor-core body of
// head_mma_fwd.cuh wherever that fits, this one past its limits and as the
// first layer of a deeper network.
//
// The cell is a policy class: its state, its step and the traces it stores
// are all that differs between the neuron families.  A Cell has
//   typename Cell::Params                  its constants and output traces;
//   Cell(const Params&)                    the state before step 0;
//   bool step(const Params&, cur, zp)      one step from the input current
//                                          and the unit's spike at t-1,
//                                          returning its spike at t;
//   store<TRAIN, HEAD, W>(Params, at, z)   the traces of (t, row, unit) at
//                                          element `at` of a (T, B, H) array
//                                          (z in the first-layer mode, the
//                                          backward's residuals in training).
// Modes: HEAD the readout runs and the logits leave the kernel (TRAIN: also
// tstar (B, O) and the spike counts (B, H) where asked); !HEAD the first
// layer of a deeper network, the same arithmetic with the readout compiled
// out, so its spikes are bitwise the spikes inside the head.  TRAIN changes
// no arithmetic, so training logits are bitwise the inference kernel's.
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
// All sums are f32 in a fixed order (ascending index); the sources are built
// with --fmad=false so a*b+c rounds twice, as in the plain PyTorch versions.
// Layout: one block = `rows` batch rows x HP threads (HP = H rounded up to a
// warp multiple); thread (h, r) owns hidden unit h of row r, and each warp
// holds 32 consecutive units of one row.
//
// Stacked replicas (an ensemble of S seeds on one batch; JAX package
// ops/pallas_fused.py, "stacked-replica grid lifting"): one launch runs S
// networks, one block per (row tile, replica).  A block offsets its
// weights, bias, outputs and traces by its replica's stride (at_replica)
// and reads the replica's beta; every replica reads the same latencies,
// which stay in the 50 MB L2 across replicas.  A single network is S = 1,
// so both share this body and its arithmetic bit for bit.  The TPU kernel
// puts the replica axis inside the tile axis so that a latency tile is
// DMA'd once per tile; here the grid's x axis walks the row tiles and y the
// replicas (row tiles fastest: tools/head_ablation.py --launch-order times
// the other order).
#pragma once

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

template <class P>
struct FwdArgs {
  const int* lat;
  const void* w_in;
  const void* w_rec;   // (H, H) masked, or null
  const void* w_out;   // (H, O) head
  const float* b_out;  // (O) head
  float* logits;       // (B, O) head
  int* tstar;          // (B, O) or null, head training
  float* counts;       // (B, H) or null, training
  int B, F, H, O, T, periodic;
  float kappa;
  P cell;
  // (T, B, H) float32: a layer's input currents where they are given
  // (izh_scan.cu on head_mma_fwd.cuh:DenseCurrent), else null.
  const float* cur = nullptr;
};

// The arguments of replica s of a stacked launch: each per-replica pointer
// moved by s of its replica's stride (the latencies are shared).
template <typename W, class P>
__device__ __forceinline__ FwdArgs<P> at_replica(FwdArgs<P> a, int s) {
  if (s == 0) return a;
  const size_t F = a.F, H = a.H, O = a.O, B = a.B;
  a.w_in = static_cast<const W*>(a.w_in) + s * F * H;
  if (a.w_rec) a.w_rec = static_cast<const W*>(a.w_rec) + s * H * H;
  if (a.w_out) a.w_out = static_cast<const W*>(a.w_out) + s * H * O;
  if (a.b_out) a.b_out += s * O;
  if (a.logits) a.logits += s * B * O;
  if (a.tstar) a.tstar += s * B * O;
  if (a.counts) a.counts += s * B * H;
  a.cell = a.cell.template at_replica<W>(s, (size_t)a.T * B * H);
  return a;
}

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

// acc plus the rows lst[0..n) of w (row stride H), column h, added one at a
// time in list order.
template <typename W>
__device__ __forceinline__ float add_rows(float acc, const uint16_t* lst,
                                          int n, const W* w, int H, int h) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) acc += to_f32(w[(size_t)lst[k] * H + h]);
  return acc;
}

// Periodic encoding: the features of period 1 (latency <= 1; the clamp to
// [1, T-1] needs T >= 2) fire at every t >= 1.  Returns the sum of their
// weight rows, in ascending f, for unit h of row r (0 where not `mine`).
// Warp w < rows lists row w's features.  Every thread of the block calls it:
// it holds two block barriers.
template <typename W>
__device__ float every_step_sum(const int16_t* s_lat, uint16_t* s_list,
                                int* s_cnt, int F, int rows, int row0, int B,
                                int warp, int lane, bool mine, int r,
                                const W* w_in, int H, int h) {
  if (warp < rows) {
    const int n = compact(s_lat + warp * F, s_list + warp * F, F, lane,
                          row0 + warp < B, [](int L) { return L <= 1; });
    if (lane == 0) s_cnt[warp] = n;
  }
  __syncthreads();
  const float sum =
      mine ? add_rows(0.f, s_list + r * F, s_cnt[r], w_in, H, h) : 0.f;
  __syncthreads();
  return sum;
}

// Warp w < rows lists the features of row w firing at step t but those of
// every step, ascending, in s_list, and their number in s_cnt[w].
__device__ __forceinline__ void list_step(const int16_t* s_lat,
                                          uint16_t* s_list, int* s_cnt,
                                          int F, int rows, int row0, int B,
                                          int warp, int lane, int t, int T,
                                          int periodic, bool every_step) {
  if (warp >= rows) return;
  const int n = compact(
      s_lat + warp * F, s_list + warp * F, F, lane, row0 + warp < B,
      [t, T, periodic, every_step](int L) {
        return fires(L, t, T, periodic) && !(every_step && L <= 1);
      });
  if (lane == 0) s_cnt[warp] = n;
}

template <class Cell, bool REC, bool TRAIN, bool HEAD, typename W>
__global__ void __launch_bounds__(1024)
    head_fwd_kernel(FwdArgs<typename Cell::Params> a0, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x;
  const FwdArgs<typename Cell::Params> a = at_replica<W>(a0, blockIdx.y);
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
  const int row0 = tile * rows;
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
  const bool mine = (row0 + r < a.B) && (h < H);
  Cell cell(a.cell);
  float n_spikes = 0.f;
  __syncthreads();

  // Periodic encoding: the weight rows of the features of every step are
  // summed once and added first at each step t >= 1.
  const int periodic = a.periodic;
  const bool every_step = periodic && T >= 2;
  const float cin_every =
      every_step ? every_step_sum(s_lat, s_list, s_cnt, F, rows, row0, a.B,
                                  warp, lane, mine, r, w_in, H, h)
                 : 0.f;

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
    list_step(s_lat, s_list, s_cnt, F, rows, row0, a.B, warp, lane, t, T,
              periodic, every_step);
    __syncthreads();
    bool z_new = false;
    if (mine) {
      const float cin = add_rows(t >= 1 ? cin_every : 0.f, s_list + r * F,
                                 s_cnt[r], w_in, H, h);
      const unsigned* zr = z_prev + r * HW;
      const float cur = REC ? cin + masked_sum(zr, HW, s_wrec + h, H) : cin;
      const float zp = (zr[h >> 5] >> (h & 31)) & 1u ? 1.f : 0.f;
      z_new = cell.step(a.cell, cur, zp);
      cell.template store<TRAIN, HEAD, W>(
          a.cell, ((size_t)t * a.B + row0 + r) * H + h, z_new);
      if (TRAIN && z_new) n_spikes += 1.f;
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

template <class Cell, bool REC, bool TRAIN, bool HEAD, typename W>
cudaError_t launch(const FwdArgs<typename Cell::Params>& a, int rows, int HP,
                   size_t smem, int S, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      head_fwd_kernel<Cell, REC, TRAIN, HEAD, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 block(HP, rows);
  const int tiles = (a.B + rows - 1) / rows;
  dim3 grid(tiles, S);
  head_fwd_kernel<Cell, REC, TRAIN, HEAD, W>
      <<<grid, block, smem, stream>>>(a, rows);
  return cudaGetLastError();
}

// One launch of the kernel of `Cell` in mode (TRAIN, HEAD) for S stacked
// replicas (S = 1: one network); recurrence where a.w_rec is not null,
// bfloat16 weights where `bf16`.
template <class Cell, bool TRAIN, bool HEAD>
int run(const FwdArgs<typename Cell::Params>& a, int bf16, int rows,
        int device, void* stream, int S = 1) {
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidConfiguration;
  if (a.B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int HP = (a.H + 31) / 32 * 32;
  const int rec = a.w_rec != nullptr;
  const size_t smem =
      layout(a.F, a.H, HEAD ? a.O : 0, rows, HP, rec, bf16 ? 2 : 4).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (bf16)
    err = rec ? launch<Cell, true, TRAIN, HEAD, BF>(a, rows, HP, smem, S, s)
              : launch<Cell, false, TRAIN, HEAD, BF>(a, rows, HP, smem, S, s);
  else
    err = rec ? launch<Cell, true, TRAIN, HEAD, float>(a, rows, HP, smem, S, s)
              : launch<Cell, false, TRAIN, HEAD, float>(a, rows, HP, smem, S, s);
  return (int)err;
}

// Rows per block and shared-memory bytes for a shape on `device` (O == 0:
// the first-layer mode).  0 when it fits, 1 when not, or a CUDA error code.
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
