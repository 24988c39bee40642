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
// serial T-chain, as the whole-network head is (fused_head.cu).
//
// Two bodies, chosen by shape (snn_fused_mid_body; ops/fused_mid.py:
// mid_bodies names it).  The tensor-core body (mid_mma_kernel, below: the
// head's tensor-core body of head_mma.cuh with z_in's bit masks as the
// input product's A operand, that product off the serial chain) takes
// O <= 16, H <= 256, Hin up to about 1.5 H (the input values a thread
// stages, MID_NL) and the weights' bf16 pieces within a block's shared
// memory (W_in's from L2 where only they do not fit).  The per-unit body (fused_mid_fwd_kernel) takes the other shapes
// its plan accepts.  The per-unit design is the head's with another source
// of input current:
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
#include "head_mma.cuh"
#include "lif_cell.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core body (mid_mma_kernel)
//
// A warp owns 16 rows x 32 units in the accumulator layout of
// head_mma.cuh, the tile's HP / 32 warps all units of its 16 rows; the
// cell is lif_cell.cuh's LifMmaCell step.  Every product is a k16-sliced
// mma.m16n8k16 whose slice goes to fresh float32 accumulators added in
// float32 (head_mma.cuh:mma_exact): the recurrent current and the readout
// on z(t-1) from the tile's exchange buffer, as in the head, and the input
// current z_in(t) @ W_in, whose A fragments come from z_in's bit masks.
// The input product is off the serial chain: z_in does not depend on it,
// so its values are loaded three steps ahead into registers, turned into
// the tile's (16, NW) mask words two steps ahead (one ballot a word, two
// buffers), and step t + 1's product is issued at step t after the cell,
// where its latency overlaps the barrier and the next step's recurrent
// product.  One named barrier a step among the tile's warps.
// Shared memory: W_rec's and W_out's bf16 pieces, and W_in's where they fit
// beside them (the deep net's 128 -> 128 in float32: 96 + 96 KB + the
// tiles' buffers); else W_in's fragments are built once a launch into
// device memory (frag_kernel) and read from L2.
constexpr int MID_NL = 24;  // input values a thread stages a step, at most

__host__ __device__ inline int spike_words(int K) { return (K + 31) >> 5; }
__host__ __device__ inline int k16(int K) { return (K + 15) & ~15; }

struct MidMmaLayout {
  size_t win, wrec, wout, b, z, m, total;
};

__host__ __device__ inline MidMmaLayout mid_mma_layout(int Hin, int H, int O,
                                                       int rec, int P,
                                                       int tpb, int win) {
  const int HP = mma_hp(H);
  MidMmaLayout L;
  size_t off = 0;
  L.win = off;  // W_in's B fragments, (k16(Hin), HP), where in shared memory
  off = align16(off + (win ? frag_bytes(k16(Hin), HP, P) : 0));
  L.wrec = off;  // W_rec's, (HP, HP)
  off = align16(off + (rec ? frag_bytes(HP, HP, P) : 0));
  L.wout = off;  // W_out's, (HP, 16), head mode
  off = align16(off + (O ? frag_bytes(HP, MMA_OMAX, P) : 0));
  L.b = off;
  off = align16(off + MMA_OMAX * 4);
  L.z = off;  // each tile's two (16, HP) bf16 buffers of z
  off = align16(off + (size_t)tpb * 2 * 16 * mma_zs(HP) * 2);
  L.m = off;  // each tile's two (16, NW) buffers of z_in's mask words
  off = align16(off + (size_t)tpb * 2 * 16 * spike_words(Hin) * 4);
  L.total = off;
  return L;
}

// Whether the mma body takes the shape (O == 0: the z-emitting mode); *win
// = 1 where W_in's pieces fit shared memory beside the rest, 0: from L2.
inline bool mid_mma_fits(int Hin, int H, int O, int rec, int bf16,
                         int max_smem, int* win) {
  const int P = bf16 ? 1 : 3, NWU = mma_hp(H) / 32;
  if (O < 0 || O > MMA_OMAX || H < 1 || Hin < 1 || mma_hp(H) > MMA_HMAX ||
      (16 * spike_words(Hin) + NWU - 1) / NWU > MID_NL)
    return false;
  for (int w = 1; w >= 0; --w) {
    if (mid_mma_layout(Hin, H, O, rec, P, 1, w).total <= (size_t)max_smem) {
      *win = w;
      return true;
    }
  }
  return false;
}

// A bf16x2 word of two 0/1 spikes from mask bits 0 and 1 of x.
__device__ __forceinline__ uint32_t bit_pair(uint32_t x) {
  return (x & 1u ? 0x3f80u : 0u) | (x & 2u ? 0x3f800000u : 0u);
}

// acc = m @ W for a tile's (16, K) 0/1 operand given as mask words m (16
// rows of nw words): KT k16 slices, each slice's product to fresh
// accumulators added in float32 (mma_exact); W's B fragments (NT8 n8
// tiles a k16 row), the warp's n8 tiles MMA_NT wu ...
template <int P>
__device__ __forceinline__ void mask_product(float (&acc)[MMA_NT][4],
                                             const uint32_t* m, int nw,
                                             int KT, const uint2* frags,
                                             int NT8, int wu, int lane) {
  const int g = lane >> 2;
  for (int kk = 0; kk < KT; ++kk) {
    const int sh = 16 * (kk & 1) + 2 * (lane & 3);
    const uint32_t m0 = m[g * nw + (kk >> 1)] >> sh;
    const uint32_t m1 = m[(g + 8) * nw + (kk >> 1)] >> sh;
    const uint32_t A[4] = {bit_pair(m0), bit_pair(m1), bit_pair(m0 >> 8),
                           bit_pair(m1 >> 8)};
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
      mma_exact_a<P>(acc[n], A, frags, kk * NT8 + MMA_NT * wu + n, lane);
  }
}

template <bool REC, bool ALIF, bool TRAIN, bool HEAD, typename W>
__global__ void __launch_bounds__(MMA_THREADS)
    mid_mma_kernel(Args a, const uint2* g_win, int tpb) {
  constexpr int P = pieces<W>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, Hin = a.Hin, O = HEAD ? a.O : 0, T = a.T, B = a.B;
  const int HP = mma_hp(H), NWU = HP / 32, KT = HP / 16, ZS = mma_zs(HP);
  const int KI = k16(Hin) / 16, NW = spike_words(Hin);
  const int NL = (16 * NW + NWU - 1) / NWU;
  const MidMmaLayout L =
      mid_mma_layout(Hin, H, O, REC, P, tpb, g_win == nullptr);
  uint2* s_win = reinterpret_cast<uint2*>(smem + L.win);
  uint2* s_wrec = reinterpret_cast<uint2*>(smem + L.wrec);
  uint2* s_wout = reinterpret_cast<uint2*>(smem + L.wout);
  float* s_b = reinterpret_cast<float*>(smem + L.b);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int tile = warp / NWU, wu = warp % NWU;
  uint16_t* s_z =
      reinterpret_cast<uint16_t*>(smem + L.z) + (size_t)tile * 2 * 16 * ZS;
  uint32_t* s_m =
      reinterpret_cast<uint32_t*>(smem + L.m) + (size_t)tile * 2 * 16 * NW;

  if (!g_win) {
    const W* w = static_cast<const W*>(a.w_in);
    fill_b<P>(s_win, 16 * KI, HP, [&](int k, int n) {
      return k < Hin && n < H ? to_f32(w[(size_t)k * H + n]) : 0.f;
    }, tid, nthreads);
  }
  if (REC) {
    const W* w = static_cast<const W*>(a.w_rec);
    fill_b<P>(s_wrec, HP, HP, [&](int k, int n) {
      return k < H && n < H ? to_f32(w[(size_t)k * H + n]) : 0.f;
    }, tid, nthreads);
  }
  if (HEAD) {
    const W* w = static_cast<const W*>(a.w_out);
    fill_b<P>(s_wout, HP, MMA_OMAX, [&](int k, int n) {
      return k < H && n < O ? to_f32(w[(size_t)k * O + n]) : 0.f;
    }, tid, nthreads);
    if (tid < MMA_OMAX) s_b[tid] = tid < O ? a.b_out[tid] : 0.f;
  }
  __syncthreads();
  const int row0 = (blockIdx.x * tpb + tile) * 16;
  if (row0 >= B) return;  // a tile past the batch; no block barrier below
  const uint2* win = g_win ? g_win : s_win;

  // The tile's input spikes: the thread's values are words k NWU + wu of
  // the tile's (16, NW) mask words, lane the bit (column 32 wi + lane of
  // row word / NW), k < NL; at[k] its offset in a step's (B, Hin) slab, or
  // NONE past the batch or the row (the host keeps B Hin below 2^32).
  constexpr unsigned NONE = 0xffffffffu;
  const W* z_in = static_cast<const W*>(a.z_in);
  const size_t slab = (size_t)B * Hin;
  unsigned at[MID_NL];
#pragma unroll
  for (int k = 0; k < MID_NL; ++k) {
    const int word = k * NWU + wu, r = word / NW;
    const int col = (word - r * NW) * 32 + lane;
    at[k] = k < NL && word < 16 * NW && row0 + r < B && col < Hin
                ? (unsigned)(row0 + r) * (unsigned)Hin + (unsigned)col
                : NONE;
  }
  W pre[MID_NL];
  auto load = [&](int t) {
#pragma unroll
    for (int k = 0; k < MID_NL; ++k)
      if (k < NL) pre[k] = at[k] != NONE ? z_in[t * slab + at[k]] : W(0.f);
  };
  auto stage = [&](uint32_t* m) {
#pragma unroll
    for (int k = 0; k < MID_NL; ++k) {
      if (k >= NL) break;
      const int word = k * NWU + wu;
      const unsigned bits = __ballot_sync(0xffffffffu, to_f32(pre[k]) != 0.f);
      if (lane == 0 && word < 16 * NW) m[word] = bits;
    }
  };
  const int tsync = 1 + tile, tn = NWU * 32;
  load(0);
  stage(s_m);
  if (T > 1) {
    load(1);
    stage(s_m + 16 * NW);
  }
  if (T > 2) load(2);
  tile_sync(tsync, tn);
  float cin[MMA_NT][4] = {};
  mask_product<P>(cin, s_m, NW, KI, win, HP / 8, wu, lane);
  tile_sync(tsync, tn);  // mask buffer 0 is rewritten at step 0

  const int col0 = MMA_NU * wu + 2 * (lane & 3);  // entry 0 of n8 tile 0
  const bool live[2] = {row0 + g < B, row0 + g + 8 < B};
  MmaReadout ro(wu, NWU, O);
  const LifParams lp{a.beta, a.alpha, a.rho, a.threshold,
                     nullptr, nullptr, nullptr, 0};
  const LifMmaCell<ALIF> cell(lp);
  typename LifMmaCell<ALIF>::State st[MMA_NT][4];
#pragma unroll
  for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = cell.start(lp);
  uint32_t cnt[MMA_NT][2] = {};  // spike counts, 16 bits an entry
  uint32_t zb = 0;               // z(t-1), bit 4 n + e

  for (int t = 0; t <= T; ++t) {
    float rec[MMA_NT][4] = {};
    if (t > 0 && (REC || HEAD)) {
      // z(t-1) as A: the readout of step t-1 and the recurrent current.
      const uint16_t* zp = s_z + ((t - 1) & 1) * 16 * ZS;
      float rp[2][4] = {};
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t A[4];
        load_a(A, zp, ZS, kk, lane);
        if (REC && t < T) {
#pragma unroll
          for (int n = 0; n < MMA_NT; ++n)
            mma_exact_a<P>(rec[n], A, s_wrec,
                           kk * (HP / 8) + MMA_NT * wu + n, lane);
        }
        ro.product<P>(rp, A, s_wout, kk, wu, NWU, lane);
      }
      ro.step<TRAIN>(rp, s_b, a.kappa, t - 1, wu, NWU, lane);
    }
    if (t == T) break;
    // The input current of step t, then the recurrent one added.
    float cur[MMA_NT][4];
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cur[n][e] = REC && t > 0 ? cin[n][e] + rec[n][e] : cin[n][e];
    // The cell step of the warp's 16 x 32 (row, unit) pairs.
    uint32_t zn = 0;
    float zf[MMA_NT][4];
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * n + (e & 1);
        const bool ok = live[e >> 1] && col < H;
        const float zp = (zb >> (4 * n + e)) & 1u ? 1.f : 0.f;
        const bool fire = cell.step(lp, st[n][e], cur[n][e], zp);
        const bool z = ok && fire;  // padding never fires
        zn |= (uint32_t)z << (4 * n + e);
        zf[n][e] = z ? 1.f : 0.f;
        if (HEAD && TRAIN) cnt[n][e >> 1] += (uint32_t)z << (16 * (e & 1));
      }
    }
    // z (z-emitting mode) and the residuals of step t: the lane's two units
    // of its rows g (e = 0, 1) and g + 8 (e = 2, 3).
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = col0 + 8 * n;
        if (!live[hh] || c >= H) continue;
        const bool two = c + 1 < H;
        const size_t at = ((size_t)t * B + row0 + g + 8 * hh) * H + c;
        const auto& s0 = st[n][2 * hh];
        const auto& s1 = st[n][2 * hh + 1];
        auto put = [&](void* base, float x0, float x1) {
          W* p = static_cast<W*>(base) + at;
          from_f32(x0, p);
          if (two) from_f32(x1, p + 1);
        };
        if (!HEAD) put(a.z, zf[n][2 * hh], zf[n][2 * hh + 1]);
        if (TRAIN && a.res) {
          if (!HEAD && a.res_is_v)
            put(a.res, s0.v, s1.v);
          else
            put(a.res, s0.delta, s1.delta);
        }
        if (ALIF && TRAIN && a.a_tr) put(a.a_tr, s0.ad, s1.ad);
      }
    }
    zb = zn;
    if (REC || HEAD) put_slice(s_z + (t & 1) * 16 * ZS, ZS, wu, lane, zf);
    // Off the chain: step t + 1's input product, then z_in(t + 2)'s mask
    // words and z_in(t + 3)'s loads.
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cin[n][e] = 0.f;
    if (t + 1 < T)
      mask_product<P>(cin, s_m + ((t + 1) & 1) * 16 * NW, NW, KI, win, HP / 8,
                      wu, lane);
    if (t + 2 < T) {
      stage(s_m + (t & 1) * 16 * NW);
      if (t + 3 < T) load(t + 3);
    }
    tile_sync(tsync, tn);
  }
  if (HEAD)
    ro.write(a.logits, TRAIN ? a.tstar : nullptr, row0, B, O, wu, NWU, lane);
  if (HEAD && TRAIN && a.counts)
    write_counts(cnt, a.counts, row0, B, H, col0, lane);
}

template <bool REC, bool ALIF, bool TRAIN, bool HEAD, typename W>
cudaError_t launch_mid_mma(const Args& a, const uint2* g_win, int device,
                           cudaStream_t stream) {
  auto kernel = mid_mma_kernel<REC, ALIF, TRAIN, HEAD, W>;
  const int NWU = mma_hp(a.H) / 32, tiles = (a.B + 15) / 16;
  int tpb = 1;
  auto smem = [&](int t) {
    return mid_mma_layout(a.Hin, a.H, HEAD ? a.O : 0, REC, pieces<W>(), t,
                          g_win == nullptr)
        .total;
  };
  cudaError_t err = mma_tiling(kernel, tiles, 1, NWU, device, smem, &tpb);
  if (err != cudaSuccess) return err;
  kernel<<<(tiles + tpb - 1) / tpb, tpb * NWU * 32, smem(tpb), stream>>>(
      a, g_win, tpb);
  return cudaGetLastError();
}

template <bool TRAIN, bool HEAD, typename W>
cudaError_t run_mid_mma(const Args& a, int rec, int alif, uint2* g_win,
                        int device, cudaStream_t s) {
  constexpr int P = pieces<W>();
  if (g_win) {
    const cudaError_t err = launch_frags<P, W>(
        a.w_in, a.Hin, a.H, k16(a.Hin), mma_hp(a.H), g_win, s);
    if (err != cudaSuccess) return err;
  }
  if (rec && alif)
    return launch_mid_mma<true, true, TRAIN, HEAD, W>(a, g_win, device, s);
  if (rec)
    return launch_mid_mma<true, false, TRAIN, HEAD, W>(a, g_win, device, s);
  if (alif)
    return launch_mid_mma<false, true, TRAIN, HEAD, W>(a, g_win, device, s);
  return launch_mid_mma<false, false, TRAIN, HEAD, W>(a, g_win, device, s);
}

template <bool TRAIN, bool HEAD>
cudaError_t run_mid_mma_w(const Args& a, int rec, int alif, int bf16,
                          uint2* g_win, int device, cudaStream_t s) {
  return bf16 ? run_mid_mma<TRAIN, HEAD, __nv_bfloat16>(a, rec, alif, g_win,
                                                         device, s)
              : run_mid_mma<TRAIN, HEAD, float>(a, rec, alif, g_win, device,
                                                s);
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

// The body fused_mid_fwd runs a shape on: out[0] = 1 the tensor-core body
// (0: the per-unit body), out[1] the bytes of scratch a launch needs (W_in's
// fragments where they come from L2, else 0).  Returns 0, or a CUDA error
// code.
int snn_fused_mid_body(int Hin, int H, int O, int rec, int bf16, int device,
                       int* out) {
  int max_smem = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  int win = 0;
  out[0] = mid_mma_fits(Hin, H, O, rec, bf16, max_smem, &win) ? 1 : 0;
  out[1] = out[0] && !win
               ? (int)frag_bytes(k16(Hin), mma_hp(H), bf16 ? 1 : 3)
               : 0;
  return 0;
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
                      int rows, void* scratch, int device, void* stream) {
  if (B == 0) return 0;
  // The kernel keeps 32-bit offsets inside one step's (B, Hin) slab.
  if ((size_t)B * Hin >= 0xffffffffu) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int head = w_out != nullptr;
  Args a{z_in, w_in, w_rec, beta, w_out, b_out, z, res, a_tr, logits, tstar,
         counts, B, Hin, H, head ? O : 0, T, res_is_v, alpha, rho, threshold,
         kappa};
  const int rec = w_rec != nullptr;
  const int train = res != nullptr || counts != nullptr || tstar != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int body[2];
  const int rc = snn_fused_mid_body(Hin, H, a.O, rec, bf16, device, body);
  if (rc != 0) return rc;
  if (body[0]) {  // the tensor-core body
    if ((body[1] != 0) != (scratch != nullptr))
      return (int)cudaErrorInvalidValue;
    uint2* g_win = static_cast<uint2*>(scratch);
    if (head)
      err = train ? run_mid_mma_w<true, true>(a, rec, alif, bf16, g_win,
                                              device, s)
                  : run_mid_mma_w<false, true>(a, rec, alif, bf16, g_win,
                                               device, s);
    else
      err = train ? run_mid_mma_w<true, false>(a, rec, alif, bf16, g_win,
                                               device, s)
                  : run_mid_mma_w<false, false>(a, rec, alif, bf16, g_win,
                                                device, s);
    return (int)err;
  }
  const int HP = (H + 31) / 32 * 32, HinP = (Hin + 31) / 32 * 32;
  const size_t smem =
      layout(Hin, H, a.O, rows, HP, HinP, rec, bf16 ? 2 : 4).total;
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
