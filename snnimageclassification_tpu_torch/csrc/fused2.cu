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
// Two bodies, chosen by shape (snn_fused2_body; ops/fused2.py:
// fused2_bodies names it): the tensor-core body (fused2_mma_kernel, below;
// O <= 16, the two layers' units at most 256 rounded up to 32 each, and
// the weights' bf16 pieces within a block's shared memory, W1's from L2
// where only they do not fit) and the per-unit body (fused2_fwd_kernel)
// for the other shapes its plan accepts.  The per-unit body:
//
// Same sums as the composed per-unit pair, so the same bits: layer 0's
// input current is head_fwd.cuh's (the step's features compacted in
// ascending f, the period-1 rows summed once under periodic encoding), its
// recurrent current
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

#include "head_mma_fwd.cuh"
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

// ---------------------------------------------------------------------------
// The tensor-core body (fused2_mma_kernel)
//
// A tile of 16 rows has NW0 = HP0 / 32 warps of layer 0 and NW1 = HP1 / 32
// of layer 1, each warp 16 rows x 32 units in head_mma.cuh's accumulator
// layout.  Layer 0 is the first layer of the head body
// (head_mma_fwd.cuh:mma_layer, the code fused_layer0_fwd runs, so the
// composed pair's layer 0 has its bits): the rows' sorted feature lists
// (head_sort_kernel, a launch before), the every-step run summed once, a
// dense product for a row firing at least F / 16 features at a TTFS step
// (ListInput), its recurrent product on W0r's B fragments; z0(t) goes to
// the tile's z0 exchange buffer, never to device memory.  Layer 1 is the mid body's: z0(s) @ W1 on tensor cores
// with z0(s) as the A operand from that buffer, its recurrent product and
// the readout on z1(s - 1) from the z1 buffer.  The TPU kernel's software
// pipeline (pallas_fused2.py:9-17): layer 1 runs one step behind layer 0
// on its own warps, so iteration t holds layer 0's step t and layer 1's
// step t - 1, independent chains, under one named barrier a step among the
// tile's warps; T + 2 iterations (the last only the readout of T - 1).
// Shared memory: W0r's, W1r's and W_out's bf16 pieces, and W1's where they
// fit beside them (bf16: ~100 KB at 784-128-128-10); float32 W1's pieces
// (96 KB more at 128-128, past the 227 KB of a block) are built once a
// launch into device memory (frag_kernel) and read from L2: every step's
// layer-1 product reads them, 96 KB a tile and step.  The two roles are
// separate functions, so the registers of one do not count against the
// other.
struct Mma2Layout {
  size_t w0r, w1, w1r, wout, b, z0, z1, total;
};

__host__ __device__ inline Mma2Layout mma2_layout(int H1, int H2, int rec,
                                                  int P, int tpb, int w1s) {
  const int HP0 = mma_hp(H1), HP1 = mma_hp(H2);
  Mma2Layout L;
  size_t off = 0;
  L.w0r = off;
  off = align16(off + (rec ? frag_bytes(HP0, HP0, P) : 0));
  L.w1 = off;
  off = align16(off + (w1s ? frag_bytes(HP0, HP1, P) : 0));
  L.w1r = off;
  off = align16(off + (rec ? frag_bytes(HP1, HP1, P) : 0));
  L.wout = off;
  off = align16(off + frag_bytes(HP1, MMA_OMAX, P));
  L.b = off;
  off = align16(off + MMA_OMAX * 4);
  L.z0 = off;  // each tile's two (16, HP0) bf16 buffers of z0
  off = align16(off + (size_t)tpb * 2 * 16 * mma_zs(HP0) * 2);
  L.z1 = off;  // and of z1
  off = align16(off + (size_t)tpb * 2 * 16 * mma_zs(HP1) * 2);
  L.total = off;
  return L;
}

// Whether the mma body takes the shape; *w1s = 1 where W1's pieces fit
// shared memory beside the rest, 0: from L2.
inline bool mma2_fits(int F, int H1, int H2, int O, int rec, int bf16,
                      int max_smem, int* w1s) {
  const int P = bf16 ? 1 : 3;
  if (O < 1 || O > MMA_OMAX || H1 < 1 || H2 < 1 || F < 1 || F > 65535 ||
      mma_hp(H1) + mma_hp(H2) > MMA_THREADS)
    return false;
  for (int w = 1; w >= 0; --w) {
    if (mma2_layout(H1, H2, rec, P, 1, w).total <= (size_t)max_smem) {
      *w1s = w;
      return true;
    }
  }
  return false;
}

// Layer 0's warps: steps 0 .. T-1 at iterations 0 .. T-1 (the first layer
// of head_mma_fwd.cuh:mma_layer, the code of fused_layer0_fwd's tensor-core
// body, with z0 left in the tile's exchange buffer and delta its
// residual), then the barriers of the last two iterations.
template <bool REC, bool ALIF, bool TRAIN, typename W>
__device__ void fused2_layer0(const Args2& a, const uint16_t* lists,
                              const uint2* s_w0r, uint16_t* s_z0, int row0,
                              int wu, int NW0, int lane, int tsync, int tn) {
  const FwdArgs<LifParams> l0{a.lat, a.w0, a.w0r, nullptr, nullptr, nullptr,
                              nullptr, a.cnt0, a.B, a.F, a.H1, 0, a.T,
                              a.periodic, 0.f, a.p0};
  mma_layer<LifMmaCell<ALIF>, REC, TRAIN, false, W, false>(
      l0, lists, s_w0r, nullptr, nullptr, s_z0, row0, wu, NW0, lane, tsync,
      tn);
  tile_sync(tsync, tn);
  tile_sync(tsync, tn);
}

// Layer 1's warps: iteration 0 waits, iteration t = 1 .. T steps s = t - 1
// on z0(s), iteration T + 1 only reads out z1(T - 1).
template <bool REC, bool ALIF, bool TRAIN, typename W>
__device__ void fused2_layer1(const Args2& a, const uint2* w1f,
                              const uint2* s_w1r, const uint2* s_wout,
                              const float* s_b, const uint16_t* s_z0,
                              uint16_t* s_z1, int row0, int wu, int NWU,
                              int lane, int tsync, int tn) {
  constexpr int P = pieces<W>();
  const int H = a.H2, O = a.O, T = a.T, B = a.B, g = lane >> 2;
  const int HP = mma_hp(H), KT = HP / 16, ZS = mma_zs(HP);
  const int HP0 = mma_hp(a.H1), KT0 = HP0 / 16, ZS0 = mma_zs(HP0);
  const int col0 = MMA_NU * wu + 2 * (lane & 3);
  const bool live[2] = {row0 + g < B, row0 + g + 8 < B};
  MmaReadout ro(wu, NWU, O);
  const LifMmaCell<ALIF> cell(a.p1);
  typename LifMmaCell<ALIF>::State st[MMA_NT][4];
#pragma unroll
  for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = cell.start(a.p1);
  uint32_t cnt[MMA_NT][2] = {};
  uint32_t zb = 0;
  tile_sync(tsync, tn);  // iteration 0: layer 0's step 0
  for (int s = 0; s <= T; ++s) {
    float rec[MMA_NT][4] = {};
    if (s > 0) {
      // z1(s-1) as A: the readout of step s-1 and the recurrent current.
      const uint16_t* zp = s_z1 + ((s - 1) & 1) * 16 * ZS;
      float rp[2][4] = {};
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t A[4];
        load_a(A, zp, ZS, kk, lane);
        if (REC && s < T) {
#pragma unroll
          for (int n = 0; n < MMA_NT; ++n)
            mma_exact_a<P>(rec[n], A, s_w1r, kk * (HP / 8) + MMA_NT * wu + n,
                           lane);
        }
        ro.product<P>(rp, A, s_wout, kk, wu, NWU, lane);
      }
      ro.step<TRAIN>(rp, s_b, a.kappa, s - 1, wu, NWU, lane);
    }
    if (s == T) {
      tile_sync(tsync, tn);
      break;
    }
    // z0(s) @ W1, then the recurrent current added.
    float cur[MMA_NT][4] = {};
    const uint16_t* z0 = s_z0 + (s & 1) * 16 * ZS0;
    for (int kk = 0; kk < KT0; ++kk) {
      uint32_t A[4];
      load_a(A, z0, ZS0, kk, lane);
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n)
        mma_exact_a<P>(cur[n], A, w1f, kk * (HP / 8) + MMA_NT * wu + n, lane);
    }
    if (REC && s > 0) {
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cur[n][e] = cur[n][e] + rec[n][e];
    }
    uint32_t zn = 0;
    float zf[MMA_NT][4];
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * n + (e & 1);
        const bool ok = live[e >> 1] && col < H;
        const float zp = (zb >> (4 * n + e)) & 1u ? 1.f : 0.f;
        const bool z = ok && cell.step(a.p1, st[n][e], cur[n][e], zp);
        zn |= (uint32_t)z << (4 * n + e);
        zf[n][e] = z ? 1.f : 0.f;
        if (TRAIN) cnt[n][e >> 1] += (uint32_t)z << (16 * (e & 1));
        if (TRAIN && (e & 1)) {
          const int c = col0 + 8 * n;
          if (live[e >> 1] && c < H)
            cell.template store<W>(
                a.p1, st[n][e - 1], st[n][e],
                ((size_t)s * B + row0 + g + 8 * (e >> 1)) * H + c, c + 1 < H);
        }
      }
    }
    zb = zn;
    put_slice(s_z1 + (s & 1) * 16 * ZS, ZS, wu, lane, zf);
    tile_sync(tsync, tn);
  }
  ro.write(a.logits, TRAIN ? a.tstar : nullptr, row0, B, O, wu, NWU, lane);
  if (TRAIN && a.cnt1) write_counts(cnt, a.cnt1, row0, B, H, col0, lane);
}

template <bool REC, bool ALIF, bool TRAIN, typename W>
__global__ void __launch_bounds__(MMA_THREADS)
    fused2_mma_kernel(Args2 a, const uint16_t* lists, const uint2* g_w1,
                      int tpb) {
  constexpr int P = pieces<W>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H1 = a.H1, H2 = a.H2, O = a.O;
  const int HP0 = mma_hp(H1), HP1 = mma_hp(H2);
  const int NW0 = HP0 / 32, NW1 = HP1 / 32, NWT = NW0 + NW1;
  const Mma2Layout L = mma2_layout(H1, H2, REC, P, tpb, g_w1 == nullptr);
  uint2* s_w0r = reinterpret_cast<uint2*>(smem + L.w0r);
  uint2* s_w1 = reinterpret_cast<uint2*>(smem + L.w1);
  uint2* s_w1r = reinterpret_cast<uint2*>(smem + L.w1r);
  uint2* s_wout = reinterpret_cast<uint2*>(smem + L.wout);
  float* s_b = reinterpret_cast<float*>(smem + L.b);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tile = warp / NWT, wt = warp % NWT;
  auto fill = [&](uint2* dst, const void* src, int K, int N, int KP,
                  int NP) {
    const W* w = static_cast<const W*>(src);
    fill_b<P>(dst, KP, NP, [&](int k, int n) {
      return k < K && n < N ? to_f32(w[(size_t)k * N + n]) : 0.f;
    }, tid, nthreads);
  };
  if (REC) {
    fill(s_w0r, a.w0r, H1, H1, HP0, HP0);
    fill(s_w1r, a.w1r, H2, H2, HP1, HP1);
  }
  if (!g_w1) fill(s_w1, a.w1, H1, H2, HP0, HP1);
  fill(s_wout, a.w_out, H2, O, HP1, MMA_OMAX);
  if (tid < MMA_OMAX) s_b[tid] = tid < O ? a.b_out[tid] : 0.f;
  __syncthreads();
  const int row0 = (blockIdx.x * tpb + tile) * 16;
  if (row0 >= a.B) return;  // a tile past the batch; no block barrier below
  uint16_t* s_z0 = reinterpret_cast<uint16_t*>(smem + L.z0) +
                   (size_t)tile * 2 * 16 * mma_zs(HP0);
  uint16_t* s_z1 = reinterpret_cast<uint16_t*>(smem + L.z1) +
                   (size_t)tile * 2 * 16 * mma_zs(HP1);
  const int tsync = 1 + tile, tn = NWT * 32;
  if (wt < NW0)
    fused2_layer0<REC, ALIF, TRAIN, W>(a, lists, s_w0r, s_z0, row0, wt, NW0,
                                       lane, tsync, tn);
  else
    fused2_layer1<REC, ALIF, TRAIN, W>(a, g_w1 ? g_w1 : s_w1, s_w1r, s_wout,
                                       s_b, s_z0, s_z1, row0, wt - NW0, NW1,
                                       lane, tsync, tn);
}

template <bool REC, bool ALIF, bool TRAIN, typename W>
cudaError_t launch2_mma(const Args2& a, const uint16_t* lists,
                        const uint2* g_w1, int device, cudaStream_t stream) {
  auto kernel = fused2_mma_kernel<REC, ALIF, TRAIN, W>;
  const int NWT = (mma_hp(a.H1) + mma_hp(a.H2)) / 32;
  const int tiles = (a.B + 15) / 16;
  int tpb = 1;
  auto smem = [&](int t) {
    return mma2_layout(a.H1, a.H2, REC, pieces<W>(), t, g_w1 == nullptr)
        .total;
  };
  cudaError_t err = mma_tiling(kernel, tiles, 1, NWT, device, smem, &tpb);
  if (err != cudaSuccess) return err;
  kernel<<<(tiles + tpb - 1) / tpb, tpb * NWT * 32, smem(tpb), stream>>>(
      a, lists, g_w1, tpb);
  return cudaGetLastError();
}

// The lists (head_sort_kernel), W1's fragments where they come from L2,
// then the kernel.
template <bool TRAIN, typename W>
cudaError_t run2_mma(const Args2& a, int rec, int alif, uint16_t* lists,
                     uint2* g_w1, int device, cudaStream_t s) {
  cudaError_t err =
      launch_sort(a.lat, lists, a.B, a.F, a.T, a.periodic, device, s);
  if (err == cudaSuccess && g_w1)
    err = launch_frags<pieces<W>(), W>(a.w1, a.H1, a.H2, mma_hp(a.H1),
                                       mma_hp(a.H2), g_w1, s);
  if (err != cudaSuccess) return err;
  if (rec && alif)
    return launch2_mma<true, true, TRAIN, W>(a, lists, g_w1, device, s);
  if (rec) return launch2_mma<true, false, TRAIN, W>(a, lists, g_w1, device, s);
  if (alif)
    return launch2_mma<false, true, TRAIN, W>(a, lists, g_w1, device, s);
  return launch2_mma<false, false, TRAIN, W>(a, lists, g_w1, device, s);
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

// The body fused2_fwd runs a shape on: out[0] = 1 the tensor-core body (0:
// the per-unit body), out[1] = 1 W1's pieces in shared memory (0: read
// from L2), out[2] the bytes of scratch a launch of B rows needs (the
// rows' feature lists, then W1's fragments where they come from L2).
// Returns 0, or a CUDA error code.
int snn_fused2_body(int F, int H1, int H2, int O, int rec, int bf16, int B,
                    int device, long long* out) {
  int max_smem = 0;
  const int err = max_smem_of(device, &max_smem);
  if (err != 0) return err;
  int w1s = 0;
  out[0] = mma2_fits(F, H1, H2, O, rec, bf16, max_smem, &w1s) ? 1 : 0;
  out[1] = out[0] ? w1s : 0;
  const size_t lists = align16((size_t)B * list_row_words(F) * 2);
  out[2] = !out[0] ? 0
                   : (long long)(lists + (w1s ? 0
                                              : frag_bytes(mma_hp(H1),
                                                           mma_hp(H2),
                                                           bf16 ? 1 : 3)));
  return 0;
}

// The training kernel where any of d0, tstar, cnt0, cnt1 is not null (each
// output written where its pointer is not null), else the inference kernel
// (logits only).  w0r and w1r are both given (recurrent) or both null.
// `scratch` holds snn_fused2_body's bytes where it names the tensor-core
// body (else null).
int snn_fused2_fwd(const int* lat, const void* w0, const void* w0r,
                   const float* beta0, const void* w1, const void* w1r,
                   const float* beta1, const void* w_out, const float* b_out,
                   float* logits, void* d0, void* a0, void* d1, void* a1,
                   int* tstar, float* cnt0, float* cnt1, int B, int F, int H1,
                   int H2, int O, int T, int periodic, int alif, int bf16,
                   float alpha, float rho, float threshold, float kappa,
                   int rows, void* scratch, int device, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  long long body[3];
  const int rc = snn_fused2_body(F, H1, H2, O, rec, bf16, B, device, body);
  if (rc != 0) return rc;
  if (body[0]) {  // the tensor-core body
    if ((body[2] != 0) != (scratch != nullptr))
      return (int)cudaErrorInvalidValue;
    uint16_t* lists = static_cast<uint16_t*>(scratch);
    uint2* g_w1 =
        body[1] ? nullptr
                : reinterpret_cast<uint2*>(
                      static_cast<unsigned char*>(scratch) +
                      align16((size_t)B * list_row_words(F) * 2));
    if (train)
      err = bf16 ? run2_mma<true, BF>(a, rec, alif, lists, g_w1, device, s)
                 : run2_mma<true, float>(a, rec, alif, lists, g_w1, device, s);
    else
      err = bf16 ? run2_mma<false, BF>(a, rec, alif, lists, g_w1, device, s)
                 : run2_mma<false, float>(a, rec, alif, lists, g_w1, device,
                                          s);
    return (int)err;
  }
  const size_t smem =
      layout2(F, H1, H2, O, rows, HP / 32, rec, bf16 ? 2 : 4).total;
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
