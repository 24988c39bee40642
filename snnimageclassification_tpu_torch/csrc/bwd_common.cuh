// Shared by the backward kernel sources (fused_head_bwd.cu,
// fused_layer0_bwd.cu, fused_mid_bwd.cu, fused2_bwd.cu): the reverse-time
// chain and the weight-gradient functions, as templates that each source
// instantiates.
//
// For t = T-1 .. 0, per batch row (z(-1) = 0):
//   head:     s(t)  = kappa s(t+1) + g_logits [t == tstar]
//             dz(t) = s(t) @ W_out^T (+ g_counts)        z(t) = [res(t) >= 0]
//   z-layer:  dz(t) = g_z(t)                             z(t) as stored
//   fused2's layer 0: dz(t) = g_z(t) (+ g_counts)        z(t) = [res(t) >= 0]
//   dz(t)  += dcur(t+1) @ W_rec^T
//   dv(t)   = dz(t) surr(delta(t)) + alpha dcur(t+1)
//   dcur(t) = dv(t) (1 - z(t-1))
// with delta(t) = res(t), or res(t) - thr(t) where the residual is the
// membrane v.  No gradient flows through the reset, the adaptation, beta or
// the threshold.  s and dcur are rounded to the weights' type before every
// product and every sum is float32; the carried dcur in alpha * dcur stays
// float32.
//
// The chain over T is serial per row, so the work is split into __global__
// functions:
//   bwd_chain: one block = `rows` batch rows x HP threads, thread (h, r)
//     owns unit h of row r and walks t down.  W_rec^T and W_out sit in shared
//     memory, the rounded dcur of the previous step in a double buffer, one
//     block barrier a step.  It writes dcur(t), rounded to the weights' type
//     (all any product ever sees of it), to a (B, T, H) buffer in device
//     memory, and the bits of z to a (B, T + 1, H / 32) buffer, so that the
//     other functions read one contiguous slab per batch row (a per-row walk
//     over a (T, B, H) trace strides 4 MB a step).
//   bwd_gwin: g_W_in of an encoded first layer.  A feature's spike times are
//     t = L (TTFS) or t = p, 2p, .. (periodic, p the clamped latency), so per
//     row a table S[k] = dcur(k) (TTFS) or S[p] = sum_j dcur(j p) (periodic)
//     turns the product into one gathered row per (row, feature): B F H adds
//     for either encoding.  A block owns a column chunk of 32 and all F
//     features (up to 800; more take feature chunks), so each row's dcur is
//     read from device memory once: row batches stream through a TMA ring,
//     the periodic table is built once a row by all warps.
//   gbits_mma (gbits_mma.cuh): sum_t bits(t)^T dcur(t) for a 0/1 left
//     operand given as bit masks, g_W_rec (bits of z(t-1)) and a mid
//     layer's g_W_in (bits of z_in(t)), as a tensor-core product.
//   bwd_gout: g_W_out and g_b from the rows' z bits and their s chains: a
//     batch of rows a block, the (row, output) chains in parallel, then
//     z(t)^T s_r(t) as fused multiply-adds of the 0/1 z in ascending t.
//   g_z_in = dcur @ W_in^T, the cotangent of a layer's input spikes: a
//     tensor-core product (gzin_mma.cuh).
// The sums cross rows and blocks.  Blocks run in any order, so each block
// walks its rows in ascending order and writes its partial sums to a slab
// of its own; the host adds the slabs in a fixed order.  No atomics: the
// gradients are the same bits on every run.
// Built with --fmad=false (the elementwise chain rounds as the plain
// PyTorch version does); the dot products use explicit fused multiply-adds.
//
// Stacked replicas (the head of an ensemble of S seeds, fused_head_bwd.cu
// and fused_izh_bwd.cu): every function takes the replica from blockIdx.z
// (gridDim.z = S), moves its per-replica pointers by the replica's stride
// (at_replica) and writes its partial sums to the replica's own run of
// slabs, (S, blocks, ...).  S = 1 is a single network: the same body, the
// same bits.  The latencies are shared by the replicas.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <string.h>

#include "head_common.cuh"

namespace {

constexpr int NACC = 32;  // accumulators a thread of the gradient functions holds
constexpr float PHI_EPSILON = 1e-5f;

struct Args {
  const float* g_logits;  // (B, O)            head
  const int* tstar;       // (B, O)            head
  const float* g_counts;  // (B, H) or null    head
  const void* g_z;        // (T, B, H) weights' type   z-layer
  const void* z;          // (T, B, H) weights' type   z-layer
  const void* delta;      // (T, B, H) weights' type: the residual
  const void* a_tr;       // (T, B, H) weights' type; ALIF with Phi, else null
  const int* lat;         // (B, F)            encoded first layer
  const void* w_rec;      // (H, H) or null
  const void* w_out;      // (H, O)            head
  const float* beta;      // (1)
  void* dcur;             // (B, T, H) weights' type, scratch
  unsigned* zmask;        // (B, T + 1, HP / 32) scratch: row k = bits of z(k-1)
  float* slab_in;         // (n_in, F * H)
  float* slab_rec;        // (n_rec, H * H)
  float* slab_out;        // (n_out, H * O + O)
  int B, F, H, O, T, periodic, phi, res_is_v;
  float alpha, threshold, gamma, kappa;
};

// The head's arguments for replica s of a stacked launch: each per-replica
// input and scratch pointer moved by s of its replica's stride (the slabs
// are moved by each function, whose grid sets their stride).  The z-layer
// modes have no stacked launch.
template <typename W>
__device__ __forceinline__ Args at_replica(Args a, int s) {
  if (s == 0) return a;
  const size_t B = a.B, T = a.T, H = a.H, O = a.O, HW = (a.H + 31) / 32;
  if (a.g_logits) a.g_logits += s * B * O;
  if (a.tstar) a.tstar += s * B * O;
  if (a.g_counts) a.g_counts += s * B * H;
  if (a.delta) a.delta = static_cast<const W*>(a.delta) + s * T * B * H;
  if (a.a_tr) a.a_tr = static_cast<const W*>(a.a_tr) + s * T * B * H;
  if (a.w_rec) a.w_rec = static_cast<const W*>(a.w_rec) + s * H * H;
  if (a.w_out) a.w_out = static_cast<const W*>(a.w_out) + s * H * O;
  if (a.beta) a.beta += s;
  if (a.dcur) a.dcur = static_cast<W*>(a.dcur) + s * B * T * H;
  if (a.zmask) a.zmask += s * B * (T + 1) * HW;
  return a;
}

// This block's slab among the (S, gridDim.x) slabs of `n` floats each.
__device__ __forceinline__ float* block_slab(float* slabs, size_t n) {
  return slabs + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * n;
}

// d spike / d v as a function of delta = v - thr (ops/surrogate.py).
__device__ __forceinline__ float surrogate(int phi, float delta, float thr,
                                           float gamma) {
  if (!phi) {
    const float denom = gamma * fabsf(delta) + 1.f;
    return 1.f / (denom * denom);
  }
  const float te = thr + PHI_EPSILON;
  return (gamma / te) * fmaxf(1.f - fabsf(delta / te), 0.f);
}

// ---------------------------------------------------------------------------
// The serial chain
// ---------------------------------------------------------------------------
struct ChainLayout {
  size_t wrec, wout, dcr, sr, st, g, ts, total;
};

__host__ __device__ inline ChainLayout chain_layout(int H, int O, int rows,
                                                    int HP, int rec,
                                                    int wsize) {
  ChainLayout L;
  size_t off = 0;
  L.wrec = off;  // W_rec transposed: [j * H + h] = W_rec[h, j]
  off = align16(off + (rec ? (size_t)H * H * wsize : 0));
  L.wout = off;
  off = align16(off + (size_t)H * O * wsize);
  L.dcr = off;  // rounded dcur, two buffers of (rows, HP) float
  off = align16(off + (size_t)2 * rows * HP * 4);
  L.sr = off;  // rounded s, two buffers of (rows, O) float
  off = align16(off + (size_t)2 * rows * O * 4);
  L.st = off;  // s, (rows, O) float
  off = align16(off + (size_t)rows * O * 4);
  L.g = off;
  off = align16(off + (size_t)rows * O * 4);
  L.ts = off;
  off = align16(off + (size_t)rows * O * 4);
  L.total = off;
  return L;
}

// (dcur(t+1) @ W_rec^T)[h] = sum_j dp[j] wt[j * H + h], ascending j; dp is
// read four at a time (one broadcast 16-byte load), 16-byte aligned.
template <typename W>
__device__ __forceinline__ float rec_product(const float* dp, const W* wt,
                                             int H, int h) {
  float acc = 0.f;
  int j = 0;
  for (; j + 4 <= H; j += 4) {
    const float4 d = *reinterpret_cast<const float4*>(dp + j);
    acc = __fmaf_rn(d.x, to_f32(wt[j * H + h]), acc);
    acc = __fmaf_rn(d.y, to_f32(wt[(j + 1) * H + h]), acc);
    acc = __fmaf_rn(d.z, to_f32(wt[(j + 2) * H + h]), acc);
    acc = __fmaf_rn(d.w, to_f32(wt[(j + 3) * H + h]), acc);
  }
  for (; j < H; ++j) acc = __fmaf_rn(dp[j], to_f32(wt[j * H + h]), acc);
  return acc;
}

// Modes: the head (HEAD); a z-layer (!HEAD, !ZD); and the first layer of the
// two-layer kernel (fused2_bwd.cu; !HEAD, ZD): dz(t) = g_z(t) + g_counts
// with g_z read as GZ (float32 there), z(t) the sign of the residual delta.
template <bool REC, bool HEAD, typename W, bool ZD = HEAD, typename GZ = W>
__global__ void __launch_bounds__(1024) bwd_chain_kernel(Args a0, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Args a = at_replica<W>(a0, blockIdx.z);
  const int HP = blockDim.x;
  const int H = a.H, O = HEAD ? a.O : 0, T = a.T, B = a.B;
  const ChainLayout L = chain_layout(H, O, rows, HP, REC, sizeof(W));
  W* s_wrec = reinterpret_cast<W*>(smem + L.wrec);
  W* s_wout = reinterpret_cast<W*>(smem + L.wout);
  float* s_dcr = reinterpret_cast<float*>(smem + L.dcr);
  float* s_sr = reinterpret_cast<float*>(smem + L.sr);
  float* s_st = reinterpret_cast<float*>(smem + L.st);
  float* s_g = reinterpret_cast<float*>(smem + L.g);
  int* s_ts = reinterpret_cast<int*>(smem + L.ts);

  const int h = threadIdx.x, r = threadIdx.y;
  const int tid = r * HP + h, nthreads = HP * rows;
  const int row0 = blockIdx.x * rows, row = row0 + r;
  const int HW = HP >> 5;

  if (REC) {
    const W* g = static_cast<const W*>(a.w_rec);
    for (int i = tid; i < H * H; i += nthreads)
      s_wrec[(i % H) * H + i / H] = g[i];
  }
  if (HEAD) {
    const W* g = static_cast<const W*>(a.w_out);
    for (int i = tid; i < H * O; i += nthreads) s_wout[i] = g[i];
  }
  for (int i = tid; i < 2 * rows * HP; i += nthreads) s_dcr[i] = 0.f;
  if constexpr (HEAD) {
    for (int i = tid; i < rows * O; i += nthreads) {
      const bool live = row0 + i / O < B;
      s_st[i] = 0.f;
      s_g[i] = live ? a.g_logits[(size_t)row0 * O + i] : 0.f;
      s_ts[i] = live ? a.tstar[(size_t)row0 * O + i] : -1;
    }
  }
  const bool mine = row < B && h < H;
  const W* delta = static_cast<const W*>(a.delta);
  const W* a_tr = static_cast<const W*>(a.a_tr);
  const GZ* g_z = static_cast<const GZ*>(a.g_z);
  const W* z_tr = static_cast<const W*>(a.z);
  W* dcur_out = static_cast<W*>(a.dcur);
  const float beta = a_tr ? *a.beta : 0.f;
  const float gcnt = ((HEAD || ZD) && mine && a.g_counts)
                         ? a.g_counts[(size_t)row * H + h]
                         : 0.f;
  const size_t step_stride = (size_t)B * H;
  const size_t at0 = (size_t)row * H + h;
  float dcur = 0.f;  // dcur(t+1), float32
  // The residual of step t, and z(t): its sign for a head (and ZD), else
  // as stored.
  float d_t = mine ? to_f32(delta[(size_t)(T - 1) * step_stride + at0]) : 0.f;
  bool z_t = ZD ? d_t >= 0.f
                  : (mine &&
                     to_f32(z_tr[(size_t)(T - 1) * step_stride + at0]) != 0.f);
  // This warp's word of the row's z bits (a warp = 32 units of one row).
  unsigned* zrow = row < B
      ? a.zmask + (size_t)row * (T + 1) * HW + (h >> 5) : nullptr;
  if (zrow && (h & 31) == 0) zrow[0] = 0u;  // z(-1)
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const int buf = t & 1;
    // s(t), by the first O threads of each row (strided where O > HP).
    for (int o = h; HEAD && o < O; o += HP) {
      const int i = r * O + o;
      const float s =
          a.kappa * s_st[i] + s_g[i] * (s_ts[i] == t ? 1.f : 0.f);
      s_st[i] = s;
      s_sr[buf * rows * O + i] = round_w<W>(s);
    }
    // The residual of step t-1 (the next step's surrogate) and z(t-1), this
    // step's reset gate; the z-layer's cotangent of this step.
    const bool prev = mine && t > 0;
    const float d_prev =
        prev ? to_f32(delta[(size_t)(t - 1) * step_stride + at0]) : -1.f;
    const bool z_prev =
        ZD ? d_prev >= 0.f
             : (prev && to_f32(z_tr[(size_t)(t - 1) * step_stride + at0]) != 0.f);
    const float gz_t =
        (!HEAD && mine) ? to_f32(g_z[(size_t)t * step_stride + at0]) : 0.f;
    __syncthreads();
    float dcr = 0.f;
    if (mine) {
      float dz = gz_t;
      if (HEAD) {
        const float* sr = s_sr + buf * rows * O + r * O;
        for (int o = 0; o < O; ++o)
          dz = __fmaf_rn(sr[o], to_f32(s_wout[h * O + o]), dz);
        if (a.g_counts) dz = dz + gcnt;
      } else if (ZD && a.g_counts) {
        dz = dz + gcnt;
      }
      if (REC) {
        const float* dp = s_dcr + (buf ^ 1) * rows * HP + r * HP;
        dz = dz + rec_product(dp, s_wrec, H, h);
      }
      float thr = a.threshold;
      if (a_tr)
        thr = a.threshold +
              beta * to_f32(a_tr[(size_t)t * step_stride + at0]);
      const float dlt = (!HEAD && a.res_is_v) ? d_t - thr : d_t;
      const float surr = surrogate(a.phi, dlt, thr, a.gamma);
      const float dv = dz * surr + a.alpha * dcur;
      const float zp = z_prev ? 1.f : 0.f;
      dcur = dv * (1.f - zp);
      from_f32(dcur, dcur_out + ((size_t)row * T + t) * H + h);
      dcr = round_w<W>(dcur);
    }
    s_dcr[buf * rows * HP + r * HP + h] = dcr;
    const unsigned zbits = __ballot_sync(0xffffffffu, mine && z_t);
    if (zrow && (h & 31) == 0) zrow[(size_t)(t + 1) * HW] = zbits;
    d_t = d_prev;
    z_t = z_prev;
  }
}

// Row groups (grid x) so that groups * per_group blocks are resident at once.
int row_groups(int sms, int sm_smem, int smem, int threads, int per_group,
               int B) {
  int per_sm = sm_smem / (smem + 1024);  // 1 KB a block is the system's
  // 2048 threads an SM, and 65536 registers at the 64 a thread that
  // __launch_bounds__(1024) allows.
  if (per_sm > 1024 / threads) per_sm = 1024 / threads;
  if (per_sm < 1) per_sm = 1;
  int groups = sms * per_sm / per_group;
  if (groups > B) groups = B;
  return groups < 1 ? 1 : groups;
}

// The device's limits the plans need.
struct Limits {
  int max_smem, sm_smem, sms;
};

inline cudaError_t limits(int device, Limits* l) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &l->max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &l->sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l->sms, cudaDevAttrMultiProcessorCount,
                                 device);
  return err;
}

// Rows per block of the chain function (0: it does not fit) and its bytes.
inline int chain_rows(int H, int O, int HP, int G, int rec, int wsize,
                      int max_smem, int* smem_out) {
  for (int rows = G; rows >= 1; rows /= 2) {
    const size_t smem = chain_layout(H, O, rows, HP, rec, wsize).total;
    if (smem <= (size_t)max_smem) {
      *smem_out = (int)smem;
      return rows;
    }
  }
  return 0;
}

template <typename K>
cudaError_t opt_in(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// ---------------------------------------------------------------------------
// TMA, mbarriers and cp.async (bwd_gwin's ring; encode_matmul.cu's
// encode_bwd)
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~(size_t)127;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// c(p) + c(2p) + .. < T of one column (step t at col[t * ts]), p >= 1:
// eight running sums over the multiples j p, j = 1 .. 8 mod 8, added
// pairwise at the end -- a fixed order with an eighth of the dependent adds.
template <typename V>
__device__ __forceinline__ float period_sum(const V* col, int ts, int p,
                                            int T) {
  float s8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int t = p;
  for (; t + 7 * p < T; t += 8 * p) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s8[i] += to_f32(col[(t + i * p) * ts]);
  }
#pragma unroll
  for (int i = 0; i < 7; ++i)
    if (t + i * p < T) s8[i] += to_f32(col[(t + i * p) * ts]);
  return ((s8[0] + s8[1]) + (s8[2] + s8[3])) +
         ((s8[4] + s8[5]) + (s8[6] + s8[7]));
}

// ---------------------------------------------------------------------------
// g_W_in of an encoded first layer
// ---------------------------------------------------------------------------
// A feature of key k (head_common.cuh:enc_key) reads row k + 1 of its batch
// row's table: TTFS dcur itself (row t + 1 = step t), periodic S[p] (row p +
// 1); row 0 is zeros, where a feature that never fires (key 0) points.
//
// grid (row groups, feature chunks x column chunks of 32, S); thread (x, g)
// owns g_W_in[f, h0 + x] for the NACC features f = f0 + NACC g + i.  Rows
// come in batches of R; TMA loads a batch's (R, TS, 32) box of dcur (from
// step -1, a zero row) into a ring of NS stages, NS - 1 batches ahead, with
// mbarrier completion.  The next batch's latencies come by cp.async while
// the current batch is summed; each warp turns its 32 features' latencies
// into keys (and, periodic, the rows' periods into bit masks).  Periodic:
// the S table of the periods in the rows' masks is built by all warps, the
// (row, period) sums dealt in turn, each sum over T split eight ways
// (period_sum), then one block barrier.  Then one gathered add a (row,
// feature) and one block barrier a batch.  Every block walks its batches in
// ascending order and writes a slab of its own, which the host adds in a
// fixed order: no atomics on the sums.  Where TMA cannot read dcur (H *
// sizeof(W) not a multiple of 16) or no two stages fit, the threads copy
// one stage, the same layout.  The kernel takes the encoding as a template
// argument (the TTFS instance carries no table code) and at most 25 warps,
// so that a thread's 32 accumulators stay in its 80 registers (a 1024-thread
// bound left 64 and spilled, 2.4x slower).  ops/fused.py:
// _gwin_ordered_reference is the plain version in this order.
constexpr int GW_RMAX = 4;   // rows a batch, at most
constexpr int GW_GMAX = 25;  // warps a block: 800 features, 80 registers

__host__ __device__ inline int period_words(int T) { return (T + 31) / 32; }

struct GwinPlan {
  int G, n_f, n_h, R, NS, TB, nbx, TS, groups, smem;
  bool tma;
};

struct GwinRing {  // the plan's numbers a block needs
  int R, NS, TB, nbx, TS, n_f;
};

struct GwinLayout {
  size_t stage, lat, key, mask, S, bar, total;
};

// NS stages of (R, TS, 32) dcur in the weights' type; the next batch's
// latencies (R, FK) int32; keys, two buffers of (R, FK) uint16; periodic,
// masks of periods, two buffers of (R, MW) words, and the S table (R, T + 1,
// 32) float; an mbarrier a stage.
__host__ __device__ inline GwinLayout gwin_layout(int R, int NS, int TS,
                                                  int T, int FK, int wsize,
                                                  int periodic) {
  GwinLayout L;
  L.stage = align128((size_t)R * TS * 32 * wsize);
  size_t off = (size_t)NS * L.stage;
  L.lat = off;
  off = align16(off + (size_t)R * FK * 4);
  L.key = off;
  off = align16(off + (size_t)2 * R * FK * 2);
  L.mask = off;
  off = align16(off + (periodic ? (size_t)2 * R * period_words(T) * 4 : 0));
  L.S = off;
  off = align16(off + (periodic ? (size_t)R * (T + 1) * 128 : 0));
  L.bar = off;
  L.total = align16(off + (size_t)NS * 8);
  return L;
}

// Thread 0: batch qb of this block's replica into stage `st`, one TMA box
// (32 columns, TB steps, 1 row) a row and step block, completing on `bar`.
// Rows past the last replica's, steps outside [0, T) and columns past H
// read zeros.
template <typename W>
__device__ __forceinline__ void gwin_issue(const CUtensorMap* map,
                                           unsigned char* st, uint64_t* bar,
                                           const GwinRing& q, int row0,
                                           int h0) {
  mbar_expect(bar, (uint32_t)(q.R * q.nbx * q.TB * 32 * sizeof(W)));
  for (int r = 0; r < q.R; ++r)
    for (int i = 0; i < q.nbx; ++i)
      tma_3d(st + ((size_t)r * q.TS + i * q.TB) * 32 * sizeof(W), map, bar,
             h0, i * q.TB - 1, row0 + r);
}

// acc[i] += tab[k_i * 32] for the NACC keys k_i at kq (16 bits each), key 0
// the zero row.  The loads are unconditional, so all NACC are in flight at
// once (skipping key 0, or a repeated key, behind a branch made the
// gathers slower: the loads wait on each other).
template <typename V>
__device__ __forceinline__ void gather_keys(float (&acc)[NACC],
                                            const uint4* kq, const V* tab) {
#pragma unroll
  for (int c = 0; c < NACC / 8; ++c) {
    const uint4 kk = kq[c];
    const unsigned u[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = (u[j >> 1] >> (16 * (j & 1))) & 0xffff;
      acc[c * 8 + j] += to_f32(tab[k * 32]);
    }
  }
}

template <typename W, bool TMA, bool PERIODIC>
__global__ void __launch_bounds__(32 * GW_GMAX)
    bwd_gwin_kernel(const __grid_constant__ CUtensorMap dmap, Args a0,
                    GwinRing q) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Args a = at_replica<W>(a0, blockIdx.z);
  const int G = blockDim.y, x = threadIdx.x, gy = threadIdx.y;
  const int tid = gy * 32 + x, FK = 32 * G;  // FK = G NACC features
  const int f0 = (blockIdx.y % q.n_f) * FK, h0 = (blockIdx.y / q.n_f) * 32;
  const int R = q.R, NS = q.NS, TS = q.TS;
  const int T = a.T, B = a.B, F = a.F, H = a.H;
  const int MW = period_words(T);
  const GwinLayout L = gwin_layout(R, NS, TS, T, FK, sizeof(W), PERIODIC);
  int* s_lat = reinterpret_cast<int*>(smem + L.lat);
  uint16_t* s_key = reinterpret_cast<uint16_t*>(smem + L.key);
  unsigned* s_mask = reinterpret_cast<unsigned*>(smem + L.mask);
  float* s_S = reinterpret_cast<float*>(smem + L.S);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int nb = (B + R - 1) / R;
  const int fl = gy * 32 + x;  // the feature whose key this thread makes
  const int* lat = a.lat + f0 + fl;

  // The latencies of batch qb by cp.async (this thread's feature), and
  // their keys into buffer kb, with the rows' periods.
  auto fetch_lat = [&](int qb) {
    for (int r = 0; r < R; ++r) {
      const int b = qb * R + r;
      if (b < B && f0 + fl < F) cp_async4(s_lat + r * FK + fl, lat + (size_t)b * F);
    }
  };
  auto make_keys = [&](int kb, int qb) {
    cp_async_wait_all();
    for (int r = 0; r < R; ++r) {
      const int b = qb * R + r;
      const int k = (b < B && f0 + fl < F)
                        ? enc_key(s_lat[r * FK + fl], T, PERIODIC) + 1
                        : 0;
      s_key[(kb * R + r) * FK + fl] = (uint16_t)k;
      if (PERIODIC) {
        const unsigned peers = __match_any_sync(0xffffffffu, k);
        if (k > 0 && x == __ffs(peers) - 1)
          atomicOr(&s_mask[(kb * R + r) * MW + ((k - 1) >> 5)],
                   1u << ((k - 1) & 31));
      }
    }
  };

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  if (PERIODIC) {
    for (int i = tid; i < R * 32; i += FK)
      s_S[(i >> 5) * (T + 1) * 32 + (i & 31)] = 0.f;  // row 0 of each row
    for (int i = tid; i < 2 * R * MW; i += FK) s_mask[i] = 0u;
  }
  if (TMA && tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(s_full + s);
    mbar_fence_init();
  }
  __syncthreads();
  const int row0 = blockIdx.z * B;  // this replica's first row in the map
  if (TMA && tid == 0)
    for (int s = 0; s < NS; ++s) {
      const int qb = blockIdx.x + s * gridDim.x;
      if (qb < nb)
        gwin_issue<W>(&dmap, smem + s * L.stage, s_full + s, q,
                      row0 + qb * R, h0);
    }
  if ((int)blockIdx.x < nb) {
    fetch_lat(blockIdx.x);
    make_keys(0, blockIdx.x);
  }
  __syncthreads();

  for (int qb = blockIdx.x, j = 0; qb < nb; qb += gridDim.x, ++j) {
    const int s = j % NS, kb = j & 1, qn = qb + gridDim.x;
    unsigned char* st = smem + s * L.stage;
    const W* sd = reinterpret_cast<const W*>(st);
    if (qn < nb) fetch_lat(qn);
    if (TMA) {
      mbar_wait(s_full + s, (j / NS) & 1);
    } else {
      W* dst = reinterpret_cast<W*>(st);
      const W* dcur = static_cast<const W*>(a.dcur);
      for (int i = tid; i < R * TS * 32; i += FK) {
        const int r = i / (TS * 32), t = (i >> 5) % TS - 1, h = h0 + (i & 31);
        const int b = qb * R + r;
        const bool ok = t >= 0 && t < T && b < B && h < H;
        from_f32(ok ? to_f32(dcur[((size_t)b * T + t) * H + h]) : 0.f,
                 dst + i);
      }
      __syncthreads();
    }
    if (PERIODIC) {
      // S[p] of each row of the batch for the periods in its mask, the
      // (row, period) sums dealt to the warps in turn.
      const unsigned* mask = s_mask + kb * R * MW;
      int turn = 0;
      for (int r = 0; r < R; ++r)
        for (int wd = 0; wd < MW; ++wd) {
          unsigned bits = mask[r * MW + wd];
          while (bits) {
            const int p = (wd << 5) + __ffs(bits) - 1;
            bits &= bits - 1u;
            const bool mine = turn == gy;
            if (++turn == G) turn = 0;
            if (!mine) continue;
            const W* col = sd + ((size_t)r * TS + 1) * 32 + x;  // step 0
            s_S[((size_t)r * (T + 1) + p + 1) * 32 + x] =
                p == 0 ? to_f32(col[0]) : period_sum(col, 32, p, T);
          }
        }
      __syncthreads();
    }
    // One gathered table entry a (row, feature); key 0 reads the zero row.
    for (int r = 0; r < R; ++r) {
      const uint4* kq = reinterpret_cast<const uint4*>(
          s_key + (kb * R + r) * FK + gy * NACC);
      const float* srow = s_S + (size_t)r * (T + 1) * 32 + x;
      const W* drow = sd + (size_t)r * TS * 32 + x;
      if (PERIODIC)
        gather_keys(acc, kq, srow);
      else
        gather_keys(acc, kq, drow);
    }
    if (qn < nb) make_keys(kb ^ 1, qn);
    __syncthreads();  // the stage, the S table and key buffer kb are free
    if (PERIODIC)
      for (int i = tid; i < R * MW; i += FK) s_mask[kb * R * MW + i] = 0u;
    if (TMA && tid == 0) {
      const int qf = qb + NS * gridDim.x;
      if (qf < nb)
        gwin_issue<W>(&dmap, st, s_full + s, q, row0 + qf * R, h0);
    }
  }
  const int h = h0 + x;
  if (h < H) {
    float* slab = block_slab(a.slab_in, (size_t)F * H);
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int f = f0 + gy * NACC + i;
      if (f < F) slab[(size_t)f * H + h] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// g_W_out, g_b
// ---------------------------------------------------------------------------
// g_W_out = sum over rows and t of z(t)^T round_w(s(t)), g_b = sum of s(t).
// grid (row groups, unit chunks of HC, S); thread (x, g) owns g_W_out[h, o]
// of unit h = chunk + x for the GO_OC outputs o = GO_OC g + i.  Rows come in
// batches of R: the block copies the batch's z bits, the R O (row, output)
// pairs run their s chains s = kappa s + g [t == t*] in parallel, one
// thread each (s(t) rounded to the weights' type into a (R, T, OP) table,
// the row's sum of the unrounded s over t descending beside it), then one
// block barrier, and each thread adds z(t)[h] s_r(t)[o] in ascending t,
// rows in order, as fused multiply-adds of the 0/1 z (an exact select);
// steps past the row's last tstar add zeros and are skipped.  g_b: the
// rows' sums added in row order.  Slabs, no atomics, as bwd_gwin.
// ops/fused.py:_gout_ordered_reference is the plain version in this order.
constexpr int GO_OC = 16;   // outputs a thread holds
constexpr int GO_RMAX = 4;  // rows a batch, at most

struct GoutPlan {
  int R, G, HC, n_h, smem, groups;
};

struct GoutLayout {
  size_t zm, sr, rs, ts, total;
};

__host__ __device__ inline GoutLayout gout_layout(int R, int T, int HW,
                                                  int O) {
  const size_t OP = (O + 3) & ~3;
  GoutLayout L;
  size_t off = 0;
  L.zm = off;  // the rows' z bits: row k holds z(k - 1), (R, T + 1, HW)
  off = align16(off + (size_t)R * (T + 1) * HW * 4);
  L.sr = off;  // rounded s, (R, T, OP)
  off = align16(off + (size_t)R * T * OP * 4);
  L.rs = off;  // the rows' sums of s over t, (R, OP)
  off = align16(off + (size_t)R * OP * 4);
  L.ts = off;  // tstar, (R, OP)
  off = align16(off + (size_t)R * OP * 4);
  L.total = off;
  return L;
}

// Batch qb (its `rows` rows, R a batch) into shared memory: the rows' z
// bits, and for each (row, output) its s chain rounded to the weights' type,
// its sum of the unrounded s over t descending and its tstar.  Every thread
// of the block calls it; the caller's barrier follows.
template <typename W>
__device__ __forceinline__ void gout_stage(const Args& a, const GoutLayout& L,
                                           unsigned char* smem, int qb, int R,
                                           int rows, int tid, int nthreads) {
  const int O = a.O, T = a.T, HW = (a.H + 31) / 32, OP = (O + 3) & ~3;
  unsigned* s_zm = reinterpret_cast<unsigned*>(smem + L.zm);
  float* s_sr = reinterpret_cast<float*>(smem + L.sr);
  float* s_rs = reinterpret_cast<float*>(smem + L.rs);
  int* s_ts = reinterpret_cast<int*>(smem + L.ts);
  const unsigned* zsrc = a.zmask + (size_t)qb * R * (T + 1) * HW;
  for (int i = tid; i < rows * (T + 1) * HW; i += nthreads) s_zm[i] = zsrc[i];
  for (int i = tid; i < rows * O; i += nthreads) {
    const int r = i / O, o = i % O;
    const size_t at = (size_t)(qb * R + r) * O + o;
    const float gl = a.g_logits[at];
    const int ts = a.tstar[at];
    float s = 0.f, rs = 0.f;
    float* dst = s_sr + (size_t)r * T * OP + o;
    for (int t = T - 1; t >= 0; --t) {
      s = a.kappa * s + gl * (ts == t ? 1.f : 0.f);
      dst[(size_t)t * OP] = round_w<W>(s);
      rs = rs + s;
    }
    s_rs[r * OP + o] = rs;
    s_ts[r * OP + o] = ts;
  }
}

template <typename W>
__global__ void __launch_bounds__(1024) bwd_gout_kernel(Args a0, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Args a = at_replica<W>(a0, blockIdx.z);
  const int HC = blockDim.x, G = blockDim.y;
  const int H = a.H, O = a.O, T = a.T, B = a.B, HW = (H + 31) / 32;
  const int OP = (O + 3) & ~3;
  const GoutLayout L = gout_layout(R, T, HW, O);
  const unsigned* s_zm = reinterpret_cast<const unsigned*>(smem + L.zm);
  const float* s_sr = reinterpret_cast<const float*>(smem + L.sr);
  const float* s_rs = reinterpret_cast<const float*>(smem + L.rs);
  const int* s_ts = reinterpret_cast<const int*>(smem + L.ts);
  const int x = threadIdx.x, g = threadIdx.y;
  const int tid = g * HC + x, nthreads = HC * G;
  const int h = blockIdx.y * HC + x, o0 = g * GO_OC;
  const bool mine = h < H && o0 < O;
  const int no = min(GO_OC, O - o0);
  float acc[GO_OC];
#pragma unroll
  for (int i = 0; i < GO_OC; ++i) acc[i] = 0.f;
  float acc_b = 0.f;

  const int nb = (B + R - 1) / R;
  for (int qb = blockIdx.x; qb < nb; qb += gridDim.x) {
    const int rows = min(R, B - qb * R);
    gout_stage<W>(a, L, smem, qb, R, rows, tid, nthreads);
    __syncthreads();
    if (blockIdx.y == 0 && tid < O)
      for (int r = 0; r < rows; ++r) acc_b = acc_b + s_rs[r * OP + tid];
    if (mine) {
      for (int r = 0; r < rows; ++r) {
        // s(t) = 0 past the last tstar of this thread's outputs.
        int te = 0;
        for (int i = 0; i < no; ++i) te = max(te, s_ts[r * OP + o0 + i] + 1);
        te = min(te, T);
        const unsigned* zw = s_zm + (size_t)r * (T + 1) * HW + HW + (h >> 5);
        const float* sr = s_sr + (size_t)r * T * OP + o0;
        for (int t = 0; t < te; ++t) {
          const float zf = (zw[t * HW] >> (h & 31)) & 1u ? 1.f : 0.f;
          const float4* s4 = reinterpret_cast<const float4*>(sr + t * OP);
#pragma unroll
          for (int c = 0; c < GO_OC / 4; ++c) {
            if (4 * c < no) {
              const float4 v = s4[c];
              acc[4 * c] = __fmaf_rn(zf, v.x, acc[4 * c]);
              acc[4 * c + 1] = __fmaf_rn(zf, v.y, acc[4 * c + 1]);
              acc[4 * c + 2] = __fmaf_rn(zf, v.z, acc[4 * c + 2]);
              acc[4 * c + 3] = __fmaf_rn(zf, v.w, acc[4 * c + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  float* slab = block_slab(a.slab_out, (size_t)H * O + O);
  if (mine) {
#pragma unroll
    for (int i = 0; i < GO_OC; ++i)
      if (i < no) slab[(size_t)h * O + o0 + i] = acc[i];
  }
  if (blockIdx.y == 0 && tid < O) slab[(size_t)H * O + tid] = acc_b;
}

// ---------------------------------------------------------------------------
// Plans and launches of bwd_gwin and bwd_gout
// ---------------------------------------------------------------------------
// 0 when the shape fits, 1 when it does not.
inline int gwin_plan(int B, int F, int H, int T, int periodic, int wsize,
                     const Limits& lim, GwinPlan* p) {
  if (F < 1 || H < 1 || T < 1) return 1;
  const int nf32 = (F + NACC - 1) / NACC;
  p->G = nf32 < GW_GMAX ? nf32 : GW_GMAX;
  const int FK = 32 * p->G;
  p->n_f = (F + FK - 1) / FK;
  p->n_h = (H + 31) / 32;
  p->nbx = (T + 1 + 255) / 256;  // a TMA box takes at most 256 steps
  p->TB = (T + 1 + p->nbx - 1) / p->nbx;
  if (wsize == 2 && (p->TB & 1)) ++p->TB;  // 128-byte aligned boxes
  p->NS = 0;
  p->tma = ((size_t)H * wsize) % 16 == 0;  // TMA needs 16-byte strides
  if (p->tma) {
    const int cand[6][2] = {{4, 3}, {4, 2}, {2, 4}, {2, 3}, {2, 2}, {1, 2}};
    for (const auto& c : cand) {  // (R, NS)
      const size_t smem = gwin_layout(c[0], c[1], p->nbx * p->TB, T, FK,
                                      wsize, periodic)
                              .total;
      if (smem <= (size_t)lim.max_smem) {
        p->R = c[0];
        p->NS = c[1];
        p->TS = p->nbx * p->TB;
        p->smem = (int)smem;
        break;
      }
    }
  }
  if (p->NS == 0) {  // one stage, copied by the threads
    p->tma = false;
    for (p->R = GW_RMAX; p->R >= 1; p->R /= 2) {
      const size_t smem =
          gwin_layout(p->R, 1, T + 1, T, FK, wsize, periodic).total;
      if (smem <= (size_t)lim.max_smem) {
        p->NS = 1;
        p->TS = T + 1;
        p->smem = (int)smem;
        break;
      }
    }
    if (p->NS == 0) return 1;
  }
  p->groups = row_groups(lim.sms, lim.sm_smem, p->smem, FK, p->n_f * p->n_h,
                         (B + p->R - 1) / p->R);
  return 0;
}

// Launches bwd_gwin on a's dcur (S replicas: dcur (S, B, T, H)).
template <typename W>
cudaError_t launch_gwin(const Args& a, const GwinPlan& p, int S,
                        cudaStream_t s) {
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (p.tma) {
    if (reinterpret_cast<uintptr_t>(a.dcur) % 16 != 0)
      return cudaErrorMisalignedAddress;
    PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
    if (!encode) return cudaErrorNotSupported;
    const cuuint64_t ws = sizeof(W);
    const cuuint64_t dims[3] = {(cuuint64_t)a.H, (cuuint64_t)a.T,
                                (cuuint64_t)S * a.B};
    const cuuint64_t strides[2] = {(cuuint64_t)a.H * ws,
                                   (cuuint64_t)a.T * a.H * ws};
    const cuuint32_t box[3] = {32, (cuuint32_t)p.TB, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    const CUresult rc = encode(
        &map,
        sizeof(W) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        3, a.dcur, dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  const GwinRing q{p.R, p.NS, p.TB, p.nbx, p.TS, p.n_f};
  auto kernel = p.tma ? (a.periodic ? bwd_gwin_kernel<W, true, true>
                                    : bwd_gwin_kernel<W, true, false>)
                      : (a.periodic ? bwd_gwin_kernel<W, false, true>
                                    : bwd_gwin_kernel<W, false, false>);
  cudaError_t err = opt_in(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.groups, p.n_f * p.n_h, S), dim3(32, p.G), p.smem, s>>>(
      map, a, q);
  return cudaGetLastError();
}

// 0 when the shape fits, 1 when it does not.
inline int gout_plan(int B, int H, int O, int T, const Limits& lim,
                     GoutPlan* p) {
  if (H < 1 || O < 1 || T < 1) return 1;
  p->G = (O + GO_OC - 1) / GO_OC;
  if (p->G > 32) return 1;
  const int HP = (H + 31) / 32 * 32;
  p->HC = (1024 / p->G) / 32 * 32;
  if (p->HC > 256) p->HC = 256;
  if (p->HC > HP) p->HC = HP;
  p->n_h = (HP + p->HC - 1) / p->HC;
  for (p->R = GO_RMAX; p->R >= 1; p->R /= 2) {
    p->smem = (int)gout_layout(p->R, T, HP / 32, O).total;
    if (p->smem <= lim.max_smem) break;
  }
  if (p->R < 1) return 1;
  p->groups = row_groups(lim.sms, lim.sm_smem, p->smem, p->HC * p->G,
                         p->n_h, (B + p->R - 1) / p->R);
  return 0;
}

template <typename W>
cudaError_t launch_gout(const Args& a, const GoutPlan& p, int S,
                        cudaStream_t s) {
  cudaError_t err = opt_in(bwd_gout_kernel<W>, p.smem);
  if (err != cudaSuccess) return err;
  bwd_gout_kernel<W><<<dim3(p.groups, p.n_h, S), dim3(p.HC, p.G), p.smem,
                       s>>>(a, p.R);
  return cudaGetLastError();
}

}  // namespace
