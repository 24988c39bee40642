// The tensor-core cluster body of the recurrent LIF/ALIF scan pair
// (rec_scan.cu): rec_mma_fwd_kernel (rec_scan_fwd, rec_scan_fwd_train) and
// rec_mma_chain_kernel (the chain of rec_scan_bwd), for layers whose W_rec
// pieces do not fit one block's shared memory (H = 512: 1.5 MB in float32
// as three bf16 pieces, 512 KB in bf16).
//
// What bounds it on an H100: the serial T-chain.  The recurrent products
// are 2 B T H^2 FLOP each way (430 GFLOP at B = 8192, T = 100, H = 512),
// 1.3 / 2.6 TFLOP of bf16 tensor-core work in float32 (three and six piece
// products), so a step must keep its product on tensor cores with W_rec in
// shared memory, which one block cannot hold.  So:
//   * A thread-block cluster of C blocks owns R batch rows for the whole
//     chain; block c (its rank) owns the units [c U, (c + 1) U) and holds
//     its slice of the recurrent matrix as B fragments of P bf16 pieces
//     (head_mma.cuh:fill_b), filled once a launch: the forward W_rec[:,
//     slice], the chain W_rec^T[:, slice].
//   * A warp owns 16 rows x 32 units (the chain: 16 where a block holds
//     too few for four warps) in mma.m16n8k16's accumulator layout
//     (head_mma.cuh); the cell's state stays in those registers.  Every
//     block sums over all H inputs of its own units in ascending k16
//     slices, each slice to fresh accumulators added in float32
//     (mma_exact, mma_split_a): K is never split across blocks, so a unit's
//     sum has one order whatever the plan, and a row's bits do not depend
//     on its batch.
//   * The left operand of the next step crosses the cluster through
//     distributed shared memory: each warp writes its share into its own
//     block's buffer and sends it to every peer block with one bulk copy
//     (cp.async.bulk shared::cta -> shared::cluster) that counts its bytes
//     on the peer's mbarrier; a block waits on its own mbarrier for the
//     step's bytes and its warps' arrivals.  No cluster barrier a step:
//     with two buffers the data a block waits for orders every write after
//     the reads it could clobber.  The forward sends z(t) as bits (R x H /
//     32 words); each warp builds its A fragments from the words in
//     registers (bit x 0x3F80 = bf16 1.0).  The chain sends dcur(t) rounded
//     to W's type as P bf16 pieces (R x H x P, in 1 KB chunks of 16 rows x
//     32 units, swizzled for ldmatrix); where two buffers do not fit one
//     buffer and a relaxed cluster barrier a step after the product.
//     Float32 chains run the CUDA-core body (rec_scan.cu:make_plan says
//     why); tools/bwd_ablation.py --wide times them here (cluster_chain).
//   * Each step's element-wise inputs are loaded a step ahead, unconverted
//     (a conversion would wait for its load), and converted in the cell.
//   * The cell keeps rec_scan.cu's expressions: the forward v = ((alpha v
//     + i) + rec)(1 - z(t-1)), ALIF's a and thr, delta; the chain dz = g_z
//     + rec, dv = dz surr + alpha dcur, dcur = dv (1 - z(t-1)).  Built with
//     --fmad=false.
// The plan (rec_mma_plan) picks C, U, R and the chain's buffers from the
// shape, the card's shared memory and cudaOccupancyMaxActiveClusters; a
// shape whose slice and buffers fit no block keeps the CUDA-core body
// (rec_scan.cu).  ops/rec_scan.py: _fwd_ordered_reference and
// _chain_ordered_reference are the plain versions in this body's order.
#pragma once

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <vector>

#include "bwd_common.cuh"
#include "head_mma.cuh"

namespace {

struct RecArgs {
  const float* cur;   // (T, B, H) float32, forward
  const void* w;      // (H, H): W_rec (forward) or W_rec^T (backward)
  const float* beta;  // (1)
  void* z;            // (T, B, H) W's type: forward output, backward input
  void* res;          // (T, B, H) W's type or null: delta, or v (res_is_v)
  void* a_tr;         // (T, B, H) W's type or null: ALIF + Phi's a
  const void* g_z;    // (T, B, H) W's type, backward
  float* g_i;         // (T, B, H) float32, backward
  unsigned* zmask;    // (T, B, HW), backward: row (t, b) = bits of z(t-1)
  int B, H, T, JC, alif, res_is_v, phi;
  float alpha, rho, threshold, gamma;
};

constexpr int RM_THREADS = MMA_THREADS;  // eight warps a block, at most
constexpr int RM_PORTABLE = 8;           // cluster sizes every card takes
constexpr int RM_CMAX = 16;              // with the non-portable attribute

// A launch of the body: C blocks a cluster, U units a block, R rows a
// cluster, NB exchange buffers (the chain), bytes of shared memory a block,
// clusters the card keeps active at once, n8 tiles a warp (units: 8 NT).
struct RecMmaPlan {
  int C, U, R, NB, smem, active, NT;
};

struct RecMmaLayout {
  size_t w, x, bar, total;
};

// The exchange buffers.  Forward: two buffers of HW x R words, word j of
// row r at j R + r, so a warp's word of its 16 rows is 64 contiguous bytes.
// Chain: NB buffers of P planes of 16 x 32 chunks (1 KB, rows of 64
// bytes): chunk (wr, j) holds rows 16 wr .. + 15 and units 32 j .. + 31,
// its four 16-byte column groups swizzled by row (rm_swz) so the eight rows
// an ldmatrix reads fall on distinct banks.
__host__ __device__ inline RecMmaLayout rec_mma_layout(int H, int U, int R,
                                                       int NB, int P,
                                                       bool chain) {
  const size_t HP = mma_hp(H);
  RecMmaLayout L;
  L.w = 0;  // the slice's B fragments, (HP, U), P pieces
  size_t off = align16(HP * U * P * 2);
  L.x = off;
  off += chain ? (size_t)NB * P * R * HP * 2 : (size_t)2 * R * (HP / 32) * 4;
  L.bar = align16(off);  // an mbarrier a buffer: its step's bytes arrived
  L.total = L.bar + 16;
  return L;
}

// Byte offset of (row r, 16-byte column group c) in a 16 x 32 bf16 chunk.
__device__ __forceinline__ uint32_t rm_swz(int r, int c) {
  return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// barrier.cluster; with `relaxed` the arrive orders no memory access (the
// chain's single buffer: only "every block is done reading it").
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address in block `rank` of what lies at shared address `local` here.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// A bulk copy of `bytes` (a multiple of 16) from this block's shared memory
// at `src` into a peer's at `dst`, counted on the peer's mbarrier `bar`
// (dst and bar from peer_addr).
__device__ __forceinline__ void copy_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// This thread's shared-memory stores made visible to the bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Waits for phase `parity` of this block's mbarrier `bar`, acquiring what
// the peers' copies wrote (cluster scope).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The A fragment of k16 slice `h` (0, 1) of a swizzled 16 x 32 chunk.
__device__ __forceinline__ void load_a_chunk(uint32_t (&a)[4], uint32_t chunk,
                                             int h, int lane) {
  const int r = lane & 15;
  const uint32_t at = chunk + rm_swz(r, 2 * h + (lane >> 4));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(at)
      : "memory");
}

// Bits 0 and 1 of y as a bf16x2 word of 0 / 1.0 (bit 0 in the low half).
__device__ __forceinline__ uint32_t bits_bf16(uint32_t y) {
  return ((y & 1u) | ((y & 2u) << 15)) * 0x3F80u;
}

// A pair of adjacent entries as loaded, unconverted: a float2 for float32,
// the bf16x2 word for bf16.  The conversion waits for the load, so it is
// left to the step that uses the pair.
template <typename W>
using raw_pair = typename std::conditional<sizeof(W) == 4, float2,
                                           uint32_t>::type;

// The pair at p: one 8- or 4-byte load where `vec` (H even: every pair is
// aligned), else two (the second where `two`).
template <typename W>
__device__ __forceinline__ raw_pair<W> load_raw(const W* p, bool vec,
                                                bool two) {
  if constexpr (sizeof(W) == 4) {
    if (vec) return *reinterpret_cast<const float2*>(p);
    return make_float2(p[0], two ? p[1] : 0.f);
  } else {
    if (vec) return *reinterpret_cast<const uint32_t*>(p);
    const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
    return (uint32_t)u[0] | (two ? (uint32_t)u[1] << 16 : 0u);
  }
}

__device__ __forceinline__ float raw_at(float2 v, int i) {
  return i ? v.y : v.x;
}
__device__ __forceinline__ float raw_at(uint32_t v, int i) {
  return __uint_as_float(i ? v & 0xffff0000u : v << 16);
}

// The launch's setup: every block's mbarriers initialised and every block
// of the cluster running before the first remote copy.  A phase of a
// buffer's mbarrier completes when the step's bytes from the peers have
// arrived and `count` arrivals were made: thread 0's, which states the
// bytes, and one from each of this block's warps that writes its share.
__device__ __forceinline__ void rm_setup(uint64_t* bars, int n, int count,
                                         int tid) {
  if (tid == 0) {
    for (int i = 0; i < n; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(bars + i)),
                   "r"(count)
                   : "memory");
    mbar_fence_init();
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();
}

// A warp's share written into this block's buffer: its shared-memory
// stores made visible to the bulk copies and, by lane 0's arrival (release),
// to this block's warps that wait on `bar`.
__device__ __forceinline__ void share_written(uint64_t* bar, int lane) {
  fence_async_shared();
  __syncwarp();
  if (lane == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

template <typename W, bool TRAIN>
__global__ void __launch_bounds__(RM_THREADS)
    rec_mma_fwd_kernel(RecArgs a, int C, int U, int R) {
  constexpr int P = pieces<W>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, T = a.T, B = a.B;
  const int HP = mma_hp(H), HW = HP / 32, NU = U / 8;
  const RecMmaLayout L = rec_mma_layout(H, U, R, 2, P, false);
  uint2* s_w = reinterpret_cast<uint2*>(smem + L.w);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem + L.x);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int rank = cluster_rank();
  const int row0 = (blockIdx.x / C) * R, unit0 = rank * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / (U / 32), wu = warp % (U / 32);
  {  // B[k][n] = W_rec[k, unit0 + n]
    const W* w = static_cast<const W*>(a.w);
    fill_b<P>(s_w, HP, U, [&](int k, int n) {
      const int h = unit0 + n;
      return k < H && h < H ? to_f32(w[(size_t)k * H + h]) : 0.f;
    }, tid, blockDim.x);
  }
  // A step's bits from the peers: R rows x their words; this block's
  // warps that write a word.
  const int own = min(U, HP - unit0) / 32;
  const uint32_t step_bytes = (uint32_t)R * (HW - own) * 4;
  rm_setup(s_full, 2, 1 + (R / 16) * own, tid);

  const int wcol = unit0 + MMA_NU * wu;  // the warp's first unit
  const int col0 = wcol + 2 * q;         // entry 0 of n8 tile 0
  const int word = wcol >> 5;            // the warp's word of a row's bits
  const int rt = wr * 16 + g;            // the lane's first row of the tile
  bool live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) live[hh] = row0 + rt + 8 * hh < B;
  const float beta = a.alif ? *a.beta : 0.f;
  float v[MMA_NT][4], ad[MMA_NT][4];
#pragma unroll
  for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[n][e] = ad[n][e] = 0.f;
  uint32_t zb = 0;  // z(t-1), bit 4 n + e
  const size_t stride = (size_t)B * H;
  W* z_out = static_cast<W*>(a.z);
  W* res_out = static_cast<W*>(a.res);
  W* a_out = static_cast<W*>(a.a_tr);
  // The currents of step t, a lane's two adjacent units at a time (rows
  // past the batch and units past H read entry 0, unused).
  const bool vec = (H & 1) == 0;
  float2 cur[MMA_NT][2];
  auto load_cur = [&](int t) {
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + rt + 8 * hh, col = col0 + 8 * n;
        const bool ok = live[hh] && col < H;
        const size_t at = (size_t)t * stride + (size_t)row * H + col;
        cur[n][hh] = load_raw(a.cur + (ok ? at : 0), vec, col + 1 < H);
      }
  };
  load_cur(0);

  for (int t = 0; t < T; ++t) {
    // z(t-1) from the peers and this block's warps (buffer (t-1) & 1); then
    // the other buffer's bytes for z(t), stated before any can be missed.
    if (t > 0) mbar_wait_cluster(s_full + ((t - 1) & 1), ((t - 1) >> 1) & 1);
    if (tid == 0 && t < T - 1) mbar_expect(s_full + (t & 1), step_bytes);
    // z(t-1) @ W_rec[:, the warp's units]: A from the rows' bit words, two
    // k16 slices a word.
    float rec[MMA_NT][4] = {};
    if (t > 0) {
      const uint32_t* zr = s_bits + (size_t)((t - 1) & 1) * HW * R + rt;
      for (int kw = 0; kw < HW; ++kw) {
        const uint32_t x0 = zr[(size_t)kw * R], x1 = zr[(size_t)kw * R + 8];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint32_t y0 = x0 >> (16 * hf + 2 * q);
          const uint32_t y1 = x1 >> (16 * hf + 2 * q);
          const uint32_t A[4] = {bits_bf16(y0), bits_bf16(y1),
                                 bits_bf16(y0 >> 8), bits_bf16(y1 >> 8)};
          const int kk = 2 * kw + hf;
#pragma unroll
          for (int n = 0; n < MMA_NT; ++n)
            mma_exact_a<P>(rec[n], A, s_w, kk * NU + MMA_NT * wu + n, lane);
        }
      }
    }
    // The cell of the warp's 16 x 32 (row, unit) pairs.
    uint32_t zn = 0, zw[2] = {0u, 0u};
    float keep[MMA_NT][4];  // the residual trace: v or delta
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = live[e >> 1] && col0 + 8 * n + (e & 1) < H;
        const float zp = (zb >> (4 * n + e)) & 1u ? 1.f : 0.f;
        const float vv = (a.alpha * v[n][e] + raw_at(cur[n][e >> 1], e & 1) +
                          rec[n][e]) *
                         (1.f - zp);
        v[n][e] = vv;
        float thr = a.threshold;
        if (a.alif) {
          ad[n][e] = a.rho * ad[n][e] + zp;
          thr = a.threshold + beta * ad[n][e];
        }
        const float delta = vv - thr;
        keep[n][e] = a.res_is_v ? vv : delta;
        const bool z = ok && delta >= 0.f;  // padding never fires
        zn |= (uint32_t)z << (4 * n + e);
        zw[e >> 1] |= (uint32_t)z << (8 * n + 2 * q + (e & 1));
      }
    }
    zb = zn;
    // z(t)'s word of the warp's 16 rows into buffer t & 1 here, then by one
    // 64-byte copy a peer into every other block (none after the last step).
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      zw[hh] |= __shfl_xor_sync(0xffffffffu, zw[hh], 1);
      zw[hh] |= __shfl_xor_sync(0xffffffffu, zw[hh], 2);
    }
    if (word < HW && t < T - 1) {
      uint32_t* dst = s_bits + ((size_t)(t & 1) * HW + word) * R + wr * 16;
      if (q == 0) {
        dst[g] = zw[0];
        dst[g + 8] = zw[1];
      }
      share_written(s_full + (t & 1), lane);
      const uint32_t src = smem_u32(dst), bar = smem_u32(s_full + (t & 1));
      for (int p = lane; p < C; p += 32)
        if (p != rank)
          copy_to_peer(peer_addr(src, p), src, 64, peer_addr(bar, p));
    }
    // Step t's traces, a lane's two adjacent units at a time; then the
    // currents of step t + 1.
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + rt + 8 * hh, col = col0 + 8 * n;
        if (!live[hh] || col >= H) continue;
        const size_t at = (size_t)t * stride + (size_t)row * H + col;
        const int e = 2 * hh;
        const bool two = col + 1 < H;
        store_pair(z_out + at, (zn >> (4 * n + e)) & 1u ? 1.f : 0.f,
                   (zn >> (4 * n + e + 1)) & 1u ? 1.f : 0.f, two);
        if (TRAIN) {
          if (res_out)
            store_pair(res_out + at, keep[n][e], keep[n][e + 1], two);
          if (a_out) store_pair(a_out + at, ad[n][e], ad[n][e + 1], two);
        }
      }
    if (t + 1 < T) load_cur(t + 1);
  }
  // No block leaves while a peer may still copy into it.
  cluster_arrive();
  cluster_wait();
}

template <typename W, int NB, int NT>
__global__ void __launch_bounds__(RM_THREADS)
    rec_mma_chain_kernel(RecArgs a, int C, int U, int R) {
  constexpr int P = pieces<W>(), WU = 8 * NT;  // units a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, T = a.T, B = a.B;
  const int HP = mma_hp(H), HW = HP / 32, KT = HP / 16, NU = U / 8;
  const RecMmaLayout L = rec_mma_layout(H, U, R, NB, P, true);
  uint2* s_w = reinterpret_cast<uint2*>(smem + L.w);
  unsigned char* s_d = smem + L.x;
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int rank = cluster_rank();
  const int row0 = (blockIdx.x / C) * R, unit0 = rank * U;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp / (U / WU), wu = warp % (U / WU);
  {  // B[j][n] = W_rec^T[j, unit0 + n] = W_rec[unit0 + n, j]
    const W* w = static_cast<const W*>(a.w);
    fill_b<P>(s_w, HP, U, [&](int k, int n) {
      const int h = unit0 + n;
      return k < H && h < H ? to_f32(w[(size_t)k * H + h]) : 0.f;
    }, tid, blockDim.x);
  }
  // Sizes in bytes: a plane (R x HP bf16), a buffer (P planes); a step's
  // pieces from the peers; this block's warps that write a tile.
  const uint32_t plane = (uint32_t)R * HP * 2, buffer = P * plane;
  const int own = min(U, HP - unit0);
  const uint32_t step_bytes = (uint32_t)R * (HP - own) * 2 * P;
  rm_setup(s_full, NB, 1 + (R / 16) * (own / 32), tid);

  // The warp's units: 32 (NT = 4) or half of a 32-unit word (NT = 2, two
  // warps a chunk, where a block holds too few rows and units for four
  // warps of 32).
  const int wcol = unit0 + WU * wu;
  const int col0 = wcol + 2 * q;
  const int word = wcol >> 5, c0 = (wcol & 31) >> 3;  // its word, groups
  const int rt = wr * 16 + g;
  const uint32_t chunk0 = ((uint32_t)wr * HW + word) * 1024;  // its chunk
  bool live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) live[hh] = row0 + rt + 8 * hh < B;
  const float beta = a.a_tr ? *a.beta : 0.f;
  float dcur[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dcur[n][e] = 0.f;
  const size_t stride = (size_t)B * H;
  const W* g_z = static_cast<const W*>(a.g_z);
  const W* z_tr = static_cast<const W*>(a.z);
  const W* res = static_cast<const W*>(a.res);
  const W* a_tr = static_cast<const W*>(a.a_tr);
  // Step t's element-wise inputs, a lane's two adjacent units at a time,
  // loaded a step ahead as they lie (rows past the batch and units past H
  // read entry 0, unused).
  const bool vec = (H & 1) == 0;
  raw_pair<W> gz[NT][2], rv[NT][2], av[NT][2], zv[NT][2];
  auto load_step = [&](int t) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + rt + 8 * hh, col = col0 + 8 * n;
        const bool ok = live[hh] && col < H, two = col + 1 < H;
        const size_t at = ok ? (size_t)t * stride + (size_t)row * H + col : 0;
        gz[n][hh] = load_raw(g_z + at, vec, two);
        rv[n][hh] = load_raw(res + at, vec, two);
        if (a_tr) av[n][hh] = load_raw(a_tr + at, vec, two);
        zv[n][hh] = load_raw(z_tr + (t > 0 && ok ? at - stride : 0), vec, two);
      }
  };
  load_step(T - 1);

  // Step s = T - 1 - t reads round(dcur(t+1)) from buffer (s - 1) % NB
  // and sends round(dcur(t)) into buffer s % NB.
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const int rb = NB == 2 ? (s - 1) & 1 : 0, wb = NB == 2 ? s & 1 : 0;
    if (s > 0)
      mbar_wait_cluster(s_full + rb, (NB == 2 ? (s - 1) >> 1 : s - 1) & 1);
    if (NB == 2 && tid == 0 && t > 0) mbar_expect(s_full + wb, step_bytes);
    // round(dcur(t+1)) @ W_rec^T[:, the warp's units]; dcur(T) = 0.
    float rec[NT][4] = {};
    if (s > 0) {
      const uint32_t base = smem_u32(s_d + (size_t)rb * buffer) +
                            (uint32_t)wr * HW * 1024;
#pragma unroll 2
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t da[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          load_a_chunk(da[p], base + p * plane + (kk >> 1) * 1024, kk & 1,
                       lane);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_split_a<P>(rec[n], da, s_w, kk * NU + NT * wu + n, lane);
      }
    }
    // One buffer: every block done reading it before any copy into it.
    if (NB == 1) cluster_arrive_relaxed();
    // The cell's cotangents; dcur(t) rounded to W's type, as pieces.
    float piece[P][NT][4];
    uint32_t zw[2] = {0u, 0u};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = live[e >> 1] && col0 + 8 * n + (e & 1) < H;
        const bool zp = ok && t > 0 && raw_at(zv[n][e >> 1], e & 1) != 0.f;
        float dcr = 0.f;
        if (ok) {
          float thr = a.threshold;
          if (a_tr) thr = a.threshold + beta * raw_at(av[n][e >> 1], e & 1);
          const float r = raw_at(rv[n][e >> 1], e & 1);
          const float dlt = a.res_is_v ? r - thr : r;
          const float surr = surrogate(a.phi, dlt, thr, a.gamma);
          const float dz = raw_at(gz[n][e >> 1], e & 1) + rec[n][e];
          const float dv = dz * surr + a.alpha * dcur[n][e];
          const float d = dv * (1.f - (zp ? 1.f : 0.f));
          dcur[n][e] = d;
          dcr = round_w<W>(d);
        }
        float pc[P];
        split<P>(dcr, pc);
#pragma unroll
        for (int p = 0; p < P; ++p) piece[p][n][e] = pc[p];
        zw[e >> 1] |= (uint32_t)zp << (8 * n + 2 * q + (e & 1));
      }
    }
    if (NB == 1) {
      cluster_wait();
      if (tid == 0 && t > 0) mbar_expect(s_full, step_bytes);
    }
    // dcur(t)'s pieces of the warp's 16 x WU tile into its chunk of buffer
    // s % NB here, then by one 1 KB copy a plane and peer into every other
    // block (none after step t = 0), by the chunk's first warp.
    if (wcol < HP && t > 0) {
      unsigned char* dst = s_d + (size_t)wb * buffer + chunk0;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = g + 8 * hh;
            *reinterpret_cast<uint32_t*>(dst + p * plane +
                                         rm_swz(r, c0 + n) + 4 * q) =
                pack_bf16(piece[p][n][2 * hh], piece[p][n][2 * hh + 1]);
          }
      if (NT == 4) {
        share_written(s_full + wb, lane);
      } else {  // the chunk's two warps meet first
        fence_async_shared();
        tile_sync(1 + warp / 2, 64);
        if (c0 == 0) share_written(s_full + wb, lane);
      }
      const uint32_t src = smem_u32(dst), bar = smem_u32(s_full + wb);
      for (int i = lane; c0 == 0 && i < P * C; i += 32) {
        const int p = i % P, peer = i / P;
        if (peer != rank)
          copy_to_peer(peer_addr(src + p * plane, peer), src + p * plane,
                       1024, peer_addr(bar, peer));
      }
    }
    // g_i(t), a lane's two adjacent units at a time, and z(t-1)'s word of
    // rows rt and rt + 8; then step t - 1's inputs.
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + rt + 8 * hh, col = col0 + 8 * n;
        if (live[hh] && col < H)
          store_pair(a.g_i + (size_t)t * stride + (size_t)row * H + col,
                     dcur[n][2 * hh], dcur[n][2 * hh + 1], col + 1 < H);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      zw[hh] |= __shfl_xor_sync(0xffffffffu, zw[hh], 1);
      zw[hh] |= __shfl_xor_sync(0xffffffffu, zw[hh], 2);
      if (q != 0 || !live[hh] || word >= HW) continue;
      const size_t at = ((size_t)t * B + row0 + rt + 8 * hh) * HW + word;
      if (NT == 4)
        a.zmask[at] = zw[hh];
      else  // this warp's half of the word
        reinterpret_cast<uint16_t*>(a.zmask)[2 * at + (c0 >> 1)] =
            (uint16_t)zw[hh];
    }
    if (t > 0) load_step(t - 1);
  }
  cluster_arrive();
  cluster_wait();
}

// Clusters of `kernel` the card keeps active at once with this plan's
// shape (0 where it schedules none); opts the kernel in to its shared
// memory and, above eight blocks, to a non-portable cluster size.
template <typename K>
cudaError_t rm_opt_in(K kernel, const RecMmaPlan& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err == cudaSuccess && p.C > RM_PORTABLE)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

inline int rm_threads(const RecMmaPlan& p) {
  return (p.R / 16) * (p.U / (8 * p.NT)) * 32;
}

template <typename K>
cudaError_t rm_active(K kernel, const RecMmaPlan& p, int* active) {
  cudaError_t err = rm_opt_in(kernel, p);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.C);
  cfg.blockDim = dim3(rm_threads(p));
  cfg.dynamicSmemBytes = p.smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
}

// The launch: ceil(B / R) clusters of C blocks.
template <typename K>
cudaError_t rm_launch(K kernel, const RecMmaPlan& p, const RecArgs& a,
                      cudaStream_t s) {
  cudaError_t err = rm_opt_in(kernel, p);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(((a.B + p.R - 1) / p.R) * p.C);
  cfg.blockDim = dim3(rm_threads(p));
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, p.C, p.U, p.R);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The kernel a plan's clusters are counted on: the training forward, or the
// chain with the plan's buffers.
template <typename W>
cudaError_t rm_active_of(bool chain, const RecMmaPlan& p, int* active) {
  if (!chain) return rm_active(rec_mma_fwd_kernel<W, true>, p, active);
  if (p.NT == 2)
    return p.NB == 2 ? rm_active(rec_mma_chain_kernel<W, 2, 2>, p, active)
                     : rm_active(rec_mma_chain_kernel<W, 1, 2>, p, active);
  return p.NB == 2 ? rm_active(rec_mma_chain_kernel<W, 2, 4>, p, active)
                   : rm_active(rec_mma_chain_kernel<W, 1, 4>, p, active);
}

// Every plan of a width that fits a block's shared memory, with the clusters
// the card keeps active at once (0: none; such a plan is never chosen).
// Portable cluster sizes are listed first; a plan of more than eight blocks
// only where no portable one fits.  Computed once a (device, H, type, mode).
inline cudaError_t rm_candidates(int H, int bf16, bool chain, int device,
                                 int max_smem,
                                 std::vector<RecMmaPlan>* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int>, std::vector<RecMmaPlan>>
      cache;
  const auto key = std::make_tuple(device, H, bf16, (int)chain);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  const int P = bf16 ? 1 : 3, HP = mma_hp(H);
  std::vector<RecMmaPlan> list;
  for (int cmax : {RM_PORTABLE, RM_CMAX}) {
    for (int U : {32, 64, 128}) {
      const int C = (HP + U - 1) / U;
      if (C > cmax || (cmax == RM_CMAX && C <= RM_PORTABLE)) continue;
      if (U > 32 && C * U - HP >= 32) continue;  // a warp of padding units
      for (int R : {16, 32, 64, 128}) {
        if ((R / 16) * (U / 32) * 32 > RM_THREADS) continue;
        for (int NB : {2, 1}) {
          if (!chain && NB == 1) continue;
          const size_t smem = rec_mma_layout(H, U, R, NB, P, chain).total;
          if (smem > (size_t)max_smem) continue;
          // The chain's warps own 16 units where 32 would leave fewer than
          // four warps a block (one a scheduler).
          const int NT = chain && (R / 16) * (U / 32) < 4 ? 2 : 4;
          RecMmaPlan p{C, U, R, NB, (int)smem, 0, NT};
          const cudaError_t err = bf16
              ? rm_active_of<__nv_bfloat16>(chain, p, &p.active)
              : rm_active_of<float>(chain, p, &p.active);
          if (err != cudaSuccess) {
            // A size the card refuses: no cluster of it is active.
            (void)cudaGetLastError();
            p.active = 0;
          }
          list.push_back(p);
        }
      }
    }
    if (!list.empty()) break;
  }
  cache[key] = list;
  *out = list;
  return cudaSuccess;
}

// The plan of a launch at batch B: 0 with *p set, 1 where no plan fits a
// block (the CUDA-core body's shape), cudaErrorInvalidClusterSize where
// plans fit but the card keeps none of their clusters active (raised: no
// other body runs instead), or a CUDA error.  Among the active plans the
// fewest waves of ceil(B / R) clusters, each weighed by max(R, 64) rows (a
// block of fewer warps leaves its SM's tensor cores idle) and a fifth more
// with one chain buffer (two barriers a step); then the smaller R, C.
inline int rec_mma_plan(int B, int H, int bf16, bool chain, int device,
                        int max_smem, RecMmaPlan* p) {
  std::vector<RecMmaPlan> list;
  const cudaError_t err =
      rm_candidates(H, bf16, chain, device, max_smem, &list);
  if (err != cudaSuccess) return (int)err;
  if (list.empty()) return 1;
  long best_cost = -1;
  for (const RecMmaPlan& c : list) {
    if (c.active < 1) continue;
    const long clusters = ((B > 0 ? B : 1) + c.R - 1) / c.R;
    const long waves = (clusters + c.active - 1) / c.active;
    const long cost =
        waves * (c.R > 64 ? c.R : 64) * (c.NB == 1 ? 5 : 4);
    const bool better =
        best_cost < 0 || cost < best_cost ||
        (cost == best_cost &&
         (c.R < p->R || (c.R == p->R && c.C < p->C)));
    if (better) {
      best_cost = cost;
      *p = c;
    }
  }
  return best_cost < 0 ? (int)cudaErrorInvalidClusterSize : 0;
}

}  // namespace
