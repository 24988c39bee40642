// Spike encoding fused into the input-current product, forward and backward:
// latencies (B, F) int32, W (F, H) -> currents (T, B, H) float32 with
// currents[t] = spikes(t) @ W, the spikes generated from the latencies; and
// g_W = sum_t spikes(t)^T g(t) from the cotangent g (T, B, H) float32.  A
// first layer that no whole-layer kernel takes (a recurrent layer too wide
// for their shared memory) gets its currents here, then rec_scan.cu.
//
// Replaces the TPU kernels
// snnimageclassification_tpu/ops/pallas_encode.py:_fwd_kernel (pl.pallas_call
// in _fwd, :165) and _bwd_kernel (in _bwd_vjp, :209), encoded_input_matmul.
//
// Every (row, feature) has a key: TTFS the latency L (it fires at t = L iff
// 0 <= L < T), periodic the period p = clamp(L, 1, T - 1) (it fires at t = p,
// 2p, ..; at T = 1 the period is 0 and every feature fires at t = 0).
//
// What bounds them on an H100: bytes.  The forward writes T B H floats (1.68
// GB at B = 8192, T = 100, H = 512: 0.5 ms at the memory rate), the backward
// reads as many; spikes are 0/1, so no product is formed, only sums of
// selected rows.  The design keeps the adds below the byte time:
//   encode_sort: one warp a row orders the row's features by key, ascending
//     f within a key (a stable counting sort), into a scratch row: the
//     features, each key's run start, the nonempty keys.  Once a row, for
//     every column chunk.
//   encode_fwd: a block owns a column chunk of 32 and keeps W's (F, 32)
//     chunk in shared memory as float for its life (loaded once); each warp
//     takes rows in turn, lane = column, the next row's sorted list
//     prefetched with cp.async while the current one is summed.  TTFS:
//     currents(t) is the sum of run t, added in ascending f (the terms and
//     the order of fused_layer0_fwd's input sum, so its bits).  Periodic:
//     S_p = the sum of run p, once, then currents(t) = the sum of S_p over
//     the periods p dividing t, in ascending p: S_1 (every step) first, the
//     other periods a few at a time in registers, each firing at its next
//     multiple -- F + sum_t d(t) row-adds a row instead of sum_f T / p_f.
//     One coalesced 128-byte store a (step, row, chunk); no block barrier
//     after the chunk's load.
//   encode_keys: one warp a row writes key + 1 of each feature (0: never
//     fires) and, periodic, the row's periods as a bit mask.
//   encode_bwd: a block owns a column chunk of 32 and a chunk of G * NACC
//     features; thread (x, g) keeps the NACC accumulators g_W[f, h0 + x] of
//     its features in registers over the rows its block walks.  Rows come in
//     batches of R; TMA loads a batch's (T + 1, R, 32) box of g (from step
//     -1, a zero row), its (R, G, 32) box of keys and its masks into a ring
//     of NS stages (mbarrier completion), NS - 1 batches ahead.  A row's
//     table is g itself (TTFS, row = key) or S[p] = sum_j g(j p) (periodic,
//     for the periods in the row's mask), so each (row, feature) adds one
//     gathered value, a key of 0 the zero row.  One block barrier a batch
//     (two periodic: the S table is built between them) serves R rows.  Each block writes a slab of its own,
//     the host adds the slabs in a fixed order: no atomics, equal bits on
//     every run.  Where TMA cannot read g (H not a multiple of 4) or no two
//     stages fit, the threads copy one stage instead.
// Built with --fmad=false; every sum is float32 in a fixed order.

#include <type_traits>

#include "bwd_common.cuh"

namespace {

constexpr int RMAX = 4;  // rows of a backward batch, at most

__host__ __device__ inline int align8(int x) { return (x + 7) & ~7; }

// A scratch row of the sorted lists, in 16-bit words: the features ordered
// by key (each as f * scale), the T + 1 run starts (run k = [start[k],
// start[k + 1])), then the number of nonempty keys and those keys,
// ascending.
__host__ __device__ inline int list_row_len(int F, int T) {
  return align8(F) + 2 * align8(T + 2);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------
constexpr int KMAX = 4;  // periods a pass of the periodic forward holds

// One warp a row: a stable counting sort of the row's features by key.
__global__ void __launch_bounds__(256)
    encode_sort_kernel(const int* lat, uint16_t* lists, int B, int F, int T,
                       int periodic, int scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* cnt = reinterpret_cast<int*>(smem) + warp * (T + 1);
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // no block barrier below
  const int* lrow = lat + (size_t)b * F;
  uint16_t* list = lists + (size_t)b * list_row_len(F, T);
  uint16_t* start = list + align8(F);
  uint16_t* nz = start + align8(T + 2);
  for (int k = lane; k <= T; k += 32) cnt[k] = 0;
  __syncwarp();
  for (int f = lane; f < F; f += 32) {
    const int k = enc_key(lrow[f], T, periodic);
    if (k >= 0) atomicAdd(&cnt[k], 1);
  }
  __syncwarp();
  // Run starts: the exclusive prefix sum of the counts; the nonempty keys.
  int carry = 0, n = 0;
  for (int k0 = 0; k0 <= T; k0 += 32) {
    const int k = k0 + lane;
    const int c = k < T ? cnt[k] : 0;
    int x = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (k <= T) {
      cnt[k] = carry + x - c;
      start[k] = (uint16_t)(carry + x - c);
    }
    carry += __shfl_sync(0xffffffffu, x, 31);
    const unsigned used = __ballot_sync(0xffffffffu, c > 0);
    if (c > 0) nz[1 + n + __popc(used & ((1u << lane) - 1u))] = (uint16_t)k;
    n += __popc(used);
  }
  if (lane == 0) nz[0] = (uint16_t)n;
  __syncwarp();
  // Features in ascending f, each after the earlier ones of its key.
  for (int f0 = 0; f0 < F; f0 += 32) {
    const int f = f0 + lane;
    const int k = f < F ? enc_key(lrow[f], T, periodic) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    if (k >= 0)
      list[cnt[k] + __popc(peers & ((1u << lane) - 1u))] =
          (uint16_t)(f * scale);
    __syncwarp();
    if (k >= 0 && lane == __ffs(peers) - 1) cnt[k] += __popc(peers);
    __syncwarp();
  }
}

// Eight weight rows, by the eight 16-bit offsets in q.
template <typename V>
__device__ __forceinline__ void load8(const V* wb, int ws, uint4 q,
                                      float* v) {
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = to_f32(wb[(int)(u[j] & 0xffffu) * ws]);
    v[2 * j + 1] = to_f32(wb[(int)(u[j] >> 16) * ws]);
  }
}

// The sum of the weight rows at offsets lst[k..e) (times ws), added in list
// order; the next eight rows are loaded while eight are added.
template <typename V>
__device__ __forceinline__ float run_sum(const V* wb, int ws,
                                         const uint16_t* lst, int k, int e) {
  float acc = 0.f;
  for (; k < e && (k & 7); ++k) acc += to_f32(wb[(int)lst[k] * ws]);
  if (k + 8 <= e) {
    float v[8];
    load8(wb, ws, *reinterpret_cast<const uint4*>(lst + k), v);
    for (k += 8; k + 8 <= e; k += 8) {
      float n[8];
      load8(wb, ws, *reinterpret_cast<const uint4*>(lst + k), n);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc += v[j];
        v[j] = n[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[j];
  }
  for (; k < e; ++k) acc += to_f32(wb[(int)lst[k] * ws]);
  return acc;
}

// grid (column chunks of 32, row groups), blockDim.x = 32 * warps.  SMEM:
// W's chunk as float (the lists hold f * 32) and two list buffers a warp in
// shared memory; otherwise (F too large for them) W and the lists (f) are
// read where they lie.
template <typename W, bool SMEM>
__global__ void __launch_bounds__(1024)
    encode_fwd_kernel(const uint16_t* lists, const W* w, float* out, int B,
                      int F, int H, int T, int periodic) {
  extern __shared__ __align__(16) unsigned char smem[];
  using V = typename std::conditional<SMEM, float, W>::type;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int h0 = blockIdx.x * 32, h = h0 + lane;
  const bool live = h < H;
  const int row_len = list_row_len(F, T);
  const size_t wchunk = SMEM ? align16((size_t)F * 128) : 0;
  uint16_t* s_list = reinterpret_cast<uint16_t*>(smem + wchunk) +
                     (size_t)warp * 2 * row_len;

  const V* wb;
  int ws;
  if (SMEM) {
    float* s_w = reinterpret_cast<float*>(smem);
#pragma unroll 8
    for (int i = threadIdx.x; i < F * 32; i += blockDim.x) {
      const int hh = h0 + (i & 31);
      s_w[i] = hh < H ? to_f32(w[(size_t)(i >> 5) * H + hh]) : 0.f;
    }
    __syncthreads();
    wb = reinterpret_cast<const V*>(s_w + lane);
    ws = 1;
  } else {
    wb = reinterpret_cast<const V*>(w + min(h, H - 1));
    ws = H;
  }

  const int NW = gridDim.y * nw;
  int b = blockIdx.y * nw + warp;
  auto prefetch = [&](int row, int buf) {
    const uint16_t* src = lists + (size_t)row * row_len;
    uint16_t* dst = s_list + buf * row_len;
    for (int i = lane * 8; i < row_len; i += 256) cp_async16(dst + i, src + i);
  };
  if (SMEM && b < B) prefetch(b, 0);
  if (SMEM) asm volatile("cp.async.commit_group;\n" ::: "memory");
  const size_t step = (size_t)B * H;
  for (int it = 0; b < B; ++it, b += NW) {
    const uint16_t* list;
    if (SMEM) {
      if (b + NW < B) prefetch(b + NW, (it + 1) & 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncwarp();
      list = s_list + (it & 1) * row_len;
    } else {
      list = lists + (size_t)b * row_len;
    }
    const uint16_t* start = list + align8(F);
    const uint16_t* nz = start + align8(T + 2);  // count, nonempty keys
    const int nk = nz[0];
    float* o = out + (size_t)b * H + (live ? h : 0);
    if (!periodic) {
      int j = 0, kn = nk > 0 ? nz[1] : T;  // the next step with a run
      for (int t = 0; t < T; ++t) {
        float acc = 0.f;
        if (t == kn) {
          acc = run_sum(wb, ws, list, start[t], start[t + 1]);
          ++j;
          kn = j < nk ? nz[1 + j] : T;
        }
        if (live) o[t * step] = acc;
      }
    } else {
      // currents(t) = sum of S_p over the nonempty periods p dividing t, in
      // ascending p.  S_1 (period 1, every step from 1 on) comes first;
      // the other periods go in passes of KMAX held in registers, each pass
      // after the first adding onto the currents the last one stored.
      int j = 0;
      float every = 0.f;
      if (nk > 0 && nz[1] == 1) {
        every = run_sum(wb, ws, list, start[1], start[2]);
        j = 1;
      }
      bool first = true;
      do {
        float S[KMAX];
        int nxt[KMAX], per[KMAX], n = 0;
#pragma unroll
        for (int q = 0; q < KMAX; ++q) {
          nxt[q] = -1;
          per[q] = 0;
          S[q] = 0.f;
          if (j < nk) {
            const int p = nz[1 + j++];
            S[q] = run_sum(wb, ws, list, start[p], start[p + 1]);
            nxt[q] = p;  // fires at p, 2p, ..; p = 0 (T = 1) at t = 0
            per[q] = p > 0 ? p : T;
            n = q + 1;
          }
        }
        int tn = T;  // the next step where a held period fires
#pragma unroll
        for (int q = 0; q < KMAX; ++q)
          if (q < n) tn = min(tn, nxt[q]);
        for (int t = 0; t < T; ++t) {
          float acc = first ? (t > 0 ? every : 0.f) : (live ? o[t * step] : 0.f);
          if (t == tn) {
            tn = T;
#pragma unroll
            for (int q = 0; q < KMAX; ++q) {
              if (q < n && t == nxt[q]) {
                acc += S[q];
                nxt[q] += per[q];
              }
              if (q < n) tn = min(tn, nxt[q]);
            }
          }
          if (live) o[t * step] = acc;
        }
        first = false;
      } while (j < nk);
    }
    if (SMEM) __syncwarp();  // the buffer is refilled two rows on
  }
}

struct FwdPlan {
  int smem_mode, warps, groups, smem, sort_smem;
};

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
__host__ __device__ inline int align32(int x) { return (x + 31) & ~31; }

// One warp a row: key + 1 of every feature, 0 where it never fires and past
// F, in rows of align32(F) 16-bit words (a block's (R rows, G, 32) box of
// them is one TMA load); periodic, also the row's periods as a bit mask of
// MW 32-bit words.
__global__ void __launch_bounds__(256)
    encode_keys_kernel(const int* lat, uint16_t* keys, unsigned* masks, int B,
                       int F, int T, int periodic, int MW) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* m = reinterpret_cast<unsigned*>(smem) + warp * MW;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // no block barrier below
  const int KP = align32(F);
  if (periodic) {
    for (int i = lane; i < MW; i += 32) m[i] = 0u;
    __syncwarp();
  }
  for (int f = lane; f < KP; f += 32) {
    const int k = f < F ? enc_key(lat[(size_t)b * F + f], T, periodic) : -1;
    keys[(size_t)b * KP + f] = (uint16_t)(k + 1);
    if (periodic && k >= 0) atomicOr(&m[k >> 5], 1u << (k & 31));
  }
  if (periodic) {
    __syncwarp();
    for (int i = lane; i < MW; i += 32) masks[(size_t)b * MW + i] = m[i];
  }
}

struct BwdArgs {
  const float* g;
  const uint16_t* keys;
  float* slab;
  int B, F, H, T, periodic, MW;
  int R, NS, TS, TB, nbx;  // rows a batch, stages, stage rows, TMA g boxes
};

// 32-bit words of a row's mask of periods, a multiple of four (16 bytes).
__host__ __device__ inline int mask_words(int T) {
  return ((T + 31) / 32 + 3) & ~3;
}

struct BwdLayout {
  size_t key, mask, stage, S, bar, total;
};

// A stage holds the batch's g, (TS, R, 32) float, then its keys, (R, G, 32)
// uint16, and with TMA under periodic encoding the rows' masks of periods,
// (R, MW) uint32.  With TMA a stage's row k is step k - 1 (row 0 reads
// zeros, where a feature that never fires points) and the periodic S table
// has a zero row 0 too; the copy by the threads keeps rows = steps, skips
// key 0 and builds every period's S without masks, so that with R = 1 it
// needs no more shared memory than covered() allows.
__host__ __device__ inline BwdLayout bwd_layout(int R, int NS, int TS, int T,
                                                int G, int periodic,
                                                bool tma) {
  BwdLayout L;
  const size_t gb = (size_t)TS * R * 128, kb = (size_t)R * G * 64;
  const size_t mb = tma && periodic ? (size_t)R * mask_words(T) * 4 : 0;
  L.key = gb;
  L.mask = align128(gb + kb);
  L.stage = tma ? align128(L.mask + mb) : gb + kb;
  size_t off = NS * L.stage;
  L.S = off;  // periodic: S[p] of each row, (R, T + tma, 32) float
  off = align16(off + (periodic ? (size_t)R * (T + tma) * 128 : 0));
  L.bar = off;  // one mbarrier a stage, with TMA
  L.total = align16(off + (tma ? (size_t)NS * 8 : 0));
  return L;
}

// Thread 0: TMA batch q (rows q R ..) into stage `st`, completing on `bar`:
// g's (TS, R, 32) box from step -1 at columns h0 .. and the keys' (R, G, 32)
// box of feature groups g0 ..  Rows past B, steps outside [0, T), columns
// past H and features past F read zeros.
__device__ __forceinline__ void issue_batch(const CUtensorMap* gmap,
                                            const CUtensorMap* kmap,
                                            const CUtensorMap* mmap,
                                            unsigned char* st,
                                            const BwdLayout& L, uint64_t* bar,
                                            const BwdArgs& a, int G, int q,
                                            int h0, int g0) {
  const uint32_t b = smem_u32(bar);
  mbar_expect(bar, (uint32_t)(a.TS * a.R * 128 + a.R * G * 64 +
                              (a.periodic ? a.R * a.MW * 4 : 0)));
  for (int i = 0; i < a.nbx; ++i)
    tma_3d(st + (size_t)i * a.TB * a.R * 128, gmap, bar, h0, q * a.R,
           i * a.TB - 1);
  tma_3d(st + L.key, kmap, bar, 0, g0, q * a.R);
  if (a.periodic)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(st + L.mask)),
        "l"(reinterpret_cast<uint64_t>(mmap)), "r"(b), "r"(0), "r"(q * a.R)
        : "memory");
}

// S[p] = g(p) + g(2p) + .. of the R rows of a stage, into the table Sb (S[0]
// = g(0) serves T = 1): for the periods set in the rows' masks (R, MW), or
// for every period where mask is null.  The (row, period) sums are dealt to
// the warps in turn, so the long sums of the small periods of the R rows
// fall to different warps.
template <int OFF>
__device__ __forceinline__ void build_S(const float* sg, const unsigned* mask,
                                        int MW, float* Sb, int R, int T,
                                        int G, int gy, int x) {
  int turn = 0;
  for (int r = 0; r < R; ++r) {
    for (int wd = 0; wd < (mask ? MW : (T + 31) / 32); ++wd) {
      unsigned bits = mask ? mask[r * MW + wd] : 0xffffffffu;
      while (bits) {
        const int p = (wd << 5) + __ffs(bits) - 1;
        bits &= bits - 1u;
        if (p >= T || (p == 0 && T >= 2)) continue;  // no such period
        const bool mine = turn == gy;
        if (++turn == G) turn = 0;
        if (!mine) continue;
        const float* col = sg + (OFF * R + r) * 32 + x;
        Sb[(r * (T + OFF) + p + OFF) * 32 + x] =
            p == 0 ? col[0] : period_sum(col, R * 32, p, T);
      }
    }
  }
}

// grid (row groups, feature chunks of G * NACC, column chunks of 32); thread
// (x, g) owns the features f0 + NACC g + i, i < NACC, of column h0 + x.
// Batch j: each thread waits for its stage and gathers (periodic encoding
// after building the S table, then a block barrier); one block barrier a
// batch frees the stage for batch j + NS.
template <bool TMA>
__global__ void __launch_bounds__(1024)
    encode_bwd_kernel(const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap mmap, BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int OFF = TMA ? 1 : 0;  // a table's row of step t is t + OFF
  const int G = blockDim.y, x = threadIdx.x, gy = threadIdx.y;
  const int tid = gy * 32 + x, nthreads = 32 * G;
  const int f0 = blockIdx.y * nthreads, h0 = blockIdx.z * 32;
  const int R = a.R, NS = a.NS, T = a.T, B = a.B, periodic = a.periodic;
  const int lgR = __ffs(R) - 1;  // R is 1, 2 or 4
  const BwdLayout L = bwd_layout(R, NS, a.TS, T, G, periodic, TMA);
  float* s_S = reinterpret_cast<float*>(smem + L.S);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int nb = (B + R - 1) / R, SR = T + OFF, KP = align32(a.F);

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  if (TMA && periodic)
    for (int i = tid; i < R * 32; i += nthreads)
      s_S[(i >> 5) * SR * 32 + (i & 31)] = 0.f;  // row 0 of each row
  if (TMA && tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(s_full + s);
    mbar_fence_init();
  }
  __syncthreads();
  if (TMA && tid == 0)
    for (int s = 0; s < NS; ++s) {
      const int q = blockIdx.x + s * gridDim.x;
      if (q < nb)
        issue_batch(&gmap, &kmap, &mmap, smem + s * L.stage, L, s_full + s,
                    a, G, q, h0, blockIdx.y * G);
    }

  for (int q = blockIdx.x, j = 0; q < nb; q += gridDim.x, ++j) {
    const int s = j % NS;
    unsigned char* st = smem + s * L.stage;
    float* sg = reinterpret_cast<float*>(st);
    const uint16_t* sk = reinterpret_cast<const uint16_t*>(st + L.key);
    if (TMA) {
      mbar_wait(s_full + s, (j / NS) & 1);
    } else {
      for (int i = tid; i < T * R * 32; i += nthreads) {
        const int t = i >> (lgR + 5), r = (i >> 5) & (R - 1);
        const int hh = h0 + (i & 31);
        const int b = q * R + r;
        sg[i] = (b < B && hh < a.H) ? a.g[((size_t)t * B + b) * a.H + hh]
                                    : 0.f;
      }
      uint16_t* kw = reinterpret_cast<uint16_t*>(st + L.key);
      for (int r = 0; r < R; ++r) {
        const int b = q * R + r;
        kw[r * nthreads + tid] =
            (b < B && f0 + tid < KP) ? a.keys[(size_t)b * KP + f0 + tid] : 0;
      }
      __syncthreads();
    }
    const float* tab = sg;
    int kstride = R * 32, rstride = 32;
    if (periodic) {
      build_S<OFF>(sg, TMA ? reinterpret_cast<const unsigned*>(st + L.mask)
                           : nullptr,
                   a.MW, s_S, R, T, G, gy, x);
      __syncthreads();
      tab = s_S;
      kstride = 32;
      rstride = SR * 32;
    }
    // One gathered table entry a (row, feature); with TMA key 0 reads the
    // zero row.
    for (int r = 0; r < R; ++r) {
      const uint4* kq =
          reinterpret_cast<const uint4*>(sk + r * nthreads + gy * NACC);
      const float* trow = tab + r * rstride + x;
#pragma unroll
      for (int c = 0; c < NACC / 8; ++c) {
        const uint4 kk = kq[c];
        const unsigned u[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int j2 = 0; j2 < 8; ++j2) {
          const int k = (u[j2 >> 1] >> (16 * (j2 & 1))) & 0xffff;
          if (!TMA && k == 0) continue;
          acc[c * 8 + j2] += trow[(k - 1 + OFF) * kstride];
        }
      }
    }
    __syncthreads();  // the stage and the S table read are free
    if (TMA && tid == 0) {
      const int qn = q + NS * gridDim.x;
      if (qn < nb)
        issue_batch(&gmap, &kmap, &mmap, st, L, s_full + s, a, G, qn, h0,
                    blockIdx.y * G);
    }
  }
  const int h = h0 + x;
  if (h < a.H) {
    float* out = a.slab + (size_t)blockIdx.x * a.F * a.H;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int f = f0 + gy * NACC + i;
      if (f < a.F) out[(size_t)f * a.H + h] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Plans
// ---------------------------------------------------------------------------
// The shapes the encoded product takes, by a fixed shared-memory rule: one
// row's latencies and firing list as 16-bit words, and one row's (T, 32)
// float32 table (two periodic) beside a chunk's 16-bit keys, within one
// block.  encode_matmul_supported (and with it the models' dispatch) reads
// this rule, not the plans below, which fit every shape it admits.
bool covered(int F, int H, int T, int periodic, const Limits& lim) {
  if (H < 1 || F < 1 || T < 1 || F > 65535 || (H + 31) / 32 * 32 > 1024)
    return false;
  const int G = (F + NACC - 1) / NACC < 32 ? (F + NACC - 1) / NACC : 32;
  const size_t fwd = 2 * align16((size_t)F * 2) + 16;
  const size_t bwd = (periodic ? 2 : 1) * align16((size_t)T * 128) +
                     align16((size_t)G * NACC * 2) +
                     (periodic ? align16((size_t)T) : 0);
  return fwd <= (size_t)lim.max_smem && bwd <= (size_t)lim.max_smem;
}

FwdPlan fwd_plan(int B, int F, int H, int T, const Limits& lim) {
  FwdPlan p;
  const size_t wchunk = align16((size_t)F * 128);
  const size_t per_warp = 4 * (size_t)list_row_len(F, T);
  const size_t warps = (size_t)lim.max_smem > wchunk
                           ? ((size_t)lim.max_smem - wchunk) / per_warp
                           : 0;
  p.smem_mode = warps >= 4 && F * 32 <= 65535;  // offsets f * 32 in 16 bits
  p.warps = p.smem_mode && warps < 32 ? (int)warps : 32;
  p.smem = p.smem_mode ? (int)(wchunk + p.warps * per_warp) : 0;
  p.groups = row_groups(lim.sms, lim.sm_smem, p.smem, 32 * p.warps,
                        (H + 31) / 32, (B + p.warps - 1) / p.warps);
  p.sort_smem = 8 * (T + 1) * 4;
  return p;
}

struct BwdPlan {
  int G, n_f, n_h, R, NS, TS, TB, nbx, smem, groups;
  bool tma;
};

int bwd_plan(int B, int F, int H, int T, int periodic, const Limits& lim,
             BwdPlan* p) {
  p->G = (F + NACC - 1) / NACC < 32 ? (F + NACC - 1) / NACC : 32;
  p->n_f = (F + p->G * NACC - 1) / (p->G * NACC);
  p->n_h = (H + 31) / 32;
  p->nbx = (T + 1 + 255) / 256;  // a TMA box takes at most 256 steps
  p->TB = (T + 1 + p->nbx - 1) / p->nbx;
  p->NS = 0;
  p->tma = H % 4 == 0;  // TMA needs 16-byte row strides
  if (p->tma) {
    const int cand[6][2] = {{4, 4}, {4, 3}, {4, 2}, {2, 3}, {2, 2}, {1, 2}};
    for (const auto& c : cand) {  // (R, NS)
      const size_t smem =
          bwd_layout(c[0], c[1], p->nbx * p->TB, T, p->G, periodic, true)
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
    for (p->R = RMAX; p->R >= 1; p->R /= 2) {
      const size_t smem =
          bwd_layout(p->R, 1, T, T, p->G, periodic, false).total;
      if (smem <= (size_t)lim.max_smem) {
        p->NS = 1;
        p->TS = T;
        p->smem = (int)smem;
        break;
      }
    }
    if (p->NS == 0) return 1;
  }
  p->groups = row_groups(lim.sms, lim.sm_smem, p->smem, 32 * p->G,
                         p->n_f * p->n_h, (B + p->R - 1) / p->R);
  return 0;
}

template <typename W>
cudaError_t launch_fwd(const int* lat, const void* w, float* out,
                       uint16_t* lists, int B, int F, int H, int T,
                       int periodic, const FwdPlan& p, cudaStream_t s) {
  cudaError_t err = opt_in(encode_sort_kernel, p.sort_smem);
  if (err != cudaSuccess) return err;
  encode_sort_kernel<<<(B + 7) / 8, 256, p.sort_smem, s>>>(
      lat, lists, B, F, T, periodic, p.smem_mode ? 32 : 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((H + 31) / 32, p.groups);
  const W* wt = static_cast<const W*>(w);
  if (p.smem_mode) {
    err = opt_in(encode_fwd_kernel<W, true>, p.smem);
    if (err != cudaSuccess) return err;
    encode_fwd_kernel<W, true><<<grid, 32 * p.warps, p.smem, s>>>(
        lists, wt, out, B, F, H, T, periodic);
  } else {
    err = opt_in(encode_fwd_kernel<W, false>, p.smem);
    if (err != cudaSuccess) return err;
    encode_fwd_kernel<W, false><<<grid, 32 * p.warps, p.smem, s>>>(
        lists, wt, out, B, F, H, T, periodic);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[0] = 16-bit words of the forward's scratch a batch row, out[1] =
// blocks of g_W slabs of the backward, out[2] = 16-bit words of the
// backward's scratch a batch row (its keys, then its mask of periods).  Returns 0 when the shape fits, 1 when it
// does not, or a CUDA error code.
int snn_encode_plan(int B, int F, int H, int T, int periodic, int device,
                    int* out) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  if (!covered(F, H, T, periodic, lim)) return 1;
  BwdPlan p;
  if (bwd_plan(B, F, H, T, periodic, lim, &p) != 0) return 1;
  out[0] = list_row_len(F, T);
  out[1] = p.groups;
  out[2] = align32(F) + 2 * mask_words(T);
  return 0;
}

// currents (T, B, H) float32 from latencies (B, F) and W (F, H); `lists` is
// scratch of B * out[0] 16-bit words (snn_encode_plan).
int snn_encode_fwd(const int* lat, const void* w, float* out, void* lists,
                   int B, int F, int H, int T, int periodic, int bf16,
                   int device, void* stream) {
  if (B == 0) return 0;
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  if (!covered(F, H, T, periodic, lim))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdPlan p = fwd_plan(B, F, H, T, lim);
  uint16_t* l = static_cast<uint16_t*>(lists);
  err = bf16 ? launch_fwd<__nv_bfloat16>(lat, w, out, l, B, F, H, T,
                                         periodic, p, s)
             : launch_fwd<float>(lat, w, out, l, B, F, H, T, periodic, p, s);
  return (int)err;
}

// g_W's slabs (groups, F * H) float32 from latencies (B, F) and the
// cotangent g (T, B, H) float32, 16-byte aligned; `keys` is scratch of B *
// out[2] 16-bit words and `groups` out[1] (snn_encode_plan).
int snn_encode_bwd(const int* lat, const float* g, void* keys, float* slab,
                   int B, int F, int H, int T, int periodic, int groups,
                   int device, void* stream) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  BwdPlan p;
  if (!covered(F, H, T, periodic, lim) ||
      bwd_plan(B, F, H, T, periodic, lim, &p) != 0)
    return (int)cudaErrorInvalidConfiguration;
  if (groups != p.groups) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) {
    return (int)cudaMemsetAsync(slab, 0, (size_t)groups * F * H * 4, s);
  }
  const int KP = align32(F), MW = mask_words(T);
  uint16_t* k = static_cast<uint16_t*>(keys);
  unsigned* m = reinterpret_cast<unsigned*>(k + (size_t)B * KP);
  encode_keys_kernel<<<(B + 7) / 8, 256, 8 * MW * 4, s>>>(lat, k, m, B, F, T,
                                                          periodic, MW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap gmap, kmap, mmap;
  memset(&gmap, 0, sizeof(gmap));
  memset(&kmap, 0, sizeof(kmap));
  memset(&mmap, 0, sizeof(mmap));
  if (p.tma) {
    if (reinterpret_cast<uintptr_t>(g) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint32_t estr[3] = {1, 1, 1};
    const cuuint64_t gdims[3] = {(cuuint64_t)H, (cuuint64_t)B,
                                 (cuuint64_t)T};
    const cuuint64_t gstrides[2] = {(cuuint64_t)H * 4,
                                    (cuuint64_t)B * H * 4};
    const cuuint32_t gbox[3] = {32, (cuuint32_t)p.R, (cuuint32_t)p.TB};
    CUresult rc = encode(&gmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                         const_cast<float*>(g), gdims, gstrides, gbox, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    const cuuint64_t kdims[3] = {32, (cuuint64_t)KP / 32, (cuuint64_t)B};
    const cuuint64_t kstrides[2] = {64, (cuuint64_t)KP * 2};
    const cuuint32_t kbox[3] = {32, (cuuint32_t)p.G, (cuuint32_t)p.R};
    rc = encode(&kmap, CU_TENSOR_MAP_DATA_TYPE_UINT16, 3, k, kdims, kstrides,
                kbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    if (periodic) {
      const cuuint64_t mdims[2] = {(cuuint64_t)MW, (cuuint64_t)B};
      const cuuint64_t mstrides[1] = {(cuuint64_t)MW * 4};
      const cuuint32_t mbox[2] = {(cuuint32_t)MW, (cuuint32_t)p.R};
      rc = encode(&mmap, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, m, mdims,
                  mstrides, mbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (rc != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    }
  }
  BwdArgs a{g,       k,   slab, B,    F,    H,    T,    periodic,
            MW,      p.R, p.NS, p.TS, p.TB, p.nbx};
  const dim3 grid(groups, p.n_f, p.n_h), block(32, p.G);
  if (p.tma) {
    err = opt_in(encode_bwd_kernel<true>, p.smem);
    if (err != cudaSuccess) return (int)err;
    encode_bwd_kernel<true><<<grid, block, p.smem, s>>>(gmap, kmap, mmap, a);
  } else {
    err = opt_in(encode_bwd_kernel<false>, p.smem);
    if (err != cudaSuccess) return (int)err;
    encode_bwd_kernel<false><<<grid, block, p.smem, s>>>(gmap, kmap, mmap,
                                                         a);
  }
  return (int)cudaGetLastError();
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
