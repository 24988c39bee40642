// The tensor-core body of the head forwards and of the first layers of
// deeper networks (fused_head.cu for LIF/ALIF: fused_head_fwd[_train],
// fused_layer0_fwd; fused_izh.cu for Izhikevich: fused_izh_fwd[_train],
// fused_izh_layer0_fwd), one template over a cell policy: the rows' feature
// lists (head_sort_kernel) and the kernel (head_mma_kernel) that steps the
// cell with its recurrent and readout products on tensor cores.  A first
// layer (HEAD = false) is the head without its readout: no W_out pieces,
// T steps, z(t) written to device memory from the tile's exchange buffer.
//
// What bounds it on an H100: the serial T-chain.  One add per selected
// weight (spikes are 0/1) is ~10 G operations a flagship training batch,
// 0.15 ms at the float32 rate; each step depends on the one before, so the
// kernel is bound by the latency of a step, which it keeps on tensor cores
// and in registers.
//   * A warp owns 16 rows x 32 units in registers (head_mma.cuh), the cell's
//     state in the accumulator layout.  The recurrent current is one (16, H)
//     @ (H, 32) product a step and warp, z(t-1) as the A operand read by
//     ldmatrix from the tile's exchange buffer, W_rec's B fragments from
//     shared memory, filled once a block in the order the lanes read them.
//     The readout is (16, H) @ (H, 16) on the same A fragments, its two n8
//     tiles on the tile's first warps; its integrator, running max and
//     argmax step stay in their registers.  Float32 weights take three
//     products (hi, mid, lo bf16 pieces), bf16 weights one.  One named
//     barrier a step among the tile's warps.
//   * The input current: head_sort_kernel orders each row's features by
//     spike key once (a stable counting sort, one warp a row, shared by the
//     replicas), so step t's features are a contiguous run (TTFS: the run of
//     key t; periodic: the runs of the periods dividing t), summed in
//     ascending f from W_in in L2.  Under periodic encoding the run of
//     period 1 fires at every t >= 1 and is summed once.  A row that fires
//     at least F / 16 features at a TTFS step (at the production tau every
//     supra-threshold pixel fires at t = 0) takes them through a dense
//     product instead: X @ W_in on tensor cores, W_in's slice read once for
//     the tile, not once a row, the other rows' spikes zero.  The choice is
//     each row's own, so a row's bits do not depend on its batch.
//   * The cell step is the policy's (lif_cell.cuh:LifMmaCell,
//     izh_cell.cuh:IzhMmaCell), the arithmetic of the per-unit body's cell;
//     built with --fmad=false, so a*b+c rounds twice, as in the plain
//     PyTorch versions.  The training traces are the policy's too.
//   * Stacked replicas: grid axis y, a block offsets its weights, outputs
//     and traces by its replica's stride (head_fwd.cuh:at_replica).
// It takes O <= 16 (O = 0: a first layer), H <= 256 and W_rec's bf16
// pieces within a block's shared memory (mma_fits); the per-unit body
// (head_fwd.cuh) the rest.
#pragma once

#include "head_fwd.cuh"
#include "head_mma.cuh"

namespace {

// The rows' feature lists
__host__ __device__ inline int align8(int x) { return (x + 7) & ~7; }

// A row of the lists, in 16-bit words: the features that fire at some step,
// ordered by key (head_common.cuh:enc_key), ascending f within a key; at
// FA = align8(F) the number nk of nonempty keys; at FA + 8 those keys,
// ascending; at 2 FA + 8 the end of each key's run (run c is [end[c - 1],
// end[c]), end[-1] = 0).  ops/head_mma.py:head_lists is its CPU twin.
__host__ __device__ inline int list_row_words(int F) {
  return 3 * align8(F) + 8;
}

// One warp a row: a stable counting sort of the row's features by key.
__global__ void __launch_bounds__(256)
    head_sort_kernel(const int* lat, uint16_t* lists, int B, int F, int T,
                     int periodic) {
  extern __shared__ __align__(16) int sort_cnt[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;  // no block barrier below
  int* cnt = sort_cnt + (size_t)warp * T;
  const int* lrow = lat + (size_t)b * F;
  const int FA = align8(F);
  uint16_t* list = lists + (size_t)b * list_row_words(F);
  uint16_t* keys = list + FA + 8;
  uint16_t* ends = keys + FA;
  for (int k = lane; k < T; k += 32) cnt[k] = 0;
  __syncwarp();
  for (int f = lane; f < F; f += 32) {
    const int k = enc_key(lrow[f], T, periodic);
    if (k >= 0) atomicAdd(&cnt[k], 1);
  }
  __syncwarp();
  // Run starts (the exclusive prefix sum of the counts), the nonempty keys
  // and their runs' ends.
  int carry = 0, n = 0;
  for (int k0 = 0; k0 < T; k0 += 32) {
    const int k = k0 + lane;
    const int c = k < T ? cnt[k] : 0;
    int x = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (k < T) cnt[k] = carry + x - c;
    const unsigned used = __ballot_sync(0xffffffffu, c > 0);
    if (c > 0) {
      const int i = n + __popc(used & ((1u << lane) - 1u));
      keys[i] = (uint16_t)k;
      ends[i] = (uint16_t)(carry + x);
    }
    n += __popc(used);
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) list[FA] = (uint16_t)n;
  __syncwarp();
  // Features in ascending f, each after the earlier ones of its key.
  for (int f0 = 0; f0 < F; f0 += 32) {
    const int f = f0 + lane;
    const int k = f < F ? enc_key(lrow[f], T, periodic) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    if (k >= 0)
      list[cnt[k] + __popc(peers & ((1u << lane) - 1u))] = (uint16_t)f;
    __syncwarp();
    if (k >= 0 && lane == __ffs(peers) - 1) cnt[k] += __popc(peers);
    __syncwarp();
  }
}

cudaError_t launch_sort(const int* lat, uint16_t* lists, int B, int F, int T,
                        int periodic, int device, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t per_warp = (size_t)T * 4;
  size_t warps = (size_t)max_smem / per_warp;
  if (warps > 8) warps = 8;
  if (warps < 1) return cudaErrorInvalidConfiguration;
  const int smem = (int)(warps * per_warp);
  err = cudaFuncSetAttribute(head_sort_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  head_sort_kernel<<<(B + (int)warps - 1) / (int)warps, (int)warps * 32, smem,
                     stream>>>(lat, lists, B, F, T, periodic);
  return cudaGetLastError();
}

// The kernel's shared memory, its shape limits and its input sums
struct MmaFwdLayout {
  size_t wrec, wout, b, z, total;
};

// A first layer (head = 0) has no W_out or b_out.
__host__ __device__ inline MmaFwdLayout mma_fwd_layout(int H, int rec, int P,
                                                       int tpb, int head) {
  const size_t HP = mma_hp(H);
  MmaFwdLayout L;
  size_t off = 0;
  L.wrec = off;  // W_rec's B fragments, (HP, HP), P pieces
  off = align16(off + (rec ? 2 * P * HP * HP : 0));
  L.wout = off;  // W_out's, (HP, 16)
  off = align16(off + (head ? 2 * P * HP * MMA_OMAX : 0));
  L.b = off;
  off = align16(off + (head ? MMA_OMAX * 4 : 0));
  L.z = off;  // each tile's two (16, HP) bf16 buffers of z
  off = align16(off + (size_t)tpb * 2 * 16 * mma_zs(HP) * 2);
  L.total = off;
  return L;
}

// Whether the mma body takes the shape (O == 0: a first layer) on a card
// with `max_smem` bytes of shared memory a block.
inline bool mma_fits(int H, int O, int rec, int bf16, int max_smem) {
  return O >= 0 && O <= MMA_OMAX && H >= 1 && mma_hp(H) <= MMA_HMAX &&
         mma_fwd_layout(H, rec, bf16 ? 1 : 3, 1, O > 0).total <=
             (size_t)max_smem;
}

__device__ __forceinline__ void load_pair(const float* p, float& x0,
                                          float& x1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x0 = v.x;
  x1 = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& x0,
                                          float& x1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  x0 = __low2float(v);
  x1 = __high2float(v);
}

// acc[n][2 hh + c] += w[f, col0 + 8 n + c] for the features f = lst[k..e),
// one at a time in list order; columns past H add nothing.
template <typename W>
__device__ __forceinline__ void gather_rows(float (&acc)[MMA_NT][4], int hh,
                                            const W* w, int H, int col0,
                                            const uint16_t* lst, int k,
                                            int e) {
  if ((H & 1) == 0) {  // pairs of columns, 4- or 8-byte aligned
#pragma unroll 4
    for (; k < e; ++k) {
      const W* wr = w + (size_t)lst[k] * H + col0;
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n) {
        if (col0 + 8 * n < H) {
          float x0, x1;
          load_pair(wr + 8 * n, x0, x1);
          acc[n][2 * hh] += x0;
          acc[n][2 * hh + 1] += x1;
        }
      }
    }
  } else {
    for (; k < e; ++k) {
      const W* wr = w + (size_t)lst[k] * H;
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n) {
        const int c = col0 + 8 * n;
        if (c < H) acc[n][2 * hh] += to_f32(wr[c]);
        if (c + 1 < H) acc[n][2 * hh + 1] += to_f32(wr[c + 1]);
      }
    }
  }
}

constexpr int NO_KEY = 1 << 30;

// The runs of list row `lrow` that fire at step t, the run of every step
// aside, each as fn(start, end), in the order they are summed.  TTFS: the
// run of key t (keys ascending; `cursor` the next run, `next` its key, kept
// in a register so that a step without input waits on no load); periodic:
// the runs of the periods p <= t dividing t, ascending p (p = 0 at T = 1:
// every step), from run `cursor` (past the every-step run) whose key is
// `next`.
template <typename Fn>
__device__ __forceinline__ void step_runs(const uint16_t* lrow, int FA, int nk,
                                          int cursor, int next, int t,
                                          int periodic, Fn fn) {
  if (next > t) return;
  const uint16_t* keys = lrow + FA + 8;
  const uint16_t* ends = keys + FA;
  if (!periodic) {
    fn(cursor ? ends[cursor - 1] : 0, ends[cursor]);
    return;
  }
  for (int c = cursor; c < nk; ++c) {
    const int p = keys[c];
    if (p > t) break;
    if (p == 0 || t % p == 0) fn(c ? ends[c - 1] : 0, ends[c]);
  }
}

// After step t under TTFS: the cursor past the run of key t.
__device__ __forceinline__ void advance(const uint16_t* lrow, int FA, int nk,
                                        int& cursor, int& next, int t,
                                        int periodic) {
  if (periodic || next != t) return;
  ++cursor;
  next = cursor < nk ? lrow[FA + 8 + cursor] : NO_KEY;
}

// Two spikes of one row as a bf16x2 word: features f and f + 1 of latency
// row l (null: a row past the batch) where `pick` takes their latency.
template <typename Pick>
__device__ __forceinline__ uint32_t spike_pair(const int* l, int f, int F,
                                               Pick pick) {
  if (!l) return 0u;
  const bool a = f < F && pick(l[f]);
  const bool b = f + 1 < F && pick(l[f + 1]);
  return (a ? 0x3f80u : 0u) | (b ? 0x3f800000u : 0u);
}

// acc += X @ W_in[:, this warp's 32 units] on tensor cores, X[r, f] =
// pick(L[r, f]) for the tile's rows r that take it (use[hh]: this lane's
// rows g and g + 8), zero for the others: a row where most features fire
// at a step (TTFS at the production tau fires every supra-threshold pixel
// at t = 0) reads W_in's slice once for the tile instead of once a row.  A
// row's sums depend on its own spikes only.  The spikes come from the
// latencies, W_in's B fragments from L2, split into P pieces in registers,
// one k16 slice at a time.
template <int P, typename W, typename Pick>
__device__ void dense_input(float (&acc)[MMA_NT][4], const int* lat, int F,
                            int row0, const bool (&use)[2], const W* w, int H,
                            int lane, int wu, Pick pick) {
  const int g = lane >> 2, q = lane & 3;
  const int* l0 = use[0] ? lat + (size_t)(row0 + g) * F : nullptr;
  const int* l1 = use[1] ? lat + (size_t)(row0 + g + 8) * F : nullptr;
  const int col = MMA_NU * wu + g;  // B's column of n8 tile 0
  for (int k0 = 0; k0 < F; k0 += 16) {
    const int f = k0 + 2 * q;
    const uint32_t a[4] = {spike_pair(l0, f, F, pick),
                           spike_pair(l1, f, F, pick),
                           spike_pair(l0, f + 8, F, pick),
                           spike_pair(l1, f + 8, F, pick)};
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n) {
      const int c = col + 8 * n;
      float x[4][P];
      const int fk[4] = {f, f + 1, f + 8, f + 9};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split<P>(fk[i] < F && c < H ? to_f32(w[(size_t)fk[i] * H + c]) : 0.f,
                 x[i]);
      uint2 b[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        b[p] = make_uint2(pack_bf16(x[0][p], x[1][p]),
                          pack_bf16(x[2][p], x[3][p]));
      mma_exact<P>(acc[n], a, b);
    }
  }
}

// The input current of an encoded layer on the tensor-core body (the
// head's, and layer 0 of fused2.cu's two-layer body), for the lane's rows
// g and g + 8 of a tile at row0 and its 32-unit slice at col0: each row's
// sorted feature list (head_sort_kernel), its cursor into the runs, and
// under periodic encoding the sum of the every-step run's weight rows,
// taken once.
template <int P, typename W>
struct ListInput {
  const uint16_t* lrow[2];
  int nk[2], cursor[2], next[2];
  int FA;
  bool every_step;
  float every[MMA_NT][4];

  template <class A>
  __device__ void start(const A& a, const uint16_t* lists,
                        const bool (&live)[2], int row0, int lane, int col0) {
    const int g = lane >> 2, F = a.F, T = a.T, periodic = a.periodic;
    const int H = a.H;
    const W* w_in = static_cast<const W*>(a.w_in);
    FA = align8(F);
    every_step = periodic && T >= 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + g + 8 * hh;
      lrow[hh] = lists + (size_t)(live[hh] ? row : 0) * list_row_words(F);
      nk[hh] = live[hh] ? lrow[hh][FA] : 0;
      const uint16_t* keys = lrow[hh] + FA + 8;
      cursor[hh] = every_step && nk[hh] > 0 && keys[0] == 1 ? 1 : 0;
      next[hh] = cursor[hh] < nk[hh] ? keys[cursor[hh]] : NO_KEY;
    }
    // Periodic encoding: the weight rows of the features of period 1
    // (every step t >= 1; the first run where present) are summed once and
    // added first at each step.
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) every[n][e] = 0.f;
    if (every_step) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (cursor[hh])
          gather_rows(every, hh, w_in, H, col0, lrow[hh], 0,
                      lrow[hh][2 * FA + 8]);
    }
  }

  // cur = the input current of step t; then the cursors move past it.
  template <class A>
  __device__ void current(float (&cur)[MMA_NT][4], int t, const A& a,
                          int row0, int lane, int wu, int col0) {
    const int F = a.F, periodic = a.periodic, H = a.H;
    const int* lat = a.lat;
    const W* w_in = static_cast<const W*>(a.w_in);
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[n][e] = t >= 1 ? every[n][e] : 0.f;
    // TTFS: a row that fires at least F / 16 features at step t takes the
    // dense product, the others gather; the choice is the row's own.
    // (Periodic steps past the every-step run, a few periods each, gather:
    // their spike test, a division a feature, costs the dense product more
    // than it saves.)
    bool dense[2] = {false, false};
    if (!periodic) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        int n = 0;
        step_runs(lrow[hh], FA, nk[hh], cursor[hh], next[hh], t, 0,
                  [&](int k, int e) { n += e - k; });
        dense[hh] = 16 * n >= F;
      }
    }
    if (__any_sync(0xffffffffu, dense[0] || dense[1]))
      dense_input<P>(cur, lat, F, row0, dense, w_in, H, lane, wu,
                     [=](int L) { return L == t; });
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (!dense[hh])
        step_runs(lrow[hh], FA, nk[hh], cursor[hh], next[hh], t, periodic,
                  [&](int k, int e) {
                    gather_rows(cur, hh, w_in, H, col0, lrow[hh], k, e);
                  });
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      advance(lrow[hh], FA, nk[hh], cursor[hh], next[hh], t, periodic);
  }
};

// The input current of a layer whose currents are given (izh_scan.cu: the
// currents z_in @ W_in of all steps, one torch.matmul outside the kernel),
// a.cur (T, B, H) float32: the lane's entries of rows g and g + 8 and its
// units in the accumulator layout, two adjacent units a load where H is
// even and the rows 8-byte aligned, step t + 1's loaded while step t
// computes (as chain_mma.cuh's z-layer policies load g_z).
struct DenseCurrent {
  const float* at[2];  // rows g, g + 8 at step 0, unit col0; null past B
  size_t step;         // B H
  int H, T, col0;
  bool pair;
  float nxt[MMA_NT][4];

  __device__ void load(int t) {
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = col0 + 8 * n;
        float x0 = 0.f, x1 = 0.f;
        if (at[hh] && c < H) {
          const float* p = at[hh] + (size_t)t * step + 8 * n;
          if (pair) {
            load_pair(p, x0, x1);
          } else {
            x0 = p[0];
            if (c + 1 < H) x1 = p[1];
          }
        }
        nxt[n][2 * hh] = x0;
        nxt[n][2 * hh + 1] = x1;
      }
  }

  template <class A>
  __device__ void start(const A& a, const uint16_t*, const bool (&live)[2],
                        int row0, int lane, int col0_) {
    H = a.H;
    T = a.T;
    col0 = col0_;
    step = (size_t)a.B * H;
    pair = (H & 1) == 0 && reinterpret_cast<uintptr_t>(a.cur) % 8 == 0;
    const int g = lane >> 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      at[hh] = live[hh] ? a.cur + (size_t)(row0 + g + 8 * hh) * H + col0
                        : nullptr;
    load(0);
  }

  template <class A>
  __device__ void current(float (&cur)[MMA_NT][4], int t, const A&, int,
                          int, int, int) {
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[n][e] = nxt[n][e];
    if (t + 1 < T) load(t + 1);
  }
};

// z(t) of a tile, as its exchange buffer holds it after the step's barrier
// (bf16 1 or 0, row stride zs), to device memory: the tile's rows are one
// contiguous block of rows x H elements of a (T, B, H) array, written by
// the layer's n threads (thread i) in 16-byte stores where H is a multiple
// of the elements a store holds (each thread's stores fixed for the launch,
// their offsets packed once), else one element a store.
template <typename Z>
struct TileStore {
  static constexpr int VEC = 16 / sizeof(Z);  // elements a 16-byte store
  static constexpr int NC = 16 / VEC;  // stores a thread and step, at most
  uint32_t off[NC];  // buffer offset << 16 | offset in the block; ~0u: none
  bool vec;
  int rows, H, zs, i, n;

  __device__ TileStore(int H_, int zs_, int rows_, int i_, int n_)
      : vec(H_ % VEC == 0), rows(rows_), H(H_), zs(zs_), i(i_), n(n_) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int e = (i + k * n) * VEC;
      const int r = e / H;
      off[k] = vec && e < rows * H
                   ? (uint32_t)(r * zs + e - r * H) << 16 | (uint32_t)e
                   : ~0u;
    }
  }

  __device__ __forceinline__ void put(Z* z, const uint16_t* buf) const {
    if (!vec) {
      for (int e = i; e < rows * H; e += n) {
        const int r = e / H;
        put1(z + e, buf[r * zs + e - r * H]);
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (off[k] != ~0u) put16(z + (off[k] & 0xffffu), buf + (off[k] >> 16));
  }

  static __device__ __forceinline__ void put1(float* d, uint16_t b) {
    *d = __uint_as_float((uint32_t)b << 16);
  }
  static __device__ __forceinline__ void put1(__nv_bfloat16* d, uint16_t b) {
    *d = __ushort_as_bfloat16(b);
  }
  static __device__ __forceinline__ void put16(float* d, const uint16_t* s) {
    const uint2 v = *reinterpret_cast<const uint2*>(s);
    *reinterpret_cast<float4*>(d) = make_float4(
        __uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
        __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
  static __device__ __forceinline__ void put16(__nv_bfloat16* d,
                                               const uint16_t* s) {
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
  }
};

// A cell of the tensor-core body.  The body keeps one State a (row, unit)
// entry of the warp's tile, in registers in the accumulator layout
// (head_mma.cuh), and calls
//   Cell(const Params&)                    the launch's constants (ALIF's
//                                          beta);
//   State start(const Params&)             the state before step 0;
//   bool step(const Params&, State&, cur, zp)
//                                          one step from the input current
//                                          and the entry's spike at t-1,
//                                          returning its spike at t;
//   store<W>(Params, s0, s1, at, two)      the training traces of entries
//                                          (row, unit) and (row, unit + 1)
//                                          at element `at` of a (T, B, H)
//                                          array; `two`: the second unit
//                                          lies inside H;
//   z_out<W>(Params)                       a first layer's spike trace z
//                                          (T, B, H), or null.
// lif_cell.cuh:LifMmaCell is the LIF/ALIF cell, izh_cell.cuh:IzhMmaCell the
// Izhikevich one.
//
// The steps of one encoded layer on the tensor-core body, for the lane's
// rows g and g + 8 of the tile at row0 and the 32 units of its warp wu (of
// the layer's NWU); the tile's warps meet at named barrier `tsync` over
// `tn` threads once a step.  HEAD: the readout on W_out's and b_out's
// pieces (s_wout, s_b), T + 1 iterations (the last the readout of step T -
// 1), then the logits (and tstar) written.  A first layer (!HEAD): T
// steps, no readout; z(t - 1) leaves from the exchange buffer at step t
// (after the step's recurrent product, off the serial chain: TileStore)
// where ZOUT and the cell names a z trace.  TRAIN: the cell's traces and,
// where a.counts is given, the spike counts.  head_mma_kernel runs it for
// a head or a first layer, fused2.cu:fused2_mma_kernel for its layer 0
// (!ZOUT: z0 stays in the exchange buffer for layer 1), so the bits of a
// first layer are one code's.  The input current is the Input policy's:
// ListInput (an encoded layer, from the rows' feature lists) or
// DenseCurrent (izh_scan.cu: given currents, no lists), each with
//   start(a, lists, live, row0, lane, col0)   before step 0;
//   current(cur, t, a, row0, lane, wu, col0)  cur = step t's current.
template <class Cell, bool REC, bool TRAIN, bool HEAD, typename W,
          bool ZOUT = !HEAD, class Input = ListInput<pieces<W>(), W>>
__device__ __forceinline__ void mma_layer(
    const FwdArgs<typename Cell::Params>& a, const uint16_t* lists,
    const uint2* s_wrec, const uint2* s_wout, const float* s_b,
    uint16_t* s_z, int row0, int wu, int NWU, int lane, int tsync, int tn) {
  constexpr int P = pieces<W>();
  const int H = a.H, O = a.O, T = a.T, B = a.B, g = lane >> 2;
  const int HP = mma_hp(H), KT = HP / 16, ZS = mma_zs(HP);
  const int col0 = MMA_NU * wu + 2 * (lane & 3);  // entry 0 of n8 tile 0
  const bool live[2] = {row0 + g < B, row0 + g + 8 < B};
  Input in;
  in.start(a, lists, live, row0, lane, col0);
  MmaReadout ro(wu, NWU, HEAD ? O : 0);
  const Cell cell(a.cell);
  auto* const zo = ZOUT ? cell.template z_out<W>(a.cell) : nullptr;
  using Z = typename std::remove_pointer<decltype(zo)>::type;
  const TileStore<Z> zst(H, ZS, min(16, B - row0), MMA_NU * wu + lane,
                         NWU * 32);
  typename Cell::State st[MMA_NT][4];
#pragma unroll
  for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = cell.start(a.cell);
  uint32_t cnt[MMA_NT][2] = {};  // spike counts, 16 bits an entry
  uint32_t zb = 0;               // z(t-1), bit 4 n + e

  for (int t = 0; t < (HEAD ? T + 1 : T); ++t) {
    float rec[MMA_NT][4] = {};
    if (t > 0 && (HEAD || REC)) {
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
        if (HEAD) ro.product<P>(rp, A, s_wout, kk, wu, NWU, lane);
      }
      if (HEAD) ro.step<TRAIN>(rp, s_b, a.kappa, t - 1, wu, NWU, lane);
    }
    if (ZOUT && zo && t > 0)
      zst.put(zo + ((size_t)(t - 1) * B + row0) * H,
              s_z + ((t - 1) & 1) * 16 * ZS);
    if (HEAD && t == T) break;
    // The input current of step t, then the recurrent one added.
    float cur[MMA_NT][4];
    in.current(cur, t, a, row0, lane, wu, col0);
    if (REC && t > 0) {
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cur[n][e] = cur[n][e] + rec[n][e];
    }
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
        const bool fire = cell.step(a.cell, st[n][e], cur[n][e], zp);
        const bool z = ok && fire;  // padding never fires
        zn |= (uint32_t)z << (4 * n + e);
        zf[n][e] = z ? 1.f : 0.f;
        if (TRAIN) cnt[n][e >> 1] += (uint32_t)z << (16 * (e & 1));
        if (TRAIN && (e & 1)) {
          // The traces of step t: the lane's two units of its row g (e =
          // 1) or g + 8 (e = 3).
          const int c = col0 + 8 * n;
          if (live[e >> 1] && c < H)
            cell.template store<W>(
                a.cell, st[n][e - 1], st[n][e],
                ((size_t)t * B + row0 + g + 8 * (e >> 1)) * H + c, c + 1 < H);
        }
      }
    }
    zb = zn;
    put_slice(s_z + (t & 1) * 16 * ZS, ZS, wu, lane, zf);
    tile_sync(tsync, tn);
  }
  if (ZOUT && zo)  // z(T - 1): its buffer is written no more
    zst.put(zo + ((size_t)(T - 1) * B + row0) * H,
            s_z + ((T - 1) & 1) * 16 * ZS);
  if (HEAD)
    ro.write(a.logits, TRAIN ? a.tstar : nullptr, row0, B, O, wu, NWU, lane);
  if (TRAIN && a.counts) write_counts(cnt, a.counts, row0, B, H, col0, lane);
}

// A head (HEAD) or a first layer on the tensor-core body: a block fills
// W_rec's (and a head's W_out's and b_out's) pieces once, then each of its
// tiles runs mma_layer.  One block an SM at least, said to ptxas: given the
// threads alone it held some instances (a first layer's inference among
// them) to 128 registers and spilled (tools/head_ablation.py --layer0,
// ptxas_heuristic).
template <class Cell, bool REC, bool TRAIN, bool HEAD, typename W,
          class Input = ListInput<pieces<W>(), W>>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    head_mma_kernel(FwdArgs<typename Cell::Params> a0, const uint16_t* lists,
                    int tpb) {
  constexpr int P = pieces<W>();
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdArgs<typename Cell::Params> a = at_replica<W>(a0, blockIdx.y);
  const int H = a.H, O = a.O, B = a.B;
  const int HP = mma_hp(H), NWU = HP / 32, ZS = mma_zs(HP);
  const MmaFwdLayout L = mma_fwd_layout(H, REC, P, tpb, HEAD);
  uint2* s_wrec = reinterpret_cast<uint2*>(smem + L.wrec);
  uint2* s_wout = reinterpret_cast<uint2*>(smem + L.wout);
  float* s_b = reinterpret_cast<float*>(smem + L.b);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tile = warp / NWU, wu = warp % NWU;
  uint16_t* s_z =
      reinterpret_cast<uint16_t*>(smem + L.z) + (size_t)tile * 2 * 16 * ZS;

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
  mma_layer<Cell, REC, TRAIN, HEAD, W, !HEAD, Input>(
      a, lists, s_wrec, s_wout, s_b, s_z, row0, wu, NWU, lane, 1 + tile,
      NWU * 32);
}

template <class Cell, bool REC, bool TRAIN, bool HEAD, typename W,
          class Input = ListInput<pieces<W>(), W>>
cudaError_t launch_mma(const FwdArgs<typename Cell::Params>& a,
                       const uint16_t* lists, int S, int device,
                       cudaStream_t stream) {
  auto kernel = head_mma_kernel<Cell, REC, TRAIN, HEAD, W, Input>;
  const int NWU = mma_hp(a.H) / 32, tiles = (a.B + 15) / 16;
  int tpb = 1;
  auto smem = [&](int t) {
    return mma_fwd_layout(a.H, REC, pieces<W>(), t, HEAD).total;
  };
  cudaError_t err = mma_tiling(kernel, tiles, S, NWU, device, smem, &tpb);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((tiles + tpb - 1) / tpb, S), tpb * NWU * 32, smem(tpb),
           stream>>>(a, lists, tpb);
  return cudaGetLastError();
}

// The mma body of one launch for S replicas (a head, or a first layer:
// !HEAD, S = 1): the rows' lists (shared by the replicas) into `lists`,
// then the kernel of `Cell`.
template <class Cell, bool TRAIN, bool HEAD, typename W>
cudaError_t run_mma_body(const FwdArgs<typename Cell::Params>& a,
                         uint16_t* lists, int S, int device,
                         cudaStream_t s) {
  cudaError_t err =
      launch_sort(a.lat, lists, a.B, a.F, a.T, a.periodic, device, s);
  if (err != cudaSuccess) return err;
  return a.w_rec
             ? launch_mma<Cell, true, TRAIN, HEAD, W>(a, lists, S, device, s)
             : launch_mma<Cell, false, TRAIN, HEAD, W>(a, lists, S, device,
                                                       s);
}

int max_smem_of(int device, int* max_smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// The body a head kernel (O == 0: a first layer) runs a shape on: 0 when
// the kernels take the shape (*mma_out = 1: the mma body; 0: the per-unit
// body), 1 when they do not, or a CUDA error code.  *rows and *smem: the
// per-unit body's plan.
int head_plan(int F, int H, int O, int rec, int bf16, int device, int* rows,
              int* smem, int* mma_out) {
  const int rc = plan(F, H, O, rec, bf16, device, rows, smem);
  if (rc != 0) return rc;
  int max_smem = 0;
  const int err = max_smem_of(device, &max_smem);
  if (err != 0) return err;
  *mma_out = mma_fits(H, O, rec, bf16, max_smem) ? 1 : 0;
  return 0;
}

// One launch of a head (or a first layer, O == 0) for S replicas on the
// body its plan gives the shape: the mma body, mma(lists), where `lists`
// (the wrapper's scratch of list_row_words(F) 16-bit words a row) is
// given, which the plan must have said; else the per-unit body,
// per_unit(rows a block).
template <class P, typename Mma, typename PerUnit>
int run_head_body(const FwdArgs<P>& a, int bf16, void* lists, int S,
                  int device, Mma mma, PerUnit per_unit) {
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidConfiguration;
  int rows = 0, smem = 0, fits = 0;
  const int rc = head_plan(a.F, a.H, a.O, a.w_rec != nullptr, bf16, device,
                           &rows, &smem, &fits);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if ((fits != 0) != (lists != nullptr)) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  return fits ? (int)mma(static_cast<uint16_t*>(lists)) : per_unit(rows);
}

}  // namespace
