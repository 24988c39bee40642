// The tensor-core pieces of the head kernel pairs' mma body
// (head_mma_fwd.cuh and chain_mma.cuh, for the LIF/ALIF and the
// Izhikevich heads; gbits_mma.cuh and gout_mma.cuh take them too): bf16
// operands split from float32, m16n8k16 products (bf16 in, float32
// accumulate) and their fragment layouts, the per-tile barrier, the shape
// limits and the launch's tiling.
//
// Layout.  A warp owns a tile of 16 batch rows and 32 hidden units (four n8
// tiles), kept in registers in the accumulator layout of mma.m16n8k16: lane
// 4 g + q holds, for n8 tile n, units 8 n + 2 q and 8 n + 2 q + 1 of rows g
// (fragment entries 0, 1) and g + 8 (entries 2, 3).  The HP / 32 warps of a
// tile (HP = H rounded up to 32) exchange the left operand of the next
// product (z in the forward, dcur in the backward) through a bf16 (16, HP)
// buffer in shared memory, one named barrier a step among those warps only.
//
// Float32 weights (and float32 left operands) are split into three bf16
// pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), whose
// sum is x exactly for a normal float32 x (8 + 8 + 8 significant bits).
// A 0/1 left operand is exact in bf16, so three products (lo, mid, hi)
// give the float32 sum; a float32 left operand takes the six products of
// the pieces whose scales sum to at most 2^-16 (the three dropped ones are
// below 2^-24 of the term).  bfloat16 weights take one product, the JAX
// kernels' jnp.dot(z.astype(w.dtype), w, preferred_element_type=f32).
// ops/head_mma.py holds the CPU twin of the split and the products.
#pragma once

#include <type_traits>

#include "head_common.cuh"

namespace {

constexpr int MMA_NT = 4;              // n8 tiles of hidden units a warp owns
constexpr int MMA_NU = 8 * MMA_NT;     // hidden units a warp owns
constexpr int MMA_OMAX = 16;           // outputs the body takes
constexpr int MMA_THREADS = 256;       // threads a block, at most
constexpr int MMA_HMAX = MMA_THREADS;  // one tile's warps fill a block

// bf16 pieces of a weight type: 1 for bf16, 3 for float32.
template <typename W>
__host__ __device__ constexpr int pieces() {
  return std::is_same<W, float>::value ? 3 : 1;
}

__host__ __device__ inline int mma_hp(int H) { return (H + 31) & ~31; }
// Row stride of the (16, HP) exchange buffer, in bf16: 16 bytes of padding
// put the eight rows an ldmatrix reads on distinct banks.
__host__ __device__ inline int mma_zs(int HP) { return HP + 8; }

// x as P bf16 pieces, largest first (P = 1: x rounded once).
template <int P>
__device__ __forceinline__ void split(float x, float (&piece)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    piece[p] = __bfloat162float(__float2bfloat16_rn(x));
    x -= piece[p];
  }
}

// Two floats (already bf16 values) as a bf16x2 word, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// d += a b, m16n8k16, bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The A fragment of columns [16 kk, 16 kk + 16) of a (16, zs) bf16 buffer.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* buf,
                                       int zs, int kk, int lane) {
  const uint16_t* p = buf + (lane & 15) * zs + 16 * kk + (lane >> 4) * 8;
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s)
      : "memory");
}

// The warps of one tile meet: named barrier `id` (1 + the tile's index in
// the block; 0 is __syncthreads') over `n` threads.
__device__ __forceinline__ void tile_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// B fragments of a (KP, NP) operand in shared memory, P pieces each, in
// the order a lane reads them: the word pair at ((kk (NP / 8) + nt) P + p)
// 32 + lane holds piece p of elements (16 kk + 2 q + {0, 1}, 8 nt + g) and
// (16 kk + 2 q + {8, 9}, 8 nt + g), lane = 4 g + q.  elem(k, n) gives the
// element as float (0 outside the operand).  Every thread of the block
// calls it; the caller's barrier follows.
template <int P, typename E>
__device__ void fill_b(uint2* dst, int KP, int NP, E elem, int tid,
                       int nthreads) {
  const int NT = NP / 8, n = (KP / 16) * NT * 32;
  for (int i = tid; i < n; i += nthreads) {
    const int lane = i & 31, tile = i >> 5;
    const int k = 16 * (tile / NT) + 2 * (lane & 3);
    const int col = 8 * (tile % NT) + (lane >> 2);
    float x[4][P];
    split<P>(elem(k, col), x[0]);
    split<P>(elem(k + 1, col), x[1]);
    split<P>(elem(k + 8, col), x[2]);
    split<P>(elem(k + 9, col), x[3]);
#pragma unroll
    for (int p = 0; p < P; ++p)
      dst[(tile * P + p) * 32 + lane] =
          make_uint2(pack_bf16(x[0][p], x[1][p]), pack_bf16(x[2][p], x[3][p]));
  }
}

__device__ __forceinline__ uint2 load_b(const uint2* frags, int tile, int p,
                                        int P, int lane) {
  return frags[(tile * P + p) * 32 + lane];
}

// Bytes of fill_b's fragments of a (KP, NP) operand in P pieces.
__host__ __device__ inline size_t frag_bytes(int KP, int NP, int P) {
  return (size_t)KP * NP * P * 2;
}

// fill_b's fragments of a row-major (K, N) weight matrix, into device
// memory: the operand of a body that reads it from L2 where its pieces do
// not fit shared memory beside the others.
template <int P, typename W>
__global__ void frag_kernel(const W* w, int K, int N, int KP, int NP,
                            uint2* dst) {
  fill_b<P>(dst, KP, NP, [&](int k, int n) {
    return k < K && n < N ? to_f32(w[(size_t)k * N + n]) : 0.f;
  }, blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x);
}

template <int P, typename W>
cudaError_t launch_frags(const void* w, int K, int N, int KP, int NP,
                         uint2* dst, cudaStream_t stream) {
  const int n = (KP / 16) * (NP / 8) * 32;
  frag_kernel<P, W><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const W*>(w), K, N, KP, NP, dst);
  return cudaGetLastError();
}

// The tensor cores truncate what they add into a chained float32
// accumulator, and over a long k the error grows past float32 noise (six
// to ten times the small-shape bars on a dcur @ W_rec^T chain).  So each
// k16 slice's product goes to fresh accumulators, the hi x hi product apart
// from the smaller ones, and the slice's sum is added to d in float32
// (round to nearest).

// d += z b for one k16 slice of a 0/1 (exact) left operand, b given as its
// P pieces.
template <int P>
__device__ __forceinline__ void mma_exact(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          const uint2 (&b)[P]) {
  float big[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(big, a, b[0]);
  if constexpr (P == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = d[e] + big[e];
  } else {
    float small[4] = {0.f, 0.f, 0.f, 0.f};
    mma16816(small, a, b[2]);
    mma16816(small, a, b[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = d[e] + (small[e] + big[e]);
  }
}

// The same, b from shared-memory fragments.
template <int P>
__device__ __forceinline__ void mma_exact_a(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint2* frags, int tile,
                                            int lane) {
  uint2 b[P];
#pragma unroll
  for (int p = 0; p < P; ++p) b[p] = load_b(frags, tile, p, P, lane);
  mma_exact<P>(d, a, b);
}

// d += x b for one k16 slice of a left operand given as P pieces a[p]: one
// product (P = 1), or the six of pieces (i, j) with i + j <= 2, the five
// cross terms smallest first (P = 3).
template <int P>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&a)[P][4],
                                          const uint2 (&b)[P]) {
  float big[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(big, a[0], b[0]);
  if constexpr (P == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = d[e] + big[e];
  } else {
    float small[4] = {0.f, 0.f, 0.f, 0.f};
    mma16816(small, a[2], b[0]);
    mma16816(small, a[1], b[1]);
    mma16816(small, a[0], b[2]);
    mma16816(small, a[1], b[0]);
    mma16816(small, a[0], b[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = d[e] + (small[e] + big[e]);
  }
}

// The same, b from shared-memory fragments.
template <int P>
__device__ __forceinline__ void mma_split_a(float (&d)[4],
                                            const uint32_t (&a)[P][4],
                                            const uint2* frags, int tile,
                                            int lane) {
  uint2 b[P];
#pragma unroll
  for (int p = 0; p < P; ++p) b[p] = load_b(frags, tile, p, P, lane);
  mma_split<P>(d, a, b);
}

// Two adjacent outputs, rounded once each, as one store (8 / 4 bytes).
__device__ __forceinline__ void store_pair(float* out, float x0, float x1) {
  *reinterpret_cast<float2*>(out) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, float x0,
                                           float x1) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x0, x1);
}

// Writes a warp's 16 x 32 slice of a bf16 (16, zs) exchange buffer from
// accumulator-layout values x[n][e] (already bf16 values).
__device__ __forceinline__ void put_slice(uint16_t* buf, int zs, int wu,
                                          int lane,
                                          const float (&x)[MMA_NT][4]) {
  const int g = lane >> 2, col = MMA_NU * wu + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < MMA_NT; ++n) {
    *reinterpret_cast<uint32_t*>(buf + g * zs + col + 8 * n) =
        pack_bf16(x[n][0], x[n][1]);
    *reinterpret_cast<uint32_t*>(buf + (g + 8) * zs + col + 8 * n) =
        pack_bf16(x[n][2], x[n][3]);
  }
}

// The readout of the tensor-core bodies: r = z(t) @ W_out + b, v_r = kappa
// v_r + r, its running max with strict > (the first maximal step wins, as
// torch.max) and that step, in the accumulator layout; a warp owns the
// readout's n8 tiles j = wu and wu + NWU below ceil(O / 8) (none at O = 0).
struct MmaReadout {
  bool owns[2];
  float vr[2][4], m[2][4];
  int ts[2][4];

  __device__ MmaReadout(int wu, int NWU, int O) {
#pragma unroll
    for (int jo = 0; jo < 2; ++jo) {
      owns[jo] = wu + jo * NWU < (O + 7) / 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        vr[jo][e] = 0.f;
        m[jo][e] = -INFINITY;
        ts[jo][e] = 0;
      }
    }
  }

  // ro += slice kk of z(t) @ W_out, A that slice of z(t).
  template <int P>
  __device__ __forceinline__ void product(float (&ro)[2][4],
                                          const uint32_t (&A)[4],
                                          const uint2* s_wout, int kk,
                                          int wu, int NWU, int lane) const {
#pragma unroll
    for (int jo = 0; jo < 2; ++jo)
      if (owns[jo])
        mma_exact_a<P>(ro[jo], A, s_wout, kk * 2 + wu + jo * NWU, lane);
  }

  // Step t from its product ro.
  template <bool TRAIN>
  __device__ __forceinline__ void step(const float (&ro)[2][4],
                                       const float* s_b, float kappa, int t,
                                       int wu, int NWU, int lane) {
#pragma unroll
    for (int jo = 0; jo < 2; ++jo) {
      if (!owns[jo]) continue;
      const int o0 = 8 * (wu + jo * NWU) + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = ro[jo][e] + s_b[o0 + (e & 1)];
        const float vv = kappa * vr[jo][e] + r;
        vr[jo][e] = vv;
        if (vv > m[jo][e]) {
          m[jo][e] = vv;
          if (TRAIN) ts[jo][e] = t;
        }
      }
    }
  }

  // The logits (and where given tstar, (B, O)) of the lane's rows.
  __device__ void write(float* logits, int* tstar, int row0, int B, int O,
                        int wu, int NWU, int lane) const {
    const int g = lane >> 2;
#pragma unroll
    for (int jo = 0; jo < 2; ++jo) {
      if (!owns[jo]) continue;
      const int o0 = 8 * (wu + jo * NWU) + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1), o = o0 + (e & 1);
        if (row >= B || o >= O) continue;
        logits[(size_t)row * O + o] = m[jo][e];
        if (tstar) tstar[(size_t)row * O + o] = ts[jo][e];
      }
    }
  }
};

// The spike counts (B, H) of the lane's entries: cnt[n][hh] holds 16 bits
// an entry, units col0 + 8 n and col0 + 8 n + 1 of row row0 + g + 8 hh.
__device__ __forceinline__ void write_counts(const uint32_t (&cnt)[MMA_NT][2],
                                             float* counts, int row0, int B,
                                             int H, int col0, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), col = col0 + 8 * n + (e & 1);
      if (row < B && col < H)
        counts[(size_t)row * H + col] =
            (float)((cnt[n][e >> 1] >> (16 * (e & 1))) & 0xffffu);
    }
}

// Tiles (16 rows each) a block takes: the fewest that put every block of
// the launch on the card at once, else the most a block holds.  `smem(tpb)`
// gives a block's bytes; the kernel is opted in to the chosen size.
template <typename K, typename Smem>
cudaError_t mma_tiling(K kernel, int tiles, int S, int NWU, int device,
                       Smem smem, int* tpb_out) {
  int sms = 0, max_smem = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int best = 1;
  for (int tpb = 1; tpb * NWU * 32 <= MMA_THREADS; tpb *= 2) {
    if (smem(tpb) > (size_t)max_smem) break;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem(tpb));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, tpb * NWU * 32, smem(tpb));
    if (err != cudaSuccess) return err;
    if (per_sm < 1) break;
    best = tpb;
    const long blocks = (long)((tiles + tpb - 1) / tpb) * S;
    if (blocks <= (long)per_sm * sms) break;
  }
  *tpb_out = best;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem(best));
}

}  // namespace
