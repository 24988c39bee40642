// The tensor-core body of the backwards' reverse-time chains, one template
// over the element-wise chain as a policy: the heads (fused_head_bwd.cu for
// LIF/ALIF, fused_izh_bwd.cu for Izhikevich), the first layers
// (fused_layer0_bwd.cu, fused_izh_bwd.cu's first-layer mode), a mid layer's
// head and z-emitting modes (fused_mid_bwd.cu), both layers of the
// two-layer backward (fused2_bwd.cu) and the Izhikevich scan of a layer
// past the first (izh_scan.cu).
//
// A warp owns 16 rows x 32 units in registers in mma.m16n8k16's
// accumulator layout (head_mma.cuh) and walks t down.  s(t) is kept by
// every warp of the tile in the A layout (K = the outputs, padded to 16);
// the chain's cotangent of the step after (dcur(t+1), or the Izhikevich
// gi(t+1)) comes from the tile's exchange buffer by ldmatrix; dz = s @
// W_out^T (+ g_counts) + cotangent(t+1) @ W_rec^T on tensor cores, W_out^T
// and W_rec^T as B fragments in shared memory.  Both left operands are
// rounded to the weights' type first (bwd_common.cuh), so bf16 weights
// take one product each; float32 ones split both operands into three bf16
// pieces and take the six products of head_mma.cuh.  The element-wise
// chain is the policy's, the per-unit chain's arithmetic.  The cotangent
// (B, T, H) in the weights' type and the z bits (B, T + 1, HP / 32) leave
// as the per-unit chains write them, so the gradient functions keep their
// inputs; the Izhikevich scan's policy (ScanOut) writes the cotangent
// unrounded to a float32 g_i (T, B, H) in place of dcur, and its zmask may
// be null (no W_rec: izh_scan.cu).  What bounds it on an
// H100: the serial T-chain, a step's two dense products and its
// element-wise work; the body keeps the step on tensor cores and in
// registers, one named barrier a step among a tile's warps.  It takes O <=
// 16, H <= 256 and the weights' bf16 pieces within a block's shared memory
// (chain_mma_fits).
//
// The z-layer mode (a policy with HEAD = false; O = 0): no s chain and no
// s @ W_out^T, dz(t) = g_z(t) (+ g_counts) + cotangent(t+1) @ W_rec^T,
// g_z(t) in the accumulator layout from the policy, which loads it a step
// ahead (lif_chain.cuh:ZChain, izh_chain.cuh:IzhZChain, IzhScanChain).
//
// A Chain policy has
//   static constexpr bool HEAD             the head (s, W_out) or the
//                                          z-layer mode;
//   typename Chain::Args                   the launch's arguments (g_logits,
//                                          tstar, g_counts, w_rec, w_out,
//                                          dcur, zmask, B, H, O, T, kappa),
//                                          with at_replica<W>(Args, s);
//   Chain(const Args&)                     the launch's constants;
//   State start(const Args&, at, ok)       an entry's carries before step
//                                          T - 1 (`at`: its element of a
//                                          (., B, H) trace; `ok`: inside
//                                          the batch and H);
//   float step(const Args&, State&, dz, t, at, ok, bool& z)
//                                          step t from dz(t): returns the
//                                          cotangent of the input current
//                                          (0 where !ok) and sets z(t);
//   float input(const State&)              (z-layer mode) g_z(t) of an
//                                          entry at step t.
// LifChain and ZChain (lif_chain.cuh), IzhChain, IzhZChain and
// IzhScanChain (izh_chain.cuh); a policy may also name
//   static constexpr bool SCAN_OUT         the Izhikevich scan's outputs
//                                          (ScanOut below).
#pragma once

#include "bwd_common.cuh"
#include "head_mma.cuh"

namespace {

struct MmaChainLayout {
  size_t wrec, wout, d, total;
};

__host__ __device__ inline MmaChainLayout mma_chain_layout(int H, int rec,
                                                           int P, int tpb,
                                                           bool head = true) {
  const size_t HP = mma_hp(H);
  MmaChainLayout L;
  size_t off = 0;
  L.wrec = off;  // W_rec^T's B fragments, (HP, HP), P pieces
  off = align16(off + (rec ? 2 * P * HP * HP : 0));
  L.wout = off;  // W_out^T's, (16, HP); none in the z-layer mode
  off = align16(off + (head ? 2 * P * HP * MMA_OMAX : 0));
  L.d = off;  // each tile's two buffers of P (16, HP) bf16 cotangent pieces
  off = align16(off + (size_t)tpb * 2 * P * 16 * mma_zs(HP) * 2);
  L.total = off;
  return L;
}

// O == 0: the z-layer mode.
inline bool chain_mma_fits(int H, int O, int rec, int bf16, int max_smem) {
  return O >= 0 && O <= MMA_OMAX && H >= 1 && mma_hp(H) <= MMA_HMAX &&
         mma_chain_layout(H, rec, bf16 ? 1 : 3, 1, O > 0).total <=
             (size_t)max_smem;
}

// Whether a chain policy writes the cotangent as the Izhikevich scan's
// does (izh_chain.cuh:IzhScanChain, SCAN_OUT): the float32 a.g_i (T, B, H)
// unrounded, and no dcur.  The other policies write dcur alone, always.
template <class C, class = void>
struct ScanOut : std::false_type {};
template <class C>
struct ScanOut<C, std::void_t<decltype(C::SCAN_OUT)>>
    : std::bool_constant<C::SCAN_OUT> {};

// Rounds x to the weights' type and packs its P bf16 pieces, entries (lo,
// hi) of a fragment register.
template <typename W, int P>
__device__ __forceinline__ void pack_pieces(uint32_t (&out)[P], float lo,
                                            float hi) {
  float a[P], b[P];
  split<P>(round_w<W>(lo), a);
  split<P>(round_w<W>(hi), b);
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = pack_bf16(a[p], b[p]);
}

template <class Chain, bool REC, typename W>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_chain_mma_kernel(typename Chain::Args a0, int tpb) {
  constexpr int P = pieces<W>();
  constexpr bool HEAD = Chain::HEAD;
  extern __shared__ __align__(16) unsigned char smem[];
  const typename Chain::Args a = at_replica<W>(a0, blockIdx.z);
  const int H = a.H, O = HEAD ? a.O : 0, T = a.T, B = a.B;
  const int HP = mma_hp(H), NWU = HP / 32, KT = HP / 16, ZS = mma_zs(HP);
  const MmaChainLayout L = mma_chain_layout(H, REC, P, tpb, HEAD);
  uint2* s_wrec = reinterpret_cast<uint2*>(smem + L.wrec);
  uint2* s_wout = reinterpret_cast<uint2*>(smem + L.wout);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int tile = warp / NWU, wu = warp % NWU;
  uint16_t* s_d =
      reinterpret_cast<uint16_t*>(smem + L.d) + (size_t)tile * 2 * P * 16 * ZS;

  if (REC) {  // B[j][h] = W_rec[h, j]
    const W* w = static_cast<const W*>(a.w_rec);
    fill_b<P>(s_wrec, HP, HP, [&](int k, int n) {
      return k < H && n < H ? to_f32(w[(size_t)n * H + k]) : 0.f;
    }, tid, nthreads);
  }
  if (HEAD) {  // B[o][h] = W_out[h, o]
    const W* w = static_cast<const W*>(a.w_out);
    fill_b<P>(s_wout, MMA_OMAX, HP, [&](int k, int n) {
      return k < O && n < H ? to_f32(w[(size_t)n * O + k]) : 0.f;
    }, tid, nthreads);
  }
  __syncthreads();
  const int row0 = (blockIdx.x * tpb + tile) * 16;
  if (row0 >= B) return;  // a tile past the batch; no block barrier below

  const int col0 = MMA_NU * wu + 2 * q;  // entry 0 of n8 tile 0
  [[maybe_unused]] W* dcur_out = static_cast<W*>(a.dcur);  // !ScanOut
  bool live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) live[hh] = row0 + g + 8 * hh < B;

  // s in the A layout: entry i = 2 r + c of register r is (row g + 8 (r &
  // 1), output 2 q + c + 8 (r >> 1)).
  float s[8], gl[8];
  int tsr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + g + 8 * ((i >> 1) & 1);
    const int o = 2 * q + (i & 1) + 8 * (i >> 2);
    const bool ok = HEAD && row < B && o < O;
    s[i] = 0.f;
    gl[i] = ok ? a.g_logits[(size_t)row * O + o] : 0.f;
    tsr[i] = ok ? a.tstar[(size_t)row * O + o] : -1;
  }
  // Per entry (n8 tile n, fragment entry e): the chain's carries and
  // g_counts.
  const Chain chain(a);
  typename Chain::State st[MMA_NT][4];
  float gcnt[MMA_NT][4];
#pragma unroll
  for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), col = col0 + 8 * n + (e & 1);
      const bool ok = live[e >> 1] && col < H;
      const size_t at = (size_t)row * H + col;
      st[n][e] = chain.start(a, at, ok);
      gcnt[n][e] = ok && a.g_counts ? a.g_counts[at] : 0.f;
    }
  // This warp's word of each row's z bits (32 units of one row).
  const int HW = NWU;
  unsigned* zrow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    zrow[hh] = live[hh] && a.zmask
                   ? a.zmask + (size_t)(row0 + g + 8 * hh) * (T + 1) * HW + wu
                   : nullptr;
    if (zrow[hh] && q == 0) zrow[hh][0] = 0u;  // z(-1)
  }

  for (int t = T - 1; t >= 0; --t) {
    float dz[MMA_NT][4] = {};
    if constexpr (HEAD) {
      // s(t), rounded to the weights' type, as P pieces of A.
#pragma unroll
      for (int i = 0; i < 8; ++i)
        s[i] = a.kappa * s[i] + gl[i] * (tsr[i] == t ? 1.f : 0.f);
      uint32_t sa[P][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t w[P];
        pack_pieces<W, P>(w, s[2 * r], s[2 * r + 1]);
#pragma unroll
        for (int p = 0; p < P; ++p) sa[p][r] = w[p];
      }
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n)
        mma_split_a<P>(dz[n], sa, s_wout, MMA_NT * wu + n, lane);
    } else {
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dz[n][e] = chain.input(st[n][e]);
    }
    if (a.g_counts) {
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dz[n][e] = dz[n][e] + gcnt[n][e];
    }
    if (REC && t < T - 1) {
      // cotangent(t+1) @ W_rec^T from the tile's buffer of step t+1.
      const uint16_t* dp = s_d + (size_t)((t + 1) & 1) * P * 16 * ZS;
      float rec[MMA_NT][4] = {};
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t da[P][4];
#pragma unroll
        for (int p = 0; p < P; ++p)
          load_a(da[p], dp + p * 16 * ZS, ZS, kk, lane);
#pragma unroll
        for (int n = 0; n < MMA_NT; ++n)
          mma_split_a<P>(rec[n], da, s_wrec, kk * (HP / 8) + MMA_NT * wu + n,
                         lane);
      }
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dz[n][e] = dz[n][e] + rec[n][e];
    }
    // The element-wise chain of each (row, unit) entry.
    float piece[P][MMA_NT][4];
    uint32_t zw[2] = {0u, 0u};
    [[maybe_unused]] float gi_even = 0.f;  // ScanOut: g_i of entry e - 1
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1), col = col0 + 8 * n + (e & 1);
        const bool ok = live[e >> 1] && col < H;
        const size_t at = (size_t)row * H + col;
        bool z;
        const float d = chain.step(a, st[n][e], dz[n][e], t, at, ok, z);
        if constexpr (ScanOut<Chain>::value) {
          // g_i: the pair (row, col - 1), (row, col) at e odd.
          if ((e & 1) == 0)
            gi_even = d;
          else if (live[e >> 1] && col - 1 < H)
            store_pair(a.g_i + ((size_t)t * B + row) * H + col - 1, gi_even,
                       d, col < H);
        } else {
          if (ok) from_f32(d, dcur_out + ((size_t)row * T + t) * H + col);
        }
        float pc[P];
        split<P>(round_w<W>(d), pc);
#pragma unroll
        for (int p = 0; p < P; ++p) piece[p][n][e] = pc[p];
        if (z) zw[e >> 1] |= 1u << (8 * n + 2 * q + (e & 1));
      }
    }
    // z(t)'s word of rows g and g + 8: the four lanes of a row group hold
    // its 32 bits between them.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      zw[hh] |= __shfl_xor_sync(0xffffffffu, zw[hh], 1);
      zw[hh] |= __shfl_xor_sync(0xffffffffu, zw[hh], 2);
      if (zrow[hh] && q == 0) zrow[hh][(size_t)(t + 1) * HW] = zw[hh];
    }
    if (REC) {
      uint16_t* dn = s_d + (size_t)(t & 1) * P * 16 * ZS;
#pragma unroll
      for (int p = 0; p < P; ++p)
        put_slice(dn + p * 16 * ZS, ZS, wu, lane, piece[p]);
      tile_sync(1 + tile, NWU * 32);
    }
  }
}

template <class Chain, bool REC, typename W>
cudaError_t launch_chain_mma(const typename Chain::Args& a, int S,
                             int device, cudaStream_t stream) {
  auto kernel = bwd_chain_mma_kernel<Chain, REC, W>;
  const int NWU = mma_hp(a.H) / 32, tiles = (a.B + 15) / 16;
  int tpb = 1;
  auto smem = [&](int t) {
    return mma_chain_layout(a.H, REC, pieces<W>(), t, Chain::HEAD).total;
  };
  cudaError_t err = mma_tiling(kernel, tiles, S, NWU, device, smem, &tpb);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((tiles + tpb - 1) / tpb, 1, S), tpb * NWU * 32, smem(tpb),
           stream>>>(a, tpb);
  return cudaGetLastError();
}

}  // namespace
