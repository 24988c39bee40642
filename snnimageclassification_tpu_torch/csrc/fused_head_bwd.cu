// Whole-network head backward: reverse-time surrogate-gradient BPTT of the
// training forward in fused_head.cu, from the logits' (and the spike
// counts') cotangent to the weight gradients.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused.py:_fused_bwd_kernel
// (head=True; pl.pallas_call in _fused_bwd_call), the backward of
// fused_encode_{rec,ff}_scan_head and of their _counts variants, and its
// stacked-replica mode (w_in.ndim == 3, pallas_fused.py:958-1114): S seeds
// of an ensemble in one launch, gridDim.z = S on every function, the slabs
// (S, blocks, ...) summed per replica by the host (bwd_common.cuh).
//
// The recurrence, the split into __global__ functions (the chain, bwd_gwin,
// gbits_mma for g_W_rec (gbits_mma.cuh), bwd_gout) and what bounds them on
// an H100 are set out in bwd_common.cuh, which this source instantiates for
// the head: the
// dense count is 2 B T (F H + 2 H H + 2 H O) FLOP, but spikes are 0/1, so
// only dcur @ W_rec^T and s @ W_out^T are real products; the rest are sums
// of selected rows.
//
// The chain's mma body (bwd_chain_mma_kernel; O <= 16, H <= 256 and the
// weights' bf16 pieces within a block's shared memory; other shapes take
// bwd_common.cuh's per-unit chain): a warp owns 16 rows x 32 units in
// registers in mma.m16n8k16's accumulator layout (head_mma.cuh) and walks t
// down.  s(t) is kept by every warp of the tile in the A layout (K = the
// outputs, padded to 16), dcur(t+1) comes from the tile's exchange buffer
// by ldmatrix; dz = s @ W_out^T (+ g_counts) + dcur(t+1) @ W_rec^T on
// tensor cores, W_out^T and W_rec^T as B fragments in shared memory.  Both
// left operands are rounded to the weights' type first (bwd_common.cuh), so
// bf16 weights take one product each; float32 ones split both operands
// into three bf16 pieces and take the six products of head_mma.cuh.  The
// element-wise chain is the per-unit chain's arithmetic.  dcur (B, T, H) and
// the z bits (B, T + 1, HP / 32) leave as before, so the three gradient
// functions keep their inputs.

#include "bwd_common.cuh"
#include "gbits_mma.cuh"
#include "gout_mma.cuh"
#include "head_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The chain's mma body
// ---------------------------------------------------------------------------
struct MmaChainLayout {
  size_t wrec, wout, d, total;
};

__host__ __device__ inline MmaChainLayout mma_chain_layout(int H, int rec,
                                                           int P, int tpb) {
  const size_t HP = mma_hp(H);
  MmaChainLayout L;
  size_t off = 0;
  L.wrec = off;  // W_rec^T's B fragments, (HP, HP), P pieces
  off = align16(off + (rec ? 2 * P * HP * HP : 0));
  L.wout = off;  // W_out^T's, (16, HP)
  off = align16(off + 2 * P * HP * MMA_OMAX);
  L.d = off;  // each tile's two buffers of P (16, HP) bf16 dcur pieces
  off = align16(off + (size_t)tpb * 2 * P * 16 * mma_zs(HP) * 2);
  L.total = off;
  return L;
}

inline bool chain_mma_fits(int H, int O, int rec, int bf16, int max_smem) {
  return O >= 1 && O <= MMA_OMAX && H >= 1 && mma_hp(H) <= MMA_HMAX &&
         mma_chain_layout(H, rec, bf16 ? 1 : 3, 1).total <= (size_t)max_smem;
}

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

template <bool REC, typename W>
__global__ void __launch_bounds__(MMA_THREADS)
    bwd_chain_mma_kernel(Args a0, int tpb) {
  constexpr int P = pieces<W>();
  extern __shared__ __align__(16) unsigned char smem[];
  const Args a = at_replica<W>(a0, blockIdx.z);
  const int H = a.H, O = a.O, T = a.T, B = a.B;
  const int HP = mma_hp(H), NWU = HP / 32, KT = HP / 16, ZS = mma_zs(HP);
  const MmaChainLayout L = mma_chain_layout(H, REC, P, tpb);
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
  {  // B[o][h] = W_out[h, o]
    const W* w = static_cast<const W*>(a.w_out);
    fill_b<P>(s_wout, MMA_OMAX, HP, [&](int k, int n) {
      return k < O && n < H ? to_f32(w[(size_t)n * O + k]) : 0.f;
    }, tid, nthreads);
  }
  __syncthreads();
  const int row0 = (blockIdx.x * tpb + tile) * 16;
  if (row0 >= B) return;  // a tile past the batch; no block barrier below

  const int col0 = MMA_NU * wu + 2 * q;  // entry 0 of n8 tile 0
  const W* delta = static_cast<const W*>(a.delta);
  const W* a_tr = static_cast<const W*>(a.a_tr);
  W* dcur_out = static_cast<W*>(a.dcur);
  const float beta = a_tr ? *a.beta : 0.f;
  const size_t step_stride = (size_t)B * H;
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
    const bool ok = row < B && o < O;
    s[i] = 0.f;
    gl[i] = ok ? a.g_logits[(size_t)row * O + o] : 0.f;
    tsr[i] = ok ? a.tstar[(size_t)row * O + o] : -1;
  }
  // Per entry (n8 tile n, fragment entry e): the element's index in a
  // (., B, H) trace, the residual of step t, g_counts, dcur(t+1).
  float d_t[MMA_NT][4], gcnt[MMA_NT][4], dcur[MMA_NT][4];
#pragma unroll
  for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), col = col0 + 8 * n + (e & 1);
      const bool ok = live[e >> 1] && col < H;
      const size_t at = (size_t)row * H + col;
      d_t[n][e] = ok ? to_f32(delta[(size_t)(T - 1) * step_stride + at]) : 0.f;
      gcnt[n][e] = ok && a.g_counts ? a.g_counts[at] : 0.f;
      dcur[n][e] = 0.f;
    }
  // This warp's word of each row's z bits (32 units of one row).
  const int HW = NWU;
  unsigned* zrow[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    zrow[hh] = live[hh]
                   ? a.zmask + (size_t)(row0 + g + 8 * hh) * (T + 1) * HW + wu
                   : nullptr;
    if (zrow[hh] && q == 0) zrow[hh][0] = 0u;  // z(-1)
  }

  for (int t = T - 1; t >= 0; --t) {
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
    float dz[MMA_NT][4] = {};
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n)
      mma_split_a<P>(dz[n], sa, s_wout, MMA_NT * wu + n, lane);
    if (a.g_counts) {
#pragma unroll
      for (int n = 0; n < MMA_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dz[n][e] = dz[n][e] + gcnt[n][e];
    }
    if (REC && t < T - 1) {
      // dcur(t+1) @ W_rec^T from the tile's buffer of step t+1.
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
    // The element-wise chain of bwd_chain_kernel, per (row, unit).
    float piece[P][MMA_NT][4];
    uint32_t zw[2] = {0u, 0u};
#pragma unroll
    for (int n = 0; n < MMA_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1), col = col0 + 8 * n + (e & 1);
        const bool ok = live[e >> 1] && col < H;
        const size_t at = (size_t)row * H + col;
        const float d_prev =
            ok && t > 0 ? to_f32(delta[(size_t)(t - 1) * step_stride + at])
                        : -1.f;
        float thr = a.threshold;
        if (a_tr)
          thr = a.threshold +
                beta * (ok ? to_f32(a_tr[(size_t)t * step_stride + at]) : 0.f);
        const float surr = surrogate(a.phi, d_t[n][e], thr, a.gamma);
        const float dv = dz[n][e] * surr + a.alpha * dcur[n][e];
        const float zp = d_prev >= 0.f ? 1.f : 0.f;
        dcur[n][e] = ok ? dv * (1.f - zp) : 0.f;
        if (ok)
          from_f32(dcur[n][e], dcur_out + ((size_t)row * T + t) * H + col);
        float pc[P];
        split<P>(round_w<W>(dcur[n][e]), pc);
#pragma unroll
        for (int p = 0; p < P; ++p) piece[p][n][e] = pc[p];
        if (ok && d_t[n][e] >= 0.f)
          zw[e >> 1] |= 1u << (8 * n + 2 * q + (e & 1));
        d_t[n][e] = d_prev;
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

template <bool REC, typename W>
cudaError_t launch_chain_mma(const Args& a, int S, int device,
                             cudaStream_t stream) {
  auto kernel = bwd_chain_mma_kernel<REC, W>;
  const int NWU = mma_hp(a.H) / 32, tiles = (a.B + 15) / 16;
  int tpb = 1;
  auto smem = [&](int t) {
    return mma_chain_layout(a.H, REC, pieces<W>(), t).total;
  };
  cudaError_t err = mma_tiling(kernel, tiles, S, NWU, device, smem, &tpb);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((tiles + tpb - 1) / tpb, 1, S), tpb * NWU * 32, smem(tpb),
           stream>>>(a, tpb);
  return cudaGetLastError();
}

struct Plan {
  int rows, smem_chain, mma;
  GwinPlan gw;
  GbitsPlan gb;
  GoutPlan go;
};

// 0 when the shape fits, 1 when it does not, else a CUDA error code.
int make_plan(int B, int F, int H, int O, int T, int rec, int bf16,
              int periodic, int device, Plan* p) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32;
  if (H < 1 || O < 1 || F < 1 || T < 1 || T > 32767 || HP > 1024) return 1;
  const int G = 512 / HP > 0 ? 512 / HP : 1;
  p->rows = chain_rows(H, O, HP, G, rec, bf16 ? 2 : 4, lim.max_smem,
                       &p->smem_chain);
  if (p->rows == 0) return 1;
  p->mma = chain_mma_fits(H, O, rec, bf16, lim.max_smem);
  p->gb.groups = 0;
  if (gwin_plan(B, F, H, T, periodic, bf16 ? 2 : 4, lim, &p->gw) != 0 ||
      gout_plan(B, H, O, T, lim, &p->go) != 0 ||
      (rec && (bf16 ? gbits_plan_rows<__nv_bfloat16>(B, T, H, H, lim, &p->gb)
                    : gbits_plan_rows<float>(B, T, H, H, lim, &p->gb)) != 0))
    return 1;
  return 0;
}

template <bool REC, typename W>
cudaError_t launch_all(const Args& a, const Plan& p, int S, int device,
                       cudaStream_t s) {
  const int HP = (a.H + 31) / 32 * 32;
  cudaError_t err;
  if (p.mma) {
    err = launch_chain_mma<REC, W>(a, S, device, s);
  } else {
    err = opt_in(bwd_chain_kernel<REC, true, W>, p.smem_chain);
    if (err != cudaSuccess) return err;
    bwd_chain_kernel<REC, true, W>
        <<<dim3((a.B + p.rows - 1) / p.rows, 1, S), dim3(HP, p.rows),
           p.smem_chain, s>>>(a, p.rows);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  if ((err = launch_gwin<W>(a, p.gw, S, s)) != cudaSuccess) return err;
  if (REC) {
    // Mask row t of zmask holds z(t - 1), the left operand of g_W_rec.
    const int HW = HP / 32;
    err = launch_gbits_rows<W>(a.dcur, a.zmask, a.slab_rec, a.B, a.T, a.H,
                               a.H, a.T + 1, HW,
                               (long long)a.B * (a.T + 1) * HW, p.gb, S, s);
    if (err != cudaSuccess) return err;
  }
  return launch_gout<W>(a, p.go, S, s);
}

}  // namespace

extern "C" {

// Slab counts for a shape on `device`: out[0] = blocks of g_W_in slabs,
// out[1] = of g_W_rec slabs (0 without recurrence), out[2] = of
// g_W_out/g_b slabs; out[3] = 1 where the chain takes its mma body; out[4]
// and out[5] = rows a batch of bwd_gwin and of bwd_gout (each block walks
// the batches blockIdx.x + k blocks, ascending); out[6] = 1 where bwd_gwin
// streams dcur through its TMA ring, 0 where the threads copy its stage;
// out[7] the same for gbits_mma (g_W_rec; its block y takes batch rows
// [y B / out[1], (y + 1) B / out[1])).
// Returns 0 when the shape fits the kernels, 1 when it does not, or a CUDA
// error code.
int snn_fused_head_bwd_plan(int B, int F, int H, int O, int T, int rec,
                            int bf16, int periodic, int device, int* out) {
  Plan p;
  const int rc = make_plan(B, F, H, O, T, rec, bf16, periodic, device, &p);
  if (rc == 0) {
    out[0] = p.gw.groups;
    out[1] = p.gb.groups;
    out[2] = p.go.groups;
    out[3] = p.mma;
    out[4] = p.gw.R;
    out[5] = p.go.R;
    out[6] = p.gw.tma;
    out[7] = p.gb.tma;
  }
  return rc;
}

// How bwd_gwin (every backward with an encoded first layer launches it)
// reads dcur at a shape on `device`: *stage = 0 through its TMA ring, 1 a
// stage copied by the threads as H * itemsize is not a multiple of 16 bytes
// (TMA's strides), 2 the same as no two stages of the ring fit in a block's
// shared memory.  Returns 0, 1 when the shape does not fit bwd_gwin, or a
// CUDA error code.
int snn_gwin_stage(int F, int H, int T, int bf16, int periodic, int device,
                   int* stage) {
  Limits lim;
  const cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  GwinPlan p;
  const int wsize = bf16 ? 2 : 4;
  if (gwin_plan(1, F, H, T, periodic, wsize, lim, &p) != 0) return 1;
  *stage = p.tma ? 0 : ((size_t)H * wsize) % 16 ? 1 : 2;
  return 0;
}

// S stacked replicas (S = 1: one network): every per-replica input, the
// scratch and the slabs carry a leading S (beta holds S values); the
// latencies are shared.
int snn_fused_head_bwd(const float* g_logits, const int* tstar,
                       const float* g_counts, const void* delta,
                       const void* a_tr, const int* lat, const void* w_rec,
                       const void* w_out, const float* beta, void* dcur,
                       void* zmask, float* slab_in, float* slab_rec,
                       float* slab_out, int B, int F, int H, int O, int T,
                       int periodic, int phi, int bf16, float alpha,
                       float threshold, float gamma, float kappa, int S,
                       int device, void* stream) {
  Plan p;
  const int rec = w_rec != nullptr;
  const int rc = make_plan(B, F, H, O, T, rec, bf16, periodic, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidConfiguration;
  if (B == 0) return 0;
  Args a{g_logits, tstar, g_counts, nullptr, nullptr, delta, a_tr, lat, w_rec,
         w_out, beta, dcur, static_cast<unsigned*>(zmask), slab_in, slab_rec,
         slab_out, B, F, H, O, T, periodic, phi, 0, alpha, threshold, gamma,
         kappa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = rec ? launch_all<true, __nv_bfloat16>(a, p, S, device, s)
              : launch_all<false, __nv_bfloat16>(a, p, S, device, s);
  else
    err = rec ? launch_all<true, float>(a, p, S, device, s)
              : launch_all<false, float>(a, p, S, device, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
