// Recurrent LIF/ALIF scan over precomputed input currents, forward and
// backward, for layers whose W_rec does not fit one block's shared memory:
// currents (T, B, H) float32 + z(t-1) @ masked W_rec -> z (T, B, H) in W's
// type (and, for training, the residuals: delta, or v [and a]); backward
// g_z -> g_i (T, B, H) float32 and g_W_rec.  H up to 1024.
//
// Replaces the TPU kernels
// snnimageclassification_tpu/ops/pallas_rec.py:_rec_fwd_kernel (pl.pallas_call
// in _rec_fwd_call, :184) and _rec_bwd_kernel (in _rec_bwd_call, :314),
// rec_lif_scan / rec_alif_scan.
//
// Forward, per step (z(-1) = 0, v = a = 0 before step 0):
//   v = (alpha v + i(t) + z(t-1) @ W_rec)(1 - z(t-1))
//   ALIF: a = rho a + z(t-1), thr = threshold + beta a;  LIF: thr = threshold
//   delta = v - thr,  z(t) = [delta >= 0]
// Backward, t = T-1 .. 0 (dcur(T) = 0):
//   dz   = g_z(t) + dcur(t+1) @ W_rec^T        (dcur rounded to W's type)
//   dv   = dz surr(delta(t)) + alpha dcur(t+1)
//   dcur = dv (1 - z(t-1))  -> g_i(t)
//   g_W_rec = sum_t z(t-1)^T dcur(t)           (dcur rounded to W's type)
// beta, the reset and the adaptation carry no gradient (quirk Q3).
//
// What bounds it on an H100: operations, in a serial chain.  The recurrent
// product is a (B, H) x (H, H) product a step inside the serial chain: 2 B T
// H^2 FLOP each way (430 GFLOP at B = 8192, T = 100, H = 512).  W_rec is 1
// MB in float32 at H = 512 (4 MB at 1024), past the 227 KB a block may
// hold, and rows are independent, so:
//   rec_mma_fwd / rec_mma_chain (rec_mma.cuh, the tensor-core cluster
//     body): a cluster of blocks owns a tile of batch rows, each block a
//     slice of the units with its slice of W_rec's bf16 pieces resident in
//     shared memory; the products on tensor cores, the next step's left
//     operand sent to the peer blocks by bulk copies counted on their
//     mbarriers.  It takes every shape whose slice and
//     exchange buffers fit a block (the forward: float32 up to H = 512,
//     bf16 up to 1024; the chain: bf16 up to 1024); the plan (rec_mma_plan)
//     says which.
//   rec_fwd / rec_chain (the CUDA-core body, the other shapes: float32
//     past H = 512, every float32 chain): a block owns R batch rows over the whole T chain and
//     all H units; thread (x, y) holds an RB x HB register tile (rows
//     y RB + rb, columns x + hb HX).  Each step the block streams W_rec (the
//     backward: W_rec^T) through shared memory in chunks of JC rows; each
//     chunk serves every row of the tile, a register tile of sums takes it,
//     and no step crosses blocks.  Where the whole matrix fits (H <= ~200
//     float32) it is staged once.  The forward adds W_rec's row j where bit j
//     of the row's z(t-1) mask is set, in ascending j (the test is uniform
//     over a warp: a warp holds 32 columns of one row); the backward takes
//     the dense product with fused multiply-adds in ascending j.  One block
//     barrier a chunk and one a step.
//   g_W_rec = sum over (row, t) of z(t-1)^T round(g_i(t)): gbits_mma
//     (gbits_mma.cuh), the tensor-core product of every bit-masked weight
//     gradient of the port, on the chain's g_i (T, B, H) float32, each
//     value rounded to W's type as it loads (a slice: 16 consecutive rows of
//     one step), and the z bits, which either chain writes (T, B, HW) in the
//     same order.  Each block sums a range of batch rows into a slab of its
//     own, the host adds the slabs in a fixed order: no atomics, the same
//     bits on every run.
// Built with --fmad=false: the cell rounds as the plain PyTorch version.

#include "bwd_common.cuh"
#include "gbits_mma.cuh"
#include "rec_mma.cuh"

namespace {

constexpr int REC_THREADS = 512;
constexpr size_t REC_CHUNK_BYTES = 64 * 1024;

// The register tile of a width: HB columns a thread (a power of two up to
// 8, so that HX = H / HB rounded up to a warp is at most 128), RB rows.
struct Tile {
  int RB, HB, HX, RY;
};

__host__ __device__ inline Tile tile_for(int H) {
  Tile t;
  t.HB = 1;
  while (t.HB < 8 && (H + t.HB - 1) / t.HB > 128) t.HB *= 2;
  t.HX = ((H + t.HB - 1) / t.HB + 31) / 32 * 32;
  t.RB = t.HB == 8 ? 4 : 8;
  t.RY = REC_THREADS / t.HX;
  return t;
}

// Rows j0 .. j0 + n of the row-major (H, H) matrix g into s (row stride H),
// 16 bytes a copy where both ends are aligned.
template <typename W>
__device__ __forceinline__ void stage_rows(const W* g, W* s, int j0, int n,
                                           int H, int tid, int nthreads) {
  constexpr int V = 16 / sizeof(W);
  const W* src = g + (size_t)j0 * H;
  const int total = n * H;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && total % V == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(s);
    for (int i = tid; i < total / V; i += nthreads) d[i] = q[i];
  } else {
    for (int i = tid; i < total; i += nthreads) s[i] = src[i];
  }
}

__host__ __device__ inline size_t rec_w_bytes(int JC, int H, int wsize) {
  return align16((size_t)(JC < H ? JC : H) * H * wsize);
}

template <int RB, int HB, typename W>
__global__ void __launch_bounds__(REC_THREADS)
    rec_fwd_kernel(RecArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HX = blockDim.x, RY = blockDim.y;
  const int H = a.H, T = a.T, B = a.B, JC = a.JC;
  const int R = RY * RB, HWX = HX * HB / 32;
  const bool resident = JC >= H;
  W* s_w = reinterpret_cast<W*>(smem);
  // Two buffers of (R, HWX) words: z(t-1)'s bits in buffer t & 1.
  unsigned* s_zm =
      reinterpret_cast<unsigned*>(smem + rec_w_bytes(JC, H, sizeof(W)));
  const int x = threadIdx.x, y = threadIdx.y;
  const int tid = y * HX + x, nthreads = HX * RY;
  const int row0 = blockIdx.x * R + y * RB;  // this thread's first row
  const W* w = static_cast<const W*>(a.w);
  for (int i = tid; i < 2 * R * HWX; i += nthreads) s_zm[i] = 0u;
  if (resident) stage_rows(w, s_w, 0, H, H, tid, nthreads);
  const float beta = a.alif ? *a.beta : 0.f;
  bool hok[HB];
  float v[RB][HB], ad[RB][HB];
#pragma unroll
  for (int hb = 0; hb < HB; ++hb) hok[hb] = x + hb * HX < H;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int hb = 0; hb < HB; ++hb) v[rb][hb] = ad[rb][hb] = 0.f;
  const size_t stride = (size_t)B * H;
  W* z_out = static_cast<W*>(a.z);
  W* res_out = static_cast<W*>(a.res);
  W* a_out = static_cast<W*>(a.a_tr);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const unsigned* zm = s_zm + (t & 1) * R * HWX + y * RB * HWX;
    float acc[RB][HB];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int hb = 0; hb < HB; ++hb) acc[rb][hb] = 0.f;
    for (int j0 = 0; j0 < H; j0 += JC) {
      const int n = min(JC, H - j0);
      if (!resident) {
        stage_rows(w, s_w, j0, n, H, tid, nthreads);
        __syncthreads();
      }
      for (int jw = 0; jw < n; jw += 32) {
        unsigned m[RB];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) m[rb] = zm[rb * HWX + ((j0 + jw) >> 5)];
        const int ne = min(32, n - jw);
        for (int jj = 0; jj < ne; ++jj) {
          const W* wr = s_w + (size_t)(jw + jj) * H + x;
          float wv[HB];
#pragma unroll
          for (int hb = 0; hb < HB; ++hb)
            wv[hb] = hok[hb] ? to_f32(wr[hb * HX]) : 0.f;
#pragma unroll
          for (int rb = 0; rb < RB; ++rb) {
            if ((m[rb] >> jj) & 1u) {
#pragma unroll
              for (int hb = 0; hb < HB; ++hb) acc[rb][hb] += wv[hb];
            }
          }
        }
      }
      __syncthreads();
    }
    // The cell, and the bits of z(t) into the other buffer.
    unsigned* zn = s_zm + ((t + 1) & 1) * R * HWX + y * RB * HWX;
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const int row = row0 + rb;
#pragma unroll
      for (int hb = 0; hb < HB; ++hb) {
        const int h = x + hb * HX;
        bool z = false;
        if (row < B && hok[hb]) {
          const float zp =
              (zm[rb * HWX + (h >> 5)] >> (h & 31)) & 1u ? 1.f : 0.f;
          const size_t at = (size_t)t * stride + (size_t)row * H + h;
          const float vv =
              (a.alpha * v[rb][hb] + a.cur[at] + acc[rb][hb]) * (1.f - zp);
          v[rb][hb] = vv;
          float thr = a.threshold;
          if (a.alif) {
            ad[rb][hb] = a.rho * ad[rb][hb] + zp;
            thr = a.threshold + beta * ad[rb][hb];
          }
          const float delta = vv - thr;
          z = delta >= 0.f;
          from_f32(z ? 1.f : 0.f, z_out + at);
          if (res_out) from_f32(a.res_is_v ? vv : delta, res_out + at);
          if (a_out) from_f32(ad[rb][hb], a_out + at);
        }
        const unsigned word = __ballot_sync(0xffffffffu, z);
        if ((x & 31) == 0) zn[rb * HWX + (h >> 5)] = word;
      }
    }
    __syncthreads();
  }
}

template <int RB, int HB, typename W>
__global__ void __launch_bounds__(REC_THREADS)
    rec_chain_kernel(RecArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HX = blockDim.x, RY = blockDim.y;
  const int H = a.H, T = a.T, B = a.B, JC = a.JC;
  const int R = RY * RB, HS = HX * HB, HW = (H + 31) / 32;
  const bool resident = JC >= H;
  W* s_w = reinterpret_cast<W*>(smem);  // rows of W_rec^T
  // The rounded dcur(t+1) of the block's rows, (R, HS) float, zero past H.
  float* s_dcr =
      reinterpret_cast<float*>(smem + rec_w_bytes(JC, H, sizeof(W)));
  const int x = threadIdx.x, y = threadIdx.y;
  const int tid = y * HX + x, nthreads = HX * RY;
  const int row0 = blockIdx.x * R + y * RB;
  const W* wt = static_cast<const W*>(a.w);
  for (int i = tid; i < R * HS; i += nthreads) s_dcr[i] = 0.f;
  if (resident) stage_rows(wt, s_w, 0, H, H, tid, nthreads);
  const float beta = a.a_tr ? *a.beta : 0.f;
  bool hok[HB];
  float dcur[RB][HB];
#pragma unroll
  for (int hb = 0; hb < HB; ++hb) hok[hb] = x + hb * HX < H;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int hb = 0; hb < HB; ++hb) dcur[rb][hb] = 0.f;
  const size_t stride = (size_t)B * H;
  const W* g_z = static_cast<const W*>(a.g_z);
  const W* z_tr = static_cast<const W*>(a.z);
  const W* res = static_cast<const W*>(a.res);
  const W* a_tr = static_cast<const W*>(a.a_tr);
  const float* dr_rows = s_dcr + (size_t)y * RB * HS;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    float acc[RB][HB];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int hb = 0; hb < HB; ++hb) acc[rb][hb] = 0.f;
    // dcur(T) = 0: the last step has no recurrent term.
    for (int j0 = 0; t < T - 1 && j0 < H; j0 += JC) {
      const int n = min(JC, H - j0);
      if (!resident) {
        stage_rows(wt, s_w, j0, n, H, tid, nthreads);
        __syncthreads();
      }
      const float* dr = dr_rows + j0;
      int jj = 0;
      for (; jj + 4 <= n; jj += 4) {
        float wv[4][HB];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int hb = 0; hb < HB; ++hb)
            wv[q][hb] = hok[hb]
                ? to_f32(s_w[(size_t)(jj + q) * H + x + hb * HX]) : 0.f;
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const float4 d =
              *reinterpret_cast<const float4*>(dr + rb * HS + jj);
#pragma unroll
          for (int hb = 0; hb < HB; ++hb) {
            float s = acc[rb][hb];
            s = __fmaf_rn(d.x, wv[0][hb], s);
            s = __fmaf_rn(d.y, wv[1][hb], s);
            s = __fmaf_rn(d.z, wv[2][hb], s);
            s = __fmaf_rn(d.w, wv[3][hb], s);
            acc[rb][hb] = s;
          }
        }
      }
      for (; jj < n; ++jj) {
        float wv[HB];
#pragma unroll
        for (int hb = 0; hb < HB; ++hb)
          wv[hb] = hok[hb] ? to_f32(s_w[(size_t)jj * H + x + hb * HX]) : 0.f;
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const float d = dr[rb * HS + jj];
#pragma unroll
          for (int hb = 0; hb < HB; ++hb)
            acc[rb][hb] = __fmaf_rn(d, wv[hb], acc[rb][hb]);
        }
      }
      __syncthreads();
    }
    // The cell's cotangents; dcur(t), rounded, replaces dcur(t+1).
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const int row = row0 + rb;
#pragma unroll
      for (int hb = 0; hb < HB; ++hb) {
        const int h = x + hb * HX;
        bool zp = false;
        float dcr = 0.f;
        if (row < B && hok[hb]) {
          const size_t at = (size_t)t * stride + (size_t)row * H + h;
          float thr = a.threshold;
          if (a_tr) thr = a.threshold + beta * to_f32(a_tr[at]);
          const float rv = to_f32(res[at]);
          const float dlt = a.res_is_v ? rv - thr : rv;
          const float surr = surrogate(a.phi, dlt, thr, a.gamma);
          const float dz = to_f32(g_z[at]) + acc[rb][hb];
          const float dv = dz * surr + a.alpha * dcur[rb][hb];
          zp = t > 0 && to_f32(z_tr[at - stride]) != 0.f;
          const float d = dv * (1.f - (zp ? 1.f : 0.f));
          dcur[rb][hb] = d;
          a.g_i[at] = d;
          dcr = round_w<W>(d);
        }
        s_dcr[(y * RB + rb) * HS + h] = dcr;
        const unsigned word = __ballot_sync(0xffffffffu, zp);
        if ((x & 31) == 0 && row < B && (h >> 5) < HW)
          a.zmask[((size_t)t * B + row) * HW + (h >> 5)] = word;
      }
    }
    __syncthreads();
  }
}

struct RecPlan {
  Tile tile;
  int R, JC, smem_fwd, smem_chain;
  GbitsPlan gb;
  // The tensor-core cluster body's plans (rec_mma.cuh), where they fit.
  bool fwd_mma, chain_mma;
  RecMmaPlan mfwd, mchain;
};

int make_plan(int B, int H, int T, int bf16, int device, RecPlan* p) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || H > 1024 || T < 1) return 1;
  const int wsize = bf16 ? 2 : 4;
  const Tile tl = tile_for(H);
  p->tile = tl;
  p->R = tl.RY * tl.RB;
  const size_t zm = (size_t)2 * p->R * (tl.HX * tl.HB / 32) * 4;
  const size_t dcr = (size_t)p->R * tl.HX * tl.HB * 4;
  const size_t rest = zm > dcr ? zm : dcr;
  // The whole matrix where it fits beside the rest, else chunks of JC rows
  // (a multiple of 32: a chunk starts on a mask word).
  if (rec_w_bytes(H, H, wsize) + rest <= (size_t)lim.max_smem) {
    p->JC = H;
  } else {
    const int jc = (int)(REC_CHUNK_BYTES / ((size_t)H * wsize)) / 32 * 32;
    p->JC = jc < 32 ? 32 : jc;
  }
  p->smem_fwd = (int)(rec_w_bytes(p->JC, H, wsize) + zm);
  p->smem_chain = (int)(rec_w_bytes(p->JC, H, wsize) + dcr);
  if (p->smem_fwd > lim.max_smem || p->smem_chain > lim.max_smem) return 1;
  // Each kernel on the cluster body where its plan fits a block, else on
  // the CUDA-core body; a plan that fits but that the card schedules no
  // cluster of raises.  The float32 chain keeps the CUDA-core body: at
  // H = 512 its cluster plan (16 blocks, one buffer, two warps an SM) ran
  // 1.35x slower than rec_chain (tools/bwd_ablation.py --wide).
  for (int chain = 0; chain < 2; ++chain) {
    RecMmaPlan& m = chain ? p->mchain : p->mfwd;
    const bool cluster = !chain || bf16;
    const int rc = cluster ? rec_mma_plan(B, H, bf16, chain != 0, device,
                                          lim.max_smem, &m)
                           : 1;
    if (rc != 0 && rc != 1) return rc;
    (chain ? p->chain_mma : p->fwd_mma) = rc == 0;
  }
  // g_W_rec on the float32 g_i (one slab at B = 0).
  return gbits_plan(B > 0 ? B : 1, T, H, H, 4, bf16 ? 1 : 3, lim, &p->gb);
}

template <int RB, int HB, typename W>
cudaError_t launch_fwd_t(const RecArgs& a, const RecPlan& p,
                         cudaStream_t s) {
  cudaError_t err = opt_in(rec_fwd_kernel<RB, HB, W>, p.smem_fwd);
  if (err != cudaSuccess) return err;
  rec_fwd_kernel<RB, HB, W>
      <<<dim3((a.B + p.R - 1) / p.R), dim3(p.tile.HX, p.tile.RY),
         p.smem_fwd, s>>>(a);
  return cudaGetLastError();
}

template <int RB, int HB, typename W>
cudaError_t launch_chain_t(const RecArgs& a, const RecPlan& p,
                           cudaStream_t s) {
  cudaError_t err = opt_in(rec_chain_kernel<RB, HB, W>, p.smem_chain);
  if (err != cudaSuccess) return err;
  rec_chain_kernel<RB, HB, W>
      <<<dim3((a.B + p.R - 1) / p.R), dim3(p.tile.HX, p.tile.RY),
         p.smem_chain, s>>>(a);
  return cudaGetLastError();
}

// The CUDA-core body's template instance of a width's tile.
template <typename W>
cudaError_t dispatch_cuda_core(const RecArgs& a, const RecPlan& p,
                               cudaStream_t s, bool chain) {
  switch (p.tile.HB) {
    case 1:
      return chain ? launch_chain_t<8, 1, W>(a, p, s)
                   : launch_fwd_t<8, 1, W>(a, p, s);
    case 2:
      return chain ? launch_chain_t<8, 2, W>(a, p, s)
                   : launch_fwd_t<8, 2, W>(a, p, s);
    case 4:
      return chain ? launch_chain_t<8, 4, W>(a, p, s)
                   : launch_fwd_t<8, 4, W>(a, p, s);
    default:
      return chain ? launch_chain_t<4, 8, W>(a, p, s)
                   : launch_fwd_t<4, 8, W>(a, p, s);
  }
}

// The forward, or the backward's chain, on the body the plan gives the
// shape.
template <typename W>
cudaError_t run_body(const RecArgs& a, const RecPlan& p, cudaStream_t s,
                     bool chain, bool train) {
  if (chain) {
    if (!p.chain_mma) return dispatch_cuda_core<W>(a, p, s, true);
    const RecMmaPlan& m = p.mchain;
    if (m.NT == 2)
      return m.NB == 2 ? rm_launch(rec_mma_chain_kernel<W, 2, 2>, m, a, s)
                       : rm_launch(rec_mma_chain_kernel<W, 1, 2>, m, a, s);
    return m.NB == 2 ? rm_launch(rec_mma_chain_kernel<W, 2, 4>, m, a, s)
                     : rm_launch(rec_mma_chain_kernel<W, 1, 4>, m, a, s);
  }
  if (!p.fwd_mma) return dispatch_cuda_core<W>(a, p, s, false);
  return train ? rm_launch(rec_mma_fwd_kernel<W, true>, p.mfwd, a, s)
               : rm_launch(rec_mma_fwd_kernel<W, false>, p.mfwd, a, s);
}

// The backward: the chain, then g_W_rec's slabs by gbits_mma.
template <typename W>
cudaError_t run_bwd(const RecArgs& a, float* slab, const RecPlan& p,
                    cudaStream_t s) {
  cudaError_t err = run_body<W>(a, p, s, true, true);
  if (err != cudaSuccess) return err;
  const int HW = (a.H + 31) / 32;
  // g_i (T, B, H) and the bits (T, B, HW): row (b, t) at t B + b.
  const GbitsArgs g{a.g_i, a.zmask, slab, a.B, a.T, 1, a.B, 1, a.B, 0, HW,
                    a.H, a.H};
  return launch_gbits<float, W>(g, p.gb, 1, s);
}

}  // namespace

extern "C" {

// out[0] = blocks of g_W_rec slabs of the backward at batch B (block y of
// gbits_mma sums the batch rows [y B / out[0], (y + 1) B / out[0])); then
// for the forward (out[1 .. 6]) and the chain (out[7 .. 12]) the body
// (1: the tensor-core cluster body, 0: the CUDA-core body) and, on the
// cluster body, its plan: blocks a cluster, units a block, rows a cluster,
// exchange buffers, clusters active at once.
// Returns 0 when the shape fits, 1 when it does not, or a CUDA error code.
int snn_rec_scan_plan(int B, int H, int T, int bf16, int device, int* out) {
  RecPlan p;
  const int rc = make_plan(B, H, T, bf16, device, &p);
  if (rc != 0) return rc;
  out[0] = p.gb.groups;
  for (int chain = 0; chain < 2; ++chain) {
    const RecMmaPlan& m = chain ? p.mchain : p.mfwd;
    const bool mma = chain ? p.chain_mma : p.fwd_mma;
    int* o = out + 1 + 6 * chain;
    o[0] = mma ? 1 : 0;
    o[1] = mma ? m.C : 0;
    o[2] = mma ? m.U : 0;
    o[3] = mma ? m.R : 0;
    o[4] = mma ? m.NB : 0;
    o[5] = mma ? m.active : 0;
  }
  return 0;
}

// z (T, B, H) in W's type and, where res is not null (training), the
// residual (v where res_is_v, else delta) and, where a_tr is not null, a.
int snn_rec_scan_fwd(const float* cur, const void* w_rec, const float* beta,
                     void* z, void* res, void* a_tr, int B, int H, int T,
                     int alif, int bf16, int res_is_v, float alpha, float rho,
                     float threshold, int device, void* stream) {
  RecPlan p;
  const int rc = make_plan(B, H, T, bf16, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (B == 0) return 0;
  RecArgs a{cur, w_rec, beta, z, res, a_tr, nullptr, nullptr, nullptr,
            B, H, T, p.JC, alif, res_is_v, 0, alpha, rho, threshold, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool train = res != nullptr;
  const cudaError_t err =
      bf16 ? run_body<__nv_bfloat16>(a, p, s, false, train)
           : run_body<float>(a, p, s, false, train);
  return (int)err;
}

// g_i (T, B, H) float32 and g_W_rec's slabs (groups, H * H) float32 from
// g_z, z and the residuals (W's type) and W_rec^T; zmask (T, B, HW) int32 is
// the call's scratch.  `groups` as snn_rec_scan_plan gave it.
int snn_rec_scan_bwd(const void* g_z, const void* z, const void* res,
                     const void* a_tr, const void* w_rec_t,
                     const float* beta, float* g_i, void* zmask, float* slab,
                     int B, int H, int T, int phi, int bf16, int res_is_v,
                     int groups, float alpha, float threshold, float gamma,
                     int device, void* stream) {
  RecPlan p;
  const int rc = make_plan(B, H, T, bf16, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (groups != p.gb.groups) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0)
    return (int)cudaMemsetAsync(slab, 0, (size_t)groups * H * H * 4, s);
  RecArgs a{nullptr, w_rec_t, beta, const_cast<void*>(z),
            const_cast<void*>(res), const_cast<void*>(a_tr), g_z, g_i,
            static_cast<unsigned*>(zmask), B, H, T, p.JC, 0, res_is_v, phi,
            alpha, 0.f, threshold, gamma};
  const cudaError_t err = bf16 ? run_bwd<__nv_bfloat16>(a, slab, p, s)
                               : run_bwd<float>(a, slab, p, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
