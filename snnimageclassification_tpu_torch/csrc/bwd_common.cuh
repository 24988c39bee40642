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
//     for either encoding.  Each thread keeps 32 accumulators g_W_in[f, h] in
//     registers over all rows its block walks.
//   bwd_gbits: sum_t bits(t)^T dcur(t) for a 0/1 left operand given as bit
//     masks: g_W_rec (bits of z(t-1)) and a mid layer's g_W_in (bits of
//     z_in(t)).  The row's dcur and its bits are staged in shared memory,
//     each thread adds dcur(t)[h] where bit j is set, for its 32 j.
//   bwd_gout: g_W_out and g_b from the row's z bits and its s chain.
//   bwd_gzin: g_z_in = dcur @ W_in^T, the cotangent of a layer's input
//     spikes, as a tiled dense product.
// The sums cross rows and blocks.  Blocks run in any order, so each block
// walks its rows in ascending order and writes its partial sums to a slab
// of its own; the host adds the slabs in a fixed order.  No atomics: the
// gradients are the same bits on every run.
// Built with --fmad=false (the elementwise chain rounds as the plain
// PyTorch version does); the dot products use explicit fused multiply-adds.
#pragma once

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
__global__ void __launch_bounds__(1024) bwd_chain_kernel(Args a, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
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

// Batch row b's contiguous (T, H) slab of the (B, T, H) dcur buffer ->
// (T, HP) floats: 16-byte loads where H needs no padding, else by element
// (the pad columns are zeroed once by the caller and never written).
template <typename W>
__device__ __forceinline__ void stage_row(const W* src, float* dst, int T,
                                          int H, int HP, int b, int tid,
                                          int nthreads) {
  constexpr int V = 16 / sizeof(W);
  const W* slab = src + (size_t)b * T * H;
  if (H == HP && (T * H) % V == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(slab);
    for (int i = tid; i < T * H / V; i += nthreads) {
      const uint4 v = q[i];
      const W* e = reinterpret_cast<const W*>(&v);
#pragma unroll
      for (int k = 0; k < V; ++k) dst[i * V + k] = to_f32(e[k]);
    }
  } else {
    for (int i = tid; i < T * H; i += nthreads)
      dst[(i / H) * HP + i % H] = to_f32(slab[i]);
  }
}

// ---------------------------------------------------------------------------
// g_W_in of an encoded first layer
// ---------------------------------------------------------------------------
struct InLayout {
  size_t raw, S, idx, used, total;
};

__host__ __device__ inline InLayout in_layout(int T, int HP, int G,
                                              int periodic) {
  InLayout L;
  size_t off = 0;
  L.raw = off;  // the row's dcur, (T, HP) float
  off = align16(off + (size_t)T * HP * 4);
  L.S = off;  // periodic: sums over the multiples of each period
  off = align16(off + (periodic ? (size_t)T * HP * 4 : 0));
  L.idx = off;  // table row of each feature of the chunk, or -1
  off = align16(off + (size_t)G * NACC * 2);
  L.used = off;  // periodic: which table rows this row's features read
  off = align16(off + (periodic ? (size_t)T : 0));
  L.total = off;
  return L;
}

// grid (row groups, feature chunks of G * NACC); thread (h, g) owns the
// features chunk0 + g + G i, i < NACC, of column h.
template <typename W>
__global__ void __launch_bounds__(1024) bwd_gwin_kernel(Args a, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = blockDim.x;
  const int H = a.H, F = a.F, T = a.T, B = a.B;
  const InLayout L = in_layout(T, HP, G, a.periodic);
  float* s_raw = reinterpret_cast<float*>(smem + L.raw);
  float* s_S = a.periodic ? reinterpret_cast<float*>(smem + L.S) : s_raw;
  int16_t* s_idx = reinterpret_cast<int16_t*>(smem + L.idx);
  unsigned char* s_used = smem + L.used;

  const int h = threadIdx.x, g = threadIdx.y;
  const int tid = g * HP + h, nthreads = HP * G;
  const int f0 = blockIdx.y * G * NACC;
  const W* dcur = static_cast<const W*>(a.dcur);
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  for (int i = tid; i < T * HP; i += nthreads) s_raw[i] = 0.f;
  if (a.periodic)
    for (int i = tid; i < T; i += nthreads) s_used[i] = 0;
  __syncthreads();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    stage_row(dcur, s_raw, T, H, HP, b, tid, nthreads);
    for (int i = tid; i < G * NACC; i += nthreads) {
      const int f = f0 + i;
      int k = -1;
      if (f < F) {
        const int Lf = a.lat[(size_t)b * F + f];
        if (a.periodic) {
          k = max(min(max(Lf, 1), T - 1), 0);
          s_used[k] = 1;  // several threads may write the same 1
        } else if (Lf >= 0 && Lf < T) {
          k = Lf;
        }
      }
      s_idx[i] = (int16_t)k;
    }
    __syncthreads();
    if (a.periodic) {
      // S[p] = sum of dcur(t) over t = p, 2p, .. < T; S[0] = dcur(0) serves
      // T == 1, where the clamped period is 0 and the one step fires.
      // Only the periods this row's features have (two at the production
      // tau: 1 and T - 1).
      for (int i = tid; i < T * HP; i += nthreads) {
        const int p = i / HP, hh = i % HP;
        if (!s_used[p]) continue;
        // Four partial sums, so that four loads are in flight.
        float sum = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        if (p == 0) {
          sum = s_raw[hh];
        } else {
          const float* col = s_raw + hh;
          int t = p;
          for (; t + 3 * p < T; t += 4 * p) {
            sum += col[t * HP];
            s1 += col[(t + p) * HP];
            s2 += col[(t + 2 * p) * HP];
            s3 += col[(t + 3 * p) * HP];
          }
          for (; t < T; t += p) sum += col[t * HP];
        }
        s_S[i] = (sum + s1) + (s2 + s3);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int k = s_idx[g + G * i];
      if (k >= 0) acc[i] += s_S[k * HP + h];
    }
    if (a.periodic)
      for (int i = tid; i < T; i += nthreads) s_used[i] = 0;
    __syncthreads();
  }
  if (h < H) {
    float* slab = a.slab_in + (size_t)blockIdx.x * F * H;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int f = f0 + g + G * i;
      if (f < F) slab[(size_t)f * H + h] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// sum_t bits(t)^T dcur(t): g_W_rec, and g_W_in of a mid layer
// ---------------------------------------------------------------------------
struct BitsLayout {
  size_t raw, bm, total;
};

__host__ __device__ inline BitsLayout bits_layout(int T, int HP, int nrows,
                                                  int BW) {
  BitsLayout L;
  size_t off = 0;
  L.raw = off;  // the row's dcur, (T, HP) float
  off = align16(off + (size_t)T * HP * 4);
  L.bm = off;  // the row's bit masks, (nrows, BW) words
  off = align16(off + (size_t)nrows * BW * 4);
  L.total = off;
  return L;
}

// `bits` holds, per batch row, `nrows` >= T mask rows of BW words; mask row t
// meets dcur(t).  grid (row groups, chunks of G mask words); thread (h, g)
// owns slab[j, h] for the 32 j of mask word y * G + g, j < J.
template <typename W>
__global__ void __launch_bounds__(1024)
    bwd_gbits_kernel(const void* dcur_, const unsigned* bits, float* slab_out,
                     int B, int T, int H, int J, int nrows, int BW, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = blockDim.x;
  const BitsLayout L = bits_layout(T, HP, nrows, BW);
  float* s_raw = reinterpret_cast<float*>(smem + L.raw);
  unsigned* s_bm = reinterpret_cast<unsigned*>(smem + L.bm);

  const int h = threadIdx.x, g = threadIdx.y;
  const int tid = g * HP + h, nthreads = HP * G;
  const int word = blockIdx.y * G + g;  // the mask word of this thread's j
  const W* dcur = static_cast<const W*>(dcur_);
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  for (int i = tid; i < T * HP; i += nthreads) s_raw[i] = 0.f;
  __syncthreads();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    stage_row(dcur, s_raw, T, H, HP, b, tid, nthreads);
    const unsigned* brow = bits + (size_t)b * nrows * BW;
    for (int i = tid; i < nrows * BW; i += nthreads) s_bm[i] = brow[i];
    __syncthreads();
    if (word < BW) {
      for (int t = 0; t < T; ++t) {
        const float d = s_raw[t * HP + h];
        const unsigned m = s_bm[t * BW + word];
#pragma unroll
        for (int i = 0; i < NACC; ++i)
          if ((m >> i) & 1u) acc[i] += d;
      }
    }
    __syncthreads();
  }
  if (word < BW && h < H) {
    float* slab = slab_out + (size_t)blockIdx.x * J * H;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int j = word * 32 + i;
      if (j < J) slab[(size_t)j * H + h] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// g_z_in = dcur @ W_in^T: the cotangent of a layer's input spike trace
// ---------------------------------------------------------------------------
constexpr int GM = 128, GN = 64, GK = 16, GPAD = 4;

// C[m, n] = sum_k A[m, k] Wn[n, k]: A = dcur as (B T, H) row-major (m = b T +
// t), Wn = W_in (Hin, H) row-major.  C goes to g_z_in[t, b, n], rounded once
// to OUT (the type of z_in in fused_mid_bwd.cu; float32 in fused2_bwd.cu).
// 256 threads; thread (tx, ty) owns rows ty * 8 .. + 8 and columns
// tx * 4 .. + 4 of the tile.
template <typename W, typename OUT = W>
__global__ void __launch_bounds__(256)
    bwd_gzin_kernel(const void* dcur_, const void* w_in_, void* g_z_in_,
                    int B, int T, int H, int Hin) {
  __shared__ __align__(16) float s_a[GK][GM + GPAD];
  __shared__ __align__(16) float s_b[GK][GN + GPAD];
  const W* A = static_cast<const W*>(dcur_);
  const W* Wn = static_cast<const W*>(w_in_);
  OUT* C = static_cast<OUT*>(g_z_in_);
  const size_t M = (size_t)B * T;
  const size_t m0 = (size_t)blockIdx.x * GM;
  const int n0 = blockIdx.y * GN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < H; k0 += GK) {
    // Tiles into shared memory, k-major, zero past the edges.
    for (int i = tid; i < GM * GK; i += 256) {
      const int m = i / GK, k = i % GK;
      const size_t gm = m0 + m;
      s_a[k][m] = (gm < M && k0 + k < H) ? to_f32(A[gm * H + k0 + k]) : 0.f;
    }
    for (int i = tid; i < GN * GK; i += 256) {
      const int n = i / GK, k = i % GK;
      s_b[k][n] = (n0 + n < Hin && k0 + k < H)
                      ? to_f32(Wn[(size_t)(n0 + n) * H + k0 + k])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s_a[k][ty * 8 + 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&s_b[k][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
    const size_t b = gm / T, t = gm % T;
    OUT* out = C + (t * B + b) * Hin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Hin) from_f32(acc[i][j], out + n);
    }
  }
}

// ---------------------------------------------------------------------------
// g_W_out, g_b
// ---------------------------------------------------------------------------
struct OutLayout {
  size_t zm, sr, sf, total;
};

__host__ __device__ inline OutLayout out_layout(int T, int HP, int O) {
  OutLayout L;
  size_t off = 0;
  L.zm = off;  // z bitmasks: row k holds z(k - 1), (T + 1, HP / 32) words
  off = align16(off + (size_t)(T + 1) * (HP / 32) * 4);
  L.sr = off;  // rounded s, (T, O)
  off = align16(off + (size_t)T * O * 4);
  L.sf = off;  // s, (T, O)
  off = align16(off + (size_t)T * O * 4);
  L.total = off;
  return L;
}

// grid (row groups); thread (h, g) owns g_W_out[h, o] for o = g + G i,
// thread o < O the s chain of output o and g_b[o].
template <typename W>
__global__ void __launch_bounds__(1024) bwd_gout_kernel(Args a, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = blockDim.x, HW = HP >> 5;
  const int H = a.H, O = a.O, T = a.T, B = a.B;
  const OutLayout L = out_layout(T, HP, O);
  unsigned* s_zm = reinterpret_cast<unsigned*>(smem + L.zm);
  float* s_sr = reinterpret_cast<float*>(smem + L.sr);
  float* s_sf = reinterpret_cast<float*>(smem + L.sf);

  const int h = threadIdx.x, g = threadIdx.y;
  const int tid = g * HP + h, nthreads = HP * G;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float acc_b = 0.f;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const unsigned* zrow = a.zmask + (size_t)b * (T + 1) * HW;
    for (int i = tid; i < (T + 1) * HW; i += nthreads) s_zm[i] = zrow[i];
    if (tid < O) {
      const float gl = a.g_logits[(size_t)b * O + tid];
      const int ts = a.tstar[(size_t)b * O + tid];
      float s = 0.f;
      for (int t = T - 1; t >= 0; --t) {
        s = a.kappa * s + gl * (ts == t ? 1.f : 0.f);
        s_sf[t * O + tid] = s;
        s_sr[t * O + tid] = round_w<W>(s);
      }
    }
    __syncthreads();
    const unsigned* zw = s_zm + HW + (h >> 5);  // z(t) at zw[t * HW]
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = g + G * i;  // the same for the whole warp
      if (o < O) {
        float sum = 0.f;
        for (int t = 0; t < T; ++t)
          if ((zw[t * HW] >> (h & 31)) & 1u) sum += s_sr[t * O + o];
        acc[i] += sum;
      }
    }
    if (tid < O)
      for (int t = 0; t < T; ++t) acc_b += s_sf[t * O + tid];
    __syncthreads();
  }
  float* slab = a.slab_out + (size_t)blockIdx.x * (H * O + O);
  if (h < H) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = g + G * i;
      if (o < O) slab[h * O + o] = acc[i];
    }
  }
  if (tid < O) slab[H * O + tid] = acc_b;
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

}  // namespace
