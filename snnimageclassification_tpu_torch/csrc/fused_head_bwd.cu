// Whole-network head backward: reverse-time surrogate-gradient BPTT of the
// training forward in fused_head.cu, from the logits' (and the spike
// counts') cotangent to the weight gradients.
//
// Replaces the TPU kernel
// snnimageclassification_tpu/ops/pallas_fused.py:_fused_bwd_kernel
// (head=True; pl.pallas_call in _fused_bwd_call), the backward of
// fused_encode_{rec,ff}_scan_head and of their _counts variants.
//
// For t = T-1 .. 0, per batch row (z(t) = [delta(t) >= 0], z(-1) = 0):
//   s(t)    = kappa s(t+1) + g_logits [t == tstar]
//   dz(t)   = s(t) @ W_out^T (+ g_counts) (+ dcur(t+1) @ W_rec^T)
//   dv(t)   = dz(t) surr(delta(t)) + alpha dcur(t+1)
//   dcur(t) = dv(t) (1 - z(t-1))
//   g_W_in  += spikes(t)^T dcur(t)     g_W_rec += z(t-1)^T dcur(t)
//   g_W_out += z(t)^T s(t)             g_b     += sum_rows s(t)
// No gradient flows through the reset, the adaptation, beta or the
// threshold.  As on the TPU, s and dcur are rounded to the weights' type
// before every product and every sum is float32; the carried dcur in
// alpha * dcur stays float32.
//
// What bounds it on an H100: the dense count is 2 B T (F H + 2 H H + 2 H O)
// FLOP, but spikes are 0/1, so only dcur @ W_rec^T is a real product; the
// rest are sums of selected rows.  The chain over T is serial per row, so
// the work is split into four __global__ functions of this source:
//   1. bwd_chain: one block = `rows` batch rows x HP threads, thread (h, r)
//      owns unit h of row r and walks t down.  W_rec^T and W_out sit in
//      shared memory, the rounded dcur of the previous step in a double
//      buffer, one block barrier a step.  It writes dcur(t), rounded to the
//      weights' type (all any product ever sees of it), to a (B, T, H)
//      buffer in device memory, and the bits of z to a (B, T + 1, H / 32)
//      buffer, so that 2. and 3. read one contiguous slab per batch row
//      (a per-row walk over the (T, B, H) residual strides 4 MB a step).
//   2. bwd_gwin: g_W_in.  A feature's spike times are t = L (TTFS) or
//      t = p, 2p, .. (periodic, p the clamped latency), so per row a table
//      S[k] = dcur(k) (TTFS) or S[p] = sum_j dcur(j p) (periodic) turns the
//      product into one gathered row per (row, feature): B F H adds for
//      either encoding.  Each thread keeps 32 accumulators g_W_in[f, h] in
//      registers over all rows its block walks.
//   3. bwd_grec: g_W_rec the same way: the row's dcur and its z bits are
//      staged in shared memory, each thread adds dcur(t)[h] where the bit
//      of z(t-1)[j] is set, for its 32 j.
//   4. bwd_gout: g_W_out and g_b from the row's z bits and its s chain.
// The sums cross rows and blocks.  Blocks run in any order, so each block
// walks its rows in ascending order and writes its partial sums to a slab
// of its own; the host adds the slabs in a fixed order.  No atomics: the
// gradients are the same bits on every run.
// Built with --fmad=false (the elementwise chain rounds as the plain
// PyTorch version does); the dot products use explicit fused multiply-adds.

#include "head_common.cuh"

namespace {

constexpr int NACC = 32;  // accumulators a thread of 2., 3. and 4. holds
constexpr float PHI_EPSILON = 1e-5f;

struct Args {
  const float* g_logits;  // (B, O)
  const int* tstar;       // (B, O)
  const float* g_counts;  // (B, H) or null
  const void* delta;      // (T, B, H) weights' type
  const void* a_tr;       // (T, B, H) weights' type; ALIF with Phi, else null
  const int* lat;         // (B, F)
  const void* w_rec;      // (H, H) or null
  const void* w_out;      // (H, O)
  const float* beta;      // (1)
  void* dcur;             // (B, T, H) weights' type, scratch
  unsigned* zmask;        // (B, T + 1, HP / 32) scratch: row k = bits of z(k-1)
  float* slab_in;         // (n_in, F * H)
  float* slab_rec;        // (n_rec, H * H)
  float* slab_out;        // (n_out, H * O + O)
  int B, F, H, O, T, periodic, phi;
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
// 1. The serial chain
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

template <bool REC, typename W>
__global__ void __launch_bounds__(1024) bwd_chain_kernel(Args a, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = blockDim.x;
  const int H = a.H, O = a.O, T = a.T, B = a.B;
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
  {
    const W* g = static_cast<const W*>(a.w_out);
    for (int i = tid; i < H * O; i += nthreads) s_wout[i] = g[i];
  }
  for (int i = tid; i < 2 * rows * HP; i += nthreads) s_dcr[i] = 0.f;
  for (int i = tid; i < rows * O; i += nthreads) {
    const bool live = row0 + i / O < B;
    s_st[i] = 0.f;
    s_g[i] = live ? a.g_logits[(size_t)row0 * O + i] : 0.f;
    s_ts[i] = live ? a.tstar[(size_t)row0 * O + i] : -1;
  }
  const bool mine = row < B && h < H;
  const W* delta = static_cast<const W*>(a.delta);
  const W* a_tr = static_cast<const W*>(a.a_tr);
  W* dcur_out = static_cast<W*>(a.dcur);
  const float beta = a_tr ? *a.beta : 0.f;
  const float gcnt =
      (mine && a.g_counts) ? a.g_counts[(size_t)row * H + h] : 0.f;
  const size_t step_stride = (size_t)B * H;
  const size_t at0 = (size_t)row * H + h;
  float dcur = 0.f;  // dcur(t+1), float32
  float d_t = mine ? to_f32(delta[(size_t)(T - 1) * step_stride + at0]) : 0.f;
  // This warp's word of the row's z bits (a warp = 32 units of one row).
  unsigned* zrow = row < B
      ? a.zmask + (size_t)row * (T + 1) * HW + (h >> 5) : nullptr;
  if (zrow && (h & 31) == 0) zrow[0] = 0u;  // z(-1)
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const int buf = t & 1;
    // s(t), by the first O threads of each row (strided where O > HP).
    for (int o = h; o < O; o += HP) {
      const int i = r * O + o;
      const float s =
          a.kappa * s_st[i] + s_g[i] * (s_ts[i] == t ? 1.f : 0.f);
      s_st[i] = s;
      s_sr[buf * rows * O + i] = round_w<W>(s);
    }
    // delta(t-1): this step's reset gate, the next step's surrogate.
    const float d_prev =
        (mine && t > 0) ? to_f32(delta[(size_t)(t - 1) * step_stride + at0])
                        : -1.f;
    __syncthreads();
    float dcr = 0.f;
    if (mine) {
      const float* sr = s_sr + buf * rows * O + r * O;
      float dz = 0.f;
      for (int o = 0; o < O; ++o)
        dz = __fmaf_rn(sr[o], to_f32(s_wout[h * O + o]), dz);
      if (a.g_counts) dz = dz + gcnt;
      if (REC) {
        const float* dp = s_dcr + (buf ^ 1) * rows * HP + r * HP;
        dz = dz + rec_product(dp, s_wrec, H, h);
      }
      float thr = a.threshold;
      if (a_tr)
        thr = a.threshold +
              beta * to_f32(a_tr[(size_t)t * step_stride + at0]);
      const float surr = surrogate(a.phi, d_t, thr, a.gamma);
      const float dv = dz * surr + a.alpha * dcur;
      const float zp = d_prev >= 0.f ? 1.f : 0.f;
      dcur = dv * (1.f - zp);
      from_f32(dcur, dcur_out + ((size_t)row * T + t) * H + h);
      dcr = round_w<W>(dcur);
    }
    s_dcr[buf * rows * HP + r * HP + h] = dcr;
    const unsigned zbits = __ballot_sync(0xffffffffu, mine && d_t >= 0.f);
    if (zrow && (h & 31) == 0) zrow[(size_t)(t + 1) * HW] = zbits;
    d_t = d_prev;
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
// 2. g_W_in
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
// 3. g_W_rec
// ---------------------------------------------------------------------------
struct RecLayout {
  size_t raw, zm, total;
};

__host__ __device__ inline RecLayout rec_layout(int T, int HP) {
  RecLayout L;
  size_t off = 0;
  L.raw = off;  // the row's dcur, (T, HP) float
  off = align16(off + (size_t)T * HP * 4);
  L.zm = off;  // z bitmasks: row k holds z(k - 1), (T + 1, HP / 32) words
  off = align16(off + (size_t)(T + 1) * (HP / 32) * 4);
  L.total = off;
  return L;
}

// grid (row groups, chunks of G mask words); thread (h, g) owns
// g_W_rec[j, h] for the 32 j of mask word y * G + g.
template <typename W>
__global__ void __launch_bounds__(1024) bwd_grec_kernel(Args a, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HP = blockDim.x, HW = HP >> 5;
  const int H = a.H, T = a.T, B = a.B;
  const RecLayout L = rec_layout(T, HP);
  float* s_raw = reinterpret_cast<float*>(smem + L.raw);
  unsigned* s_zm = reinterpret_cast<unsigned*>(smem + L.zm);

  const int h = threadIdx.x, g = threadIdx.y;
  const int tid = g * HP + h, nthreads = HP * G;
  const int word = blockIdx.y * G + g;  // the mask word of this thread's j
  const W* dcur = static_cast<const W*>(a.dcur);
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  for (int i = tid; i < T * HP; i += nthreads) s_raw[i] = 0.f;
  __syncthreads();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    stage_row(dcur, s_raw, T, H, HP, b, tid, nthreads);
    const unsigned* zrow = a.zmask + (size_t)b * (T + 1) * HW;
    for (int i = tid; i < (T + 1) * HW; i += nthreads) s_zm[i] = zrow[i];
    __syncthreads();
    if (word < HW) {
      for (int t = 0; t < T; ++t) {
        const float d = s_raw[t * HP + h];
        const unsigned bits = s_zm[t * HW + word];  // z(t - 1)
#pragma unroll
        for (int i = 0; i < NACC; ++i)
          if ((bits >> i) & 1u) acc[i] += d;
      }
    }
    __syncthreads();
  }
  if (word < HW && h < H) {
    float* slab = a.slab_rec + (size_t)blockIdx.x * H * H;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int j = word * 32 + i;
      if (j < H) slab[(size_t)j * H + h] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// 4. g_W_out, g_b
// ---------------------------------------------------------------------------
struct OutLayout {
  size_t zm, sr, sf, total;
};

__host__ __device__ inline OutLayout out_layout(int T, int HP, int O) {
  OutLayout L;
  size_t off = 0;
  L.zm = off;  // z bitmasks as in rec_layout
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

struct Plan {
  int rows, smem_chain, G, smem_in, smem_rec, smem_out, n_f, n_j, n_in, n_rec,
      n_out;
};

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

// 0 when the shape fits, 1 when it does not, else a CUDA error code.
int make_plan(int B, int F, int H, int O, int T, int rec, int bf16,
              int periodic, int device, Plan* p) {
  int max_smem = 0, sm_smem = 0, sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32;
  if (H < 1 || O < 1 || F < 1 || T < 1 || T > 32767 || HP > 1024) return 1;
  const int wsize = bf16 ? 2 : 4;
  const int G = 512 / HP > 0 ? 512 / HP : 1;
  // The readout block keeps g_W_out[h, o] for NACC o per thread and walks
  // the s chain on one thread per output.
  if (O > G * NACC || O > G * HP) return 1;
  p->rows = 0;
  for (int rows = G; rows >= 1; rows /= 2) {
    const size_t smem = chain_layout(H, O, rows, HP, rec, wsize).total;
    if (smem <= (size_t)max_smem) {
      p->rows = rows;
      p->smem_chain = (int)smem;
      break;
    }
  }
  if (p->rows == 0) return 1;
  p->G = G;
  p->smem_in = (int)in_layout(T, HP, G, periodic).total;
  p->smem_rec = (int)rec_layout(T, HP).total;
  p->smem_out = (int)out_layout(T, HP, O).total;
  if (p->smem_in > max_smem || p->smem_rec > max_smem ||
      p->smem_out > max_smem)
    return 1;
  p->n_f = (F + G * NACC - 1) / (G * NACC);
  p->n_j = rec ? (HP / 32 + G - 1) / G : 0;
  // As many blocks as the card holds at once (by shared memory and by
  // threads); each walks its share of the rows in ascending order.
  p->n_in = row_groups(sms, sm_smem, p->smem_in, HP * G, p->n_f, B);
  p->n_rec = rec ? row_groups(sms, sm_smem, p->smem_rec, HP * G, p->n_j, B)
                 : 0;
  p->n_out = row_groups(sms, sm_smem, p->smem_out, HP * G, 1, B);
  return 0;
}

template <typename K>
cudaError_t opt_in(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool REC, typename W>
cudaError_t launch_all(const Args& a, const Plan& p, cudaStream_t s) {
  const int HP = (a.H + 31) / 32 * 32;
  cudaError_t err = opt_in(bwd_chain_kernel<REC, W>, p.smem_chain);
  if (err != cudaSuccess) return err;
  bwd_chain_kernel<REC, W>
      <<<dim3((a.B + p.rows - 1) / p.rows), dim3(HP, p.rows), p.smem_chain,
         s>>>(a, p.rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = opt_in(bwd_gwin_kernel<W>, p.smem_in)) != cudaSuccess)
    return err;
  bwd_gwin_kernel<W>
      <<<dim3(p.n_in, p.n_f), dim3(HP, p.G), p.smem_in, s>>>(a, p.G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (REC) {
    if ((err = opt_in(bwd_grec_kernel<W>, p.smem_rec)) != cudaSuccess)
      return err;
    bwd_grec_kernel<W>
        <<<dim3(p.n_rec, p.n_j), dim3(HP, p.G), p.smem_rec, s>>>(a, p.G);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = opt_in(bwd_gout_kernel<W>, p.smem_out)) != cudaSuccess)
    return err;
  bwd_gout_kernel<W><<<dim3(p.n_out), dim3(HP, p.G), p.smem_out, s>>>(a, p.G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Slab counts for a shape on `device`: out[0] = blocks of g_W_in slabs,
// out[1] = of g_W_rec slabs (0 without recurrence), out[2] = of
// g_W_out/g_b slabs.  Returns 0 when the shape fits the kernels, 1 when it
// does not, or a CUDA error code.
int snn_fused_head_bwd_plan(int B, int F, int H, int O, int T, int rec,
                            int bf16, int periodic, int device, int* out) {
  Plan p;
  const int rc = make_plan(B, F, H, O, T, rec, bf16, periodic, device, &p);
  if (rc == 0) {
    out[0] = p.n_in;
    out[1] = p.n_rec;
    out[2] = p.n_out;
  }
  return rc;
}

int snn_fused_head_bwd(const float* g_logits, const int* tstar,
                       const float* g_counts, const void* delta,
                       const void* a_tr, const int* lat, const void* w_rec,
                       const void* w_out, const float* beta, void* dcur,
                       void* zmask, float* slab_in, float* slab_rec,
                       float* slab_out, int B, int F, int H, int O, int T,
                       int periodic, int phi, int bf16, float alpha,
                       float threshold, float gamma, float kappa, int device,
                       void* stream) {
  Plan p;
  const int rec = w_rec != nullptr;
  const int rc = make_plan(B, F, H, O, T, rec, bf16, periodic, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (B == 0) return 0;
  Args a{g_logits, tstar, g_counts, delta, a_tr, lat, w_rec, w_out, beta,
         dcur, static_cast<unsigned*>(zmask), slab_in, slab_rec, slab_out,
         B, F, H, O, T, periodic, phi, alpha, threshold, gamma, kappa};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = rec ? launch_all<true, __nv_bfloat16>(a, p, s)
              : launch_all<false, __nv_bfloat16>(a, p, s);
  else
    err = rec ? launch_all<true, float>(a, p, s)
              : launch_all<false, float>(a, p, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
