// Shared by the Izhikevich kernel sources (izh_scan.cu, fused_izh.cu,
// fused_izh_bwd.cu): the cell's forward step and its reverse-time chain.
//
// Forward, with r = z(t-1) (ops/cells.py izhikevich_step; v(-1) = v_rest,
// u(-1) = 0, z(-1) = 0):
//   dvdt = k (v - v_rest) (v - v_th) - u + cur
//   v'   = (v + dt dvdt / C) (1 - r) + c r
//   u'   = (u + dt a (b (v - v_rest) - u)) + d r
//   z    = [v' >= v_peak]
// dt dvdt / C is (dt * dvdt) / C, an IEEE division, as the plain PyTorch
// version computes it (the sources are built with --fmad=false and without
// fast math).
//
// Backward (JAX package ops/pallas_izh.py, module docstring), two carries
// dv(t+1), du(t+1), for t = T-1 .. 0 (the reset and v_peak get no
// gradient):
//   dcur_next = dv(t+1) (dt/C) (1 - z(t))                  = gi(t+1)
//   dz(t)  = g_z(t), or s(t) @ W_out^T (+ g_counts) for a head, whose z(t)
//            is recomputed as [v(t) >= v_peak]
//   dz(t) += round(dcur_next) @ W_rec^T
//   dv(t)  = dz(t) surr(v(t) - v_peak) + dv(t+1) (1 + (dt k/C)(2 v(t) -
//            v_rest - v_th)) (1 - z(t)) + du(t+1) (dt a b)
//   du(t)  = -dcur_next + du(t+1) (1 - dt a)
//   gi(t)  = dv(t) (dt/C) (1 - z(t-1))
// gi takes the place of dcur in the LIF/ALIF chain (bwd_common.cuh): it is
// the cotangent of the input current, so g_W_in, g_W_rec and the readout's
// gradients come from bwd_gwin, bwd_gbits and bwd_gout unchanged.  The four
// constants dt/C, dt k/C, dt a b and 1 - dt a are rounded to float once, on
// the host, from double expressions, as the JAX kernel's Python constants.
#pragma once

#include "bwd_common.cuh"

namespace {

struct IzhParams {
  float dt, C, v_rest, v_th, k, a, b, c, d, v_peak;
};

// One step of unit state (v, u) from the input current `cur` and the unit's
// previous spike zp (0 or 1).
__device__ __forceinline__ void izh_step(const IzhParams& p, float cur,
                                         float zp, float& v, float& u) {
  const float dvdt = p.k * (v - p.v_rest) * (v - p.v_th) - u + cur;
  const float v_new = (v + p.dt * dvdt / p.C) * (1.f - zp) + p.c * zp;
  const float dudt = p.a * (p.b * (v - p.v_rest) - u);
  u = (u + p.dt * dudt) + p.d * zp;
  v = v_new;
}

struct IzhBwd {
  float dtC, c1, c2, c3;  // dt/C, dt k/C, dt a b, 1 - dt a
  float v_rest, v_th, v_peak, gamma;
  int phi;
};

struct IzhChainArgs {
  const float* g_logits;  // (B, O)            head
  const int* tstar;       // (B, O)            head
  const float* g_counts;  // (B, H) or null    head
  const float* g_z;       // (T, B, H)         z-layer
  const float* z;         // (T, B, H)         z-layer
  const float* v;         // (T, B, H) the membrane after each step
  const void* w_rec;      // (H, H) or null
  const void* w_out;      // (H, O)            head
  float* g_i;             // (T, B, H) or null: gi in float32
  void* dcur;             // (B, T, H) weights' type or null: gi rounded
  unsigned* zmask;        // (B, T + 1, HP / 32) or null: row k = z(k-1)
  int B, H, O, T;
  IzhBwd p;
  float kappa;
};

// The head's arguments for replica s of a stacked launch (gridDim.z = S,
// bwd_common.cuh): each per-replica pointer moved by s of its stride.
template <typename W>
__device__ __forceinline__ IzhChainArgs at_replica(IzhChainArgs a, int s) {
  if (s == 0) return a;
  const size_t B = a.B, T = a.T, H = a.H, O = a.O, HW = (a.H + 31) / 32;
  if (a.g_logits) a.g_logits += s * B * O;
  if (a.tstar) a.tstar += s * B * O;
  if (a.g_counts) a.g_counts += s * B * H;
  if (a.v) a.v += s * T * B * H;
  if (a.w_rec) a.w_rec = static_cast<const W*>(a.w_rec) + s * H * H;
  if (a.w_out) a.w_out = static_cast<const W*>(a.w_out) + s * H * O;
  if (a.g_i) a.g_i += s * T * B * H;
  if (a.dcur) a.dcur = static_cast<W*>(a.dcur) + s * B * T * H;
  if (a.zmask) a.zmask += s * B * (T + 1) * HW;
  return a;
}

// One block = `rows` batch rows x HP threads, thread (h, r) owns unit h of
// row r and walks t down, as bwd_chain does: W_rec^T and W_out in shared
// memory (chain_layout), the rounded gi of the step after in a double
// buffer, one block barrier a step.  Replica blockIdx.z of a stacked head.
template <bool REC, bool HEAD, typename W>
__global__ void __launch_bounds__(1024)
    izh_chain_kernel(IzhChainArgs a0, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const IzhChainArgs a = at_replica<W>(a0, blockIdx.z);
  const int HP = blockDim.x, HW = HP >> 5;
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
  const IzhBwd p = a.p;
  W* dcur_out = static_cast<W*>(a.dcur);
  const float gcnt =
      (HEAD && mine && a.g_counts) ? a.g_counts[(size_t)row * H + h] : 0.f;
  const size_t step_stride = (size_t)B * H;
  const size_t at0 = (size_t)row * H + h;
  float dv_next = 0.f, du_next = 0.f;  // dv(t+1), du(t+1)
  // v(t) and z(t): for a head z is v >= v_peak (the forward took z from
  // exactly this float), else as stored.
  float v_t = mine ? a.v[(size_t)(T - 1) * step_stride + at0] : 0.f;
  bool z_t = HEAD ? (mine && v_t >= p.v_peak)
                  : (mine && a.z[(size_t)(T - 1) * step_stride + at0] != 0.f);
  unsigned* zrow = (a.zmask && row < B)
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
    const bool prev = mine && t > 0;
    const float v_prev =
        prev ? a.v[(size_t)(t - 1) * step_stride + at0] : 0.f;
    const bool z_prev =
        HEAD ? (prev && v_prev >= p.v_peak)
             : (prev && a.z[(size_t)(t - 1) * step_stride + at0] != 0.f);
    const float gz_t =
        (!HEAD && mine) ? a.g_z[(size_t)t * step_stride + at0] : 0.f;
    __syncthreads();
    float gr = 0.f;
    if (mine) {
      const float nr = 1.f - (z_t ? 1.f : 0.f);  // the reset gate of step t+1
      const float dcn = dv_next * p.dtC * nr;    // gi(t+1), bitwise
      float dz = gz_t;
      if (HEAD) {
        const float* sr = s_sr + buf * rows * O + r * O;
        for (int o = 0; o < O; ++o)
          dz = __fmaf_rn(sr[o], to_f32(s_wout[h * O + o]), dz);
        if (a.g_counts) dz = dz + gcnt;
      }
      if (REC) {
        const float* dp = s_dcr + (buf ^ 1) * rows * HP + r * HP;
        dz = dz + rec_product(dp, s_wrec, H, h);
      }
      const float surr = surrogate(p.phi, v_t - p.v_peak, p.v_peak, p.gamma);
      const float dv =
          dz * surr +
          dv_next * (1.f + p.c1 * (2.f * v_t - p.v_rest - p.v_th)) * nr +
          du_next * p.c2;
      const float du = -dcn + du_next * p.c3;
      const float gi = dv * p.dtC * (1.f - (z_prev ? 1.f : 0.f));
      if (a.g_i) a.g_i[(size_t)t * step_stride + at0] = gi;
      if (dcur_out) from_f32(gi, dcur_out + ((size_t)row * T + t) * H + h);
      gr = round_w<W>(gi);
      dv_next = dv;
      du_next = du;
    }
    s_dcr[buf * rows * HP + r * HP + h] = gr;
    const unsigned zbits = __ballot_sync(0xffffffffu, mine && z_t);
    if (zrow && (h & 31) == 0) zrow[(size_t)(t + 1) * HW] = zbits;
    v_t = v_prev;
    z_t = z_prev;
  }
}

}  // namespace
