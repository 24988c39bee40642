// The tensor-core form of bwd_gout (bwd_common.cuh), kept to be measured
// beside it; the main path launches bwd_gout.  tools/bwd_ablation.py's
// `gout_mma` variant launches this in its place (its time), and
// tools/gout_mma_probe.py holds its bits against a plain version in its
// order (PERF.md §6, row 2-gout).
//
// g_W_out = sum over rows of z^T s_r, one m16n8k16 product a k16 slice of a
// row's steps: A = z(t)[h] (units x steps, 0/1, exact in bf16), B = s_r(t)[o]
// (steps x outputs) as P bf16 pieces (head_mma.cuh:split; 1 for bf16
// weights, 3 for float32), each slice into fresh accumulators added in
// float32 (head_mma.cuh:mma_exact).  A warp owns 16 units and every output
// (O <= 16, two n8 tiles), a block 8 warps; the batches, the s chains
// (gout_stage), g_b and the slabs are bwd_gout's.  Slices past the row's
// last tstar add zeros and are skipped.
#pragma once

#include "bwd_common.cuh"
#include "head_mma.cuh"

namespace {

constexpr int GM_WARPS = 8;  // m16 tiles of units a block

template <typename W>
__global__ void __launch_bounds__(32 * GM_WARPS)
    bwd_gout_mma_kernel(Args a0, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = pieces<W>();
  const Args a = at_replica<W>(a0, blockIdx.z);
  const int H = a.H, O = a.O, T = a.T, B = a.B, HW = (H + 31) / 32;
  const int OP = (O + 3) & ~3, NT = (O + 7) / 8;
  const GoutLayout L = gout_layout(R, T, HW, O);
  const unsigned* s_zm = reinterpret_cast<const unsigned*>(smem + L.zm);
  const float* s_sr = reinterpret_cast<const float*>(smem + L.sr);
  const float* s_rs = reinterpret_cast<const float*>(smem + L.rs);
  const int* s_ts = reinterpret_cast<const int*>(smem + L.ts);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int m0 = (blockIdx.y * GM_WARPS + (tid >> 5)) * 16;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float acc_b = 0.f;

  const int nb = (B + R - 1) / R;
  for (int qb = blockIdx.x; qb < nb; qb += gridDim.x) {
    const int rows = min(R, B - qb * R);
    gout_stage<W>(a, L, smem, qb, R, rows, tid, nthreads);
    __syncthreads();
    if (blockIdx.y == 0 && tid < O)
      for (int r = 0; r < rows; ++r) acc_b = acc_b + s_rs[r * OP + tid];
    for (int r = 0; r < rows && m0 < H; ++r) {
      int te = 0;
      for (int o = 0; o < O; ++o) te = max(te, s_ts[r * OP + o] + 1);
      te = min(te, T);
      const unsigned* zr = s_zm + (size_t)r * (T + 1) * HW + HW;  // z(0)
      const float* sr = s_sr + (size_t)r * T * OP;
      for (int t0 = 0; t0 < te; t0 += 16) {
        // bf16 1.0 where unit m0 + m fired at step t0 + k.
        auto zb = [&](int m, int k) -> uint32_t {
          const int h = m0 + m, t = t0 + k;
          return h < H && t < T && ((zr[t * HW + (h >> 5)] >> (h & 31)) & 1u)
                     ? 0x3F80u
                     : 0u;
        };
        const uint32_t af[4] = {zb(gq, 2 * q) | zb(gq, 2 * q + 1) << 16,
                                zb(gq + 8, 2 * q) | zb(gq + 8, 2 * q + 1) << 16,
                                zb(gq, 2 * q + 8) | zb(gq, 2 * q + 9) << 16,
                                zb(gq + 8, 2 * q + 8) |
                                    zb(gq + 8, 2 * q + 9) << 16};
        for (int n = 0; n < NT; ++n) {
          const int o = 8 * n + gq;
          auto sv = [&](int k) {
            const int t = t0 + k;
            return o < O && t < T ? sr[t * OP + o] : 0.f;
          };
          float x[4][P];
          split<P>(sv(2 * q), x[0]);
          split<P>(sv(2 * q + 1), x[1]);
          split<P>(sv(2 * q + 8), x[2]);
          split<P>(sv(2 * q + 9), x[3]);
          uint2 b[P];
#pragma unroll
          for (int p = 0; p < P; ++p)
            b[p] = make_uint2(pack_bf16(x[0][p], x[1][p]),
                              pack_bf16(x[2][p], x[3][p]));
          mma_exact<P>(acc[n], af, b);
        }
      }
    }
    __syncthreads();
  }
  float* slab = block_slab(a.slab_out, (size_t)H * O + O);
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = m0 + gq + (e >> 1) * 8, o = 8 * n + 2 * q + (e & 1);
      if (h < H && o < O) slab[(size_t)h * O + o] = acc[n][e];
    }
  if (blockIdx.y == 0 && tid < O) slab[(size_t)H * O + tid] = acc_b;
}

// bwd_gout's plan (its row groups, R and shared memory), this kernel's
// blocks of 16 GM_WARPS units.
template <typename W>
cudaError_t launch_gout_mma(const Args& a, const GoutPlan& p, int S,
                            cudaStream_t s) {
  if (a.O > 16) return cudaErrorInvalidValue;
  cudaError_t err = opt_in(bwd_gout_mma_kernel<W>, p.smem);
  if (err != cudaSuccess) return err;
  const int n_h = (a.H + 16 * GM_WARPS - 1) / (16 * GM_WARPS);
  bwd_gout_mma_kernel<W><<<dim3(p.groups, n_h, S), 32 * GM_WARPS, p.smem,
                           s>>>(a, p.R);
  return cudaGetLastError();
}

}  // namespace
