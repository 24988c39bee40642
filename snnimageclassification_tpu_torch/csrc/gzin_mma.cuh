// g_z_in = dcur @ W_in^T on tensor cores: the cotangent of a layer's input
// spike trace, fused_mid_bwd.cu's g_z_in and fused2_bwd.cu's dz0 = dcur1 @
// W1^T where the chain body does not form it itself (chain_mma.cuh, the
// input product of the z-layer and head modes), and fused_mid.gzin.  Port of
// the dense product inside the TPU kernels' bodies
// (pallas_fused_mid.py:_mid_bwd_kernel, pallas_fused2.py:_fused2_bwd_kernel).
//
// C[m, n] = sum_k A[m, k] W[n, k] with A = the chain's rounded dcur as (B T,
// K) row-major (m = b T + t, K = the layer's H) in the weights' type and W =
// W_in (N = Hin, K) row-major; C[m, n] goes to out[t, b, n], rounded once to
// OUT (the type of z_in in fused_mid_bwd.cu; float32 in fused2_bwd.cu).
// bf16 weights take one m16n8k16 product a k16 slice; float32 ones split
// both operands into three bf16 pieces and take the six products of
// head_mma.cuh:mma_split, each slice's sum added in float32 in ascending k
// (ops/fused.py:_gzin_ordered_reference is its plain version in that
// order; the chain body's input product sums in the same order, so both
// give the same bits).
//
// Layout: a persistent block owns a column chunk of BN (<= 128) columns of
// W, whose P bf16 pieces it builds once as B fragments in shared memory,
// and walks row tiles of 128 rows.  A tile's A rows come through a ring of
// GZ_NS = 3 stages of 32 columns each (cp.async, 16 bytes a copy, two
// stages ahead; rows whose bytes are not a multiple of 16 are copied by the
// threads).  The 8 warps are 4 along the rows (32 rows, two m16 tiles) x 2
// along the columns (BN / 2); a warp splits its A fragments into pieces
// once a slice and reuses each B fragment on both m16 tiles.  What bounds it
// on an H100: reading A and writing C once (2 B T (K + N) bytes in the
// weights' type / OUT) against 2 B T K N FLOP, x6 for float32 weights, at
// the tensor cores' rate; measured, neither (PERF.md: 2.8-3.4x the byte
// bound; tiles of 8 steps x 16 rows, one warp a 16-row slice of all
// columns, or stages of the whole K were slower).
#pragma once

#include "chain_mma.cuh"

namespace {

constexpr int GZ_BM = 128;        // rows of a tile
constexpr int GZ_KC = 32;         // A columns a stage
constexpr int GZ_NS = 3;          // stages of the ring
constexpr int GZ_THREADS = 256;
constexpr int GZ_NTW = 8;         // n8 tiles a warp at most
constexpr int GZ_AS = GZ_KC + 8;  // a stage's row stride, in elements

struct GzinPlan {
  int BN, KP, chunks, grid, smem;
  bool async;  // A by cp.async (K * itemsize a multiple of 16 bytes)
};

__host__ __device__ inline size_t gzin_bfrag_bytes(int KP, int BN, int P) {
  return align16(frag_bytes(KP, BN, P));
}

__host__ __device__ inline size_t gzin_smem(int KP, int BN, int P,
                                            int wsize) {
  return gzin_bfrag_bytes(KP, BN, P) +
         (size_t)GZ_NS * GZ_BM * GZ_AS * wsize;
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename W, typename OUT>
__global__ void __launch_bounds__(GZ_THREADS)
    gzin_mma_kernel(const W* __restrict__ A, const W* __restrict__ Wn,
                    OUT* __restrict__ out, int B, int T, int K, int N,
                    GzinPlan p) {
  constexpr int P = pieces<W>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* s_b = reinterpret_cast<uint2*>(smem);
  W* s_a = reinterpret_cast<W*>(smem + gzin_bfrag_bytes(p.KP, p.BN, P));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int BN = p.BN, NT = BN / 8, ntw = NT / 2;
  const int n0 = blockIdx.y * BN;
  // B[k][n] = W[n0 + n, k], the block's column chunk, once.
  fill_b<P>(s_b, p.KP, BN, [&](int k, int n) {
    return k < K && n0 + n < N ? to_f32(Wn[(size_t)(n0 + n) * K + k]) : 0.f;
  }, tid, GZ_THREADS);
  const size_t M = (size_t)B * T;
  const int tiles = (int)((M + GZ_BM - 1) / GZ_BM);
  const int nk = p.chunks;
  const int my_tiles = blockIdx.x < tiles
                           ? (tiles - 1 - blockIdx.x) / gridDim.x + 1
                           : 0;
  const int total = my_tiles * nk;

  // Stage j: tile blockIdx.x + (j / nk) gridDim.x, columns (j % nk) 32 ..
  auto load_stage = [&](int j) {
    if (j < total) {
      const size_t m0 =
          (size_t)(blockIdx.x + (j / nk) * gridDim.x) * GZ_BM;
      const int k0 = (j % nk) * GZ_KC;
      W* st = s_a + (size_t)(j % GZ_NS) * GZ_BM * GZ_AS;
      if (p.async) {
        constexpr int PER = 16 / sizeof(W);
        constexpr int ROWC = GZ_KC / PER;
        for (int i = tid; i < GZ_BM * ROWC; i += GZ_THREADS) {
          const int r = i / ROWC, c = (i % ROWC) * PER;
          const size_t m = m0 + r;
          const bool in = m < M && k0 + c < K;
          cp_async16_zfill(st + r * GZ_AS + c,
                           in ? A + m * K + k0 + c : A, in);
        }
      } else {
        for (int i = tid; i < GZ_BM * GZ_KC; i += GZ_THREADS) {
          const int r = i / GZ_KC, c = i % GZ_KC;
          const size_t m = m0 + r;
          if (m < M && k0 + c < K)
            st[r * GZ_AS + c] = A[m * K + k0 + c];
          else
            from_f32(0.f, st + r * GZ_AS + c);
        }
      }
    }
    cp_async_commit();
  };
  float acc[2][GZ_NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < GZ_NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < GZ_NS - 1; ++j) load_stage(j);
  __syncthreads();
  const bool pairs = (N & 1) == 0;
  for (int j = 0; j < total; ++j) {
    cp_async_wait_group<GZ_NS - 2>();
    __syncthreads();  // stage j in; every warp done with stage j - 1
    load_stage(j + GZ_NS - 1);
    const int kc = j % nk;
    const W* st = s_a + (size_t)(j % GZ_NS) * GZ_BM * GZ_AS +
                  (size_t)wm * 32 * GZ_AS;
    const int slices = min(2, (p.KP - kc * GZ_KC) / 16);
    for (int ks = 0; ks < slices; ++ks) {
      uint32_t af[2][P][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const W* tb = st + mt * 16 * GZ_AS;
        if constexpr (P == 1) {
          load_a(af[mt][0], reinterpret_cast<const uint16_t*>(tb), GZ_AS, ks,
                 lane);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 v = *reinterpret_cast<const float2*>(
                tb + (g + 8 * (r & 1)) * GZ_AS + 16 * ks + 2 * q +
                8 * (r >> 1));
            uint32_t w[P];
            pack_pieces<W, P>(w, v.x, v.y);
#pragma unroll
            for (int pc = 0; pc < P; ++pc) af[mt][pc][r] = w[pc];
          }
        }
      }
      const int kk = kc * (GZ_KC / 16) + ks;
#pragma unroll
      for (int n = 0; n < GZ_NTW; ++n) {
        if (n >= ntw) break;
        uint2 b[P];
#pragma unroll
        for (int pc = 0; pc < P; ++pc)
          b[pc] = load_b(s_b, kk * NT + wn * ntw + n, pc, P, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_split<P>(acc[mt][n], af[mt], b);
      }
    }
    if (kc == nk - 1) {  // the tile's last stage: its rows out
      const size_t m0 = (size_t)(blockIdx.x + (j / nk) * gridDim.x) * GZ_BM +
                        wm * 32;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const size_t m = m0 + mt * 16 + g + 8 * hh;
          if (m < M) {
            const size_t b = m / T, t = m % T;
            OUT* row = out + (t * B + b) * N;
#pragma unroll
            for (int n = 0; n < GZ_NTW; ++n) {
              if (n >= ntw) break;
              const int col = n0 + 8 * (wn * ntw + n) + 2 * q;
              const float x0 = acc[mt][n][2 * hh],
                          x1 = acc[mt][n][2 * hh + 1];
              if (pairs && col + 1 < N) {
                store_pair(row + col, x0, x1);
              } else {
                if (col < N) from_f32(x0, row + col);
                if (col + 1 < N) from_f32(x1, row + col + 1);
              }
            }
          }
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < GZ_NTW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    }
  }
  cp_async_wait_group<0>();
}

// The plan of a (M, K) x (K, N) product on a device with `max_smem` bytes a
// block and `sms` SMs: the widest column chunk (a multiple of 16, at most
// 128) whose fragments and ring fit; blocks: the row tiles, at most the
// blocks resident at once.
template <typename W>
int gzin_plan(long long M, int K, int N, int max_smem, int sms, int per_sm,
              GzinPlan* p) {
  constexpr int P = pieces<W>();
  if (K < 1 || N < 1) return 1;
  p->KP = (K + 15) / 16 * 16;
  p->chunks = (p->KP + GZ_KC - 1) / GZ_KC;
  int bn = (N + 15) / 16 * 16;
  if (bn > 8 * 2 * GZ_NTW) bn = 8 * 2 * GZ_NTW;
  while (bn >= 16 && gzin_smem(p->KP, bn, P, sizeof(W)) > (size_t)max_smem)
    bn -= 16;
  if (bn < 16) return 1;
  p->BN = bn;
  p->smem = (int)gzin_smem(p->KP, bn, P, sizeof(W));
  p->async = ((size_t)K * sizeof(W)) % 16 == 0;
  const long long tiles = (M + GZ_BM - 1) / GZ_BM;
  const int ny = (N + bn - 1) / bn;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1) / ny;
  if (grid < 1) grid = 1;
  if (grid > tiles) grid = tiles > 0 ? tiles : 1;
  p->grid = (int)grid;
  return 0;
}

// Whether a (., K) x (K, N) product has a plan on a device with
// `max_smem` bytes a block.
inline bool gzin_fits(int K, int N, int bf16, int max_smem) {
  GzinPlan p;
  return (bf16 ? gzin_plan<__nv_bfloat16>(1, K, N, max_smem, 1, 1, &p)
               : gzin_plan<float>(1, K, N, max_smem, 1, 1, &p)) == 0;
}

// out (T, B, N) = dcur (B, T, K) @ W (N, K)^T, on `stream`.
template <typename W, typename OUT>
cudaError_t launch_gzin_mma(const void* dcur, const void* w, void* out,
                            int B, int T, int K, int N, int device,
                            cudaStream_t stream) {
  int max_smem = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  auto kernel = gzin_mma_kernel<W, OUT>;
  GzinPlan p;
  if (gzin_plan<W>((long long)B * T, K, N, max_smem, sms, 1, &p) != 0)
    return cudaErrorInvalidConfiguration;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem)) !=
      cudaSuccess)
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, GZ_THREADS, p.smem)) != cudaSuccess)
    return err;
  gzin_plan<W>((long long)B * T, K, N, max_smem, sms, per_sm, &p);
  const int ny = (N + p.BN - 1) / p.BN;
  kernel<<<dim3(p.grid, ny), GZ_THREADS, p.smem, stream>>>(
      static_cast<const W*>(dcur), static_cast<const W*>(w),
      static_cast<OUT*>(out), B, T, K, N, p);
  return cudaGetLastError();
}

}  // namespace
