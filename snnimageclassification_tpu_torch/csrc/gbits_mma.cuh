// The bit-masked weight gradient on tensor cores: one template for every
// g_W_rec of the port and a mid layer's g_W_in,
//
//   slab[j, h] = sum over this block's k of bit_j(k) d(k)[h],
//
// where k runs over (batch row, step) pairs, bit_j(k) is a 0/1 spike given
// as bit masks and d(k) the chain's cotangent of the input current.
// Replaces the bit-walked sums of bwd_gbits (the head, layer 0, the mid
// layer, the two-layer pair, the Izhikevich head and izh_scan) and of
// rec_scan.cu's rec_gw; the TPU kernels' counterpart is the dot_general of
// z(t-1)^T and dcur in pallas_fused.py:_fused_bwd_kernel (and _mid_, _izh_,
// _fused2_bwd_kernel) and pallas_rec.py:253-267.
//
// K order.  k runs over (batch row b, step t).  d is a (rows, H) view in
// the type D it is stored in (the weights' type; rec_scan's float32 g_i),
// row b d_sb + t d_st, each value rounded to the weights' type W as it is
// read: the fused callers' dcur is (B, T, H) (d_sb = T, d_st = 1), the wide
// net's g_i (T, B, H) (d_sb = 1, d_st = B).  Mask row b m_sb + t m_st holds
// bit_j(b, t) (the head's zmask (B, T + 1, HW): m_sb = T + 1, row t =
// z(t - 1); rec_chain writes its bits (T, B, HW)).  A block owns the batch
// rows [y B / groups, (y + 1) B / groups) and walks them in k16 slices of
// 16 rows at one step, the steps in ascending order and within a step its
// chunks of 16 rows: the rows of a slice sit at one depth of the reverse
// chain, so their values span few binades and the slice's exact sum fits
// float32 more often than 16 steps of one row would.
//
// What bounds it on an H100: the bits are 0/1 and exact in bf16, so the sum
// is a product, M = J, N = H, K = B T (26.8 GFLOP at the flagship; the
// wide net's 429 GFLOP), and d is read once (0.125 / 0.063 ms at the
// flagship, 0.50 ms of g_i in the wide net).  bf16 d is one bf16 operand;
// float32 d its three bf16 pieces (head_mma.cuh:split), three products a
// tile, each exact because A is 0/1.
//
// Design.  A block owns a 128 x 128 output tile (grid x; the J tiles the
// fastest index, so the tiles that read the same d rows run together and
// share them in L2) and a range of batch rows (grid y, `groups` of them, as
// many as the card holds blocks of one tile; replicas of a stacked launch
// on grid z).  d streams through a TMA ring of NS stages of four slices,
// NS - 1 stages ahead (3D boxes of 128 bytes of columns x 16 batch rows at
// one step, in the 128-byte swizzle; cp.async.bulk.tensor, an mbarrier a
// stage); the mask words come by cp.async, two stages ahead.  The 8 warps
// split the tile 2 (j) x 4 (h), 64 x 32 each, accumulators in registers.
// A (the bits) is built once a block a stage into shared memory in the
// lane order of mma.m16n8k16 (a shift, then a byte permute, a mask and a
// multiply by bf16 1.0 a register; one block barrier a stage), and a warp
// loads its four A fragments once a k16 slice and reuses them across its
// four n8 tiles.  B comes straight from the swizzled stage, conflict-free:
// bf16 d by ldmatrix.trans (its bits are the operand), float32 d by one
// load a value, rounded to W and split into P pieces in registers.  Each
// k16 slice's products go to fresh accumulators added in float32, round to
// nearest (head_mma.cuh:mma_exact): chained float32 accumulators truncate
// on the tensor cores.  The block walks its slices in order and writes a
// slab of its own; the host adds the slabs in float64 and rounds once
// (ops/fused.py:gbits_sums).  No atomics: the same bits on every run.
// Where TMA cannot read d (H * sizeof(D) not a multiple of 16 bytes or
// below 128, or a batch below 16 rows) the threads copy each stage into
// one slot in the same layout; the plan says so.
// ops/gbits.py:_gbits_ordered_reference is the plain version in this order.
#pragma once

#include <initializer_list>

#include "bwd_common.cuh"
#include "head_mma.cuh"

namespace {

constexpr int GB_WARPS = 8;               // 2 (j) x 4 (h) warps a block
constexpr int GB_THREADS = 32 * GB_WARPS;
constexpr int GB_JT = 128;                // output rows (j) a block
constexpr int GB_NT = 128;                // output columns (h) a block
constexpr int GB_KS = 64;                 // k rows a stage: four k16 slices
constexpr int GB_JW = GB_JT / 32;         // mask words of a block's rows
constexpr int GB_MT = GB_JT / 16;         // m16 tiles a block
constexpr int GB_BOX = 128;               // bytes of a box row (the swizzle)

struct GbitsPlan {
  int n_jt, n_ht, NS, tma, groups, smem;
};

// d and the mask words are indexed by (batch row b, step t): d's row (b
// d_sb + t d_st) of a (rows, H) view (replica z at z B T rows), the mask
// row (b m_sb + t m_st) of BW words (replica z at z m_rep words).
struct GbitsArgs {
  const void* d;          // (S, B T, H) in D
  const unsigned* bits;
  float* slab;            // (S, groups, J * H)
  int B, T;
  long long d_sb, d_st, m_sb, m_st, m_rep;
  int BW, J, H;
};

struct GbitsLayout {
  size_t stage, afrag, afragbuf, bits, bar, total;
};

// NS ring stages of four slices, each slice (GB_NT * dsize / 128) boxes of
// 16 rows x 128 bytes in the 128-byte swizzle (1024-byte aligned); two A
// fragment buffers of (KS / 16, MT, 32) uint4; three buffers of (KS, JW)
// mask words; an mbarrier a stage.
__host__ __device__ inline GbitsLayout gbits_layout(int NS, int dsize) {
  GbitsLayout L;
  L.stage = (size_t)GB_KS * GB_NT * dsize;  // a multiple of 1024
  size_t off = (size_t)NS * L.stage;
  L.afrag = off;
  L.afragbuf = (size_t)(GB_KS / 16) * GB_MT * 32 * 16;
  off += 2 * L.afragbuf;
  L.bits = off;
  off += (size_t)3 * GB_KS * GB_JW * 4;
  L.bar = off;
  L.total = align16(off + (size_t)NS * 8) + 1024;  // room to align the ring
  return L;
}

// Byte offset in a stage of d's element (slice i, row r, column c), D of
// `es` bytes: box c / (128 / es) of the slice, its 16-byte group XORed with
// the row (CU_TENSOR_MAP_SWIZZLE_128B on a 1024-byte aligned box).
__device__ __forceinline__ uint32_t gb_off(int i, int r, int c, int es) {
  const int cb = c * es / GB_BOX, cc = (c * es) % GB_BOX;
  return (uint32_t)(((i * (GB_NT * es / GB_BOX) + cb) * 16 + r) * GB_BOX +
                    (((cc >> 4) ^ (r & 7)) << 4) + (cc & 15));
}

// Generic-proxy writes to shared memory before the async proxy (TMA) takes
// the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Two floats as a bf16x2 word (round to nearest), `lo` in the low half.
__device__ __forceinline__ uint32_t cvt2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The P bf16 pieces of lo and hi (head_mma.cuh:split of each), a word a
// piece, largest first.
template <int P>
__device__ __forceinline__ void split2(float lo, float hi,
                                       uint32_t (&w)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    w[p] = cvt2(lo, hi);
    lo -= __uint_as_float(w[p] << 16);
    hi -= __uint_as_float(w[p] & 0xffff0000u);
  }
}

// b0 and b1 of two n8 tiles from four 8 x 8 bf16 matrices of shared memory,
// transposed: lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_t4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// bf16 1.0 where bit b of u (low half) and of v (high half) is set; u and
// v hold the bits of rows g + 8 i at byte i (b = 0, 8, 16 or 24).
template <int B>
__device__ __forceinline__ uint32_t bit_pair(uint32_t u, uint32_t v) {
  constexpr uint32_t sel = (B / 8) | ((B / 8) << 4) | ((4 + B / 8) << 8) |
                           ((4 + B / 8) << 12);
  return (__byte_perm(u, v, sel) & 0x00010001u) * 0x3F80u;
}

// Lane (g, q)'s A fragment of the m16 tile of rows 16 hh .. 16 hh + 15 of
// a mask word, for one k16 slice: y[i] is the word of slice row 2q, 2q + 1,
// 2q + 8, 2q + 9 (i = 0 .. 3), shifted right by g.
template <int HH>
__device__ __forceinline__ uint4 build_a(const uint32_t (&y)[4]) {
  return make_uint4(bit_pair<16 * HH>(y[0], y[1]),
                    bit_pair<16 * HH + 8>(y[0], y[1]),
                    bit_pair<16 * HH>(y[2], y[3]),
                    bit_pair<16 * HH + 8>(y[2], y[3]));
}

// A block's share: batch rows [b0, b1) in C chunks of 16, and its slices
// in order, t = 0 .. T - 1 and within a step the chunks: slice q is (t, c)
// = (q / C, q % C).
struct GbitsShare {
  int b0, b1, C, nsl;
};

__device__ __forceinline__ GbitsShare gbits_share(const GbitsArgs& a) {
  GbitsShare sh;
  const int G = gridDim.y, y = blockIdx.y;
  sh.b0 = (int)((long long)y * a.B / G);
  sh.b1 = (int)(((long long)y + 1) * a.B / G);
  sh.C = (sh.b1 - sh.b0 + 15) / 16;
  sh.nsl = sh.C * a.T;
  return sh;
}

template <typename D, typename W, bool TMA>
__global__ void __launch_bounds__(GB_THREADS, 2)
    gbits_mma_kernel(const __grid_constant__ CUtensorMap dmap, GbitsArgs a,
                     int NS) {
  constexpr int P = pieces<W>(), ES = sizeof(D);
  constexpr int CB = GB_BOX / ES;  // columns a box
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const GbitsLayout L = gbits_layout(NS, ES);
  uint4* s_afrag = reinterpret_cast<uint4*>(smem + L.afrag);
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem + L.bits);
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + L.bar);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n_jt = (a.J + GB_JT - 1) / GB_JT;
  const int jt = blockIdx.x % n_jt, ht = blockIdx.x / n_jt;
  const int h0 = ht * GB_NT, jw0 = jt * GB_JW;
  const int nbx = min(GB_NT, a.H - h0 + CB - 1) / CB;  // boxes past H: none
  const int z = blockIdx.z;
  const GbitsShare sh = gbits_share(a);
  const int nst = (sh.nsl + 3) / 4;  // stages of four slices
  const unsigned* bits = a.bits + (size_t)z * a.m_rep;
  const D* d = static_cast<const D*>(a.d) + (size_t)z * a.B * a.T * a.H;

  // This thread's mask word of stage s into buffer buf: stage row kl = tid
  // / JW (slice kl / 16 of the stage, its row kl % 16), word tid % JW.
  auto fetch_bits = [&](int s, int buf) {
    const int kl = tid / GB_JW, w = jw0 + tid % GB_JW;
    const int sq = 4 * s + kl / 16;
    const int t = sq / sh.C, b = sh.b0 + 16 * (sq % sh.C) + kl % 16;
    unsigned* dst = s_bits + buf * GB_KS * GB_JW + tid;
    if (sq < sh.nsl && b < sh.b1 && w < a.BW)
      cp_async4(dst, bits + (b * a.m_sb + t * a.m_st) * a.BW + w);
    else
      *dst = 0u;
  };
  // Thread 0: stage s's slices (up to four), nbx TMA boxes (128 bytes of
  // columns x 16 batch rows at one step) each, completing on the stage's
  // mbarrier.
  auto load_stage = [&](int s) {
    uint64_t* bar = s_full + s % NS;
    const int n = min(4, sh.nsl - 4 * s);
    mbar_expect(bar, (uint32_t)(n * nbx * 16 * GB_BOX));
    unsigned char* st = smem + (size_t)(s % NS) * L.stage;
    for (int i = 0; i < n; ++i) {
      const int sq = 4 * s + i, t = sq / sh.C;
      const int b = z * a.B + sh.b0 + 16 * (sq % sh.C);
      for (int cb = 0; cb < nbx; ++cb) {
        unsigned char* dst = st + gb_off(i, 0, cb * CB, ES);
        if (a.d_sb < a.d_st)  // the map's dims (H, B, T)
          tma_3d(dst, &dmap, bar, h0 + cb * CB, b, t);
        else  // (H, T, S B)
          tma_3d(dst, &dmap, bar, h0 + cb * CB, t, b);
      }
    }
  };
  // Without TMA: all threads copy stage s into the one slot, zeros past
  // the share, the last slice and H.
  auto copy_stage = [&](int s) {
    for (int e = tid; e < GB_KS * GB_NT; e += GB_THREADS) {
      const int i = e / (16 * GB_NT), r = (e / GB_NT) % 16, c = e % GB_NT;
      const int sq = 4 * s + i, t = sq / sh.C;
      const int b = sh.b0 + 16 * (sq % sh.C) + r;
      D v;
      from_f32(0.f, &v);
      if (sq < sh.nsl && b < sh.b1 && h0 + c < a.H)
        v = d[(b * a.d_sb + t * a.d_st) * a.H + h0 + c];
      *reinterpret_cast<D*>(smem + gb_off(i, r, c, ES)) = v;
    }
  };

  // Zero the ring once: a slot's bytes that no box writes (past the last
  // slice or past H) then hold zeros or finite data of an earlier stage,
  // which the zero bits of A take to zero.
  for (int i = tid; i < (int)(NS * L.stage / 16); i += GB_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (TMA && tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(s_full + s);
    mbar_fence_init();
  }
  fence_proxy_async();
  __syncthreads();
  if (TMA && tid == 0)
    for (int s = 0; s < NS && s < nst; ++s) load_stage(s);
  // Mask words two stages ahead: the A pass of stage s reads words that
  // every thread waited for before the barrier of stage s - 1.
  for (int s = 0; s < 2 && s < nst; ++s) fetch_bits(s, s);
  cp_async_wait_all();
  __syncthreads();

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  const int wj = warp & 1, wh = warp >> 1;

  for (int s = 0; s < nst; ++s) {
    const int buf = s & 1;
    if (!TMA) {
      __syncthreads();  // every warp is done with stage s - 1
      copy_stage(s);
    }
    cp_async_wait_all();
    // The stage's A fragments, once a block: item (kk, m16 tile mt) a warp
    // at a time, lane (g, q)'s four registers from the mask words of slice
    // kk's rows 2q, 2q + 1, 2q + 8, 2q + 9.
    uint4* fa = s_afrag + (size_t)buf * (L.afragbuf / 16);
    const unsigned* sbits = s_bits + (s % 3) * GB_KS * GB_JW;
#pragma unroll
    for (int i = 0; i < (GB_KS / 16) * GB_MT / GB_WARPS; ++i) {
      const int item = warp + GB_WARPS * i;
      const int kk = item / GB_MT, mt = item % GB_MT;
      uint32_t y[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        y[r] = sbits[(16 * kk + 2 * q + (r & 1) + 8 * (r >> 1)) * GB_JW +
                     mt / 2] >> g;
      fa[item * 32 + lane] = (mt & 1) ? build_a<1>(y) : build_a<0>(y);
    }
    // A in; every warp done with stage s - 1, its ring slot free.
    __syncthreads();
    if (TMA && tid == 0 && s >= 1 && s - 1 + NS < nst)
      load_stage(s - 1 + NS);
    if (s + 2 < nst) fetch_bits(s + 2, (s + 2) % 3);
    if (TMA) mbar_wait(s_full + s % NS, (s / NS) & 1);

    const unsigned char* st = smem + (TMA ? (size_t)(s % NS) * L.stage : 0);
    const uint32_t st_u32 = smem_u32(st);
    // The stage's slices rolled: unrolled, bf16 spills and runs slower
    // (tools/bwd_ablation.py, gbits_slices_unrolled).
#pragma unroll 1
    for (int kk = 0; kk < GB_KS / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint4 v = fa[(kk * GB_MT + 4 * wj + mt) * 32 + lane];
        af[mt][0] = v.x;
        af[mt][1] = v.y;
        af[mt][2] = v.z;
        af[mt][3] = v.w;
      }
      // B of the warp's n8 tiles (columns 32 wh ..), two at a time, k =
      // the slice's row: b0 rows 2q, 2q + 1, b1 rows 2q + 8, 2q + 9,
      // column g.
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint2 b[2][P];
        if constexpr (ES == 2) {  // bf16 d and weights: the bits, transposed
          const int k = 8 * ((lane >> 3) & 1) + (lane & 7);
          const int c = 32 * wh + 16 * n2 + 8 * (lane >> 4);
          uint32_t r[4];
          ldmatrix_t4(r, st_u32 + gb_off(kk, k, c, ES));
          b[0][0] = make_uint2(r[0], r[1]);
          b[1][0] = make_uint2(r[2], r[3]);
        } else {  // float32 d: W's pieces of each value
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const int c = 32 * wh + 8 * (2 * n2 + nn) + g;
            float v[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              v[r] = *reinterpret_cast<const float*>(
                  st + gb_off(kk, 2 * q + (r & 1) + 8 * (r >> 1), c, ES));
            uint32_t lo[P], hi[P];
            split2<P>(v[0], v[1], lo);
            split2<P>(v[2], v[3], hi);
#pragma unroll
            for (int p = 0; p < P; ++p) b[nn][p] = make_uint2(lo[p], hi[p]);
          }
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            mma_exact<P>(acc[mt][2 * n2 + nn], af[mt], b[nn]);
      }
    }
  }
  float* slab = a.slab + ((size_t)z * gridDim.y + blockIdx.y) * a.J * a.H;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = jt * GB_JT + 64 * wj + 16 * mt + g + 8 * (e >> 1);
        const int h = h0 + 32 * wh + 8 * n + 2 * q + (e & 1);
        if (j < a.J && h < a.H) slab[(size_t)j * a.H + h] = acc[mt][n][e];
      }
}

// The plan of a call: output tiles, the ring (NS stages, or one slot the
// threads fill), the row groups and shared memory.  dsize: bytes of D; P:
// pieces of W.  0 when the shape fits, 1 when it does not.
inline int gbits_plan(int B, int T, int J, int H, int dsize, int P,
                      const Limits& lim, GbitsPlan* p) {
  if (B < 1 || T < 1 || J < 1 || H < 1) return 1;
  p->n_jt = (J + GB_JT - 1) / GB_JT;
  p->n_ht = (H + GB_NT - 1) / GB_NT;
  // TMA needs 16-byte row strides, a box of 128 bytes of columns within
  // a row, and one of 16 rows within the batch.
  p->tma = ((size_t)H * dsize) % 16 == 0 && H * dsize >= GB_BOX && B >= 16;
  p->NS = 0;
  if (p->tma) {
    // The most stages that keep two blocks an SM (what its registers hold:
    // __launch_bounds__) within its shared memory, else within a block's.
    const size_t room = (size_t)lim.sm_smem / 2 - 1024;
    for (size_t cap : {room, (size_t)lim.max_smem})
      for (int ns = 4; ns >= 2 && p->NS == 0; --ns)
        if (gbits_layout(ns, dsize).total <= cap) p->NS = ns;
    if (p->NS == 0) p->tma = 0;
  }
  if (!p->tma) p->NS = 1;
  p->smem = (int)gbits_layout(p->NS, dsize).total;
  if (p->smem > lim.max_smem) return 1;
  // Row groups: as many as the card holds blocks of one tile at once (by
  // shared memory, 1 KB a block being the system's, and by registers: two,
  // __launch_bounds__); a shape of several tiles runs them in waves, the
  // tiles of a group together.  At a small batch every block takes one
  // row, so each slice holds one term.
  int per_sm = lim.sm_smem / (p->smem + 1024);
  if (per_sm > 2) per_sm = 2;
  if (per_sm < 1) per_sm = 1;
  long long groups = (long long)lim.sms * per_sm;
  if (groups > B) groups = B;
  if (groups > 65535) groups = 65535;
  p->groups = groups < 1 ? 1 : (int)groups;
  return 0;
}

// Launches gbits_mma_kernel<D, W> on S replicas (slabs (S, groups, J H)).
template <typename D, typename W>
cudaError_t launch_gbits(const GbitsArgs& a, const GbitsPlan& p, int S,
                         cudaStream_t s) {
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (p.tma) {
    if (reinterpret_cast<uintptr_t>(a.d) % 16 != 0)
      return cudaErrorMisalignedAddress;
    PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
    if (!encode) return cudaErrorNotSupported;
    // A box is 128 bytes of columns of 16 batch rows at one step, in the
    // 128-byte swizzle: dims (H, T, S B), or (H, B, T) where batch rows are
    // the nearer (the wide net's g_i).
    const cuuint64_t row = (cuuint64_t)a.H * sizeof(D);
    const bool bt = a.d_sb < a.d_st;
    const cuuint64_t dims[3] = {
        (cuuint64_t)a.H, bt ? (cuuint64_t)a.B : (cuuint64_t)a.T,
        bt ? (cuuint64_t)a.T : (cuuint64_t)S * a.B};
    const cuuint64_t strides[2] = {row * (bt ? a.d_sb : a.d_st),
                                   row * (bt ? a.d_st : a.d_sb)};
    const cuuint32_t box[3] = {(cuuint32_t)(GB_BOX / sizeof(D)),
                               bt ? 16u : 1u, bt ? 1u : 16u};
    const cuuint32_t estr[3] = {1, 1, 1};
    const CUresult rc = encode(
        &map,
        sizeof(D) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        3, const_cast<void*>(a.d), dims, strides, box, estr,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  auto kernel = p.tma ? gbits_mma_kernel<D, W, true>
                      : gbits_mma_kernel<D, W, false>;
  cudaError_t err = opt_in(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.n_jt * p.n_ht, p.groups, S), GB_THREADS, p.smem, s>>>(
      map, a, p.NS);
  return cudaGetLastError();
}

// The plan of g_W_rec (or a mid layer's g_W_in) on a (B, T, H) dcur in the
// weights' type W.
template <typename W>
int gbits_plan_rows(int B, int T, int J, int H, const Limits& lim,
                    GbitsPlan* p) {
  return gbits_plan(B, T, J, H, sizeof(W), pieces<W>(), lim, p);
}

// Launches it on dcur (S, B, T, H) and masks of nrows rows a batch row
// (BW words a row, row t meets dcur(t)), the replica's masks `m_rep` words
// on.
template <typename W>
cudaError_t launch_gbits_rows(const void* dcur, const unsigned* bits,
                              float* slab, int B, int T, int J, int H,
                              int nrows, int BW, long long m_rep,
                              const GbitsPlan& p, int S, cudaStream_t s) {
  const GbitsArgs a{dcur, bits, slab, B, T, T, 1, nrows, 1, m_rep, BW, J, H};
  return launch_gbits<W, W>(a, p, S, s);
}

}  // namespace
