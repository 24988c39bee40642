// Spike encoding fused into the input-current product, forward and backward:
// latencies (B, F) int32, W (F, H) -> currents (T, B, H) float32 with
// currents[t] = spikes(t) @ W, the spikes generated from the latencies; and
// g_W = sum_t spikes(t)^T g(t) from the cotangent g (T, B, H) float32.  A
// first layer that no whole-layer kernel takes (a recurrent layer too wide
// for their shared memory) gets its currents here, then rec_scan.cu.
//
// Replaces the TPU kernels
// snnimageclassification_tpu/ops/pallas_encode.py:_fwd_kernel (pl.pallas_call
// in _fwd, :165) and _bwd_kernel (in _bwd_vjp, :209), encoded_input_matmul.
//
// What bounds it on an H100: bytes.  The forward writes T B H floats (1.68 GB
// at B = 8192, T = 100, H = 512: 0.5 ms at the memory rate) and adds one
// weight row per input spike (B F H adds at most under TTFS); the backward
// reads as many.  Spikes are 0/1, so no product is formed:
//   encode_fwd: a block owns `rows` batch rows x HP threads, thread (h, r)
//     unit h of row r, as head_fwd.cuh's kernel: each step one warp a row
//     lists the features firing at t in ascending f (compact), every thread
//     adds their weight rows (add_rows, W in L2) and writes its current.
//     Under periodic encoding the features of period 1 fire at every step
//     t >= 1; their sum is taken once a row (every_step_sum) and added first.
//   encode_bwd: a feature's spike times are t = L (TTFS) or t = p, 2p, ..
//     (periodic, p the clamped latency), so per row a table S[k] = g(k)
//     (TTFS) or S[p] = sum_j g(j p) (periodic) turns the product into one
//     gathered table row a (row, feature): bwd_gwin's design (bwd_common.cuh)
//     tiled over H in chunks of 32 columns, so the table is (T, 32) floats
//     for any H.  Thread (x, g) keeps 32 accumulators g_W[f, h] over the rows
//     its block walks; each block writes a slab of its own, the host adds
//     the slabs in a fixed order: no atomics.
// Built with --fmad=false; every sum is float32 in a fixed order.

#include "bwd_common.cuh"
#include "head_fwd.cuh"

namespace {

struct EncLayout {
  size_t lat, list, cnt, total;
};

__host__ __device__ inline EncLayout enc_layout(int F, int rows) {
  EncLayout L;
  size_t off = 0;
  L.lat = off;  // latencies clamped to [-1, T], (rows, F) int16
  off = align16(off + (size_t)rows * F * 2);
  L.list = off;  // firing feature indices, (rows, F) uint16
  off = align16(off + (size_t)rows * F * 2);
  L.cnt = off;
  off = align16(off + (size_t)rows * 4);
  L.total = off;
  return L;
}

template <typename W>
__global__ void __launch_bounds__(1024)
    encode_fwd_kernel(const int* lat, const W* w, float* out, int B, int F,
                      int H, int T, int periodic, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const EncLayout L = enc_layout(F, rows);
  int16_t* s_lat = reinterpret_cast<int16_t*>(smem + L.lat);
  uint16_t* s_list = reinterpret_cast<uint16_t*>(smem + L.list);
  int* s_cnt = reinterpret_cast<int*>(smem + L.cnt);

  const int HP = blockDim.x;
  const int h = threadIdx.x, r = threadIdx.y;
  const int tid = r * HP + h, nthreads = HP * rows;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * rows;
  for (int i = tid; i < rows * F; i += nthreads) {
    const int b = row0 + i / F;
    const int L0 = b < B ? lat[(size_t)row0 * F + i] : -1;
    s_lat[i] = (int16_t)min(max(L0, -1), T);
  }
  const bool mine = (row0 + r < B) && (h < H);
  __syncthreads();

  const bool every_step = periodic && T >= 2;
  const float cin_every =
      every_step ? every_step_sum(s_lat, s_list, s_cnt, F, rows, row0, B,
                                  warp, lane, mine, r, w, H, h)
                 : 0.f;
  const size_t at0 = (size_t)(row0 + r) * H + h;
  for (int t = 0; t < T; ++t) {
    list_step(s_lat, s_list, s_cnt, F, rows, row0, B, warp, lane, t, T,
              periodic, every_step);
    __syncthreads();
    if (mine)
      out[(size_t)t * B * H + at0] = add_rows(
          t >= 1 ? cin_every : 0.f, s_list + r * F, s_cnt[r], w, H, h);
    __syncthreads();
  }
}

struct EncBwdLayout {
  size_t raw, S, idx, used, total;
};

__host__ __device__ inline EncBwdLayout enc_bwd_layout(int T, int G,
                                                       int periodic) {
  EncBwdLayout L;
  size_t off = 0;
  L.raw = off;  // the row's g for the block's 32 columns, (T, 32) float
  off = align16(off + (size_t)T * 32 * 4);
  L.S = off;  // periodic: sums over the multiples of each period
  off = align16(off + (periodic ? (size_t)T * 32 * 4 : 0));
  L.idx = off;  // table row of each feature of the chunk, or -1
  off = align16(off + (size_t)G * NACC * 2);
  L.used = off;  // periodic: which table rows this row's features read
  off = align16(off + (periodic ? (size_t)T : 0));
  L.total = off;
  return L;
}

// grid (row groups, feature chunks of G * NACC, column chunks of 32); thread
// (x, g) owns the features chunk0 + g + G i, i < NACC, of column h0 + x.
__global__ void __launch_bounds__(1024)
    encode_bwd_kernel(const int* lat, const float* g, float* slab, int B,
                      int F, int H, int T, int periodic) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.y;
  const EncBwdLayout L = enc_bwd_layout(T, G, periodic);
  float* s_raw = reinterpret_cast<float*>(smem + L.raw);
  float* s_S = periodic ? reinterpret_cast<float*>(smem + L.S) : s_raw;
  int16_t* s_idx = reinterpret_cast<int16_t*>(smem + L.idx);
  unsigned char* s_used = smem + L.used;

  const int x = threadIdx.x, gy = threadIdx.y;
  const int tid = gy * 32 + x, nthreads = 32 * G;
  const int f0 = blockIdx.y * G * NACC;
  const int h0 = blockIdx.z * 32, h = h0 + x;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  if (periodic)
    for (int i = tid; i < T; i += nthreads) s_used[i] = 0;
  __syncthreads();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    // The row's g at every step, for the block's columns (zero past H).
    for (int i = tid; i < T * 32; i += nthreads) {
      const int t = i >> 5, hh = h0 + (i & 31);
      s_raw[i] = hh < H ? g[((size_t)t * B + b) * H + hh] : 0.f;
    }
    for (int i = tid; i < G * NACC; i += nthreads) {
      const int f = f0 + i;
      int k = -1;
      if (f < F) {
        const int Lf = lat[(size_t)b * F + f];
        if (periodic) {
          k = max(min(max(Lf, 1), T - 1), 0);
          s_used[k] = 1;  // several threads may write the same 1
        } else if (Lf >= 0 && Lf < T) {
          k = Lf;
        }
      }
      s_idx[i] = (int16_t)k;
    }
    __syncthreads();
    if (periodic) {
      // S[p] = sum of g(t) over t = p, 2p, .. < T; S[0] = g(0) serves
      // T == 1, where the clamped period is 0 and the one step fires.
      for (int i = tid; i < T * 32; i += nthreads) {
        const int p = i >> 5, hh = i & 31;
        if (!s_used[p]) continue;
        float sum = 0.f;
        if (p == 0) {
          sum = s_raw[hh];
        } else {
          for (int t = p; t < T; t += p) sum += s_raw[t * 32 + hh];
        }
        s_S[i] = sum;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int k = s_idx[gy + G * i];
      if (k >= 0) acc[i] += s_S[k * 32 + x];
    }
    if (periodic)
      for (int i = tid; i < T; i += nthreads) s_used[i] = 0;
    __syncthreads();
  }
  if (h < H) {
    float* out = slab + (size_t)blockIdx.x * F * H;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int f = f0 + gy + G * i;
      if (f < F) out[(size_t)f * H + h] = acc[i];
    }
  }
}

struct EncPlan {
  int rows, smem_fwd, G, n_f, n_h, smem_bwd, groups;
};

int make_plan(int B, int F, int H, int T, int periodic, int device,
              EncPlan* p) {
  Limits lim;
  cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  const int HP = (H + 31) / 32 * 32;
  if (H < 1 || F < 1 || T < 1 || F > 65535 || HP > 1024) return 1;
  p->rows = 0;
  for (int rows = 512 / HP > 0 ? 512 / HP : 1; rows >= 1; rows /= 2) {
    const size_t smem = enc_layout(F, rows).total;
    if (smem <= (size_t)lim.max_smem) {
      p->rows = rows;
      p->smem_fwd = (int)smem;
      break;
    }
  }
  if (p->rows == 0) return 1;
  p->G = (F + NACC - 1) / NACC < 32 ? (F + NACC - 1) / NACC : 32;
  p->n_f = (F + p->G * NACC - 1) / (p->G * NACC);
  p->n_h = (H + 31) / 32;
  p->smem_bwd = (int)enc_bwd_layout(T, p->G, periodic).total;
  if (p->smem_bwd > lim.max_smem) return 1;
  p->groups = row_groups(lim.sms, lim.sm_smem, p->smem_bwd, 32 * p->G,
                         p->n_f * p->n_h, B);
  return 0;
}

template <typename W>
cudaError_t launch_fwd(const int* lat, const void* w, float* out, int B,
                       int F, int H, int T, int periodic, int rows,
                       cudaStream_t s) {
  const int HP = (H + 31) / 32 * 32;
  const int smem = (int)enc_layout(F, rows).total;
  cudaError_t err = opt_in(encode_fwd_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  encode_fwd_kernel<W><<<dim3((B + rows - 1) / rows), dim3(HP, rows), smem,
                         s>>>(lat, static_cast<const W*>(w), out, B, F, H, T,
                              periodic, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[0] = rows per block of the forward, out[1] = blocks of g_W slabs of
// the backward.  Returns 0 when the shape fits, 1 when it does not, or a
// CUDA error code.
int snn_encode_plan(int B, int F, int H, int T, int periodic, int device,
                    int* out) {
  EncPlan p;
  const int rc = make_plan(B, F, H, T, periodic, device, &p);
  if (rc == 0) {
    out[0] = p.rows;
    out[1] = p.groups;
  }
  return rc;
}

// currents (T, B, H) float32 from latencies (B, F) and W (F, H).
int snn_encode_fwd(const int* lat, const void* w, float* out, int B, int F,
                   int H, int T, int periodic, int bf16, int rows, int device,
                   void* stream) {
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_fwd<__nv_bfloat16>(lat, w, out, B, F, H, T, periodic,
                                         rows, s)
             : launch_fwd<float>(lat, w, out, B, F, H, T, periodic, rows, s);
  return (int)err;
}

// g_W's slabs (groups, F * H) float32 from latencies (B, F) and the
// cotangent g (T, B, H) float32; `groups` as snn_encode_plan gave it.
int snn_encode_bwd(const int* lat, const float* g, float* slab, int B, int F,
                   int H, int T, int periodic, int groups, int device,
                   void* stream) {
  EncPlan p;
  const int rc = make_plan(B, F, H, T, periodic, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (groups != p.groups) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = opt_in(encode_bwd_kernel, p.smem_bwd);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) {
    return (int)cudaMemsetAsync(slab, 0, (size_t)groups * F * H * 4, s);
  }
  encode_bwd_kernel<<<dim3(groups, p.n_f, p.n_h), dim3(32, p.G), p.smem_bwd,
                      s>>>(lat, g, slab, B, F, H, T, periodic);
  return (int)cudaGetLastError();
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
