// Feedforward LIF/ALIF scan over precomputed input currents, forward and
// backward: currents (T, B, H) float32 -> z (T, B, H) in the trace type
// (float32 or bfloat16; and, for training, the residuals: delta, or v [and
// a]); backward g_z -> g_i (T, B, H) float32.  Any B and H.
//
// Replaces the TPU kernels
// snnimageclassification_tpu/ops/pallas_scan.py:_alif_fwd_kernel /
// _lif_fwd_kernel (pl.pallas_call in _fwd_call, :280) and _alif_bwd_kernel /
// _lif_bwd_kernel (in _bwd_call, :314), alif_scan / lif_scan.
//
// Forward, per (row, unit) lane (z(-1) = 0, v = a = 0 before step 0):
//   v = (alpha v + i(t))(1 - z(t-1))
//   ALIF: a = rho a + z(t-1), thr = threshold + beta a;  LIF: thr = threshold
//   delta = v - thr,  z(t) = [delta >= 0]
// the cell of lif_cell.cuh (LifCell), so given equal currents the spikes are
// those of fused_layer0_fwd, fused_mid_fwd and rec_scan_fwd.
// Backward, t = T-1 .. 0 (carry = 0 at T):
//   dv = g_z(t) surr(delta(t)) + carry
//   g_i(t) = dv (1 - z(t-1)),  carry = alpha g_i(t)
// delta from the stored residual (v - thr where it is v; Phi's dynamic
// threshold from the stored a).  beta, the reset and the adaptation carry no
// gradient (quirk Q3).
//
// What bounds it on an H100: bytes.  Every lane is independent and does ~10
// operations a step, so the work is the traces: the inference forward reads
// the currents (4 B) and writes z (4 or 2 B) a (row, step, unit), the
// training forward adds one or two residual traces, the backward reads g_z,
// the residuals and z and writes g_i (0.84 GB a served batch at B = 4096,
// H = 256: 0.25 ms at 3.35 TB/s).  One thread a lane of the (T, B, H)
// layout: neighbouring threads take neighbouring units, so every load and
// store of a warp is one coalesced 128-byte (64-byte bf16) transaction; the
// thread walks t with its state in registers and loads SCAN_U currents (or
// backward operands) ahead of the cell steps that use them.  No shared
// memory, no padding, no block barrier.  Built with --fmad=false: the cell
// rounds as the plain PyTorch version.

#include "bwd_common.cuh"
#include "lif_cell.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_U = 8;  // steps whose loads issue together

struct ScanFwdArgs {
  const float* cur;  // (T, B, H)
  LifParams p;       // z, and in training delta / a_tr
  long long n;       // B * H lanes
  int T;
};

template <bool ALIF, bool TRAIN, typename W>
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_fwd_kernel(ScanFwdArgs a) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n) return;
  const float* __restrict__ cur = a.cur;
  LifCell<ALIF> cell(a.p);
  float zp = 0.f;
  const size_t n = (size_t)a.n;
  for (int t0 = 0; t0 < a.T; t0 += SCAN_U) {
    float c[SCAN_U];
#pragma unroll
    for (int k = 0; k < SCAN_U; ++k)
      c[k] = t0 + k < a.T ? __ldg(cur + (size_t)(t0 + k) * n + lane) : 0.f;
#pragma unroll
    for (int k = 0; k < SCAN_U; ++k) {
      if (t0 + k >= a.T) break;
      const bool z = cell.step(a.p, c[k], zp);
      cell.template store<TRAIN, false, W>(a.p, (size_t)(t0 + k) * n + lane,
                                           z);
      zp = z ? 1.f : 0.f;
    }
  }
}

struct ScanBwdArgs {
  const void* g_z;   // (T, B, H) trace type
  const void* z;     // (T, B, H) trace type
  const void* res;   // (T, B, H) trace type: delta, or v (res_is_v)
  const void* a_tr;  // (T, B, H) trace type or null: ALIF + Phi's a
  const float* beta; // (1)
  float* g_i;        // (T, B, H) float32
  long long n;
  int T, phi, res_is_v;
  float alpha, threshold, gamma;
};

template <typename W>
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_bwd_kernel(ScanBwdArgs a) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n) return;
  const size_t n = (size_t)a.n;
  const W* __restrict__ g_z = static_cast<const W*>(a.g_z);
  const W* __restrict__ z_tr = static_cast<const W*>(a.z);
  const W* __restrict__ res = static_cast<const W*>(a.res);
  const W* __restrict__ a_tr = static_cast<const W*>(a.a_tr);
  const float beta = a_tr ? *a.beta : 0.f;
  float carry = 0.f;
  for (int t1 = a.T - 1; t1 >= 0; t1 -= SCAN_U) {
    // Steps t1, t1 - 1, .. down to t1 - SCAN_U + 1 (and >= 0).
    float gz[SCAN_U], rv[SCAN_U], av[SCAN_U], zp[SCAN_U];
#pragma unroll
    for (int k = 0; k < SCAN_U; ++k) {
      const int t = t1 - k;
      const size_t at = (size_t)(t < 0 ? 0 : t) * n + lane;
      gz[k] = t >= 0 ? to_f32(g_z[at]) : 0.f;
      rv[k] = t >= 0 ? to_f32(res[at]) : 0.f;
      av[k] = (t >= 0 && a_tr) ? to_f32(a_tr[at]) : 0.f;
      zp[k] = t > 0 ? to_f32(z_tr[at - n]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < SCAN_U; ++k) {
      const int t = t1 - k;
      if (t < 0) break;
      float thr = a.threshold;
      if (a_tr) thr = a.threshold + beta * av[k];
      const float dlt = a.res_is_v ? rv[k] - thr : rv[k];
      const float surr = surrogate(a.phi, dlt, thr, a.gamma);
      const float dv = gz[k] * surr + carry;
      const float gi = dv * (1.f - (zp[k] != 0.f ? 1.f : 0.f));
      a.g_i[(size_t)t * n + lane] = gi;
      carry = a.alpha * gi;
    }
  }
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + SCAN_THREADS - 1) / SCAN_THREADS);
}

template <bool TRAIN, typename W>
cudaError_t launch_fwd(const ScanFwdArgs& a, bool alif, cudaStream_t s) {
  if (alif)
    scan_fwd_kernel<true, TRAIN, W>
        <<<blocks_for(a.n), SCAN_THREADS, 0, s>>>(a);
  else
    scan_fwd_kernel<false, TRAIN, W>
        <<<blocks_for(a.n), SCAN_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

int check_shape(int B, int H, int T, int device) {
  if (B < 0 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  // The grid's x dimension bounds the lanes.
  if (((long long)B * H + SCAN_THREADS - 1) / SCAN_THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  return (int)cudaSetDevice(device);
}

int scan_fwd(const float* cur, const float* beta, void* z, void* res,
             void* a_tr, int B, int H, int T, int alif, int bf16,
             int res_is_v, float alpha, float rho, float threshold,
             bool train, int device, void* stream) {
  const int rc = check_shape(B, H, T, device);
  if (rc != 0 || B == 0) return rc;
  ScanFwdArgs a;
  a.cur = cur;
  a.p.beta = beta;
  a.p.alpha = alpha;
  a.p.rho = rho;
  a.p.threshold = threshold;
  a.p.z = z;
  a.p.delta = res;
  a.p.a_tr = a_tr;
  a.p.res_is_v = res_is_v;
  a.n = (long long)B * H;
  a.T = T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (train)
    err = bf16 ? launch_fwd<true, __nv_bfloat16>(a, alif, s)
               : launch_fwd<true, float>(a, alif, s);
  else
    err = bf16 ? launch_fwd<false, __nv_bfloat16>(a, alif, s)
               : launch_fwd<false, float>(a, alif, s);
  return (int)err;
}

}  // namespace

extern "C" {

// scan_fwd: z (T, B, H) in the trace type from the currents.
int snn_scan_fwd(const float* cur, const float* beta, void* z, int B, int H,
                 int T, int alif, int bf16, float alpha, float rho,
                 float threshold, int device, void* stream) {
  return scan_fwd(cur, beta, z, nullptr, nullptr, B, H, T, alif, bf16, 0,
                  alpha, rho, threshold, false, device, stream);
}

// scan_fwd_train: z and the residual (v where res_is_v, else delta) and,
// where a_tr is not null, a; the same spikes as snn_scan_fwd.
int snn_scan_fwd_train(const float* cur, const float* beta, void* z,
                       void* res, void* a_tr, int B, int H, int T, int alif,
                       int bf16, int res_is_v, float alpha, float rho,
                       float threshold, int device, void* stream) {
  return scan_fwd(cur, beta, z, res, a_tr, B, H, T, alif, bf16, res_is_v,
                  alpha, rho, threshold, true, device, stream);
}

// scan_bwd: g_i (T, B, H) float32 from g_z, z and the residuals (trace
// type).
int snn_scan_bwd(const void* g_z, const void* z, const void* res,
                 const void* a_tr, const float* beta, float* g_i, int B,
                 int H, int T, int phi, int bf16, int res_is_v, float alpha,
                 float threshold, float gamma, int device, void* stream) {
  const int rc = check_shape(B, H, T, device);
  if (rc != 0 || B == 0) return rc;
  ScanBwdArgs a{g_z, z, res, a_tr, beta, g_i, (long long)B * H, T, phi,
                res_is_v, alpha, threshold, gamma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    scan_bwd_kernel<__nv_bfloat16>
        <<<blocks_for(a.n), SCAN_THREADS, 0, s>>>(a);
  else
    scan_bwd_kernel<float><<<blocks_for(a.n), SCAN_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
