// The bit-masked weight gradient (gbits_mma.cuh) as a call of its own:
// slab[j, h] = sum over each block's k of bit_j(k) d(k)[h].  Every backward
// of the port launches the kernel inside its own call (fused_head_bwd.cu,
// fused_layer0_bwd.cu, fused_mid_bwd.cu, fused2_bwd.cu, fused_izh_bwd.cu,
// izh_scan.cu, rec_scan.cu); this entry point runs it alone on given
// operands, for its tests, its time and its plan (ops/gbits.py).

#include "gbits_mma.cuh"

namespace {

int plan_for(int B, int T, int J, int H, int dbf16, int wbf16, int device,
             GbitsPlan* p) {
  if (dbf16 && !wbf16) return 1;  // bf16 d is rounded to bf16 weights only
  Limits lim;
  const cudaError_t err = limits(device, &lim);
  if (err != cudaSuccess) return (int)err;
  return gbits_plan(B, T, J, H, dbf16 ? 2 : 4, wbf16 ? 1 : 3, lim, p);
}

}  // namespace

extern "C" {

// The plan at a shape on `device`: out[0] = row groups (slabs a replica;
// block y sums the batch rows [y B / out[0], (y + 1) B / out[0])), out[1]
// = 1 where d streams through the TMA ring, 0 where the threads copy it.
// Returns 0 when the shape fits, 1 when it does not, or a CUDA error code.
int snn_gbits_plan(int B, int T, int J, int H, int dbf16, int wbf16,
                   int device, int* out) {
  GbitsPlan p;
  const int rc = plan_for(B, T, J, H, dbf16, wbf16, device, &p);
  if (rc == 0) {
    out[0] = p.groups;
    out[1] = p.tma;
  }
  return rc;
}

// d (S, B T, H) in bf16 (dbf16) or float32, each value rounded to the
// weights' type (wbf16): row b T + t, mask row b nrows + t (BW words a
// row, replica s at bits + s m_rep words); step_major: d row t B + b, mask
// row t B + b (S = 1).  slab (S, groups, J, H) float32.  `groups` as
// snn_gbits_plan gave it.
int snn_gbits(const void* d, const void* bits, float* slab, int B, int T,
              int step_major, int nrows, int BW, int J, int H,
              long long m_rep, int S, int dbf16, int wbf16, int groups,
              int device, void* stream) {
  GbitsPlan p;
  const int rc = plan_for(B, T, J, H, dbf16, wbf16, device, &p);
  if (rc != 0) return rc == 1 ? (int)cudaErrorInvalidConfiguration : rc;
  if (groups != p.groups || S < 1 || S > 65535 || BW < (J + 31) / 32 ||
      (step_major ? S != 1 : nrows < T))
    return (int)cudaErrorInvalidValue;
  const long long sb = step_major ? 1 : T, st = step_major ? B : 1;
  const long long mb = step_major ? 1 : nrows, mt = step_major ? B : 1;
  const GbitsArgs a{d, static_cast<const unsigned*>(bits), slab, B, T, sb,
                    st, mb, mt, m_rep, BW, J, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dbf16)
    err = launch_gbits<__nv_bfloat16, __nv_bfloat16>(a, p, S, s);
  else if (wbf16)
    err = launch_gbits<float, __nv_bfloat16>(a, p, S, s);
  else
    err = launch_gbits<float, float>(a, p, S, s);
  return (int)err;
}

const char* snn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
