// in_stats for Hopper: one read of x, fp32 Σx and Σx² per (b, c).
//
// Replaces endosr/kernels/in_stats.py::in_stats_pallas (pallas_call at
// :47), whose sequential TPU grid carried the sums from step to step; here
// blocks run in parallel, so the sums are reduced in two stages (see
// in_stats.cuh). Bound on the H100: bytes, x read once (16.8 MB at
// [8,128,128,64] bf16, ≈5 µs at 3.35 TB/s).

#include "in_stats.cuh"

extern "C" {

// x: [B, H, W, C] with element strides sb, sy, sx (channel stride 1);
// part: scratch of B·chunks·C float2; out: [B, C, 2] fp32 (Σx, Σx²).
// dtype: 0 float32, 1 bfloat16.
int in_stats(int dtype, const void* x, i64 sb, i64 sy, i64 sx, int B, int H,
             int W, int C, int chunks, void* part, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    in_stats_launch<float, false>((const float*)x, sb, sy, sx, B, H, W, C,
                                  chunks, 0.f, (float2*)part, (float2*)out, s);
  else
    in_stats_launch<__nv_bfloat16, false>((const __nv_bfloat16*)x, sb, sy, sx,
                                          B, H, W, C, chunks, 0.f,
                                          (float2*)part, (float2*)out, s);
  return (int)cudaGetLastError();
}

const char* in_stats_error(int e) { return cudaGetErrorString((cudaError_t)e); }
}
