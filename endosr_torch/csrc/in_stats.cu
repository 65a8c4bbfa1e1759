// in_stats for Hopper: one read of x, fp32 Σx and Σx² per (b, c).
//
// Replaces endosr/kernels/in_stats.py::in_stats_pallas (pallas_call at
// :47), whose sequential TPU grid carried the sums from step to step; here
// blocks run in parallel, so the sums are reduced per chunk of pixels and
// the chunks added in a fixed order (see in_stats.cuh): in one launch on
// the vec16 route (the last block of an image adds them), in two on v1.
// Bound on the H100: bytes, x read once (16.8 MB at [8,128,128,64] bf16,
// ≈5 µs at 3.35 TB/s); vec16 keeps 32 KB of 16-byte loads in flight a
// block for it.

#include "in_stats.cuh"

extern "C" {

// v1. x: [B, H, W, C] with element strides sb, sy, sx (channel stride 1);
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

// vec16: as in_stats, in one launch of chunks × B blocks of per_chunk
// pixels each; tickets: B int32 zeros, left at 0. Returns
// cudaErrorInvalidValue for an x the route does not take.
int in_stats_vec16(int dtype, const void* x, i64 sb, i64 sy, i64 sx, int B,
                   int H, int W, int C, int chunks, int per_chunk, void* part,
                   void* tickets, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && in_stats_vec16_args_ok<float>(x, sb, sy, sx, B, H, W, C,
                                                  chunks, per_chunk))
    in_stats_vec16_launch<float, false>((const float*)x, sb, sy, sx, B, H, W,
                                        C, chunks, per_chunk, 0.f,
                                        (float2*)part, (int*)tickets,
                                        (float2*)out, s);
  else if (dtype == 1 && in_stats_vec16_args_ok<__nv_bfloat16>(
                             x, sb, sy, sx, B, H, W, C, chunks, per_chunk))
    in_stats_vec16_launch<__nv_bfloat16, false>(
        (const __nv_bfloat16*)x, sb, sy, sx, B, H, W, C, chunks, per_chunk,
        0.f, (float2*)part, (int*)tickets, (float2*)out, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* in_stats_error(int e) { return cudaGetErrorString((cudaError_t)e); }
}
