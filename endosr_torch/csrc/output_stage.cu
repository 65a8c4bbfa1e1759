// output_stage_x8 for Hopper: clamp → un-embed 64→48 → PixelShuffle(4) → fp32.
//
// Replaces endosr/kernels/output_stage.py::output_stage_x8 (pallas_call at
// :275). The embedded head channel i·16 + j·3 + c of input pixel (y, b, x)
// lands at out[b, 4y+i, (4x+j)·3 + c]. For a fixed (y, b, x, i) the twelve
// channels i·16 .. i·16+11 are contiguous in the input and the twelve
// outputs contiguous in row 4y+i, so one thread moves one such run: a pure
// gather with a clamp and a cast, bit-identical to the plain version.
//
// Bound on the H100: bytes, ~67 MB read + ~101 MB written at the flagship
// shape, ≈50 µs at 3.35 TB/s. Threads run along x, so a warp writes 32
// neighbouring 48-byte runs of one output row.

#include "common.cuh"

template <typename T>
__global__ void output_stage_x8_kernel(const T* __restrict__ pre, i64 sy,
                                       i64 sb, i64 sx, int H, int B, int W,
                                       float lo, float hi,
                                       float* __restrict__ out) {
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  i64 n = (i64)H * B * 4 * W;
  if (t >= n) return;
  int x = (int)(t % W);
  i64 r = t / W;
  int i = (int)(r % 4);
  r /= 4;
  int b = (int)(r % B);
  int y = (int)(r / B);
  const T* src = pre + (i64)y * sy + (i64)b * sb + (i64)x * sx + i * 16;
  float* dst = out + ((i64)b * 4 * H + 4 * y + i) * (i64)(12 * W) + 12 * x;
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    float v = to_f<T>(src[q]);
    // clip keeps NaN like jnp.clip / torch.clamp
    v = v < lo ? lo : (v > hi ? hi : v);
    dst[q] = v;
  }
}

extern "C" {

// pre: [H, B, W, 64] (HBWC) with element strides sy, sb, sx (channel stride
// 1); out: contiguous fp32 [B, 4H, 12W]. dtype: 0 float32, 1 bfloat16.
int output_stage_x8(int dtype, const void* pre, i64 sy, i64 sb, i64 sx, int H,
                    int B, int W, float lo, float hi, void* out,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  i64 n = (i64)H * B * 4 * W;
  unsigned blocks = (unsigned)((n + 255) / 256);
  if (dtype == 0)
    output_stage_x8_kernel<float><<<blocks, 256, 0, s>>>(
        (const float*)pre, sy, sb, sx, H, B, W, lo, hi, (float*)out);
  else
    output_stage_x8_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        (const __nv_bfloat16*)pre, sy, sb, sx, H, B, W, lo, hi, (float*)out);
  return (int)cudaGetLastError();
}

const char* output_stage_x8_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
