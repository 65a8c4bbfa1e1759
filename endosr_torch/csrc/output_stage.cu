// Output stages for Hopper: clamp → PixelShuffle(r) → fp32 rows.
//
// output_stage_x8 replaces endosr/kernels/output_stage.py::output_stage_x8
// (pallas_call at :275): the embedded head channel i·16 + j·3 + c of input
// pixel (y, b, x) lands at out[b, 4y+i, (4x+j)·3 + c]. For a fixed
// (y, b, x, i) the twelve channels i·16 .. i·16+11 are contiguous in the
// input and the twelve outputs contiguous in row 4y+i, so one thread moves
// one such run.
//
// output_stage replaces endosr/kernels/output_stage.py::output_stage
// (pallas_calls at :316 and :351) for any r and C:
//   out[b, y·r+i, (x·r+j)·C + c] = float(clamp(pre[b, y, x, c·r² + i·r + j]))
// One thread writes one output float. A block owns one input row segment
// (b, y, 64 pixels) and walks the r output rows it feeds, so every input
// channel vector is fetched from device memory once and re-read from L1;
// the writes of a warp are 32 neighbouring floats of one output row.
//
// Both are pure gathers with a clamp in the storage type and a cast,
// bit-identical to their plain versions. Bound on the H100: bytes (each
// input element read once, each output float written once); at
// [8,256,256,48] bf16 → [8,1024,3072] fp32 that is ~50 MB + ~101 MB,
// ≈45 µs at 3.35 TB/s.

#include "common.cuh"

// clip keeps NaN like jnp.clip / torch.clamp
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

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
  for (int q = 0; q < 12; ++q) dst[q] = clampf(to_f<T>(src[q]), lo, hi);
}

#define OS_XB 64  // input pixels of one row per block

template <typename T>
__global__ void __launch_bounds__(256)
output_stage_kernel(const T* __restrict__ pre, i64 sb, i64 sy, i64 sx, int H,
                    int W, int r, int C, float lo, float hi,
                    float* __restrict__ out) {
  const int x0 = blockIdx.x * OS_XB;
  const int y = blockIdx.y, b = blockIdx.z;
  const int rc = r * C, rr = r * r;
  const int nx = min(OS_XB, W - x0);
  const int n = nx * rc;                      // floats of one output row here
  const float tlo = rnd<T>(lo), thi = rnd<T>(hi);
  const T* src = pre + (i64)b * sb + (i64)y * sy + (i64)x0 * sx;
  const i64 row = (i64)W * rc;
  float* dst = out + ((i64)b * H * r + (i64)y * r) * row + (i64)x0 * rc;
  for (int i = 0; i < r; ++i)
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      int x = e / rc, q = e - x * rc;         // q = j·C + c
      int j = q / C, c = q - j * C;
      dst[(i64)i * row + e] =
          clampf(to_f<T>(src[(i64)x * sx + c * rr + i * r + j]), tlo, thi);
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

// pre: [B, H, W, C·r²] with element strides sb, sy, sx (channel stride 1);
// out: contiguous fp32 [B, H·r, W·r·C]. H and B go on grid.y / grid.z
// (≤ 65535 each). dtype: 0 float32, 1 bfloat16.
int output_stage(int dtype, const void* pre, i64 sb, i64 sy, i64 sx, int B,
                 int H, int W, int r, int C, float lo, float hi, void* out,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((W + OS_XB - 1) / OS_XB, H, B);
  if (dtype == 0)
    output_stage_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)pre, sb, sy, sx, H, W, r, C, lo, hi, (float*)out);
  else
    output_stage_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)pre, sb, sy, sx, H, W, r, C, lo, hi,
        (float*)out);
  return (int)cudaGetLastError();
}

const char* output_stage_x8_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
