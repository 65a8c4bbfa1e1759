// Per-(b, c) Σx and Σx² over H·W of an NHWC tensor, fp32, in two stages
// with no atomics, so a result is bit-stable from run to run.
//
// Stage 1 (in_stats_partial): grid (chunks, ⌈C/64⌉, B). A block of 64 × 4
// threads owns 64 channels and one chunk of pixels: threadIdx.x runs along
// the channels (a warp reads 32 neighbouring channels of one pixel),
// threadIdx.y strides over the chunk's pixels. Each thread keeps its two
// sums in registers, the four pixel lanes are added in shared memory, and
// the block writes part[b, chunk, c] = (Σx, Σx²).
// Stage 2 (in_stats_finish): one thread per (b, c) adds the chunks in
// order and writes either the two sums or (mean, 1/√(var+ε)) with
// var = max(E[x²] − mean², 0).
#pragma once

#include "common.cuh"

#define IS_CT 64   // channels per block
#define IS_PY 4    // pixel lanes per block

template <typename T>
__global__ void __launch_bounds__(IS_CT * IS_PY)
in_stats_partial(const T* __restrict__ x, i64 sb, i64 sy, i64 sx, int W,
                 int HW, int C, int per_chunk, float2* __restrict__ part) {
  __shared__ float2 red[IS_PY][IS_CT];
  const int c = blockIdx.y * IS_CT + threadIdx.x;
  const int b = blockIdx.z, chunk = blockIdx.x;
  const int p0 = chunk * per_chunk;
  const int p1 = min(HW, p0 + per_chunk);
  float s = 0.f, q = 0.f;
  if (c < C) {
    const T* xb = x + (i64)b * sb + c;
#pragma unroll 4
    for (int p = p0 + threadIdx.y; p < p1; p += IS_PY) {
      int h = p / W, w = p - h * W;
      float v = to_f<T>(xb[(i64)h * sy + (i64)w * sx]);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  red[threadIdx.y][threadIdx.x] = make_float2(s, q);
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
#pragma unroll
    for (int k = 1; k < IS_PY; ++k) {
      s += red[k][threadIdx.x].x;
      q += red[k][threadIdx.x].y;
    }
    part[((i64)b * gridDim.x + chunk) * C + c] = make_float2(s, q);
  }
}

// part [B, chunks, C] → out [B, C] as float2: (Σx, Σx²), or with NORM
// (mean, rsqrt(var + eps)) over hw elements.
template <bool NORM>
__global__ void in_stats_finish(const float2* __restrict__ part, int chunks,
                                int C, int BC, float hw, float eps,
                                float2* __restrict__ out) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BC) return;
  int b = t / C, c = t - b * C;
  float s = 0.f, q = 0.f;
  for (int k = 0; k < chunks; ++k) {
    float2 v = part[((i64)b * chunks + k) * C + c];
    s += v.x;
    q += v.y;
  }
  if (NORM) {
    float mean = s / hw;
    float var = fmaxf(q / hw - mean * mean, 0.f);
    out[t] = make_float2(mean, 1.0f / sqrtf(var + eps));
  } else {
    out[t] = make_float2(s, q);
  }
}

// Launch both stages on stream s. part must hold B·chunks·C float2, out
// B·C float2.
template <typename T, bool NORM>
static void in_stats_launch(const T* x, i64 sb, i64 sy, i64 sx, int B, int H,
                            int W, int C, int chunks, float eps, float2* part,
                            float2* out, cudaStream_t s) {
  const int HW = H * W;
  const int per_chunk = (HW + chunks - 1) / chunks;
  dim3 grid(chunks, (C + IS_CT - 1) / IS_CT, B);
  in_stats_partial<T><<<grid, dim3(IS_CT, IS_PY), 0, s>>>(
      x, sb, sy, sx, W, HW, C, per_chunk, part);
  const int BC = B * C;
  in_stats_finish<NORM><<<(BC + 127) / 128, 128, 0, s>>>(
      part, chunks, C, BC, (float)HW, eps, out);
}
