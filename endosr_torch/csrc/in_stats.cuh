// Per-(b, c) Σx and Σx² over H·W of an NHWC tensor, fp32, with no float
// atomics, so a result is bit-stable from run to run. Two routes:
//
// vec16 (in_stats_vec16_kernel, one launch): for x whose channel vectors of
// V = 16 / sizeof(T) elements are 16-byte aligned (base and strides), with
// G = C / V a power of two ≤ 32. Grid (chunks, B); a block of 256 threads
// owns one chunk of one image's pixels and all C channels: thread t adds
// vector g = t mod G of the pixels of lane t / G, every L = 256 / G-th
// pixel, so a warp reads 32 / G whole pixels (512 contiguous bytes at
// C = 64 bf16). Each thread starts IS_UNROLL 16-byte loads before it adds
// any (32 KB in flight a block), stepping (h, w) by L with no division.
// Then a butterfly over the lanes of a warp that share a vector, the warps
// in shared memory in fixed order, and the block writes part[b, chunk, :].
// It takes a ticket on tickets[b]; the block that draws the last one adds
// the chunks in chunk order (J = 256 / C threads a channel, each with 16
// loads in flight, their sums in order), writes out[b, :] and puts
// tickets[b] back to 0. Two blocks fit an SM, so the plan's ≈ 2 blocks an
// SM run as one wave.
//
// v1 (in_stats_partial + in_stats_finish, two launches), for any C and
// strides: grid (chunks, ⌈C/64⌉, B). A block of 64 × 4 threads owns 64
// channels and one chunk of pixels: threadIdx.x runs along the channels (a
// warp reads 32 neighbouring channels of one pixel), threadIdx.y strides
// over the chunk's pixels. Each thread keeps its two sums in registers,
// the four pixel lanes are added in shared memory, and the block writes
// part[b, chunk, c] = (Σx, Σx²). The finish: one thread per (b, c) adds
// the chunks in order.
//
// Both write either the two sums or, with NORM, (mean, 1/√(var+ε)) with
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

// ---- vec16 ----------------------------------------------------------------

#define IS_THREADS 256     // threads of a vec16 statistics block
#define IS_UNROLL 8        // 16-byte loads a thread starts before it adds any
#define IS_BLOCKS_SM 2     // resident blocks an SM (the plan's ≈ 2 an SM)

// whether x can take the vec16 route (see the top of this file)
template <typename T>
static bool in_stats_vec16_ok(const void* x, i64 sb, i64 sy, i64 sx, int C) {
  constexpr int V = 16 / (int)sizeof(T);
  const int G = C / V;
  return C % V == 0 && G >= 1 && G <= 32 && (G & (G - 1)) == 0 &&
         (uintptr_t)x % 16 == 0 && sb % V == 0 && sy % V == 0 && sx % V == 0;
}

// Adds pixels [p0, p1) of image xb (any vec16 strides) into thread
// (g, lane)'s sums: IS_UNROLL 16-byte loads in flight before the adds,
// (h, w) stepped by the block's L pixels with no division.
template <typename T>
__device__ __forceinline__ void in_stats_loads(const T* xb, i64 sy, i64 sx,
                                               int W, int p0, int p1, int g,
                                               int lane, int L, float* s,
                                               float* q) {
  constexpr int V = 16 / (int)sizeof(T);
  xb += g * V;
  int p = p0 + lane;
  int h = p / W, w = p - h * W;  // one division a chunk
  const int dh = L / W, dw = L - dh * W;
  while (p < p1) {
    uint4 r[IS_UNROLL];
    bool ok[IS_UNROLL];
#pragma unroll
    for (int u = 0; u < IS_UNROLL; ++u) {
      ok[u] = p < p1;
      r[u] = ok[u] ? __ldg(reinterpret_cast<const uint4*>(xb + h * sy + w * sx))
                   : make_uint4(0, 0, 0, 0);
      p += L;
      h += dh;
      w += dw;
      if (w >= W) {
        w -= W;
        ++h;
      }
    }
#pragma unroll
    for (int u = 0; u < IS_UNROLL; ++u) {
      if (!ok[u]) continue;
      const T* e = reinterpret_cast<const T*>(&r[u]);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v = to_f<T>(e[k]);
        s[k] += v;
        q[k] = fmaf(v, v, q[k]);
      }
    }
  }
}

template <typename T, bool NORM>
__global__ void __launch_bounds__(IS_THREADS, IS_BLOCKS_SM)
in_stats_vec16_kernel(const T* __restrict__ x, i64 sb, i64 sy, i64 sx, int W,
                      int HW, int C, int per_chunk, float eps,
                      float2* __restrict__ part, int* __restrict__ tickets,
                      float2* __restrict__ out) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int NW = IS_THREADS / 32;
  __shared__ float2 red[NW][256];  // a warp's sums by channel (C ≤ 256)
  __shared__ int last;
  const int tid = threadIdx.x;
  const int G = C / V, lg = __ffs(G) - 1;
  const int g = tid & (G - 1), lane = tid >> lg, L = IS_THREADS >> lg;
  const int chunk = blockIdx.x, chunks = gridDim.x, b = blockIdx.y;
  const int p0 = chunk * per_chunk, p1 = min(HW, p0 + per_chunk);
  const T* xb = x + (i64)b * sb;

  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  in_stats_loads<T>(xb, sy, sx, W, p0, p1, g, lane, L, s, q);
  // the lanes of a warp that share vector g are G apart
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
      q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
    }
  const int warp = tid >> 5;
  if ((tid & 31) < G)
#pragma unroll
    for (int k = 0; k < V; ++k) red[warp][g * V + k] = make_float2(s[k], q[k]);
  __syncthreads();
  if (tid < C) {
    float2 a = red[0][tid];
#pragma unroll
    for (int k = 1; k < NW; ++k) {
      a.x += red[k][tid].x;
      a.y += red[k][tid].y;
    }
    part[((i64)b * chunks + chunk) * C + tid] = a;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[b], 1) == chunks - 1;
  __syncthreads();
  if (!last) return;

  // the last block of image b: thread (c, j) adds chunks j, j + J, ... in
  // order (past L1: other blocks wrote them), then the J sums in order
  __threadfence();
  const int J = IS_THREADS / C, c = tid & (C - 1), j = tid / C;
  const float2* pc = part + (i64)b * chunks * C + c;
  float2 a = make_float2(0.f, 0.f);
  for (int k0 = j; k0 < chunks; k0 += IS_UNROLL * 2 * J) {
    float2 v[IS_UNROLL * 2];  // one batch of loads in flight, then the adds
#pragma unroll
    for (int u = 0; u < IS_UNROLL * 2; ++u) {
      const int k = k0 + u * J;
      v[u] = k < chunks ? __ldcg(pc + (i64)k * C) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < IS_UNROLL * 2; ++u) {
      a.x += v[u].x;
      a.y += v[u].y;
    }
  }
  float2* fin = &red[0][0];  // [J][C]
  fin[j * C + c] = a;
  __syncthreads();
  if (tid < C) {
    float2 r = fin[tid];
    for (int k = 1; k < J; ++k) {
      r.x += fin[k * C + tid].x;
      r.y += fin[k * C + tid].y;
    }
    if (NORM) {
      const float hw = (float)HW;
      const float mean = r.x / hw;
      const float var = fmaxf(r.y / hw - mean * mean, 0.f);
      out[(i64)b * C + tid] = make_float2(mean, 1.0f / sqrtf(var + eps));
    } else {
      out[(i64)b * C + tid] = r;
    }
  }
  if (tid == 0) atomicExch(&tickets[b], 0);
}

// One launch on stream s. part must hold B·chunks·C float2, out B·C float2,
// tickets B zeros (left at 0); chunks · per_chunk ≥ H·W.
template <typename T, bool NORM>
static void in_stats_vec16_launch(const T* x, i64 sb, i64 sy, i64 sx, int B,
                                  int H, int W, int C, int chunks,
                                  int per_chunk, float eps, float2* part,
                                  int* tickets, float2* out, cudaStream_t s) {
  in_stats_vec16_kernel<T, NORM><<<dim3(chunks, B), IS_THREADS, 0, s>>>(
      x, sb, sy, sx, W, H * W, C, per_chunk, eps, part, tickets, out);
}

// the arguments a vec16 launch takes, else false
template <typename T>
static bool in_stats_vec16_args_ok(const void* x, i64 sb, i64 sy, i64 sx,
                                   int B, int H, int W, int C, int chunks,
                                   int per_chunk) {
  return in_stats_vec16_ok<T>(x, sb, sy, sx, C) && B >= 1 && B <= 65535 &&
         H >= 1 && W >= 1 && chunks >= 1 && per_chunk >= 1 &&
         (i64)chunks * per_chunk >= (i64)H * W &&
         (i64)chunks * per_chunk < (1ll << 31) - IS_THREADS * IS_UNROLL;
}
