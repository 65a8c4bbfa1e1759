// fused_in_mod for Hopper: out = IN(x)·(1 + γ) + β, the tail of a SEAN call.
//
// Replaces endosr/kernels/fused_in_mod.py::fused_instance_norm_modulate
// (pallas_call at :95). The TPU kernel's two phases share one sequential
// grid; here the statistics (Σx, Σx² → mean, 1/√(var+ε), see in_stats.cuh)
// and the apply pass are separate launches made by one call. The apply
// pass computes ((x − μ)·inv)·(1 + γ) + β in fp32 from x, γ and β in the
// storage type T and stores T.
//
// Bound on the H100: bytes. x, γ, β read once and out written once is
// 4 × 16.8 MB at [8,128,128,64] bf16, ≈20 µs at 3.35 TB/s. Two routes:
//
// vec16 (two launches): the one-launch statistics kernel with NORM, then
// in_mod_apply_vec16, a grid-stride loop over 16-byte channel vectors of
// one image a block row: a thread keeps its vector's (μ, inv) in registers
// (its channels stay the same along the loop), finds (h, w) of two pixels
// with 32-bit arithmetic, starts the six 16-byte loads of x, γ and β before
// any math and stores two 16-byte vectors. x's second read finds it in the
// 50 MB L2 (16.8 MB at the flagship shape), so device memory sees about
// the bound's bytes; the apply pass loads and stores with the streaming
// (evict-first) hint, which keeps more of x in L2 until it is read.
// v1 (three launches, any C and strides): the two-launch statistics, then
// in_mod_apply, a thread on one 16-byte vector of channels where the
// addresses allow, else on one element.

#include "in_stats.cuh"

#include <algorithm>

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
in_mod_apply(const T* __restrict__ x, i64 xb, i64 xy, i64 xx,
             const T* __restrict__ g, i64 gb, i64 gy, i64 gx,
             const T* __restrict__ be, i64 bb, i64 by, i64 bx,
             const float2* __restrict__ stats, T* __restrict__ out, int B,
             int H, int W, int C) {
  const int cv = C / VEC;
  i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  i64 n = (i64)B * H * W * cv;
  if (t >= n) return;
  int c = (int)(t % cv) * VEC;
  i64 r = t / cv;
  int w = (int)(r % W);
  r /= W;
  int h = (int)(r % H);
  int b = (int)(r / H);
  __align__(16) T vx[VEC];
  __align__(16) T vg[VEC];
  __align__(16) T vb[VEC];
  __align__(16) T vo[VEC];
  typedef typename std::conditional<VEC == 1, T, uint4>::type Vec;
  *reinterpret_cast<Vec*>(vx) =
      *reinterpret_cast<const Vec*>(x + b * xb + h * xy + w * xx + c);
  *reinterpret_cast<Vec*>(vg) =
      *reinterpret_cast<const Vec*>(g + b * gb + h * gy + w * gx + c);
  *reinterpret_cast<Vec*>(vb) =
      *reinterpret_cast<const Vec*>(be + b * bb + h * by + w * bx + c);
  const float2* st = stats + (i64)b * C + c;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float2 mi = st[k];
    float y = ((to_f<T>(vx[k]) - mi.x) * mi.y) * (1.0f + to_f<T>(vg[k])) +
              to_f<T>(vb[k]);
    vo[k] = from_f<T>(y);
  }
  *reinterpret_cast<Vec*>(out + (((i64)b * H + h) * W + w) * C + c) =
      *reinterpret_cast<const Vec*>(vo);
}

// a tensor whose every channel vector of vec elements starts on 16 bytes
static bool vec_ok(const void* p, i64 s0, i64 s1, i64 s2, int vec) {
  return ((uintptr_t)p % 16 == 0) && s0 % vec == 0 && s1 % vec == 0 &&
         s2 % vec == 0;
}

template <typename T>
static void in_mod_launch(const T* x, i64 xb, i64 xy, i64 xx, const T* g,
                          i64 gb, i64 gy, i64 gx, const T* be, i64 bb, i64 by,
                          i64 bx, int B, int H, int W, int C, int chunks,
                          float eps, float2* part, float2* stats, T* out,
                          cudaStream_t s) {
  in_stats_launch<T, true>(x, xb, xy, xx, B, H, W, C, chunks, eps, part, stats,
                           s);
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec = C % V == 0 && vec_ok(x, xb, xy, xx, V) &&
                   vec_ok(g, gb, gy, gx, V) &&
                   vec_ok(be, bb, by, bx, V) &&
                   (uintptr_t)out % 16 == 0;
  if (vec) {
    i64 n = (i64)B * H * W * (C / V);
    in_mod_apply<T, V><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        x, xb, xy, xx, g, gb, gy, gx, be, bb, by, bx, stats, out, B, H, W, C);
  } else {
    i64 n = (i64)B * H * W * C;
    in_mod_apply<T, 1><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        x, xb, xy, xx, g, gb, gy, gx, be, bb, by, bx, stats, out, B, H, W, C);
  }
}

#define IM_THREADS 256

// grid (blocks, B): block row b walks image b's H·W·G vectors (G = C / V a
// power of two), two a thread a step, i and i + IM_THREADS
template <typename T>
__global__ void __launch_bounds__(IM_THREADS)
in_mod_apply_vec16(const T* __restrict__ x, i64 xb, i64 xy, i64 xx,
                   const T* __restrict__ g, i64 gb, i64 gy, i64 gx,
                   const T* __restrict__ be, i64 bb, i64 by, i64 bx,
                   const float2* __restrict__ stats, T* __restrict__ out, int W,
                   int HW, int C) {
  constexpr int V = 16 / (int)sizeof(T);
  const int G = C / V, lg = __ffs(G) - 1;
  const int b = blockIdx.y, n = HW << lg;
  const int step = gridDim.x * IM_THREADS * 2;
  const int c = (threadIdx.x & (G - 1)) * V;  // the same for every step
  float mu[V], inv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float2 m = __ldg(stats + (i64)b * C + c + k);
    mu[k] = m.x;
    inv[k] = m.y;
  }
  x += b * xb + c;
  g += b * gb + c;
  be += b * bb + c;
  out += (i64)b * HW * C + c;
  for (int i = blockIdx.x * IM_THREADS * 2 + threadIdx.x; i < n; i += step) {
    const int i1 = i + IM_THREADS;
    const bool two = i1 < n;
    const int p0 = i >> lg, p1 = two ? i1 >> lg : p0;
    const int h0 = p0 / W, w0 = p0 - h0 * W;
    const int h1 = p1 / W, w1 = p1 - h1 * W;
    uint4 vx[2] = {}, vg[2] = {}, vb[2] = {}, vo[2];
    vx[0] = __ldcs(reinterpret_cast<const uint4*>(x + h0 * xy + w0 * xx));
    vg[0] = __ldcs(reinterpret_cast<const uint4*>(g + h0 * gy + w0 * gx));
    vb[0] = __ldcs(reinterpret_cast<const uint4*>(be + h0 * by + w0 * bx));
    if (two) {
      vx[1] = __ldcs(reinterpret_cast<const uint4*>(x + h1 * xy + w1 * xx));
      vg[1] = __ldcs(reinterpret_cast<const uint4*>(g + h1 * gy + w1 * gx));
      vb[1] = __ldcs(reinterpret_cast<const uint4*>(be + h1 * by + w1 * bx));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const T* ex = reinterpret_cast<const T*>(&vx[u]);
      const T* eg = reinterpret_cast<const T*>(&vg[u]);
      const T* eb = reinterpret_cast<const T*>(&vb[u]);
      T* eo = reinterpret_cast<T*>(&vo[u]);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float y = ((to_f<T>(ex[k]) - mu[k]) * inv[k]) * (1.0f + to_f<T>(eg[k])) +
                        to_f<T>(eb[k]);
        eo[k] = from_f<T>(y);
      }
    }
    __stcs(reinterpret_cast<uint4*>(out + (i64)p0 * C), vo[0]);
    if (two) __stcs(reinterpret_cast<uint4*>(out + (i64)p1 * C), vo[1]);
  }
}

template <typename T>
static int in_mod_vec16_launch(const T* x, i64 xb, i64 xy, i64 xx, const T* g,
                               i64 gb, i64 gy, i64 gx, const T* be, i64 bb,
                               i64 by, i64 bx, int B, int H, int W, int C,
                               int chunks, int per_chunk, float eps,
                               float2* part, int* tickets, float2* stats,
                               T* out, cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  const i64 n = (i64)H * W * (C / V);
  if (!in_stats_vec16_args_ok<T>(x, xb, xy, xx, B, H, W, C, chunks,
                                 per_chunk) ||
      !in_stats_vec16_ok<T>(g, gb, gy, gx, C) ||
      !in_stats_vec16_ok<T>(be, bb, by, bx, C) || (uintptr_t)out % 16 != 0 ||
      n >= (1ll << 30))
    return (int)cudaErrorInvalidValue;
  in_stats_vec16_launch<T, true>(x, xb, xy, xx, B, H, W, C, chunks, per_chunk,
                                 eps, part, tickets, stats, s);
  // about eight resident blocks an SM over the 132 SMs, split over the images
  const int blocks = (int)std::min<i64>((n + 2 * IM_THREADS - 1) / (2 * IM_THREADS),
                                        std::max(1, 8 * 132 / B));
  in_mod_apply_vec16<T><<<dim3(blocks, B), IM_THREADS, 0, s>>>(
      x, xb, xy, xx, g, gb, gy, gx, be, bb, by, bx, stats, out, W, H * W, C);
  return (int)cudaGetLastError();
}

// The stats-in form: the apply pass alone, from per-(b, c) sums (Σx, Σx²)
// that the caller took over `count` pixels (a row slab's in_stats sums added
// over the ranks of a spatial block). One launch turns them into (μ,
// 1/√(var+ε)) as in_stats_finish<NORM> does, then the apply pass of the
// vec16 or v1 route, whose bytes are the bound's: x, γ, β read, out written.
__global__ void in_mod_norm_sums(const float* __restrict__ s,
                                 const float* __restrict__ q, int BC,
                                 float count, float eps,
                                 float2* __restrict__ out) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BC) return;
  float mean = s[t] / count;
  float var = fmaxf(q[t] / count - mean * mean, 0.f);
  out[t] = make_float2(mean, 1.0f / sqrtf(var + eps));
}

template <typename T>
static int in_mod_stats_launch(const T* x, i64 xb, i64 xy, i64 xx, const T* g,
                               i64 gb, i64 gy, i64 gx, const T* be, i64 bb,
                               i64 by, i64 bx, int B, int H, int W, int C,
                               const float* sum, const float* sumsq,
                               float count, float eps, float2* stats, T* out,
                               int vec16, cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  const int BC = B * C;
  in_mod_norm_sums<<<(BC + 127) / 128, 128, 0, s>>>(sum, sumsq, BC, count, eps,
                                                    stats);
  if (vec16) {
    const i64 n = (i64)H * W * (C / V);
    if (!in_stats_vec16_ok<T>(x, xb, xy, xx, C) ||
        !in_stats_vec16_ok<T>(g, gb, gy, gx, C) ||
        !in_stats_vec16_ok<T>(be, bb, by, bx, C) || (uintptr_t)out % 16 != 0 ||
        n >= (1ll << 30) || B > 65535)
      return (int)cudaErrorInvalidValue;
    const int blocks = (int)std::min<i64>(
        (n + 2 * IM_THREADS - 1) / (2 * IM_THREADS), std::max(1, 8 * 132 / B));
    in_mod_apply_vec16<T><<<dim3(blocks, B), IM_THREADS, 0, s>>>(
        x, xb, xy, xx, g, gb, gy, gx, be, bb, by, bx, stats, out, W, H * W, C);
  } else {
    const bool v = C % V == 0 && vec_ok(x, xb, xy, xx, V) &&
                   vec_ok(g, gb, gy, gx, V) && vec_ok(be, bb, by, bx, V) &&
                   (uintptr_t)out % 16 == 0;
    if (v) {
      i64 n = (i64)B * H * W * (C / V);
      in_mod_apply<T, V><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
          x, xb, xy, xx, g, gb, gy, gx, be, bb, by, bx, stats, out, B, H, W,
          C);
    } else {
      i64 n = (i64)B * H * W * C;
      in_mod_apply<T, 1><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
          x, xb, xy, xx, g, gb, gy, gx, be, bb, by, bx, stats, out, B, H, W,
          C);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" {

// v1. x, gamma, beta: [B, H, W, C] of one dtype, each with its own element
// strides (batch, row, column; channel stride 1); part: scratch of
// B·chunks·C float2; stats: scratch of B·C float2; out: contiguous
// [B, H, W, C]. dtype: 0 float32, 1 bfloat16.
int fused_in_mod(int dtype, const void* x, i64 xb, i64 xy, i64 xx,
                 const void* g, i64 gb, i64 gy, i64 gx, const void* be, i64 bb,
                 i64 by, i64 bx, int B, int H, int W, int C, int chunks,
                 float eps, void* part, void* stats, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    in_mod_launch<float>((const float*)x, xb, xy, xx, (const float*)g, gb, gy,
                         gx, (const float*)be, bb, by, bx, B, H, W, C, chunks,
                         eps, (float2*)part, (float2*)stats, (float*)out, s);
  else
    in_mod_launch<__nv_bfloat16>(
        (const __nv_bfloat16*)x, xb, xy, xx, (const __nv_bfloat16*)g, gb, gy,
        gx, (const __nv_bfloat16*)be, bb, by, bx, B, H, W, C, chunks, eps,
        (float2*)part, (float2*)stats, (__nv_bfloat16*)out, s);
  return (int)cudaGetLastError();
}

// vec16: as fused_in_mod in two launches (see the top of this file), the
// statistics in chunks × B blocks of per_chunk pixels; tickets: B int32
// zeros, left at 0. Returns cudaErrorInvalidValue for tensors the route
// does not take.
int fused_in_mod_vec16(int dtype, const void* x, i64 xb, i64 xy, i64 xx,
                       const void* g, i64 gb, i64 gy, i64 gx, const void* be,
                       i64 bb, i64 by, i64 bx, int B, int H, int W, int C,
                       int chunks, int per_chunk, float eps, void* part,
                       void* tickets, void* stats, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return in_mod_vec16_launch<float>(
        (const float*)x, xb, xy, xx, (const float*)g, gb, gy, gx,
        (const float*)be, bb, by, bx, B, H, W, C, chunks, per_chunk, eps,
        (float2*)part, (int*)tickets, (float2*)stats, (float*)out, s);
  if (dtype == 1)
    return in_mod_vec16_launch<__nv_bfloat16>(
        (const __nv_bfloat16*)x, xb, xy, xx, (const __nv_bfloat16*)g, gb, gy,
        gx, (const __nv_bfloat16*)be, bb, by, bx, B, H, W, C, chunks,
        per_chunk, eps, (float2*)part, (int*)tickets, (float2*)stats,
        (__nv_bfloat16*)out, s);
  return (int)cudaErrorInvalidValue;
}

// stats-in: out = ((x − μ)·rsqrt(var+ε))·(1 + γ) + β with μ and var from
// sum, sumsq ([B, C] fp32, contiguous) over count pixels; stats: scratch of
// B·C float2; vec16: 1 for the vec16 apply pass (cudaErrorInvalidValue if
// the tensors do not take it), 0 for v1's.
int fused_in_mod_stats(int dtype, const void* x, i64 xb, i64 xy, i64 xx,
                       const void* g, i64 gb, i64 gy, i64 gx, const void* be,
                       i64 bb, i64 by, i64 bx, int B, int H, int W, int C,
                       const void* sum, const void* sumsq, float count,
                       float eps, void* stats, void* out, int vec16,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return in_mod_stats_launch<float>(
        (const float*)x, xb, xy, xx, (const float*)g, gb, gy, gx,
        (const float*)be, bb, by, bx, B, H, W, C, (const float*)sum,
        (const float*)sumsq, count, eps, (float2*)stats, (float*)out, vec16,
        s);
  if (dtype == 1)
    return in_mod_stats_launch<__nv_bfloat16>(
        (const __nv_bfloat16*)x, xb, xy, xx, (const __nv_bfloat16*)g, gb, gy,
        gx, (const __nv_bfloat16*)be, bb, by, bx, B, H, W, C,
        (const float*)sum, (const float*)sumsq, count, eps, (float2*)stats,
        (__nv_bfloat16*)out, vec16, s);
  return (int)cudaErrorInvalidValue;
}

const char* fused_in_mod_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
