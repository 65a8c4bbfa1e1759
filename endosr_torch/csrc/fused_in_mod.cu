// fused_in_mod for Hopper: out = IN(x)·(1 + γ) + β, the tail of a SEAN call.
//
// Replaces endosr/kernels/fused_in_mod.py::fused_instance_norm_modulate
// (pallas_call at :95). The TPU kernel's two phases share one sequential
// grid; here the statistics (Σx, Σx² → mean, 1/√(var+ε), see in_stats.cuh)
// are two small launches and the apply pass a third, all issued by one
// call. The apply pass computes ((x − μ)·inv)·(1 + γ) + β in fp32 from x,
// γ and β in the storage type T and stores T; a thread moves one 16-byte
// vector of channels where the addresses allow, else one element.
//
// Bound on the H100: bytes. x, γ, β read once and out written once is
// 4 × 16.8 MB at [8,128,128,64] bf16, ≈20 µs at 3.35 TB/s; this version
// reads x twice (statistics, then apply), 25 % above that.

#include "in_stats.cuh"

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

extern "C" {

// x, gamma, beta: [B, H, W, C] of one dtype, each with its own element
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

const char* fused_in_mod_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
