// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel here computes what its plain PyTorch version computes, in
// the same op and dtype order: products accumulate in fp32, the sum is
// rounded to the storage type T, and bias, activation and gates then run
// with a rounding to T after each op (rnd<T>). For T = float the
// roundings are the identity.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

typedef long long i64;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision, kept as float
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// max(x, s·x) with s and the product rounded to T (the twin's leaky_relu);
// the product of two bf16 values is exact in fp32, so one rounding of it
// equals the bf16 multiply
template <typename T> __device__ __forceinline__ float lrelu_t(float x, float slope) {
  float s = rnd<T>(slope);
  return fmaxf(x, rnd<T>(x * s));
}

__device__ __forceinline__ float relu_f(float x) { return x > 0.f ? x : 0.f; }

// 16 consecutive bf16 values into two 16-byte registers (vector loads when
// the address allows)
__device__ __forceinline__ void load16_bf16(const __nv_bfloat16* p, uint4* r) {
  if (((uintptr_t)p & 15) == 0) {
    r[0] = reinterpret_cast<const uint4*>(p)[0];
    r[1] = reinterpret_cast<const uint4*>(p)[1];
  } else {
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(r);
#pragma unroll
    for (int q = 0; q < 16; ++q) d[q] = p[q];
  }
}

// ---------------------------------------------------------------------------
// Implicit-GEMM direct convolution, fp32 accumulation on the CUDA cores.
//
// Output pixels (b, oy, ox) form the M axis (ox fastest), output channels
// the N axis, and K = (ky, kx, c) with c fastest (HWIO weights row-major
// [KH·KW·Cin, Cout]). A block computes a 64×64 tile with 256 threads, 4×4
// outputs each. Cin must be a multiple of 16, so a 16-deep K slice lies in
// one tap. The input element fetch (padding, producer epilogue, gates,
// phase interleave) and the output epilogue are functors, so one loop
// serves the packed chain stages and the head conv.
// ---------------------------------------------------------------------------

#define IG_BM 64
#define IG_BN 64
#define IG_BK 16
#define IG_THREADS 256

struct IgGeom {
  int B, Cin, KH, KW, pad_y, pad_x, Hout, Wout, Cout;
};

// fetch.ptr(iy, ix, b, c) points at channel c of input pixel (iy, ix, b),
// or is null where the conv reads zeros (padding, gated slots);
// fetch.xform(y, c) applies the producer epilogue to a loaded value of
// channel c; epi(oy, ox, b, o, acc) writes one output value.
template <typename T, class Fetch, class Epi>
__global__ void __launch_bounds__(IG_THREADS)
igemm_conv(IgGeom g, const T* __restrict__ w, Fetch fetch, Epi epi) {
  __shared__ float As[IG_BK][IG_BM + 4];
  __shared__ float Bs[IG_BK][IG_BN + 4];
  const int tid = threadIdx.x;
  const i64 M = (i64)g.B * g.Hout * g.Wout;
  const i64 m0 = (i64)blockIdx.x * IG_BM;
  const int n0 = blockIdx.y * IG_BN;

  // this thread's A-load pixel
  const int a_mi = tid >> 2, a_kq = (tid & 3) * 4;
  const i64 am = m0 + a_mi;
  const bool a_ok = am < M;
  int a_b = 0, a_oy = 0, a_ox = 0;
  if (a_ok) {
    a_ox = (int)(am % g.Wout);
    i64 r = am / g.Wout;
    a_oy = (int)(r % g.Hout);
    a_b = (int)(r / g.Hout);
  }
  // this thread's B-load slot
  const int b_ki = tid >> 4, b_nq = (tid & 15) * 4;

  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int K = g.KH * g.KW * g.Cin;
  for (int k0 = 0; k0 < K; k0 += IG_BK) {
    const int tap = k0 / g.Cin, c0 = k0 - tap * g.Cin;
    const int ky = tap / g.KW, kx = tap - ky * g.KW;
    const T* p = a_ok ? fetch.ptr(a_oy - g.pad_y + ky, a_ox - g.pad_x + kx,
                                  a_b, c0 + a_kq)
                      : nullptr;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      As[a_kq + q][a_mi] = p ? fetch.xform(to_f<T>(p[q]), c0 + a_kq + q) : 0.f;
    const T* wr = w + (i64)(k0 + b_ki) * g.Cout;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int n = n0 + b_nq + q;
      Bs[b_ki][b_nq + q] = n < g.Cout ? to_f<T>(wr[n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < IG_BK; ++k) {
      float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    i64 m = m0 + ty * 4 + i;
    if (m >= M) continue;
    int ox = (int)(m % g.Wout);
    i64 r = m / g.Wout;
    int oy = (int)(r % g.Hout);
    int b = (int)(r / g.Hout);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int o = n0 + tx * 4 + j;
      if (o < g.Cout) epi(oy, ox, b, o, acc[i][j]);
    }
  }
}

static inline dim3 igemm_grid(const IgGeom& g) {
  long long M = (long long)g.B * g.Hout * g.Wout;
  return dim3((unsigned)((M + IG_BM - 1) / IG_BM),
              (unsigned)((g.Cout + IG_BN - 1) / IG_BN));
}

// ---------------------------------------------------------------------------
// The same implicit GEMM on the tensor cores, for bf16 storage: warp-level
// bf16 mma (nvcuda::wmma, 16×16×16 fragments) with fp32 accumulation. A
// block computes 128 pixels × 64 channels with 8 warps (4 × 2, 32×32 each)
// over 32-deep K slices (Cin a multiple of 32); each thread loads 16
// input channels and 8 weights per slice, one slice ahead. The fetch
// epilogue's values are bf16-exact, so staging them as bf16 loses
// nothing. The accumulators go through shared memory to the same
// per-element epilogue.
// ---------------------------------------------------------------------------

#define TC_BM 128
#define TC_BN 64
#define TC_BK 32
#define TC_SMEM (TC_BM * (TC_BN + 4) * 4)

template <class Fetch, class Epi>
__global__ void __launch_bounds__(256)
igemm_conv_tc(IgGeom g, const __nv_bfloat16* __restrict__ w, Fetch fetch,
              Epi epi) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[TC_SMEM];
  typedef __nv_bfloat16 ARow[TC_BK + 8];
  typedef __nv_bfloat16 BRow[TC_BN + 8];
  typedef float CRow[TC_BN + 4];
  ARow* As = reinterpret_cast<ARow*>(smem);
  BRow* Bs = reinterpret_cast<BRow*>(smem + TC_BM * sizeof(ARow));
  CRow* Cs = reinterpret_cast<CRow*>(smem);  // after the main loop only

  const int tid = threadIdx.x;
  const i64 M = (i64)g.B * g.Hout * g.Wout;
  const i64 m0 = (i64)blockIdx.x * TC_BM;
  const int n0 = blockIdx.y * TC_BN;

  const int a_row = tid >> 1, a_k = (tid & 1) * 16;
  const i64 am = m0 + a_row;
  const bool a_ok = am < M;
  int a_b = 0, a_oy = 0, a_ox = 0;
  if (a_ok) {
    a_ox = (int)(am % g.Wout);
    i64 r = am / g.Wout;
    a_oy = (int)(r % g.Hout);
    a_b = (int)(r / g.Hout);
  }
  const int b_k = tid >> 3, b_n = (tid & 7) * 8;
  const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // global → registers for K slice k0 (issued before the previous slice's
  // mma so the loads overlap it), registers → shared memory after
  const int K = g.KH * g.KW * g.Cin;
  uint4 ra[2], rb;
  const __nv_bfloat16* pa = nullptr;
  int rc = 0;
  auto gload = [&](int k0) {
    const int tap = k0 / g.Cin, c0 = k0 - tap * g.Cin;
    const int ky = tap / g.KW, kx = tap - ky * g.KW;
    rc = c0 + a_k;
    pa = a_ok ? fetch.ptr(a_oy - g.pad_y + ky, a_ox - g.pad_x + kx, a_b, rc)
              : nullptr;
    if (pa) load16_bf16(pa, ra);
    const __nv_bfloat16* wr = w + (i64)(k0 + b_k) * g.Cout + n0 + b_n;
    if (n0 + b_n + 8 <= g.Cout && (g.Cout & 7) == 0 &&
        ((uintptr_t)wr & 15) == 0) {
      rb = *reinterpret_cast<const uint4*>(wr);
    } else {
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(&rb);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        d[q] = n0 + b_n + q < g.Cout ? wr[q] : __float2bfloat16_rn(0.f);
    }
  };
  gload(0);
  for (int k0 = 0; k0 < K; k0 += TC_BK) {
    const __nv_bfloat16* rv = reinterpret_cast<const __nv_bfloat16*>(ra);
#pragma unroll
    for (int q = 0; q < 16; ++q)
      As[a_row][a_k + q] = pa ? __float2bfloat16_rn(
                                    fetch.xform(__bfloat162float(rv[q]), rc + q))
                              : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(&Bs[b_k][b_n]) = rb;
    __syncthreads();
    if (k0 + TC_BK < K) gload(k0 + TC_BK);
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], TC_BK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk][wn * 32 + j * 16], TC_BN + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j],
                              TC_BN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < TC_BM * TC_BN; e += 256) {
    const int r = e / TC_BN, c = e - r * TC_BN;
    const i64 m = m0 + r;
    const int o = n0 + c;
    if (m >= M || o >= g.Cout) continue;
    int ox = (int)(m % g.Wout);
    i64 q = m / g.Wout;
    int oy = (int)(q % g.Hout);
    int b = (int)(q / g.Hout);
    epi(oy, ox, b, o, Cs[r][c]);
  }
}

// Launch the conv: tensor cores for bf16 when Cin allows, else the fp32
// CUDA-core loop (always for float storage, which must stay exact fp32).
template <typename T, class Fetch, class Epi>
static void igemm_launch(const IgGeom& g, const T* w, Fetch f, Epi e,
                         cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (g.Cin % TC_BK == 0) {
      long long M = (long long)g.B * g.Hout * g.Wout;
      dim3 grid((unsigned)((M + TC_BM - 1) / TC_BM),
                (unsigned)((g.Cout + TC_BN - 1) / TC_BN));
      igemm_conv_tc<<<grid, 256, 0, s>>>(g, w, f, e);
      return;
    }
  }
  igemm_conv<T><<<igemm_grid(g), IG_THREADS, 0, s>>>(g, w, f, e);
}
