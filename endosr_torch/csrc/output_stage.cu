// Output stages for Hopper: clamp → PixelShuffle(r) → fp32 rows.
//
// output_stage_x8 replaces endosr/kernels/output_stage.py::output_stage_x8
// (pallas_call at :275): the embedded head channel i·16 + j·3 + c of input
// pixel (y, b, x) lands at out[b, 4y+i, (4x+j)·3 + c], i.e.
//   out[b, 4y+i, 12x+q] = float(clamp(pre[y, b, x, 16i+q])),  q < 12.
//
// output_stage replaces endosr/kernels/output_stage.py::output_stage
// (pallas_calls at :316 and :351) for any r and C:
//   out[b, y·r+i, (x·r+j)·C + c] = float(clamp(pre[b, y, x, c·r² + i·r + j]))
//
// Both are pure gathers with a clamp and a cast, bit-identical to their
// plain versions: the bounds are rounded to the storage type first, as
// torch.clamp and jnp.clip round a Python float bound on a bf16 tensor
// (0.999 clamps to 1.0 in bf16). Bound on the H100: bytes (each input
// element read once, each output float written once), ≈50 µs at the ×8
// flagship shape (67 MB in + 101 MB out at 3.35 TB/s). Two routes each,
// picked by endosr_torch/kernels/output_stage.py:
//
// vec16 (16-byte stores, streaming):
// - output_stage_x8_vec16: the four output rows 4y..4y+3 of image b are
//   one contiguous run of 12W float4s. Block (chunk, y·B + b) owns
//   OSX_UNROLL·256 of its float4s, one thread each of OSX_UNROLL, so a
//   warp stores 512 contiguous bytes (st.global.cs: evict first, the 101 MB
//   of output pass the 50 MB L2). Output float4 k of row i reads the four
//   neighbouring channels 16i + 4(k mod 3) of pixel k / 3: one 8-byte (bf16)
//   or 16-byte (fp32) load, all OSX_UNROLL of a thread in flight before its
//   first store; (i, k) step with no division after the first.
// - output_stage_vec16: block (span, y, b) owns X pixels of one input row,
//   whose X·C·r² elements are contiguous (pixel stride C·r²): it copies them
//   into shared memory with 16-byte cp.async, then writes the r output rows'
//   X·r·C floats as float4 streaming stores. X is a multiple of 8, so every
//   span starts 16-byte aligned (a pixel at r = 3, C = 3 is 54 bytes) and
//   every output row piece too (W·r·C a multiple of 4). r is a template
//   argument; the divisions by r·C and C run in float (exact below 2^16).
//
// v1 (any strides and alignment): output_stage_x8_kernel moves one run of
// twelve channels a thread (scalar loads and stores); output_stage_kernel
// writes one output float a thread, a block walking the r output rows one
// input row segment feeds.

#include "common.cuh"
#include "hopper.cuh"

// clip keeps NaN like jnp.clip / torch.clamp
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---- v1 -------------------------------------------------------------------

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
  const float tlo = rnd<T>(lo), thi = rnd<T>(hi);
  const T* src = pre + (i64)y * sy + (i64)b * sb + (i64)x * sx + i * 16;
  float* dst = out + ((i64)b * 4 * H + 4 * y + i) * (i64)(12 * W) + 12 * x;
#pragma unroll
  for (int q = 0; q < 12; ++q) dst[q] = clampf(to_f<T>(src[q]), tlo, thi);
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

// ---- vec16 ----------------------------------------------------------------

#define OS_THREADS 256
#define OSX_UNROLL 4       // float4 outputs (and loads in flight) a thread
#define OS_SPAN_BYTES 16384  // a span's input bytes in shared memory, at most
#define OS_SPAN_MAX 256      // pixels of a span, at most

// four neighbouring storage values: 16 bytes of fp32, 8 of bf16
template <typename T> struct Quad;
template <> struct Quad<float> {
  typedef float4 L;
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 clamp(float4 v, float lo, float hi) {
    return make_float4(clampf(v.x, lo, hi), clampf(v.y, lo, hi),
                       clampf(v.z, lo, hi), clampf(v.w, lo, hi));
  }
};
template <> struct Quad<__nv_bfloat16> {
  typedef uint2 L;
  static __device__ __forceinline__ uint2 load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  // a bf16 is the upper half of the float with the same value
  static __device__ __forceinline__ float4 clamp(uint2 v, float lo, float hi) {
    return make_float4(clampf(__uint_as_float(v.x << 16), lo, hi),
                       clampf(__uint_as_float(v.x & 0xffff0000u), lo, hi),
                       clampf(__uint_as_float(v.y << 16), lo, hi),
                       clampf(__uint_as_float(v.y & 0xffff0000u), lo, hi));
  }
};

template <typename T>
__global__ void __launch_bounds__(OS_THREADS)
output_stage_x8_vec16_kernel(const T* __restrict__ pre, i64 sy, i64 sb,
                             i64 sx, int H, int B, int W, float lo, float hi,
                             float* __restrict__ out) {
  typedef Quad<T> Q;
  const int yb = blockIdx.y, y = yb / B, b = yb - y * B;
  const int R = 3 * W;        // float4s of one output row
  const int n = 4 * R;        // float4s of the four rows 4y..4y+3
  const T* src = pre + (i64)y * sy + (i64)b * sb;
  float4* dst = reinterpret_cast<float4*>(out + ((i64)b * 4 * H + 4 * y) *
                                                    (i64)(12 * W));
  const float tlo = rnd<T>(lo), thi = rnd<T>(hi);
  const int e0 = blockIdx.x * (OS_THREADS * OSX_UNROLL) + threadIdx.x;
  int i = e0 / R, k = e0 - i * R;
  typename Q::L v[OSX_UNROLL];
#pragma unroll
  for (int u = 0; u < OSX_UNROLL; ++u) {
    if (e0 + u * OS_THREADS < n) {
      const int x = k / 3;
      v[u] = Q::load(src + (i64)x * sx + 16 * i + 4 * (k - 3 * x));
    }
    k += OS_THREADS;
    while (k >= R) {
      k -= R;
      ++i;
    }
  }
#pragma unroll
  for (int u = 0; u < OSX_UNROLL; ++u) {
    const int e = e0 + u * OS_THREADS;
    if (e < n) __stcs(dst + e, Q::clamp(v[u], tlo, thi));
  }
}

// floor(n / d) for 0 ≤ n < 2^16, rd = 1.0f / d: (n + ½)/d lies at least
// ½/d from an integer, the float error is below 2^-7/d
__device__ __forceinline__ int div_small(int n, float rd) {
  return (int)(((float)n + 0.5f) * rd);
}

template <typename T, int R>
__global__ void __launch_bounds__(OS_THREADS)
output_stage_vec16_kernel(const T* __restrict__ pre, i64 sb, i64 sy, int H,
                          int W, int C, int X, float lo, float hi,
                          float* __restrict__ out) {
  extern __shared__ uint4 os_span[];
  constexpr int V = 16 / (int)sizeof(T);
  const T* s = reinterpret_cast<const T*>(os_span);
  const int x0 = blockIdx.x * X, y = blockIdx.y, b = blockIdx.z;
  const int nx = min(X, W - x0);
  const int crr = C * R * R, rc = R * C;
  const int nin = nx * crr;                 // the span's input elements
  const T* src = pre + (i64)b * sb + (i64)y * sy + (i64)x0 * crr;
  const int nv = nin / V;
  for (int t = threadIdx.x; t < nv; t += OS_THREADS)
    cp_async16(os_span + t, reinterpret_cast<const uint4*>(src) + t);
  cp_async_commit();
  T* tail = reinterpret_cast<T*>(os_span);
  for (int t = nv * V + threadIdx.x; t < nin; t += OS_THREADS) tail[t] = src[t];
  cp_async_wait_all();
  __syncthreads();

  const float tlo = rnd<T>(lo), thi = rnd<T>(hi);
  const float rrc = 1.0f / (float)rc, rC = 1.0f / (float)C;
  const i64 row = (i64)W * rc;              // floats of an output row
  float* dst = out + ((i64)b * H * R + (i64)y * R) * row + (i64)x0 * rc;
  const int nf = nx * rc / 4;               // float4s of a row's piece
  const float rnf = 1.0f / (float)nf;
  for (int f = threadIdx.x; f < R * nf; f += OS_THREADS) {
    const int i = div_small(f, rnf);
    const int e = 4 * (f - i * nf);         // first float of the piece
    int x = div_small(e, rrc);
    const int q = e - x * rc;
    int j = div_small(q, rC), c = q - j * C;
    float v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      v[m] = clampf(to_f<T>(s[x * crr + c * R * R + i * R + j]), tlo, thi);
      if (++c == C) {
        c = 0;
        if (++j == R) {
          j = 0;
          ++x;
        }
      }
    }
    __stcs(reinterpret_cast<float4*>(dst + (i64)i * row + e),
           make_float4(v[0], v[1], v[2], v[3]));
  }
}

// pixels a span of output_stage_vec16: a multiple of 8 (16-byte aligned
// starts), as many as OS_SPAN_BYTES of input hold, at most OS_SPAN_MAX
static int os_span_pixels(int C, int r, int esize) {
  int X = 8;
  while (2 * X <= OS_SPAN_MAX && 2 * X * C * r * r * esize <= OS_SPAN_BYTES)
    X *= 2;
  return X;
}

template <typename T, int R>
static void os_vec16_launch(const void* pre, i64 sb, i64 sy, int B, int H,
                            int W, int C, float lo, float hi, void* out,
                            cudaStream_t s) {
  const int X = os_span_pixels(C, R, (int)sizeof(T));
  dim3 grid((W + X - 1) / X, H, B);
  output_stage_vec16_kernel<T, R>
      <<<grid, OS_THREADS, X * C * R * R * sizeof(T), s>>>(
          (const T*)pre, sb, sy, H, W, C, X, lo, hi, (float*)out);
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

// As output_stage_x8, with sy, sb, sx multiples of 4, pre and out 16-byte
// aligned and H·B ≤ 65535 (else cudaErrorInvalidValue).
int output_stage_x8_vec16(int dtype, const void* pre, i64 sy, i64 sb, i64 sx,
                          int H, int B, int W, float lo, float hi, void* out,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((sy | sb | sx) % 4 != 0 || (((uintptr_t)pre | (uintptr_t)out) & 15) ||
      (i64)H * B > 65535 || 12ll * W >= (1ll << 31) - OS_THREADS * OSX_UNROLL)
    return (int)cudaErrorInvalidValue;
  dim3 grid((12 * W + OS_THREADS * OSX_UNROLL - 1) / (OS_THREADS * OSX_UNROLL),
            H * B);
  if (dtype == 0)
    output_stage_x8_vec16_kernel<float><<<grid, OS_THREADS, 0, s>>>(
        (const float*)pre, sy, sb, sx, H, B, W, lo, hi, (float*)out);
  else
    output_stage_x8_vec16_kernel<__nv_bfloat16><<<grid, OS_THREADS, 0, s>>>(
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

// As output_stage, with r ∈ {2, 3, 4}, sx = C·r² (a row's pixels
// contiguous), sb and sy multiples of 16 bytes, pre and out 16-byte
// aligned, W·r·C a multiple of 4 and 8 pixels' input within OS_SPAN_BYTES
// (else cudaErrorInvalidValue).
int output_stage_vec16(int dtype, const void* pre, i64 sb, i64 sy, i64 sx,
                       int B, int H, int W, int r, int C, float lo, float hi,
                       void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int esize = dtype == 0 ? 4 : 2, V = 16 / esize;
  if (r < 2 || r > 4 || C < 1 || sx != (i64)C * r * r || sb % V != 0 ||
      sy % V != 0 || (((uintptr_t)pre | (uintptr_t)out) & 15) ||
      (W * r * C) % 4 != 0 || 8 * C * r * r * esize > OS_SPAN_BYTES ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (r == 2) os_vec16_launch<float, 2>(pre, sb, sy, B, H, W, C, lo, hi, out, s);
    if (r == 3) os_vec16_launch<float, 3>(pre, sb, sy, B, H, W, C, lo, hi, out, s);
    if (r == 4) os_vec16_launch<float, 4>(pre, sb, sy, B, H, W, C, lo, hi, out, s);
  } else {
    typedef __nv_bfloat16 bf;
    if (r == 2) os_vec16_launch<bf, 2>(pre, sb, sy, B, H, W, C, lo, hi, out, s);
    if (r == 3) os_vec16_launch<bf, 3>(pre, sb, sy, B, H, W, C, lo, hi, out, s);
    if (r == 4) os_vec16_launch<bf, 4>(pre, sb, sy, B, H, W, C, lo, hi, out, s);
  }
  return (int)cudaGetLastError();
}

const char* output_stage_x8_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
