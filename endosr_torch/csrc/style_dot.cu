// style_blend_dot for Hopper: group style dot + o-branch conv adds + bias.
//
// Replaces endosr/kernels/style_dot.py::style_blend_dot (pallas_call at
// :284). For one group of SEAN instances:
//   out[h, w, b, m] = (dot[b,h,w,m] + conv_{m/c2}[h, w, b, m mod c2]) + bias[m]
//   dot[b,h,w,m]    = Σ_j shifted[b,h,w,j] · v[b,j,m]      (J = 9K = 90)
// with the dot rounded to T before the adds, as the twin does. The N conv
// outputs are read in place through a device table of pointers, so no
// concatenated copy of them is ever made.
//
// Bound on the H100: bytes. At the flagship M=1792 group it moves ~0.96 GB
// (the convs in, the blended maps out, shifted once), ≈0.29 ms at
// 3.35 TB/s; the dot is 2·B·H·W·90·M ≈ 42 GFLOP. This first version tiles
// 64 pixels × 64 channels per block with the dot on the CUDA cores in fp32
// and the adds fused into the epilogue; the conv reads and map writes are
// one pass each.

#include "common.cuh"

#define SD_BM 64
#define SD_BN 64
#define SD_BK 16

template <typename T>
__global__ void __launch_bounds__(256)
style_blend_kernel(const T* __restrict__ sh, const T* __restrict__ v,
                   const i64* __restrict__ convs, i64 ch, i64 cw, i64 cb,
                   int c2, const float* __restrict__ bias, T* __restrict__ out,
                   i64 oh, i64 ow, i64 ob, int H, int W, int J, int M) {
  __shared__ float As[SD_BK][SD_BM + 4];
  __shared__ float Bs[SD_BK][SD_BN + 4];
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int HW = H * W;
  const int p0 = blockIdx.x * SD_BM;   // pixel index h·W + w within batch b
  const int n0 = blockIdx.y * SD_BN;
  const T* shb = sh + (i64)b * HW * J;
  const T* vb = v + (i64)b * J * M;

  const int a_mi = tid >> 2, a_kq = (tid & 3) * 4;
  const int b_ki = tid >> 4, b_nq = (tid & 15) * 4;
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < J; k0 += SD_BK) {
    const int pa = p0 + a_mi;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int k = k0 + a_kq + q;
      As[a_kq + q][a_mi] =
          (pa < HW && k < J) ? to_f<T>(shb[(i64)pa * J + k]) : 0.f;
    }
    const int kb = k0 + b_ki;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int n = n0 + b_nq + q;
      Bs[b_ki][b_nq + q] =
          (kb < J && n < M) ? to_f<T>(vb[(i64)kb * M + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SD_BK; ++k) {
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
    int p = p0 + ty * 4 + i;
    if (p >= HW) continue;
    int hh = p / W, ww = p - hh * W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int m = n0 + tx * 4 + j;
      if (m >= M) continue;
      int ci = m / c2, cm = m - ci * c2;
      const T* cp = reinterpret_cast<const T*>(convs[ci]);
      float y = rnd<T>(acc[i][j]);
      y = rnd<T>(y + to_f<T>(cp[hh * ch + ww * cw + b * cb + cm]));
      y = y + rnd<T>(bias[m]);
      out[hh * oh + ww * ow + b * ob + m] = from_f<T>(y);
    }
  }
}

extern "C" {

// shifted: contiguous [B, H, W, J]; v: contiguous [B, J, M]; convs: device
// array of N pointers to [H, W, B, c2] tensors sharing the element strides
// ch, cw, cb (channel stride 1), N·c2 = M; bias fp32 [M]; out [H, W, B, M]
// with strides oh, ow, ob. dtype: 0 float32, 1 bfloat16.
int style_blend_dot(int dtype, const void* shifted, const void* v,
                    const void* convs, i64 ch, i64 cw, i64 cb, int c2,
                    const void* bias, void* out, i64 oh, i64 ow, i64 ob,
                    int B, int H, int W, int J, int M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((H * W + SD_BM - 1) / SD_BM, (M + SD_BN - 1) / SD_BN, B);
  if (dtype == 0)
    style_blend_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)shifted, (const float*)v, (const i64*)convs, ch, cw, cb,
        c2, (const float*)bias, (float*)out, oh, ow, ob, H, W, J, M);
  else
    style_blend_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)shifted, (const __nv_bfloat16*)v,
        (const i64*)convs, ch, cw, cb, c2, (const float*)bias,
        (__nv_bfloat16*)out, oh, ow, ob, H, W, J, M);
  return (int)cudaGetLastError();
}

const char* style_blend_dot_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
