// Group style dots for Hopper.
//
// style_dot_hwbm replaces endosr/kernels/style_dot.py::style_dot_hwbm
// (pallas_call at :111): out[b,h,w,m] = Σ_j shifted[b,h,w,j] · v[b,j,m]
// (J = 9K = 90), rounded once to T, written in [H, W, B, M] index order over
// a BHWC tensor. It runs where the masked (bucketed) forward cannot take the
// blend. Bound on the H100 in bf16: bytes, the [B,H,W,M] map written once
// (470 MB at M = 1792, 0.14 ms at 3.35 TB/s) against 42 GFLOP (0.04 ms at
// the tensor-core peak). Two kernels, picked by shape in
// endosr_torch/kernels/style_dot.py:
//
// style_dot_tc (bf16, J even and ≤ 96, M a multiple of 8): the stores are
// the kernel, so everything else is arranged to keep them wide and flowing.
// A block owns 128 consecutive pixels of one image and walks over M in
// tiles of 128 channels.
// - A. The block's rows of `shifted` are one contiguous run (rows of 2·J =
//   180 bytes, which neither a tiled TMA copy nor ldmatrix can address), so
//   it is read once with aligned 4-byte loads (a row is a whole number of
//   words for even J, at any H·W and any image base), repacked into rows of
//   96 with a 208-byte pitch (an odd multiple of 16: ldmatrix without bank
//   conflicts), the pad columns J..95 and the rows past a ragged last tile
//   zeroed; each warp then keeps its 16 pixels × 96 as mma fragments in
//   registers for all of the block's N tiles.
// - B. A [J, 128] slice of v[b] per N tile through 16-byte cp.async into
//   one of two buffers (pitch 272 bytes), the next slice in flight during
//   this one's product; rows J..95 are zeroed once, columns past M per
//   tile (0 × garbage could be NaN).
// - The product. mma.sync.m16n8k16 through ldmatrix, fp32 accumulators, a
//   warp 16 pixels × 128 channels: six k-steps leave the tensor cores far
//   from being the limit, so the warp-level instruction is enough here.
// - The stores. A warp rounds its accumulators to bf16 into its own 16 ×
//   128 staging tile in shared memory and reads it back as 16-byte pieces:
//   half a warp writes 256 contiguous bytes of a pixel. Only the warp itself
//   synchronises for this, global stores do not block the issuing warp, and
//   two blocks share an SM, so one tile's stores drain while the next
//   tile's product (of this or the neighbouring block) runs.
// The main loop is a __device__ function whose epilogue is a functor over
// (pixel, channel, eight rounded dot values, what the functor loaded for
// them before the product): style_dot_hwbm's stores the dot, style_blend's
// adds the conv slice and the bias. It multiplies a tile in two halves of
// 64 channels, so 32 accumulators are live beside the A fragments and the
// epilogue's prefetched loads.
//
// style_dot_kernel (fp32, and any other bf16 shape): 64 pixels × 64 channels
// a block, the dot in fp32 on the CUDA cores, exact for float storage.
//
// style_blend_dot replaces endosr/kernels/style_dot.py::style_blend_dot
// (pallas_call at :284). For one group of SEAN instances:
//   out[h, w, b, m] = (dot[b,h,w,m] + conv_{m/c2}[h, w, b, m mod c2]) + bias[m]
// with the dot rounded to T before the adds, as the twin does. The N conv
// outputs are read in place through a device table of pointers, so no
// concatenated copy of them is ever made. Bound on the H100: bytes. At the
// flagship M = 1792 group it moves ~0.96 GB (the convs in, the blended maps
// out, shifted once), ≈0.29 ms at 3.35 TB/s. Two kernels, picked by shape in
// endosr_torch/kernels/style_dot.py:
//
// style_blend_tc (bf16, J even and ≤ 96, M and c2 multiples of 8, conv
// strides multiples of 8, 16-byte aligned bases): style_dot_tc_block with
// BlendEpi. The conv reads are half the bytes; each lane issues the eight
// 16-byte conv loads of the pieces it will store before the tile's product
// and consumes them in the epilogue, so their latency hides under the mma
// work instead of putting a global round trip before every store.
//
// style_dot_kernel<T, true> (fp32, and any other bf16 shape): the CUDA-core
// dot with the adds in its scalar epilogue.
//
// Both blend kernels read `shifted` through two strides: sb between images
// and sp between the pixels of an image (p = h·W + w). The [B, H, W, J]
// layout has sb = H·W·J, sp = J; the `hwbc` option's [H, W, B, J] layout
// (the mask-conv producer's order) has sb = J, sp = B·J. Rows stay whole
// runs of J values, so the tensor-core route reads them as before.

#include "common.cuh"
#include "hopper.cuh"

#define SD_BM 64
#define SD_BN 64
#define SD_BK 16

// BLEND: add the conv slice and the bias in the epilogue (style_blend_dot);
// otherwise store the rounded dot (style_dot_hwbm; convs and bias unused).
template <typename T, bool BLEND>
__global__ void __launch_bounds__(256)
style_dot_kernel(const T* __restrict__ sh, i64 sb, i64 sp, const T* __restrict__ v,
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
  const T* shb = sh + (i64)b * sb;
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
          (pa < HW && k < J) ? to_f<T>(shb[(i64)pa * sp + k]) : 0.f;
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
      float y = acc[i][j];
      if (BLEND) {
        int ci = m / c2, cm = m - ci * c2;
        const T* cp = reinterpret_cast<const T*>(convs[ci]);
        y = rnd<T>(y);
        y = rnd<T>(y + to_f<T>(cp[hh * ch + ww * cw + b * cb + cm]));
        y = y + rnd<T>(bias[m]);
      }
      out[hh * oh + ww * ow + b * ob + m] = from_f<T>(y);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core dot
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

#define ST_PX 128      // pixels of a block
#define ST_BN 128      // channels of an N tile
#define ST_KP 96       // J padded to whole k-steps
#define ST_AP 104      // A row pitch, elements (208 bytes)
#define ST_BP 136      // B row and staging row pitch, elements (272 bytes)
#define ST_BBUF (ST_KP * ST_BP)              // elements of one B buffer
#define ST_SMEM ((2 * ST_BBUF + 8 * 16 * ST_BP) * 2)   // ≥ the A tile's 128·ST_AP

// One block of the dot: pixels p0 .. p0+127 of an image whose `shifted` rows
// of J start at sh, sp elements apart (sp even), and whose v is vb ([J, M]). epi(p, m, dot8, pre)
// receives eight consecutive channels m..m+7 of pixel p (p < HW, m < M),
// rounded to bf16, and what epi.load(p, m) (an Epi::Pre) returned for the
// same piece before the tile's product. smem: ST_SMEM bytes, 16-byte
// aligned. 256 threads.
template <class Epi>
__device__ __forceinline__ void style_dot_tc_block(const bf16* __restrict__ sh, i64 sp,
                                                   const bf16* __restrict__ vb, int HW,
                                                   int J, int M, int p0,
                                                   unsigned char* smem, Epi epi) {
  bf16* Bs = reinterpret_cast<bf16*>(smem);
  bf16* Rs = Bs + 2 * ST_BBUF;       // the A tile, later the warps' staging tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r16 = lane & 15, q8 = (lane >> 4) * 8, g = lane >> 2, t = lane & 3;
  const int ksteps = (J + 15) >> 4;

  auto issue_b = [&](int n0, bf16* dst) {
    for (int e = tid; e < J * (ST_BN / 8); e += 256) {
      const int j = e >> 4, col = n0 + (e & 15) * 8;
      bf16* d = dst + j * ST_BP + (e & 15) * 8;
      if (col < M)
        cp_async16(d, vb + (i64)j * M + col);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  };

  // B's pad rows, both buffers, once
  for (int e = tid; e < 2 * (ST_KP - J) * (ST_BN / 8); e += 256) {
    const int buf = e / ((ST_KP - J) * (ST_BN / 8)), r = e % ((ST_KP - J) * (ST_BN / 8));
    *reinterpret_cast<uint4*>(Bs + buf * ST_BBUF + (J + (r >> 4)) * ST_BP + (r & 15) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  issue_b(0, Bs);

  // A: words of the padded [128, 96] tile; all loads first, then the stores
  {
    constexpr int WPR = ST_KP / 2, IT = ST_PX * WPR / 256;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(sh);
    const int jw = J >> 1;
    const i64 spw = sp >> 1;
    uint32_t vals[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int e = tid + i * 256, p = e / WPR, kw = e - p * WPR;
      vals[i] = (p0 + p < HW && kw < jw) ? src[(i64)(p0 + p) * spw + kw] : 0u;
    }
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int e = tid + i * 256, p = e / WPR, kw = e - p * WPR;
      *reinterpret_cast<uint32_t*>(Rs + p * ST_AP + 2 * kw) = vals[i];
    }
  }
  __syncthreads();
  uint32_t a[ST_KP / 16][4];
#pragma unroll
  for (int ks = 0; ks < ST_KP / 16; ++ks)
    if (ks < ksteps) ldsm_x4(a[ks], Rs + (warp * 16 + r16) * ST_AP + ks * 16 + q8);
  __syncthreads();      // the A tile's room becomes the staging tiles

  bf16* Cw = Rs + warp * 16 * ST_BP;
  const int tiles = (M + ST_BN - 1) / ST_BN;
  for (int it = 0; it < tiles; ++it) {
    const int n0 = it * ST_BN;
    // the epilogue's own loads for this lane's eight pieces of the tile go
    // out first, so their latency hides under the wait and the product
    typename Epi::Pre pre[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = lane + 32 * i, row = c >> 4, q = c & 15;
      const int p = p0 + warp * 16 + row, m = n0 + q * 8;
      if (p < HW && m < M) pre[i] = epi.load(p, m);
    }
    const bf16* Bt = Bs + (it & 1) * ST_BBUF;
    if (it + 1 < tiles) {
      issue_b(n0 + ST_BN, Bs + ((it + 1) & 1) * ST_BBUF);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();    // this tile's slice of v has landed for every thread

    // two halves of 64 channels, so only 32 accumulators are live beside the
    // A fragments and the epilogue's loads
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < ST_KP / 16; ++ks) {
        if (ks >= ksteps) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, Bt + (ks * 16 + r16) * ST_BP + (4 * nh + jj) * 16 + q8);
          mma_bf16(acc[2 * jj], a[ks], bf[0], bf[1]);
          mma_bf16(acc[2 * jj + 1], a[ks], bf[2], bf[3]);
        }
      }
      // accumulator (j, q): pixel lane/4 (+8 for q ≥ 2), channel
      // 64·nh + 8j + 2·(lane%4) + (q&1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nh + 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(Cw + g * ST_BP + col) =
            __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(Cw + (g + 8) * ST_BP + col) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = lane + 32 * i, row = c >> 4, q = c & 15;
      const int p = p0 + warp * 16 + row, m = n0 + q * 8;
      const uint4 val = *reinterpret_cast<const uint4*>(Cw + row * ST_BP + q * 8);
      if (p < HW && m < M) epi(p, m, val, pre[i]);
    }
    __syncthreads();    // every warp is done with this B buffer and its staging tile
  }
}

// style_dot_hwbm's epilogue: the rounded dot, 16 bytes a store
struct StoreDot {
  struct Pre {};
  bf16* out;   // this image's [HW, M]
  int M;
  __device__ __forceinline__ Pre load(int, int) const { return Pre{}; }
  __device__ __forceinline__ void operator()(int p, int m, uint4 dot8, Pre) const {
    *reinterpret_cast<uint4*>(out + (i64)p * M + m) = dot8;
  }
};

// style_blend_dot's epilogue: out = rnd(rnd(dot + conv) + rnd(bias)) per
// channel, the twin's (y + concat) + bias. The eight conv values of a piece
// are one 16-byte load through the pointer table (c2 a multiple of 8, so a
// piece lies in one conv), issued before the product; 16 bytes a store.
struct BlendEpi {
  typedef uint4 Pre;
  const i64* convs;     // device table of the N conv pointers
  i64 ch, cw, cb;       // their element strides
  int c2, W, b;
  const float* bias;    // [M] fp32
  bf16* out;            // this image's [HW, M]
  int M;
  __device__ __forceinline__ Pre load(int p, int m) const {
    const int ci = m / c2, hh = p / W;
    const bf16* cp = reinterpret_cast<const bf16*>(__ldg(convs + ci));
    return *reinterpret_cast<const uint4*>(cp + hh * ch + (p - hh * W) * cw + b * cb +
                                           (m - ci * c2));
  }
  __device__ __forceinline__ void operator()(int p, int m, uint4 dot8, Pre conv8) const {
    const bf16* d = reinterpret_cast<const bf16*>(&dot8);
    const bf16* c = reinterpret_cast<const bf16*>(&conv8);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + m));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + m) + 1);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 o;
    bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      ov[k] = __float2bfloat16_rn(rnd<bf16>(__bfloat162float(d[k]) + __bfloat162float(c[k])) +
                                  rnd<bf16>(bv[k]));
    *reinterpret_cast<uint4*>(out + (i64)p * M + m) = o;
  }
};

__global__ void __launch_bounds__(256, 2)
style_dot_tc_kernel(const bf16* __restrict__ shifted, const bf16* __restrict__ v,
                    bf16* __restrict__ out, int HW, int J, int M) {
  extern __shared__ __align__(16) unsigned char st_smem[];
  const int b = blockIdx.y;
  style_dot_tc_block(shifted + (i64)b * HW * J, J, v + (i64)b * J * M, HW, J, M,
                     blockIdx.x * ST_PX, st_smem,
                     StoreDot{out + (i64)b * HW * M, M});
}

__global__ void __launch_bounds__(256, 2)
style_blend_tc_kernel(const bf16* __restrict__ shifted, i64 sb, i64 sp,
                      const bf16* __restrict__ v,
                      const i64* __restrict__ convs, i64 ch, i64 cw, i64 cb, int c2,
                      const float* __restrict__ bias, bf16* __restrict__ out, int W, int HW,
                      int J, int M) {
  extern __shared__ __align__(16) unsigned char st_smem[];
  const int b = blockIdx.y;
  style_dot_tc_block(shifted + (i64)b * sb, sp, v + (i64)b * J * M, HW, J, M,
                     blockIdx.x * ST_PX, st_smem,
                     BlendEpi{convs, ch, cw, cb, c2, W, b, bias, out + (i64)b * HW * M, M});
}

extern "C" {

// shifted: pixel rows of J (channel stride 1), images sb and pixels (h·W + w)
// sp elements apart: a contiguous [B, H, W, J] (sb = H·W·J, sp = J) or
// [H, W, B, J] (sb = J, sp = B·J); v: contiguous [B, J, M]; convs: device
// array of N pointers to [H, W, B, c2] tensors sharing the element strides
// ch, cw, cb (channel stride 1), N·c2 = M; bias fp32 [M]; out [H, W, B, M]
// with strides oh, ow, ob. dtype: 0 float32, 1 bfloat16.
int style_blend_dot(int dtype, const void* shifted, i64 sb, i64 sp, const void* v,
                    const void* convs, i64 ch, i64 cw, i64 cb, int c2,
                    const void* bias, void* out, i64 oh, i64 ow, i64 ob,
                    int B, int H, int W, int J, int M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((H * W + SD_BM - 1) / SD_BM, (M + SD_BN - 1) / SD_BN, B);
  if (dtype == 0)
    style_dot_kernel<float, true><<<grid, 256, 0, s>>>(
        (const float*)shifted, sb, sp, (const float*)v, (const i64*)convs, ch, cw, cb,
        c2, (const float*)bias, (float*)out, oh, ow, ob, H, W, J, M);
  else
    style_dot_kernel<__nv_bfloat16, true><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)shifted, sb, sp, (const __nv_bfloat16*)v,
        (const i64*)convs, ch, cw, cb, c2, (const float*)bias,
        (__nv_bfloat16*)out, oh, ow, ob, H, W, J, M);
  return (int)cudaGetLastError();
}

// shifted: contiguous [B, H, W, J]; v: contiguous [B, J, M]; out [H, W, B, M]
// with strides oh, ow, ob (channel stride 1). dtype: 0 float32, 1 bfloat16.
int style_dot_hwbm(int dtype, const void* shifted, const void* v, void* out,
                   i64 oh, i64 ow, i64 ob, int B, int H, int W, int J, int M,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((H * W + SD_BM - 1) / SD_BM, (M + SD_BN - 1) / SD_BN, B);
  if (dtype == 0)
    style_dot_kernel<float, false><<<grid, 256, 0, s>>>(
        (const float*)shifted, (i64)H * W * J, J, (const float*)v, nullptr, 0, 0, 0, 1, nullptr,
        (float*)out, oh, ow, ob, H, W, J, M);
  else
    style_dot_kernel<__nv_bfloat16, false><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)shifted, (i64)H * W * J, J, (const __nv_bfloat16*)v, nullptr, 0, 0,
        0, 1, nullptr, (__nv_bfloat16*)out, oh, ow, ob, H, W, J, M);
  return (int)cudaGetLastError();
}

// The tensor-core route of style_dot_hwbm, bf16 only: shifted contiguous
// [B, HW, J] (4-byte aligned, J even and ≤ 96), v contiguous [B, J, M] and out
// contiguous [B, HW, M] (16-byte aligned, M a multiple of 8).
int style_dot_tc(const void* shifted, const void* v, void* out, int B, int HW,
                 int J, int M, void* stream) {
  if (J > ST_KP || J % 2 != 0 || M % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      style_dot_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ST_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((HW + ST_PX - 1) / ST_PX, B);
  style_dot_tc_kernel<<<grid, 256, ST_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)shifted, (const bf16*)v, (bf16*)out, HW, J, M);
  return (int)cudaGetLastError();
}

// The tensor-core route of style_blend_dot, bf16 only: shifted rows of J
// with the strides sb, sp of style_blend_dot (both even; 4-byte aligned, J
// even and ≤ 96), v contiguous [B, J, M]
// (16-byte aligned, M a multiple of 8); convs: device array of N pointers to
// [H, W, B, c2] tensors (16-byte aligned) sharing the element strides ch, cw,
// cb (multiples of 8, channel stride 1), c2 a multiple of 8, N·c2 = M; bias
// fp32 [M] (16-byte aligned); out contiguous [B, H, W, M] (16-byte aligned).
int style_blend_tc(const void* shifted, i64 sb, i64 sp, const void* v, const void* convs,
                   i64 ch, i64 cw, i64 cb, int c2, const void* bias, void* out, int B, int H,
                   int W, int J, int M, void* stream) {
  if (J > ST_KP || J % 2 != 0 || M % 8 != 0 || c2 % 8 != 0 || (ch | cw | cb) % 8 != 0 ||
      (sb | sp) % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      style_blend_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ST_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((H * W + ST_PX - 1) / ST_PX, B);
  style_blend_tc_kernel<<<grid, 256, ST_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)shifted, sb, sp, (const bf16*)v, (const i64*)convs, ch, cw, cb, c2,
      (const float*)bias, (bf16*)out, W, H * W, J, M);
  return (int)cudaGetLastError();
}

const char* style_blend_dot_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
