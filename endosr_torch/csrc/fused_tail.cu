// fused_tail for Hopper: the packed ×8 tail's folded head conv, clamp,
// PixelShuffle(4) and fp32 rows in one pass.
//
// Replaces endosr/kernels/fused_tail.py::fused_tail (pallas_call at :238).
//   pre[b,y,x,o] = rnd(Σ_{dy,dx,c} a[y+dy−1, x+dx−1, b, c] · w[dy,dx,c,o]) + bias[o]
//   out[b, 4y+i, 12x + q] = float(clamp(pre[b,y,x, i·12 + q]))      q = j·3 + colour
// for y < h, x < wout, with zero padding above and left. With a producer
// bias pb, a = lrelu(rnd(g4 + pb), 0.2) gated (row ≥ h and column ≥ wout
// dead): the raw g4 of the producer conv is read once and no activated copy
// is written. Without, a = g4, which arrives activated and gated. The
// wrapper has put the head's 48 output channels in i·12 + q order.
//
// Bound on the H100: operations, 2·B·h·wout·9·C4·48 ≈ 232 GFLOP at the
// flagship shape (≈0.23 ms of bf16 tensor-core time); the bytes (g4 read
// once, 540 MB, the fp32 image written once, 101 MB) are ≈0.19 ms.
//
// Two kernels, picked by shape in endosr_torch/kernels/fused_tail.py:
//
// fused_tail_wgmma (bf16, C4 a multiple of 64): the implicit GEMM on wgmma
// of conv_wgmma.cuh (3×3 taps) with N = 48, the head's channels and nothing else
// (wgmma.m64n48k16 is a legal shape: no tile padded to 64, no zero work),
// and TailWgEpi as its epilogue. The 48-channel pre-activation never reaches
// device memory: a warp rounds, adds the bias, clamps and writes its 16
// pixels × 48 values as fp32 into its own scratch in the order of the output
// rows ([i][pixel][q]), then stores them as 16-byte pieces: for each phase
// row i the warp's 16 pixels are 768 contiguous bytes of that output row.
//
// fused_tail (any other shape or type): the shared implicit GEMM of
// common.cuh (warp-level bf16 mma, or the exact fp32 CUDA-core loop) with
// the output stage as its per-element epilogue.

#include "common.cuh"
#include "conv_wgmma.cuh"

template <typename T>
struct TailFetch {
  const T* g4;
  i64 sh, sw, sb;
  int gate_h, gate_w;   // rows / columns of g4 the conv may read
  const T* pb;          // producer bias [C4] or null (then no epilogue)
  __device__ __forceinline__ const T* ptr(int iy, int ix, int b, int c) const {
    if (iy < 0 || ix < 0 || iy >= gate_h || ix >= gate_w) return nullptr;
    return g4 + (i64)iy * sh + (i64)ix * sw + (i64)b * sb + c;
  }
  __device__ __forceinline__ float xform(float y, int c) const {
    return pb ? lrelu_t<T>(rnd<T>(y + to_f<T>(pb[c])), 0.2f) : y;
  }
};

// v = rnd(rnd(acc) + rnd(bias)), clamped in T's precision; keeps NaN like
// torch.clamp
template <typename T>
__device__ __forceinline__ float tail_value(float acc, float bias, float lo, float hi) {
  const float v = rnd<T>(rnd<T>(acc) + rnd<T>(bias));
  const float tlo = rnd<T>(lo), thi = rnd<T>(hi);
  return v < tlo ? tlo : (v > thi ? thi : v);
}

template <typename T>
struct TailEpi {
  float* out;
  int h, wout;
  const float* bias;  // [48] fp32, rounded to T as the plain version does
  float lo, hi;
  __device__ __forceinline__ void operator()(int oy, int ox, int b, int o,
                                             float acc) const {
    const int i = o / 12, q = o - i * 12;
    out[((i64)b * 4 * h + 4 * oy + i) * (i64)(12 * wout) + 12 * ox + q] =
        tail_value<T>(acc, bias[o], lo, hi);
  }
};

template <typename T>
static int launch(const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4, int h,
                  int wout, const void* w, const void* bias, const void* pb,
                  float lo, float hi, void* out, cudaStream_t s) {
  IgGeom g;
  g.B = B; g.Cin = c4; g.KH = 3; g.KW = 3; g.pad_y = 1; g.pad_x = 1;
  g.Hout = h; g.Wout = wout; g.Cout = 48;
  // the conv reads rows ≤ h and columns ≤ wout; with pb, row h and column
  // wout are dead
  TailFetch<T> f{(const T*)g4, sh, sw, sb, pb ? h : h + 1, pb ? wout : wout + 1,
                 (const T*)pb};
  TailEpi<T> e{(float*)out, h, wout, (const float*)bias, lo, hi};
  igemm_launch<T>(g, (const T*)w, f, e, s);
  return (int)cudaGetLastError();
}

// The wgmma route's epilogue: a warp's 16 pixels × 48 channels through its
// scratch ([4 i][16 pixels][12 q] fp32, 3 KB) to 16-byte stores
struct TailWgEpi {
  float* out;           // contiguous fp32 [B, 4h, 12·wout]
  const float* bias;    // [48] fp32, i·12 + q order
  int h, wout;
  float lo, hi;
  static constexpr int kScratch = 3072;
  __device__ __forceinline__ void operator()(const float (&acc)[24], int y, int xw, int b,
                                             int lane, unsigned char* scratch) const {
    float* st = reinterpret_cast<float*>(scratch);
    const int g = lane >> 2, t = lane & 3;
    // accumulator 4j + 2·half + e: pixel g + 8·half, channel 8j + 2t + e; a
    // channel pair never straddles two phase rows (12 is even)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int c = 8 * j + 2 * t, i = c / 12, q = c - 12 * i;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(st + i * 192 + (g + 8 * half) * 12 + q) =
            make_float2(tail_value<bf16>(acc[4 * j + 2 * half], b0, lo, hi),
                        tail_value<bf16>(acc[4 * j + 2 * half + 1], b1, lo, hi));
    }
    __syncwarp();
    if (y >= h) return;
    // row i: 48 pieces of 4 floats, three a pixel; lanes take consecutive
    // pieces, so a warp's store is 512 contiguous bytes
    float* row = out + ((i64)b * 4 * h + 4 * y) * (i64)(12 * wout) + 12 * (i64)xw;
#pragma unroll
    for (int n = 0; n < 6; ++n) {
      const int k = lane + 32 * n, i = k / 48, r = k - 48 * i;
      if (xw + r / 3 < wout)
        *reinterpret_cast<float4*>(row + (i64)i * 12 * wout + 4 * r) =
            *reinterpret_cast<const float4*>(st + i * 192 + 4 * r);
    }
  }
};

extern "C" {

// g4: [h+1, Wc, B, c4] with element strides sh, sw, sb (channel stride 1),
// Wc > wout; w: contiguous [3,3,c4,48] with output channels i·12 + j·3 +
// colour; bias fp32 [48] in the same order; pb [c4] or null; out: contiguous
// fp32 [B, 4h, 12·wout]. dtype: 0 float32, 1 bfloat16.
int fused_tail(int dtype, const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4,
               int h, int wout, const void* w, const void* bias, const void* pb,
               float lo, float hi, void* out, void* stream) {
  if (c4 % IG_BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(g4, sh, sw, sb, B, c4, h, wout, w, bias, pb, lo, hi, out, s);
  return launch<__nv_bfloat16>(g4, sh, sw, sb, B, c4, h, wout, w, bias, pb, lo, hi,
                               out, s);
}

// bf16 only. g4 as above with sh, sw, sb multiples of 8 and a 16-byte aligned
// base; wp: the head as [c4/64][9][48 o][64 c] tiles (o in i·12 + q order)
// with the 16-byte pieces of a row swizzled (piece ^ (o & 7)), 16-byte
// aligned; bias fp32 [48], i·12 + q order; pb bf16 [c4] (16-byte aligned) or
// null; out contiguous fp32 [B, 4h, 12·wout].
int fused_tail_wgmma(const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4, int h, int wc,
                     int wout, const void* wp, const void* bias, const void* pb, float lo,
                     float hi, void* out, void* stream) {
  if (wc <= wout) return (int)cudaErrorInvalidValue;
  TailWgEpi epi{(float*)out, (const float*)bias, h, wout, lo, hi};
  // with pb, row h and column wout are dead; without, g4 arrives gated
  return conv3x3_wgmma_launch<48>(g4, sh, sw, sb, B, c4, h, wc, wout, pb ? h : h + 1,
                                  pb ? wout : wc, wp, pb, epi, (cudaStream_t)stream);
}

const char* fused_tail_error(int e) { return cudaGetErrorString((cudaError_t)e); }
}
