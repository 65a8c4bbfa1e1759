// fused_tail for Hopper: the packed ×8 tail's folded head conv, clamp,
// PixelShuffle(4) and fp32 rows in one pass.
//
// Replaces endosr/kernels/fused_tail.py::fused_tail (pallas_call at :238).
//   pre[b,y,x,o] = rnd(Σ_{dy,dx,c} g4[y+dy−1, x+dx−1, b, c] · w[dy,dx,c,o]) + bias[o]
//   out[b, 4y+i, 12x + q] = float(clamp(pre[b,y,x, i·12 + q]))      q = j·3 + colour
// for y < h, x < wout, with zero padding above and left; g4 arrives already
// activated and gated (its row h and its columns ≥ wout hold zeros), and
// the wrapper has put the head's 48 output channels in i·12 + q order.
//
// Bound on the H100: operations, 2·B·h·wout·9·C4·48 ≈ 232 GFLOP at the
// flagship shape (≈0.23 ms of bf16 tensor-core time); the bytes (g4 read
// once, 540 MB, the fp32 image written once, 101 MB) are ≈0.19 ms. It is
// the shared implicit GEMM (common.cuh: warp-level bf16 mma, or the fp32
// CUDA-core loop) with the output stage as its epilogue, so the 48-channel
// pre-activation never reaches device memory: twelve neighbouring threads
// write the twelve neighbouring floats one pixel gives an output row.

#include "common.cuh"

template <typename T>
struct TailFetch {
  const T* g4;
  i64 sh, sw, sb;
  __device__ __forceinline__ const T* ptr(int iy, int ix, int b, int c) const {
    if (iy < 0 || ix < 0) return nullptr;
    return g4 + (i64)iy * sh + (i64)ix * sw + (i64)b * sb + c;
  }
  __device__ __forceinline__ float xform(float y, int) const { return y; }
};

template <typename T>
struct TailEpi {
  float* out;
  int h, wout;
  const float* bias;  // [48] fp32, rounded to T as the plain version does
  float lo, hi;
  __device__ __forceinline__ void operator()(int oy, int ox, int b, int o,
                                             float acc) const {
    const int i = o / 12, q = o - i * 12;
    float v = rnd<T>(rnd<T>(acc) + rnd<T>(bias[o]));
    const float tlo = rnd<T>(lo), thi = rnd<T>(hi);
    v = v < tlo ? tlo : (v > thi ? thi : v);  // keeps NaN like torch.clamp
    out[((i64)b * 4 * h + 4 * oy + i) * (i64)(12 * wout) + 12 * ox + q] = v;
  }
};

template <typename T>
static int launch(const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4, int h,
                  int wout, const void* w, const void* bias, float lo, float hi,
                  void* out, cudaStream_t s) {
  IgGeom g;
  g.B = B; g.Cin = c4; g.KH = 3; g.KW = 3; g.pad_y = 1; g.pad_x = 1;
  g.Hout = h; g.Wout = wout; g.Cout = 48;
  TailFetch<T> f{(const T*)g4, sh, sw, sb};
  TailEpi<T> e{(float*)out, h, wout, (const float*)bias, lo, hi};
  igemm_launch<T>(g, (const T*)w, f, e, s);
  return (int)cudaGetLastError();
}

extern "C" {

// g4: [h+1, Wc, B, c4] with element strides sh, sw, sb (channel stride 1),
// Wc > wout; w: contiguous [3,3,c4,48] with output channels i·12 + j·3 +
// colour; bias fp32 [48] in the same order; out: contiguous fp32
// [B, 4h, 12·wout]. dtype: 0 float32, 1 bfloat16.
int fused_tail(int dtype, const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4,
               int h, int wout, const void* w, const void* bias, float lo,
               float hi, void* out, void* stream) {
  if (c4 % IG_BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(g4, sh, sw, sb, B, c4, h, wout, w, bias, lo, hi, out, s);
  return launch<__nv_bfloat16>(g4, sh, sw, sb, B, c4, h, wout, w, bias, lo, hi,
                               out, s);
}

const char* fused_tail_error(int e) { return cudaGetErrorString((cudaError_t)e); }
}
