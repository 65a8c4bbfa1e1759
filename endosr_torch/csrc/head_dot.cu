// head_dot for Hopper: the folded ×8 head conv of the packed tail.
//
// Replaces endosr/kernels/head_dot.py::head_dot (pallas_call at :283).
// pre64[y, b, x, o] = Σ_{dy,dx,c} a[y+dy−1, x+dx−1, b, c] · w64[dy,dx,c,o]
//                     + b64[o]
// where a = lrelu(g4 + pre_bias) with the s=0 packed gate (row ≥ h and
// column ≥ wout dead) and zero padding above/left: the producer conv's
// bias + leaky_relu epilogue and the gate run at load time, so the raw g4
// is read once and no activated copy is written.
//
// Bound on the H100: operations, 2·B·h·wout·9·C4·64 ≈ 309 GFLOP at the
// flagship shape (≈0.31 ms of bf16 tensor-core time). It is the shared
// implicit GEMM (common.cuh): warp-level bf16 mma for bf16 storage, the
// CUDA cores for fp32; a wgmma/TMA pipeline is later work. The output is
// written HBWC, the order output_stage_x8 reads.

#include "common.cuh"

template <typename T>
struct HeadFetch {
  const T* g4;
  i64 sh, sw, sb;
  int h, wout;     // live rows / columns of g4 (the s=0 gate)
  const T* pb;     // producer bias [C4] or null (then no epilogue)
  __device__ __forceinline__ const T* ptr(int iy, int ix, int b, int c) const {
    if (iy < 0 || ix < 0 || iy >= h || ix >= wout) return nullptr;
    return g4 + (i64)iy * sh + (i64)ix * sw + (i64)b * sb + c;
  }
  __device__ __forceinline__ float xform(float y, int c) const {
    return pb ? lrelu_t<T>(rnd<T>(y + to_f<T>(pb[c])), 0.2f) : y;
  }
};

template <typename T>
struct HeadEpi {
  T* out;
  i64 oy_s, ob_s, ox_s;  // HBWC output strides
  const float* bias;     // [Cout] fp32, rounded to T as the twin does
  __device__ __forceinline__ void operator()(int oy, int ox, int b, int o,
                                             float acc) const {
    out[(i64)oy * oy_s + (i64)b * ob_s + (i64)ox * ox_s + o] =
        from_f<T>(rnd<T>(acc) + rnd<T>(bias[o]));
  }
};

template <typename T>
static int launch(const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4,
                  int h, int wout, const void* w, const void* bias,
                  const void* pb, void* out, int cout, cudaStream_t s) {
  IgGeom g;
  g.B = B; g.Cin = c4; g.KH = 3; g.KW = 3; g.pad_y = 1; g.pad_x = 1;
  g.Hout = h; g.Wout = wout; g.Cout = cout;
  HeadFetch<T> f{(const T*)g4, sh, sw, sb, h, wout, (const T*)pb};
  HeadEpi<T> e{(T*)out, (i64)B * wout * cout, (i64)wout * cout, cout,
               (const float*)bias};
  igemm_launch<T>(g, (const T*)w, f, e, s);
  return (int)cudaGetLastError();
}

extern "C" {

// g4: [Hp, Wc, B, c4] with element strides sh, sw, sb (channel stride 1);
// h = Hp − 1; w: [3,3,c4,cout] contiguous; bias fp32 [cout]; pb [c4] or
// null; out: contiguous [h, B, wout, cout]. dtype: 0 float32, 1 bfloat16.
int head_dot(int dtype, const void* g4, i64 sh, i64 sw, i64 sb, int B,
             int c4, int h, int wout, const void* w, const void* bias,
             const void* pb, void* out, int cout, void* stream) {
  if (c4 % IG_BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(g4, sh, sw, sb, B, c4, h, wout, w, bias, pb, out,
                         cout, s);
  return launch<__nv_bfloat16>(g4, sh, sw, sb, B, c4, h, wout, w, bias, pb,
                               out, cout, s);
}

const char* head_dot_error(int e) { return cudaGetErrorString((cudaError_t)e); }
}
