// head_dot for Hopper: the folded ×8 head conv of the packed tail.
//
// Replaces endosr/kernels/head_dot.py::head_dot (pallas_call at :283).
// pre64[y, b, x, o] = Σ_{dy,dx,c} a[y+dy−1, x+dx−1, b, c] · w64[dy,dx,c,o]
//                     + b64[o]
// where a = lrelu(g4 + pre_bias) with the s=0 packed gate (row ≥ h and
// column ≥ wout dead) and zero padding above/left: the producer conv's
// bias + leaky_relu epilogue and the gate run at load time, so the raw g4
// is read once and no activated copy is written. The output is written
// HBWC, the order output_stage_x8 reads.
//
// Bound on the H100: operations, 2·B·h·wout·9·C4·64 ≈ 309 GFLOP at the
// flagship shape (≈0.31 ms at the bf16 tensor-core peak); the bytes (540 MB
// of g4 in, 67 MB out) take half of that.
//
// Two kernels, picked by shape in endosr_torch/kernels/head_dot.py:
//
// head_dot_wgmma (bf16, C4 a multiple of 64, 64 output channels): the
// implicit GEMM on wgmma of conv_wgmma.cuh (TMA halo tiles activated in
// place, A from registers through ldmatrix, a ring of weight tiles; 220 KB
// of shared memory, one block an SM) with HeadWgEpi as its epilogue: bf16
// HBWC in 16-byte stores. What holds it at about half the tensor-core peak
// is not known: a warpgroup drains its four wgmma of a tap before it issues
// the next tap's (keeping two taps in flight made ptxas serialise the wgmma
// for want of registers), and persistent blocks, a fourth halo stage, one
// TMA load a halo row and doubled ldmatrix traffic each left the time where
// it was.
//
// head_dot (any other shape or type): the shared implicit GEMM of
// common.cuh, warp-level mma for bf16, an exact fp32 loop on the CUDA cores
// for float storage.

#include "common.cuh"
#include "conv_wgmma.cuh"

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

// ---------------------------------------------------------------------------
// The wgmma route: conv_wgmma.cuh's 3×3 kernel with 64 output channels and
// this epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t sel4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                         int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// rnd(acc) + rnd(b64[o]) in registers, a 4×4 word transpose inside each lane
// quad, and 16-byte stores: a pixel's 64 channels are 128 contiguous bytes of
// the HBWC output
struct HeadWgEpi {
  bf16* out;            // contiguous [h, B, wout, 64]
  const float* bias;    // [64] fp32
  int h, wout, B;
  static constexpr int kScratch = 0;
  __device__ __forceinline__ void operator()(const float (&acc)[32], int y, int xw, int b,
                                             int lane, unsigned char*) const {
    // Within a quad, lane t ends up with the whole 8-channel block
    // j = 4m + t of its pixel.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * m + jj, c = 8 * j + 2 * t;
          v[jj] = pack_bf16(rnd<bf16>(acc[4 * j + 2 * half]) + rnd<bf16>(bias[c]),
                            rnd<bf16>(acc[4 * j + 2 * half + 1]) + rnd<bf16>(bias[c + 1]));
        }
        // round r: lane u hands its word of block u^r to lane u^r
        uint32_t rc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          rc[r] = __shfl_xor_sync(0xFFFFFFFFu, sel4(v[0], v[1], v[2], v[3], t ^ r), r);
        // rc[r] came from lane t^r: channels 2·(t^r), +1 of the block
        const uint4 o = make_uint4(sel4(rc[0], rc[1], rc[2], rc[3], t),
                                   sel4(rc[0], rc[1], rc[2], rc[3], t ^ 1),
                                   sel4(rc[0], rc[1], rc[2], rc[3], t ^ 2),
                                   sel4(rc[0], rc[1], rc[2], rc[3], t ^ 3));
        const int x = xw + g + 8 * half;
        if (y < h && x < wout)
          *reinterpret_cast<uint4*>(out + (((i64)y * B + b) * wout + x) * 64 +
                                    (4 * m + t) * 8) = o;
      }
    }
  }
};

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

// bf16 only, 64 output channels. g4 as above, Wc columns in memory, with sh,
// sw, sb multiples of 8 and a 16-byte aligned base; wp: w64 as
// [c4/64][9][64 o][64 c] tiles with the 16-byte pieces of a row swizzled
// (piece ^ (o & 7)), 16-byte aligned; bias fp32 [64]; pb bf16 [c4] (16-byte
// aligned) or null; out contiguous [h, B, wout, 64].
int head_dot_wgmma(const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4, int h, int wc,
                   int wout, const void* wp, const void* bias, const void* pb, void* out,
                   void* stream) {
  HeadWgEpi epi{(bf16*)out, (const float*)bias, h, wout, B};
  return conv3x3_wgmma_launch<64>(g4, sh, sw, sb, B, c4, h, wc, wout, h, wout, wp, pb, epi,
                                  (cudaStream_t)stream);
}

const char* head_dot_error(int e) { return cudaGetErrorString((cudaError_t)e); }
}
