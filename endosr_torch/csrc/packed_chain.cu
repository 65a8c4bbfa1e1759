// packed_g123 for Hopper: one phase-packed conv stage per launch.
//
// Replaces endosr/kernels/packed_chain.py::packed_g123 (pallas_call at
// :438). The wrapper (endosr_torch/kernels/packed_chain.py) runs the three
// stages as three calls:
//   g1 = gate1(lrelu(x ⊛ K1 + b1))        pads (1,1)  — x read with the
//        producer's deferred bias + leaky_relu and, with `phases`, the
//        fine-grid interleave of the packed producer tensor, at load time
//   g2 = gate0(relu(g1 ⊛ K2 + b2))        pads (0,1)
//   g3 = gate1(relu(g1 + g2 ⊛ K3 + b3))   pads (1,0)
// Each stage is a [2,2,Cin,C4] conv with fp32 accumulation, then the
// storage-type epilogue of the JAX twin (rounded after the sum and after
// each of bias, residual, activation and gate).
//
// Bound on the H100: operations. The tail chain is ≈208 GFLOP and the up1
// chain ≈70 GFLOP a forward (0.21 and 0.07 ms at the bf16 tensor-core
// peak); the bytes (x, g1, g2, g3 once each, g1 twice) take about a third of
// that.
//
// Two kernels, picked by shape in kernels/packed_chain.py:
//
// packed_stage_wgmma (bf16, Cin % 64 == 0, C4 = 128): the implicit GEMM on
// wgmma of conv_wgmma.cuh with 2×2 taps (TMA halo tiles activated in place,
// A from registers through ldmatrix, a ring of weight tiles) and StageWgEpi
// as its epilogue.
// - Persistent blocks. A tile is 4 to 16 taps (one to four 64-channel
//   slices of 2×2 taps), against 72 in head_dot, so a block a tile spends
//   most of its life in its first copies and its epilogue, with one block
//   an SM nothing overlaps them. One block an SM walks its tiles with the
//   rings running on across them.
// - Channels. A tile is 3 rows × 64 pixels × all 128 output channels:
//   three consumer warpgroups issue wgmma.m64n128k16 (64 fp32 accumulators
//   a thread) beside one producer warpgroup, 512 threads, at most 128
//   registers a thread (ptxas: 128, a few bytes spilled for the phase-packed
//   plan). The halo is loaded and activated once for all 128 channels and an
//   A fragment serves 128 of them. Two 64-channel halves in separate tiles
//   (wgmma.m64n64k16, four warpgroups of 4 × 64 pixels, 90 registers, the
//   first version) loaded and activated every halo twice: 1.05 ms against
//   0.92 for the tail chain in one A/B call; two consumer warpgroups of 2 ×
//   64 pixels, 1.00 against 0.89. m64n128 with four consumer warpgroups
//   would leave 96 registers a thread (or need setmaxnreg, which hung in a
//   first try on the 3×3 conv).
// - Weights. A stage of one or two 64-channel slices has 8 weight tiles of
//   16 KB: they fill the rectangular plan's 8 weight stages once per block
//   and stay (only the halo is read per tile), beside two 33 KB halo stages;
//   a ring of 4 stages and 3 halo stages was slower (0.91 against 0.88 ms).
//   The phase-packed plan's halo stages are 52 KB (four boxes), so it keeps
//   three of them beside a ring of four weight stages.
// - Phases. The tail chain's x is the packed producer [129, 129, B, 512]:
//   its halo is four TMA boxes, one per phase, and the fine pixel (iy, ix)
//   is a shared-memory address (conv_wgmma.cuh, ConvPlan::px_off). The dead
//   packed row and column (fine rows/columns ≥ nx, mx) are zeroed by
//   coordinate in the activation pass, as the padding is.
// - Odd extents. The outputs are 2N + 1 wide (129, 257). Rows are tiled by
//   3 (129 = 43·3, 257 → 258: 0.4 % more computed). Columns by 64 would
//   compute 192/129 and 320/257, so when a stage's width is one to eight
//   columns past a multiple of 64 above 64, the kernel takes the multiple of
//   64 and, in a second launch, the rest as the last rows of the transpose:
//   a tensor map with rows and columns swapped, the taps' weights read
//   transposed, phases (0, 1) and (1, 0) swapped, the output and residual
//   strides swapped and the gate evaluated at swapped coordinates. That
//   launch computes 3 × 64-pixel tiles for one column (a few tiles a
//   stage). The shared warp-mma kernel, and a strip kernel on the CUDA
//   cores, took tens of µs a launch on that column: few blocks, each
//   walking K in series.
// - The epilogue. The sum is rounded and the bias added in packed bf16x2
//   arithmetic, a quad of lanes trades words so that each lane holds 8
//   consecutive channels of a pixel (head_dot.cu's transpose), then the
//   residual g1 (one 16-byte load), the activation and the gate by
//   coordinate (the 8 channels lie in one phase group), and one 16-byte
//   store. Each op rounds once, as the fp32 form and a rounding do.
// - What holds it (python -m endosr_torch.tools.prof_conv): the taps of a
//   tile run at about the tensor-core rate, but the three consumer
//   warpgroups reach the epilogue together, and it takes longer than the
//   taps in the rectangular stages; in the phase-packed stage the
//   activation pass takes longer than the taps.
//
// packed_stage (any shape, either type): the shared implicit GEMM of
// common.cuh — warp-level bf16 mma, or an exact fp32 loop on the CUDA
// cores for float storage — with StageFetch / StageEpi, per element.

#include "common.cuh"
#include "conv_wgmma.cuh"

template <typename T>
struct StageFetch {
  const T* x;
  i64 sh, sw, sb;   // element strides of the (logical) input's H, W, B
  int nx, mx, cin;  // logical input extent and channels
  int phases;       // x is the packed producer [Hg, Wg, B, 4·cin]
  const T* pb;      // deferred producer bias [cin] or null
  int pre_act;      // deferred producer leaky_relu
  __device__ __forceinline__ const T* ptr(int iy, int ix, int b, int c) const {
    if (iy < 0 || ix < 0 || iy >= nx || ix >= mx) return nullptr;
    if (phases)
      return x + (i64)(iy >> 1) * sh + (i64)(ix >> 1) * sw + (i64)b * sb +
             ((iy & 1) * 2 + (ix & 1)) * cin + c;
    return x + (i64)iy * sh + (i64)ix * sw + (i64)b * sb + c;
  }
  __device__ __forceinline__ float xform(float y, int c) const {
    if (pb) y = rnd<T>(y + to_f<T>(pb[c]));
    if (pre_act) y = lrelu_t<T>(y, 0.2f);
    return y;
  }
};

// dead slots of the packed gate: with s = 1, group (a, bb) is dead in row
// n − 1 when a = 0 and in row 0 when a = 1 (columns alike with bb); with
// s = 0 the last row and column are
__device__ __forceinline__ bool gate_dead(int gate_s, int grp, int oy, int ox, int nrow,
                                          int ncol) {
  const int a = grp >> 1, bb = grp & 1;
  const bool dead_r = gate_s ? ((a == 0 && oy == nrow) || (a == 1 && oy == 0)) : oy == nrow;
  const bool dead_c = gate_s ? ((bb == 0 && ox == ncol) || (bb == 1 && ox == 0)) : ox == ncol;
  return dead_r || dead_c;
}

template <typename T>
struct StageEpi {
  T* out;
  i64 oh, ow, ob;     // output strides
  const T* bias;      // [C4]
  const T* res;       // residual (g1) with the output's geometry, or null
  i64 rh, rw, rb;
  int act;            // 0 relu, 1 leaky_relu(0.2)
  int gate_s;         // packed gate shift (0 or 1)
  int nrow, ncol;     // the grid's last row and column: packed extent − 1
  int cg;             // channels per phase group (C4 / 4)
  __device__ __forceinline__ void operator()(int oy, int ox, int b, int o,
                                             float acc) const {
    float g = rnd<T>(rnd<T>(acc) + to_f<T>(bias[o]));
    if (res) g = rnd<T>(to_f<T>(res[oy * rh + ox * rw + b * rb + o]) + g);
    g = act ? lrelu_t<T>(g, 0.2f) : relu_f(g);
    if (gate_dead(gate_s, o / cg, oy, ox, nrow, ncol)) g = 0.f;
    out[(i64)oy * oh + (i64)ox * ow + (i64)b * ob + o] = from_f<T>(g);
  }
};

template <typename T>
static int launch(const void* x, i64 sh, i64 sw, i64 sb, int nx, int mx,
                  int hout, int wout, int B, int cin, int phases, const void* pb,
                  int pre_act, const void* w, const void* bias, int pad_y, int pad_x,
                  void* out, i64 oh, i64 ow, i64 ob, int c4,
                  const void* res, i64 rh, i64 rw, i64 rb, int act,
                  int gate_s, cudaStream_t stream) {
  IgGeom g;
  g.B = B; g.Cin = cin; g.KH = 2; g.KW = 2; g.pad_y = pad_y; g.pad_x = pad_x;
  g.Hout = hout; g.Wout = wout; g.Cout = c4;
  StageFetch<T> f{(const T*)x, sh, sw, sb, nx, mx, cin, phases,
                  (const T*)pb, pre_act};
  StageEpi<T> e{(T*)out, oh, ow, ob, (const T*)bias, (const T*)res,
                rh, rw, rb, act, gate_s, hout - 1, wout - 1, c4 / 4};
  igemm_launch<T>(g, (const T*)w, f, e, stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma route's epilogue: NOUT output channels of 16 pixels a warp,
// BHWC bf16 in 16-byte stores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pick4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                          int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

template <int NOUT>
struct StageWgEpi {
  bf16* out;
  i64 oh, ow, ob;       // output element strides (channel stride 1)
  const bf16* bias;     // [128]
  const bf16* res;      // residual (g1) with the output's geometry, or null
  i64 rh, rw, rb;
  int act;              // 0 relu, 1 leaky_relu(0.2)
  int gate_s;           // packed gate shift (0 or 1)
  int h, wout;          // rows and columns this launch writes
  int nrow, ncol;       // the grid's last row and column
  int transposed;       // the launch computes the transpose: (y, x) is (ox, oy)
  static constexpr int kScratch = 0;
  // Packed bf16x2 arithmetic: each op rounds once to bf16, as the fp32 form
  // followed by a rounding does (the twin's order: the sum rounded, then
  // bias, residual, activation, gate), at a quarter of its instructions.
  __device__ __forceinline__ void operator()(const float (&acc)[NOUT / 2], int y, int xw,
                                             int b, int lane, unsigned char*) const {
    // Within a quad, lane t ends up with the whole 8-channel block
    // j = 4m + t of its pixel. The residual's 16-byte pieces are all loaded
    // first, in flight together.
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
    const __nv_bfloat162 slope = __float2bfloat162_rn(0.2f);
    uint4 rraw[NOUT / 32][2];
#pragma unroll
    for (int m = 0; m < NOUT / 32; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int x = xw + g + 8 * half;
        rraw[m][half] = res && y < h && x < wout
                            ? *reinterpret_cast<const uint4*>(res + (i64)y * rh + (i64)x * rw +
                                                              (i64)b * rb + (4 * m + t) * 8)
                            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int m = 0; m < NOUT / 32; ++m) {
      const int c0 = (4 * m + t) * 8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * m + jj, c = 8 * j + 2 * t;
          __nv_bfloat162 s2 = __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
          s2 = __hadd2(s2, *reinterpret_cast<const __nv_bfloat162*>(bias + c));
          v[jj] = *reinterpret_cast<uint32_t*>(&s2);
        }
        // round r: lane u hands its word of block u^r to lane u^r
        uint32_t rc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          rc[r] = __shfl_xor_sync(0xFFFFFFFFu, pick4(v[0], v[1], v[2], v[3], t ^ r), r);
        // rc[r] came from lane t^r: channels 2·(t^r), +1 of the block
        uint4 o = make_uint4(pick4(rc[0], rc[1], rc[2], rc[3], t),
                             pick4(rc[0], rc[1], rc[2], rc[3], t ^ 1),
                             pick4(rc[0], rc[1], rc[2], rc[3], t ^ 2),
                             pick4(rc[0], rc[1], rc[2], rc[3], t ^ 3));
        const int x = xw + g + 8 * half;
        if (y >= h || x >= wout) continue;
        __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&o);
        const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&rraw[m][half]);
        const bool dead = transposed ? gate_dead(gate_s, c0 / 32, x, y, nrow, ncol)
                                     : gate_dead(gate_s, c0 / 32, y, x, nrow, ncol);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          __nv_bfloat162 y2 = ov[q];
          if (res) y2 = __hadd2(rv[q], y2);
          y2 = act ? __hmax2(y2, __hmul2(y2, slope)) : __hmax2(y2, zero2);
          ov[q] = dead ? zero2 : y2;
        }
        *reinterpret_cast<uint4*>(out + (i64)y * oh + (i64)x * ow + (i64)b * ob + c0) = o;
      }
    }
  }
};

// The stage's plans: all 128 output channels a block (wgmma.m64n128k16),
// three consumer warpgroups (3 output rows of 64 pixels), one block an SM.
// A rectangular input: eight weight stages (128 KB: a one- or two-slice
// stage's weights stay resident) and two halo stages of 4 × 65 pixels. A
// phase-packed input: its halo stage is four 3 × 33 boxes (52 KB), so three
// of them beside a ring of four weight stages.
typedef ConvPlan<128, 2, false, 3, 8, 2> StagePlan;
typedef ConvPlan<128, 2, true, 3, 4, 3> StagePhasePlan;

extern "C" {

// One packed stage. The input's logical extent is nx × mx (for `phases`
// the fine grid of a packed [nx/2+1, mx/2+1] producer); the output is
// hout × wout × B × c4. The conv uses stride 1, taps 2×2, and the
// top/left padding pad_y/pad_x (the bottom/right padding follows from the
// output extent). dtype: 0 float32, 1 bfloat16.
int packed_stage(int dtype, const void* x, i64 sh, i64 sw, i64 sb, int nx,
                 int mx, int hout, int wout, int B, int cin, int phases, const void* pb,
                 int pre_act, const void* w, const void* bias, int pad_y,
                 int pad_x, void* out, i64 oh, i64 ow, i64 ob, int c4,
                 const void* res, i64 rh, i64 rw, i64 rb, int act, int gate_s,
                 void* stream) {
  if (cin % IG_BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, sh, sw, sb, nx, mx, hout, wout, B, cin, phases, pb, pre_act,
                         w, bias, pad_y, pad_x, out, oh, ow, ob, c4, res, rh,
                         rw, rb, act, gate_s, s);
  return launch<__nv_bfloat16>(x, sh, sw, sb, nx, mx, hout, wout, B, cin, phases, pb,
                               pre_act, w, bias, pad_y, pad_x, out, oh, ow, ob,
                               c4, res, rh, rw, rb, act, gate_s, s);
}

// The same stage on the wgmma route: bf16, cin % 64 == 0, c4 = 128, padding
// pad on both sides' top/left. x as above, with sh, sw, sb multiples of 8
// and a 16-byte aligned base (for `phases` the packed tensor's strides); wp:
// the stage's weights as [cin/64][4 taps][128 o][64 c] tiles with
// the 16-byte pieces of a row swizzled (piece ^ (o & 7)); bias bf16 [128];
// pb bf16 [cin] (16-byte aligned) or null; out and res: 16-byte aligned
// with strides multiples of 8.
int packed_stage_wgmma(const void* x, i64 sh, i64 sw, i64 sb, int nx, int mx, int hout,
                       int wout, int B, int cin, int phases, const void* pb, int pre_act,
                       const void* wp, const void* bias, int pad, void* out,
                       i64 oh, i64 ow, i64 ob, const void* res, i64 rh, i64 rw, i64 rb,
                       int act, int gate_s, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((oh | ow | ob) % 8 != 0 || ((uintptr_t)out & 15) != 0 ||
      (res && ((rh | rw | rb) % 8 != 0 || ((uintptr_t)res & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  // columns [0, wmain) as they are; a remainder of one to eight columns
  // past a multiple of 64 as the last rows of the transpose
  const int rem = wout % CONV_COLS;
  const int wmain = (wout > CONV_COLS && rem >= 1 && rem <= 8) ? wout - rem : wout;
  StageWgEpi<128> epi{(bf16*)out, oh, ow, ob, (const bf16*)bias, (const bf16*)res, rh, rw, rb,
                      act, gate_s, hout, wmain, hout - 1, wout - 1, 0};
  for (int tr = 0; tr < 2; ++tr) {
    if (tr) {
      if (wmain == wout) break;
      // rows [wmain, wout) × columns [0, hout) of the transpose
      epi = StageWgEpi<128>{(bf16*)out, ow, oh, ob, (const bf16*)bias, (const bf16*)res, rw, rh,
                            rb, act, gate_s, wout, hout, hout - 1, wout - 1, 1};
    }
    const int h = tr ? wout - wmain : hout, w = tr ? hout : wmain, y_org = tr ? wmain : 0;
    CUtensorMap map;
    int e;
    if (phases) {
      typedef StagePhasePlan P;
      const int hg = nx / 2 + 1, wg = mx / 2 + 1;
      e = tr ? conv_tensor_map(&map, x, sw, sh, sb, 4 * cin, hg, wg, B, P::pc, P::pr)
             : conv_tensor_map(&map, x, sh, sw, sb, 4 * cin, wg, hg, B, P::pc, P::pr);
      if (e) return e;
      e = conv_wgmma_run<P>(map, B, cin, h, w, pad, pad, tr ? mx : nx, tr ? nx : mx, pre_act, wp,
                            pb, epi, true, s, y_org, tr);
    } else {
      typedef StagePlan P;
      e = tr ? conv_tensor_map(&map, x, sw, sh, sb, cin, nx, mx, B, P::hc, P::hr)
             : conv_tensor_map(&map, x, sh, sw, sb, cin, mx, nx, B, P::hc, P::hr);
      if (e) return e;
      e = conv_wgmma_run<P>(map, B, cin, h, w, pad, pad, tr ? mx : nx, tr ? nx : mx, pre_act, wp,
                            pb, epi, true, s, y_org, tr);
    }
    if (e) return e;
  }
  return 0;
}

const char* packed_stage_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
