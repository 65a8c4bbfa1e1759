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
// head_dot_wgmma (bf16, C4 a multiple of 64, 64 output channels): an
// implicit GEMM on wgmma. A block owns 4 output rows × 64 columns of one
// image and has four consumer warpgroups (one output row, 64 pixels, each)
// and one producer warpgroup. The K loop runs over 64-channel slices of g4,
// and inside a slice over the nine taps.
// - The halo tile. For a slice, one tiled TMA load brings the raw g4 of the
//   6 × 66 input pixels the block's taps touch into shared memory (the tensor
//   map is built in the exported function from g4's pointer and strides; a
//   pixel's 64 channels are one 128-byte row, rows in the 128-byte swizzle).
//   TMA rather than cp.async: a first version that copied 16 bytes a thread
//   spent more time issuing its 3,168 copies a slice than the consumers
//   spent multiplying, while a TMA load is one instruction of one thread.
//   Three warps of the producer group then activate the tile in place, once:
//   lrelu(rnd(x + pre_bias)) in packed bf16 arithmetic, and a pixel in the
//   padding or in a dead row/column of g4 is stored as zero (lrelu(0 + bias)
//   ≠ 0 and a dead pixel holds data, so the mask is by coordinate; TMA's
//   zero fill outside the tensor is not enough). A thread keeps eleven
//   16-byte loads in flight: with one at a time the pass was a chain of 33
//   shared-memory round trips a slice, each queued behind the consumers'
//   traffic, and set the kernel's pace. So a byte of g4 is read once per
//   block that needs it (6/4 of the tensor in all, the overlap from L2) and
//   an element is activated once, not nine times.
// - The taps. A tap's A operand is the halo tile shifted by whole pixels.
//   A one-pixel shift is a shift of one 128-byte row, no start for a
//   swizzled wgmma shared-memory descriptor, so A comes from registers:
//   ldmatrix.x4 at the shifted pixel addresses (piece ^ (pixel & 7), free of
//   bank conflicts at any shift) yields exactly the m64k16 register fragment,
//   16 pixels a warp. The next tap's fragments are loaded while this tap's
//   wgmma run.
// - The weights. The wrapper arranges w64 once per call into the order the
//   kernel streams: [slice][tap][o][c] tiles of 64 × 64 (8 KB, K-major for
//   wgmma's B) with the 16-byte pieces of a row already in the 128-byte
//   swizzle, so a tile moves with one 1-D bulk copy. All 590 KB stay in L2.
// - The ring. Three halo stages and eight weight stages in dynamic shared
//   memory (220 KB, one block an SM), each with mbarriers: landed (TMA
//   bytes) → full (activated) → empty for a halo stage, full → empty for a
//   weight stage. One producer thread issues every copy in the order the
//   consumers need them and runs ahead as far as the rings allow: slice
//   s + 2 is in flight while slice s + 1 is activated and slice s
//   multiplied. Consumers issue four wgmma.m64n64k16 a tap (fp32 accumulators
//   in registers) and release a weight stage when its group has completed.
//   Blocks are not persistent.
// - The epilogue. rnd(acc) + rnd(b64[o]) in registers, a 4×4 word transpose
//   inside each lane quad, and 16-byte stores: a pixel's 64 channels are 128
//   contiguous bytes of the HBWC output.
// What holds it at about half the tensor-core peak is not known: a warpgroup
// drains its four wgmma of a tap before it issues the next tap's (keeping two
// taps in flight made ptxas serialise the wgmma for want of registers), and
// persistent blocks, a fourth halo stage, one TMA load a halo row and doubled
// ldmatrix traffic each left the time where it was.
//
// head_dot (any other shape or type): the shared implicit GEMM of
// common.cuh, warp-level mma for bf16, an exact fp32 loop on the CUDA cores
// for float storage.

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"
#include "hopper.cuh"

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
// The wgmma kernel
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

#define HD_ROWS 4                  // output rows of a block, a consumer warpgroup each
#define HD_COLS 64                 // output columns of a block
#define HD_HW (HD_COLS + 2)        // halo columns
#define HD_WTILE 4096              // elements of one weight tile [64 o][64 c]
#define HD_HS 3                    // halo stages
#define HD_WS 8                    // weight stages
#define HD_HALO_TAP (HD_WS < 8 ? HD_WS : 8)   // the tap before which the next halo load goes out
#define HD_ACTIVATORS 96           // threads that activate halo tiles (3 warps)

struct HdPlan {
  static constexpr int halo_px = (HD_ROWS + 2) * HD_HW;
  static constexpr int box_bytes = halo_px * 128;
  // a stage starts on a multiple of 1024 bytes (the swizzle's period)
  static constexpr int stage_el = (box_bytes + 1023) / 1024 * 512;
  static constexpr int off_halo = HD_WS * HD_WTILE * 2;             // bytes
  static constexpr int off_bar = off_halo + HD_HS * stage_el * 2;
  static constexpr int total = off_bar + 8 * (3 * HD_HS + 2 * HD_WS) + 1024;
  // HD_ROWS consumer warpgroups and the producer warpgroup
  static constexpr int threads = (HD_ROWS + 1) * 128;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t sel4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                         int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

__global__ void __launch_bounds__(HdPlan::threads, 1)
head_dot_wgmma_kernel(const __grid_constant__ CUtensorMap g4map, int c4, int h, int wout,
                      const bf16* __restrict__ wp, const float* __restrict__ bias,
                      const bf16* __restrict__ pb, bf16* __restrict__ out, int B) {
  typedef HdPlan P;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need a 1024-byte aligned base
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* wtiles = reinterpret_cast<bf16*>(smem);
  bf16* halo = reinterpret_cast<bf16*>(smem + P::off_halo);
  uint64_t* landed_h = reinterpret_cast<uint64_t*>(smem + P::off_bar);  // TMA done
  uint64_t* full_h = landed_h + HD_HS;                                       // activated
  uint64_t* empty_h = full_h + HD_HS;
  uint64_t* full_w = empty_h + HD_HS;
  uint64_t* empty_w = full_w + HD_WS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < HD_HS; ++i) {
      mbar_init(landed_h + i, 1);           // the issuer's expect_tx arrival
      mbar_init(full_h + i, HD_ACTIVATORS);
      mbar_init(empty_h + i, HD_ROWS * 4);     // one arrival a consumer warp
    }
    for (int i = 0; i < HD_WS; ++i) {
      mbar_init(full_w + i, 1);             // the loader's expect_tx arrival
      mbar_init(empty_w + i, HD_ROWS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int x0 = blockIdx.x * HD_COLS, y0 = blockIdx.y * HD_ROWS, b = blockIdx.z;
  const int S = c4 / 64;
  const int wg = threadIdx.x >> 7;

  if (wg == HD_ROWS) {
    // ============ producer warpgroup ============
    const int t = threadIdx.x - HD_ROWS * 128;
    if (t < HD_ACTIVATORS) {
      // warps 0-2: each halo tile, once it has landed, activated in place
      const int piece = t & 7;      // this thread's 8 channels of its pixels
      const __nv_bfloat162 slope = __float2bfloat162_rn(0.2f);
      // bit i: this thread's i-th pixel is a live pixel of g4 (the same in
      // every slice)
      uint64_t live = 0;
      for (int p = t >> 3, i = 0; p < P::halo_px; p += HD_ACTIVATORS / 8, ++i) {
        const int r = p / HD_HW;
        const int iy = y0 - 1 + r, ix = x0 - 1 + (p - r * HD_HW);
        if (iy >= 0 && iy < h && ix >= 0 && ix < wout) live |= 1ull << i;
      }
      for (int s = 0; s < S; ++s) {
        const int st = s % HD_HS;
        mbar_wait(landed_h + st, (s / HD_HS) & 1);
        uint4 praw = make_uint4(0u, 0u, 0u, 0u);
        if (pb) praw = *reinterpret_cast<const uint4*>(pb + s * 64 + piece * 8);
        const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&praw);
        bf16* base = halo + (i64)st * P::stage_el;
        constexpr int PER = HD_ACTIVATORS / 8;                  // pixels a pass
        constexpr int IT = (P::halo_px + PER - 1) / PER;        // passes a thread
        auto piece_at = [&](int i) {
          const int p = min((t >> 3) + i * PER, P::halo_px - 1);
          return reinterpret_cast<uint4*>(base + p * 64 + ((piece ^ (p & 7)) << 3));
        };
        if (pb) {
          // Eleven pieces a round, without a branch: all their loads are in
          // flight together. One load at a time would make a slice's 33
          // passes 33 shared-memory round trips, each queued behind the
          // consumers' traffic, and the activation, not the multiply, would
          // set the pace. Packed bf16 math: the add and the multiply each
          // round once, as the fp32 forms do (their fp32 results are exact or
          // round the same way), and max is exact. A pixel in the padding
          // (already zero) or in a dead row/column of g4 (not zero) becomes 0.
          constexpr int U = 11;
          for (int i0 = 0; i0 < IT; i0 += U) {
            uint4 raw[U];
#pragma unroll
            for (int u = 0; u < U; ++u) raw[u] = *piece_at(i0 + u);
#pragma unroll
            for (int u = 0; u < U; ++u) {
              __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw[u]);
              const bool alive = (live >> (i0 + u)) & 1;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const __nv_bfloat162 y = __hadd2(v[q], pv[q]);
                v[q] = alive ? __hmax2(y, __hmul2(y, slope)) : __float2bfloat162_rn(0.f);
              }
              if (i0 + u < IT && (t >> 3) + (i0 + u) * PER < P::halo_px) *piece_at(i0 + u) = raw[u];
            }
          }
        } else {
          // nothing to activate: only the dead pixels are zeroed
          for (int i = 0; i < IT; ++i)
            if (!((live >> i) & 1) && (t >> 3) + i * PER < P::halo_px)
              *piece_at(i) = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();    // before a later TMA load overwrites these bytes
        mbar_arrive(full_h + st);
      }
    } else if (t == HD_ACTIVATORS) {
      // one thread of warp 3 issues every copy, in the order the consumers
      // need them: the halo tile of slice s + HD_HS − 1 goes out late among
      // slice s's weight tiles, whose ring keeps this thread at most HD_WS
      // taps ahead of the consumers, so the stage it reuses (slice s − 1's)
      // is free by then or about to be
      auto issue_halo = [&](int s) {
        const int st = s % HD_HS;
        mbar_wait(empty_h + st, ((s / HD_HS) & 1) ^ 1);
        mbar_arrive_expect_tx(landed_h + st, P::box_bytes);
        tma_load_4d(halo + (i64)st * P::stage_el, &g4map, s * 64, x0 - 1, y0 - 1, b,
                    landed_h + st);
      };
      for (int s = 0; s < HD_HS - 1 && s < S; ++s) issue_halo(s);
      int i = 0;
      for (int s = 0; s < S; ++s)
        for (int tap = 0; tap < 9; ++tap, ++i) {
          if (tap == HD_HALO_TAP && s + HD_HS - 1 < S) issue_halo(s + HD_HS - 1);
          const int st = i % HD_WS;
          mbar_wait(empty_w + st, ((i / HD_WS) & 1) ^ 1);
          mbar_arrive_expect_tx(full_w + st, HD_WTILE * 2);
          bulk_copy_g2s(wtiles + st * HD_WTILE, wp + (i64)i * HD_WTILE, HD_WTILE * 2,
                        full_w + st);
        }
    }
  } else {
    // ============ consumer warpgroups ============
    const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
    const int r16 = lane & 15, hi = lane >> 4;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    // this lane's ldmatrix row at tap (0,0): halo pixel of output pixel
    // 16·w4 + r16 of row wg
    const int pix0 = wg * HD_HW + w4 * 16 + r16;
    int wst = 0;
    uint32_t wph = 0;
    for (int s = 0; s < S; ++s) {
      const int hst = s % HD_HS;
      mbar_wait(full_h + hst, (s / HD_HS) & 1);
      const bf16* tile = halo + (i64)hst * P::stage_el;
      // a tap's fragments are loaded while the tap before it multiplies
      auto load_a = [&](uint32_t (&a)[4][4], int tap) {
        const int pix = pix0 + (tap / 3) * HD_HW + tap % 3;
        const bf16* row = tile + pix * 64;
        const int sw = pix & 7;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], row + (((2 * kk + hi) ^ sw) << 3));
      };
      uint32_t a[2][4][4];
      load_a(a[0], 0);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        mbar_wait(full_w + wst, wph);
        const uint64_t desc = wgmma_desc_k128(wtiles + wst * HD_WTILE);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs(acc, a[tap & 1][kk], desc + 2 * kk);
        wgmma_commit();
        if (tap < 8) load_a(a[(tap + 1) & 1], tap + 1);
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty_w + wst);
        if (++wst == HD_WS) {
          wst = 0;
          wph ^= 1;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_h + hst);
    }

    // accumulator 4j + 2·half + e: pixel 16·w4 + lane/4 + 8·half, channel
    // 8j + 2·(lane%4) + e. Within a quad, lane t ends up with the whole
    // 8-channel block j = 4m + t of its pixel.
    const int y = y0 + wg, g = lane >> 2, t = lane & 3;
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
        const int x = x0 + w4 * 16 + g + 8 * half;
        if (y < h && x < wout)
          *reinterpret_cast<uint4*>(out + (((i64)y * B + b) * wout + x) * 64 +
                                    (4 * m + t) * 8) = o;
      }
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda, which the CUDA runtime has loaded
// by the time a kernel is launched: looked up there once, so this library
// links against nothing but the runtime
typedef CUresult (*TensorMapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave,
                                    CUtensorMapSwizzle, CUtensorMapL2promotion,
                                    CUtensorMapFloatOOBfill);

static TensorMapEncode tensor_map_encode() {
  static TensorMapEncode fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return (TensorMapEncode)(lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr);
  }();
  return fn;
}

static int launch_wgmma(const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4, int h,
                        int wc, int wout, const void* wp, const void* bias, const void* pb,
                        void* out, cudaStream_t s) {
  typedef HdPlan P;
  TensorMapEncode encode = tensor_map_encode();
  if (!encode) return (int)cudaErrorNotSupported;
  // g4 as (c, x, y, b), innermost first; a box is one 64-channel slice of the
  // block's halo pixels, its 128-byte pixel rows swizzled in shared memory
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)c4, (cuuint64_t)wc, (cuuint64_t)h + 1,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sw * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, HD_HW, HD_ROWS + 2, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(g4), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kern = head_dot_wgmma_kernel;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       P::total);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((wout + HD_COLS - 1) / HD_COLS, (h + HD_ROWS - 1) / HD_ROWS, B);
  kern<<<grid, P::threads, P::total, s>>>(map, c4, h, wout, (const bf16*)wp,
                                          (const float*)bias, (const bf16*)pb, (bf16*)out,
                                          B);
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

// bf16 only, 64 output channels. g4 as above, Wc columns in memory, with sh,
// sw, sb multiples of 8 and a 16-byte aligned base; wp: w64 as
// [c4/64][9][64 o][64 c] tiles with the 16-byte pieces of a row swizzled
// (piece ^ (o & 7)), 16-byte aligned; bias fp32 [64]; pb bf16 [c4] (16-byte
// aligned) or null; out contiguous [h, B, wout, 64].
int head_dot_wgmma(const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4, int h, int wc,
                   int wout, const void* wp, const void* bias, const void* pb, void* out,
                   void* stream) {
  if (c4 % 64 != 0 || (sh | sw | sb) % 8 != 0) return (int)cudaErrorInvalidValue;
  return launch_wgmma(g4, sh, sw, sb, B, c4, h, wc, wout, wp, bias, pb, out,
                            (cudaStream_t)stream);
}

const char* head_dot_error(int e) { return cudaGetErrorString((cudaError_t)e); }
}
