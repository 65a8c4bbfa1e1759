// The 3×3 implicit-GEMM conv on wgmma shared by head_dot and fused_tail.
//
//   acc[y, b, x, o] = Σ_{dy,dx,c} a[y+dy−1, x+dx−1, b, c] · w[dy,dx,c,o]
//
// where a = lrelu(rnd(g4 + pre_bias), 0.2) (with pre_bias, else a = g4),
// zero outside rows [0, gate_h) and columns [0, gate_w), and zero padding
// above and left. The sum stays in fp32 registers; an epilogue functor
// turns it into the caller's output (head_dot: HBWC bf16; fused_tail: the
// output stage's fp32 rows).
//
// Bound on the H100: operations, 2·B·h·wout·9·C4·NOUT (≈309 GFLOP for
// head_dot's 64 channels, ≈232 for fused_tail's 48: 0.31 / 0.23 ms at the
// bf16 tensor-core peak); the bytes (540 MB of g4 in) take about as long.
//
// A block owns 4 output rows × 64 columns of one image and has four consumer
// warpgroups (one output row, 64 pixels, each) and one producer warpgroup.
// The K loop runs over 64-channel slices of g4, and inside a slice over the
// nine taps.
// - The halo tile. For a slice, one tiled TMA load brings the raw g4 of the
//   6 × 66 input pixels the block's taps touch into shared memory (the tensor
//   map is built by conv3x3_tensor_map from g4's pointer and strides; a
//   pixel's 64 channels are one 128-byte row, rows in the 128-byte swizzle).
//   TMA rather than cp.async: a first version that copied 16 bytes a thread
//   spent more time issuing its 3,168 copies a slice than the consumers
//   spent multiplying, while a TMA load is one instruction of one thread.
//   Three warps of the producer group then activate the tile in place, once:
//   lrelu(rnd(x + pre_bias)) in packed bf16 arithmetic, and a pixel in the
//   padding or outside the gate is stored as zero (lrelu(0 + bias) ≠ 0 and a
//   dead pixel holds data, so the mask is by coordinate; TMA's zero fill
//   outside the tensor is not enough). A thread keeps eleven 16-byte loads
//   in flight: with one at a time the pass was a chain of 33 shared-memory
//   round trips a slice, each queued behind the consumers' traffic, and set
//   the kernel's pace. So a byte of g4 is read once per block that needs it
//   (6/4 of the tensor in all, the overlap from L2) and an element is
//   activated once, not nine times.
// - The taps. A tap's A operand is the halo tile shifted by whole pixels.
//   A one-pixel shift is a shift of one 128-byte row, no start for a
//   swizzled wgmma shared-memory descriptor, so A comes from registers:
//   ldmatrix.x4 at the shifted pixel addresses (piece ^ (pixel & 7), free of
//   bank conflicts at any shift) yields exactly the m64k16 register fragment,
//   16 pixels a warp. The next tap's fragments are loaded while this tap's
//   wgmma run.
// - The weights. The wrapper arranges w once per call into the order the
//   kernel streams: [slice][tap][o][c] tiles of NOUT × 64 (K-major for
//   wgmma's B) with the 16-byte pieces of a row already in the 128-byte
//   swizzle, so a tile moves with one 1-D bulk copy. They stay in L2.
// - The ring. Three halo stages and eight weight stages in dynamic shared
//   memory (one block an SM), each with mbarriers: landed (TMA bytes) → full
//   (activated) → empty for a halo stage, full → empty for a weight stage.
//   One producer thread issues every copy in the order the consumers need
//   them and runs ahead as far as the rings allow: slice s + 2 is in flight
//   while slice s + 1 is activated and slice s multiplied. Consumers issue
//   four wgmma.m64nNOUTk16 a tap (fp32 accumulators in registers) and
//   release a weight stage when its group has completed. Blocks are not
//   persistent.
// - The epilogue. epi(acc, y, x, b, lane, scratch) is called by every
//   consumer warp with its accumulators: output row y, pixels x .. x+15 of
//   image b; accumulator 4j + 2·half + e holds pixel x + lane/4 + 8·half,
//   channel 8j + 2·(lane%4) + e. scratch is 16-byte aligned shared memory
//   of the warp's own (CONV3_SCRATCH bytes: a halo stage that no slice uses
//   any more by then).
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

#define CONV3_ROWS 4                   // output rows of a block, a consumer warpgroup each
#define CONV3_COLS 64                  // output columns of a block
#define CONV3_HW (CONV3_COLS + 2)      // halo columns
#define CONV3_HS 3                     // halo stages
#define CONV3_WS 8                     // weight stages
#define CONV3_ACTIVATORS 96            // threads that activate halo tiles (3 warps)
#define CONV3_SCRATCH 3072             // epilogue scratch bytes of one consumer warp

template <int NOUT>
struct Conv3Plan {
  static_assert(NOUT % 16 == 0 && NOUT <= 64, "NOUT: 16, 32, 48 or 64");
  static constexpr int wtile = NOUT * 64;                     // elements of a weight tile
  static constexpr int halo_px = (CONV3_ROWS + 2) * CONV3_HW;
  static constexpr int box_bytes = halo_px * 128;
  // a stage starts on a multiple of 1024 bytes (the swizzle's period)
  static constexpr int stage_el = (box_bytes + 1023) / 1024 * 512;
  static constexpr int off_halo = CONV3_WS * wtile * 2;       // bytes
  static constexpr int off_bar = off_halo + CONV3_HS * stage_el * 2;
  static constexpr int total = off_bar + 8 * (3 * CONV3_HS + 2 * CONV3_WS) + 1024;
  // CONV3_ROWS consumer warpgroups and the producer warpgroup
  static constexpr int threads = (CONV3_ROWS + 1) * 128;
  static_assert(off_halo % 1024 == 0, "weight tiles keep the swizzle's alignment");
  static_assert(CONV3_ROWS * 4 * CONV3_SCRATCH <= stage_el * 2,
                "the consumers' scratch fits in one halo stage");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NOUT>
__device__ __forceinline__ void wgmma_rs(float (&d)[NOUT / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (NOUT == 64)
    wgmma_m64n64k16_rs(d, a, desc_b);
  else
    wgmma_m64n48k16_rs(d, a, desc_b);
}

template <int NOUT, class Epi>
__global__ void __launch_bounds__(Conv3Plan<NOUT>::threads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap g4map, int c4, int gate_h,
                     int gate_w, const bf16* __restrict__ wp, const bf16* __restrict__ pb,
                     Epi epi) {
  typedef Conv3Plan<NOUT> P;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need a 1024-byte aligned base
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* wtiles = reinterpret_cast<bf16*>(smem);
  bf16* halo = reinterpret_cast<bf16*>(smem + P::off_halo);
  uint64_t* landed_h = reinterpret_cast<uint64_t*>(smem + P::off_bar);  // TMA done
  uint64_t* full_h = landed_h + CONV3_HS;                                  // activated
  uint64_t* empty_h = full_h + CONV3_HS;
  uint64_t* full_w = empty_h + CONV3_HS;
  uint64_t* empty_w = full_w + CONV3_WS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < CONV3_HS; ++i) {
      mbar_init(landed_h + i, 1);           // the issuer's expect_tx arrival
      mbar_init(full_h + i, CONV3_ACTIVATORS);
      mbar_init(empty_h + i, CONV3_ROWS * 4);   // one arrival a consumer warp
    }
    for (int i = 0; i < CONV3_WS; ++i) {
      mbar_init(full_w + i, 1);             // the loader's expect_tx arrival
      mbar_init(empty_w + i, CONV3_ROWS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int x0 = blockIdx.x * CONV3_COLS, y0 = blockIdx.y * CONV3_ROWS, b = blockIdx.z;
  const int S = c4 / 64;
  const int wg = threadIdx.x >> 7;

  if (wg == CONV3_ROWS) {
    // ============ producer warpgroup ============
    const int t = threadIdx.x - CONV3_ROWS * 128;
    if (t < CONV3_ACTIVATORS) {
      // warps 0-2: each halo tile, once it has landed, activated in place
      const int piece = t & 7;      // this thread's 8 channels of its pixels
      const __nv_bfloat162 slope = __float2bfloat162_rn(0.2f);
      // bit i: this thread's i-th pixel is a live pixel of g4 (the same in
      // every slice)
      uint64_t live = 0;
      for (int p = t >> 3, i = 0; p < P::halo_px; p += CONV3_ACTIVATORS / 8, ++i) {
        const int r = p / CONV3_HW;
        const int iy = y0 - 1 + r, ix = x0 - 1 + (p - r * CONV3_HW);
        if (iy >= 0 && iy < gate_h && ix >= 0 && ix < gate_w) live |= 1ull << i;
      }
      for (int s = 0; s < S; ++s) {
        const int st = s % CONV3_HS;
        mbar_wait(landed_h + st, (s / CONV3_HS) & 1);
        uint4 praw = make_uint4(0u, 0u, 0u, 0u);
        if (pb) praw = *reinterpret_cast<const uint4*>(pb + s * 64 + piece * 8);
        const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&praw);
        bf16* base = halo + (i64)st * P::stage_el;
        constexpr int PER = CONV3_ACTIVATORS / 8;               // pixels a pass
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
          // (already zero) or outside the gate (not zero) becomes 0.
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
    } else if (t == CONV3_ACTIVATORS) {
      // one thread of warp 3 issues every copy, in the order the consumers
      // need them: the halo tile of slice s + CONV3_HS − 1 goes out late among
      // slice s's weight tiles, whose ring keeps this thread at most CONV3_WS
      // taps ahead of the consumers, so the stage it reuses (slice s − 1's)
      // is free by then or about to be
      constexpr int halo_tap = CONV3_WS < 8 ? CONV3_WS : 8;
      auto issue_halo = [&](int s) {
        const int st = s % CONV3_HS;
        mbar_wait(empty_h + st, ((s / CONV3_HS) & 1) ^ 1);
        mbar_arrive_expect_tx(landed_h + st, P::box_bytes);
        tma_load_4d(halo + (i64)st * P::stage_el, &g4map, s * 64, x0 - 1, y0 - 1, b,
                    landed_h + st);
      };
      for (int s = 0; s < CONV3_HS - 1 && s < S; ++s) issue_halo(s);
      int i = 0;
      for (int s = 0; s < S; ++s)
        for (int tap = 0; tap < 9; ++tap, ++i) {
          if (tap == halo_tap && s + CONV3_HS - 1 < S) issue_halo(s + CONV3_HS - 1);
          const int st = i % CONV3_WS;
          mbar_wait(empty_w + st, ((i / CONV3_WS) & 1) ^ 1);
          mbar_arrive_expect_tx(full_w + st, P::wtile * 2);
          bulk_copy_g2s(wtiles + st * P::wtile, wp + (i64)i * P::wtile, P::wtile * 2,
                        full_w + st);
        }
    }
  } else {
    // ============ consumer warpgroups ============
    const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
    const int r16 = lane & 15, hi = lane >> 4;
    float acc[NOUT / 2];
#pragma unroll
    for (int i = 0; i < NOUT / 2; ++i) acc[i] = 0.f;

    // this lane's ldmatrix row at tap (0,0): halo pixel of output pixel
    // 16·w4 + r16 of row wg
    const int pix0 = wg * CONV3_HW + w4 * 16 + r16;
    int wst = 0;
    uint32_t wph = 0;
    for (int s = 0; s < S; ++s) {
      const int hst = s % CONV3_HS;
      mbar_wait(full_h + hst, (s / CONV3_HS) & 1);
      const bf16* tile = halo + (i64)hst * P::stage_el;
      // a tap's fragments are loaded while the tap before it multiplies
      auto load_a = [&](uint32_t (&a)[4][4], int tap) {
        const int pix = pix0 + (tap / 3) * CONV3_HW + tap % 3;
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
        const uint64_t desc = wgmma_desc_k128(wtiles + wst * P::wtile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<NOUT>(acc, a[tap & 1][kk], desc + 2 * kk);
        wgmma_commit();
        if (tap < 8) load_a(a[(tap + 1) & 1], tap + 1);
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty_w + wst);
        if (++wst == CONV3_WS) {
          wst = 0;
          wph ^= 1;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_h + hst);
    }

    // Scratch: halo stage S % CONV3_HS, which holds no slice any more. A
    // warpgroup gets here only after its last weight tile has landed, which
    // the ring allows only once every consumer warp has released the tile
    // CONV3_WS earlier, in slice S − 1: so every warp has left slice S − 2
    // behind, the activators are past slice S − 1, and no later halo load
    // exists. The stage is slice S − 3's, or one no slice used.
    unsigned char* scratch = reinterpret_cast<unsigned char*>(
        halo + (i64)(S % CONV3_HS) * P::stage_el) + (wg * 4 + w4) * CONV3_SCRATCH;
    epi(acc, y0 + wg, x0 + 16 * w4, b, lane, scratch);
  }
}

// cuTensorMapEncodeTiled lives in libcuda, which the CUDA runtime has loaded
// by the time a kernel is launched: looked up there once, so a library
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

// Launch the conv over g4 [h + 1, wc, B, c4] (element strides sh, sw, sb,
// channel stride 1; multiples of 8, base 16-byte aligned) for output rows
// [0, h) and columns [0, wout); wp: the packed weights, pb: bf16 [c4] or
// null. Returns a cudaError_t.
template <int NOUT, class Epi>
static int conv3x3_wgmma_launch(const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4, int h,
                                int wc, int wout, int gate_h, int gate_w, const void* wp,
                                const void* pb, Epi epi, cudaStream_t s) {
  typedef Conv3Plan<NOUT> P;
  if (c4 % 64 != 0 || (sh | sw | sb) % 8 != 0 || ((uintptr_t)g4 & 15) != 0)
    return (int)cudaErrorInvalidValue;
  TensorMapEncode encode = tensor_map_encode();
  if (!encode) return (int)cudaErrorNotSupported;
  // g4 as (c, x, y, b), innermost first; a box is one 64-channel slice of the
  // block's halo pixels, its 128-byte pixel rows swizzled in shared memory
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)c4, (cuuint64_t)wc, (cuuint64_t)h + 1,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sw * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, CONV3_HW, CONV3_ROWS + 2, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(g4), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kern = conv3x3_wgmma_kernel<NOUT, Epi>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       P::total);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((wout + CONV3_COLS - 1) / CONV3_COLS, (h + CONV3_ROWS - 1) / CONV3_ROWS, B);
  kern<<<grid, P::threads, P::total, s>>>(map, c4, gate_h, gate_w, (const bf16*)wp,
                                          (const bf16*)pb, epi);
  return (int)cudaGetLastError();
}
