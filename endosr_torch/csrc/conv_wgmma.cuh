// The implicit-GEMM conv on wgmma shared by head_dot and fused_tail (3×3
// taps) and by packed_g123's stages (2×2 taps).
//
//   acc[y, b, x, o] = Σ_{dy,dx,c} a[y+dy−pad_y, x+dx−pad_x, b, c] · w[dy,dx,c,o]
//
// where a = lrelu(rnd(x + pre_bias), 0.2) with `act` (pre_bias taken as 0
// when absent), else a = x, and a is zero outside rows [0, gate_h) and
// columns [0, gate_w). With PHASES, x is a phase-packed producer
// [Hg, Wg, B, 4·C] read as its fine grid: a[iy, ix, c] is
// x[iy>>1, ix>>1, b, ((iy&1)·2 + (ix&1))·C + c]. The sum stays in fp32
// registers; an epilogue functor turns it into the caller's output
// (head_dot: HBWC bf16; fused_tail: the output stage's fp32 rows; a packed
// stage: bias, residual, activation and gate, BHWC bf16).
//
// Bound on the H100: operations (head_dot ≈309 GFLOP, fused_tail ≈232, the
// two packed chains ≈278 a forward); the bytes take about as long for the
// 3×3 convs and a third as long for the packed stages.
//
// A tile is ROWS output rows × 64 columns × NOUT output channels of one
// image; a block has ROWS consumer warpgroups (one output row, 64 pixels, each)
// and one producer warpgroup (ConvPlan: the 3×3 convs 4 rows, a packed
// stage 3 rows × 128 channels). The K loop runs over 64-channel slices of
// x, and inside a slice over the KT × KT taps.
// - The halo tile. For a slice, TMA brings the raw x of the input pixels the
//   block's taps touch into shared memory: one tiled load of the
//   (ROWS + KT − 1) × (64 + KT − 1) window, or with PHASES four, one per
//   phase, each 3 × 33 packed pixels at a 1024-byte aligned place (the fine
//   window starts on the even row and column at or one before the first
//   one a tap reads: the interleave is an address map, nothing is
//   materialised). A pixel's 64 channels are one 128-byte
//   row, rows in the 128-byte swizzle (the 16-byte piece c of the row at
//   byte offset r·128 stored at piece c ^ (r & 7)). TMA rather than
//   cp.async: a first version that copied 16 bytes a thread spent more time
//   issuing its 3,168 copies a slice than the consumers spent multiplying,
//   while a TMA load is one instruction of one thread. Three warps of the
//   producer group then activate the tile in place, once: lrelu(rnd(x +
//   pre_bias)) in packed bf16 arithmetic, and a pixel in the padding or
//   outside the gate is stored as zero (lrelu(0 + bias) ≠ 0 and a dead pixel
//   holds data, such as a packed producer's last row and column, so the mask
//   is by coordinate; TMA's zero fill outside the tensor is not enough). A
//   thread keeps eleven 16-byte loads in flight: with one at a time the pass
//   was a chain of 33 shared-memory round trips a slice, each queued behind
//   the consumers' traffic, and set the kernel's pace. So a byte of x is read
//   once per block that needs it and an element is activated once, not once
//   per tap.
// - The taps. A tap's A operand is the halo tile shifted by whole pixels.
//   A one-pixel shift is a shift of one 128-byte row, no start for a
//   swizzled wgmma shared-memory descriptor, so A comes from registers:
//   ldmatrix.x4 at the shifted pixel addresses (piece ^ (row & 7), free of
//   bank conflicts at any shift) yields exactly the m64k16 register fragment,
//   16 pixels a warp. The next tap's fragments are loaded while this tap's
//   wgmma run.
// - The weights. The wrapper arranges w once per call into the order the
//   kernel streams: [slice][tap][o][c] tiles of NOUT × 64 (K-major for
//   wgmma's B) with the 16-byte pieces of a row already in the 128-byte
//   swizzle, so a tile moves with one 1-D bulk copy. They stay in L2.
// - The ring. HS halo stages and WS weight stages in dynamic shared memory
//   (one block an SM; the 3×3 convs 3 and 8), each with mbarriers: landed (TMA bytes) → full
//   (activated) → empty for a halo stage, full → empty for a weight stage.
//   One producer thread issues every copy in the order the consumers need
//   them and runs ahead as far as the rings allow: slice s + 2 is in flight
//   while slice s + 1 is activated and slice s multiplied. Consumers issue
//   four wgmma.m64nNOUTk16 a tap (fp32 accumulators in registers) and
//   release a weight stage when its group has completed. When a tile's
//   weight tiles fit the eight stages (a packed stage of one or two slices)
//   they are loaded once and stay: a tile then reads only its halo from L2. The 3×3 convs run
//   one block a tile (72 taps a tile); the packed stages, 4 to 16 taps a
//   tile, run one persistent block an SM that walks its tiles with the rings
//   running on, so a tile's first copies overlap the last taps and the
//   epilogue of the one before.
// - The epilogue. epi(acc, y, x, b, lane, scratch) is called by every
//   consumer warp with its accumulators: output row y, pixels x .. x+15 of
//   image b; accumulator 4j + 2·half + e holds pixel x + lane/4 + 8·half,
//   channel 8j + 2·(lane%4) + e. scratch
//   is 16-byte aligned shared memory of the warp's own (Epi::kScratch bytes:
//   a halo stage that no slice uses any more by then).
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

// Where a block's time goes, compiled in only with CONV_PROFILE defined
// (python -m endosr_torch.tools.prof_conv): cycles summed per block, for
// the first consumer thread (0 waiting for halo tiles, 1 in the taps, 2 in
// the epilogue, 3 from start to end, 7 tiles), the first activator (4
// waiting for TMA, 5 activating) and the issuing thread (6 waiting for a
// free halo stage); slot 1 for a PHASES plan, 0 otherwise.
#ifdef CONV_PROFILE
__device__ unsigned long long conv_prof[2][1024][8];
#define CONV_NOW() clock64()
#define CONV_ADD(cond, k, v)                                                              \
  do {                                                                                    \
    if ((cond) && blockIdx.x < 1024) conv_prof[PHASES ? 1 : 0][blockIdx.x][k] += (v);     \
  } while (0)
#else
#define CONV_NOW() 0ull
#define CONV_ADD(cond, k, v) \
  do {                       \
  } while (0)
#endif

#define CONV_COLS 64                  // output columns of a block
#define CONV_ACTIVATORS 96            // threads that activate halo tiles (3 warps)

// ROWS output rows a block (a consumer warpgroup each), WS weight stages, HS
// halo stages
template <int NOUT, int KT, bool PHASES, int ROWS = 4, int WS = 8, int HS = 3>
struct ConvPlan {
  static_assert(NOUT % 16 == 0 && (NOUT <= 64 || NOUT == 128), "NOUT: 16 … 64 or 128");
  static_assert(KT == 2 || KT == 3, "2×2 or 3×3 taps");
  static_assert(!PHASES || KT == 2, "the phase interleave is the packed stage's");
  static constexpr int nout = NOUT, kt = KT, rows = ROWS, ws = WS, hs = HS;
  static constexpr bool phases = PHASES;
  static constexpr int taps = KT * KT;
  static constexpr int wtile = NOUT * 64;                     // elements of a weight tile
  // the halo window of a rectangular input
  static constexpr int hr = ROWS + KT - 1, hc = CONV_COLS + KT - 1;
  // with PHASES: one phase's box of packed pixels, 1024-byte aligned (the
  // window starts on an even fine row and column, at most one before the
  // first one a tap reads)
  static constexpr int pr = (ROWS + 3) / 2, pc = CONV_COLS / 2 + 1;
  static constexpr int phase_bytes = (pr * pc * 128 + 1023) / 1024 * 1024;
  static constexpr int halo_px = PHASES ? 4 * pr * pc : hr * hc;
  static constexpr int box_bytes = halo_px * 128;             // a slice's TMA bytes
  // a stage starts on a multiple of 1024 bytes (the swizzle's period)
  static constexpr int stage_bytes =
      PHASES ? 4 * phase_bytes : (box_bytes + 1023) / 1024 * 1024;
  static constexpr int off_halo = WS * wtile * 2;             // bytes
  static constexpr int off_bar = off_halo + HS * stage_bytes;
  static constexpr int total = off_bar + 8 * (3 * HS + 2 * WS) + 1024;
  // ROWS consumer warpgroups and the producer warpgroup
  static constexpr int threads = (ROWS + 1) * 128;
  static_assert(off_halo % 1024 == 0, "weight tiles keep the swizzle's alignment");
  static_assert(total <= 232448, "one block fits an SM's shared memory");
  static_assert(WS <= 2 * taps, "the epilogue's scratch stage is free (see the kernel)");

  // byte offset in a halo stage of the window pixel (ry, rx), counted from
  // the window's first row and column (of the fine grid with PHASES)
  static __device__ __forceinline__ int px_off(int ry, int rx) {
    if constexpr (PHASES)
      return ((ry & 1) * 2 + (rx & 1)) * phase_bytes + ((ry >> 1) * pc + (rx >> 1)) * 128;
    else
      return (ry * hc + rx) * 128;
  }
  // the p-th pixel row of a halo stage in the order the loads store them:
  // its byte offset and its (ry, rx) in the window
  static __device__ __forceinline__ int px_at(int p, int& ry, int& rx) {
    if constexpr (PHASES) {
      const int ph = p / (pr * pc), q = p - ph * (pr * pc), py = q / pc;
      ry = 2 * py + (ph >> 1);
      rx = 2 * (q - py * pc) + (ph & 1);
      return ph * phase_bytes + q * 128;
    } else {
      ry = p / hc;
      rx = p - ry * hc;
      return p * 128;
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NOUT>
__device__ __forceinline__ void wgmma_rs(float (&d)[NOUT / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (NOUT == 128)
    wgmma_m64n128k16_rs(d, a, desc_b);
  else if constexpr (NOUT == 64)
    wgmma_m64n64k16_rs(d, a, desc_b);
  else
    wgmma_m64n48k16_rs(d, a, desc_b);
}

// Output tile t of a launch: columns fastest, then rows, then the image
struct ConvTile {
  int x0, y0, b;
};
template <int ROWS>
__device__ __forceinline__ ConvTile conv_tile(int t, int ncx, int nry, int y_org) {
  ConvTile c;
  c.x0 = (t % ncx) * CONV_COLS;
  t /= ncx;
  c.y0 = y_org + (t % nry) * ROWS;
  c.b = t / nry;
  return c;
}

// A block computes tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the
// ntiles = ncx · nry · B; its rings run on across tiles, so the
// copies of the next tile's first slices overlap this tile's last taps and
// epilogue. Slice g of the block is slice g % S of its (g / S)-th tile.
template <class P, class Epi>
__global__ void __launch_bounds__(P::threads, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, int cin, int pad_y, int pad_x,
                  int gate_h, int gate_w, int act, int ncx, int nry, int ntiles, int y_org,
                  int tswap,
                  const bf16* __restrict__ wp, const bf16* __restrict__ pb, Epi epi) {
  constexpr int NOUT = P::nout, KT = P::kt, ROWS = P::rows;
  constexpr int WS = P::ws, HS = P::hs;
  constexpr bool PHASES = P::phases;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need a 1024-byte aligned base
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* wtiles = reinterpret_cast<bf16*>(smem);
  unsigned char* halo = smem + P::off_halo;
  uint64_t* landed_h = reinterpret_cast<uint64_t*>(smem + P::off_bar);  // TMA done
  uint64_t* full_h = landed_h + HS;                                   // activated
  uint64_t* empty_h = full_h + HS;
  uint64_t* full_w = empty_h + HS;
  uint64_t* empty_w = full_w + WS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < HS; ++i) {
      mbar_init(landed_h + i, 1);           // the issuer's expect_tx arrival
      mbar_init(full_h + i, CONV_ACTIVATORS);
      mbar_init(empty_h + i, ROWS * 4);   // one arrival a consumer warp
    }
    for (int i = 0; i < WS; ++i) {
      mbar_init(full_w + i, 1);             // the loader's expect_tx arrival
      mbar_init(empty_w + i, ROWS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int S = cin / 64;
  const int nslices = ((ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * S;
  // a tile's weight tiles fit the weight stages: loaded once, kept for
  // every tile
  const bool resident = S * P::taps <= WS;
  const int wg = threadIdx.x >> 7;
  auto tile_of = [&](int g) {
    return conv_tile<ROWS>(blockIdx.x + (g / S) * gridDim.x, ncx, nry, y_org);
  };
  // weight tile of tap `tap` of slice s: with tswap the input is read
  // through its transpose, so tap (dy, dx) takes the weights of (dx, dy)
  auto wtile_of = [&](int s, int tap) {
    return s * P::taps + (tswap ? (tap % KT) * KT + tap / KT : tap);
  };
  // the window's first input row and column (PHASES: even, at most one
  // before the first one a tap reads, so the packed box starts on a pair)
  auto window_y = [&](const ConvTile& c) { return PHASES ? (c.y0 - 1) & ~1 : c.y0 - pad_y; };
  auto window_x = [&](const ConvTile& c) { return PHASES ? (c.x0 - 1) & ~1 : c.x0 - pad_x; };

  if (wg == ROWS) {
    // ============ producer warpgroup ============
    const int t = threadIdx.x - ROWS * 128;
    if (t < CONV_ACTIVATORS) {
      // warps 0-2: each halo tile, once it has landed, activated in place
      const int piece = t & 7;      // this thread's 8 channels of its pixels
      const __nv_bfloat162 slope = __float2bfloat162_rn(0.2f);
      constexpr int PER = CONV_ACTIVATORS / 8;              // pixels a pass
      constexpr int IT = (P::halo_px + PER - 1) / PER;      // passes a thread
      static_assert(IT <= 64, "a pixel's liveness is one bit of a word");
      constexpr int U = 11;                                 // loads in flight
      // with PHASES the address map divides: the byte offsets of this
      // thread's pixels in a halo stage are worked out once and, the passes
      // below being unrolled, stay in registers
      constexpr int NOFF = PHASES ? (IT + U - 1) / U * U : 1;
      int poff[NOFF];
#pragma unroll
      for (int i = 0; i < NOFF; ++i) {
        int ry, rx;
        poff[i] = P::px_at(min((t >> 3) + i * PER, P::halo_px - 1), ry, rx);
      }
      // bit i: this thread's i-th pixel is a live pixel of x; of need, a
      // tap reads it (with PHASES the boxes hold a row and a column more
      // than the taps read, which are neither loaded nor stored here); the
      // same in every slice of a tile
      uint64_t live = 0, need = 0;
      for (int g = 0; g < nslices; ++g) {
        const int s = g % S;
        if (s == 0) {
          const ConvTile c = tile_of(g);
          const int hy0 = window_y(c), hx0 = window_x(c);
          const int dy = c.y0 - pad_y - hy0, dx = c.x0 - pad_x - hx0;
          live = need = 0;
          for (int p = t >> 3, i = 0; p < P::halo_px; p += PER, ++i) {
            int ry, rx;
            P::px_at(p, ry, rx);
            const int iy = hy0 + ry, ix = hx0 + rx;
            if (iy >= 0 && iy < gate_h && ix >= 0 && ix < gate_w) live |= 1ull << i;
            if (PHASES && ry >= dy && ry < dy + P::hr && rx >= dx && rx < dx + P::hc)
              need |= 1ull << i;
          }
        }
        const int st = g % HS;
        const unsigned long long ta = CONV_NOW();
        mbar_wait(landed_h + st, (g / HS) & 1);
        const unsigned long long tb = CONV_NOW();
        CONV_ADD(t == 0, 4, tb - ta);
        uint4 praw = make_uint4(0u, 0u, 0u, 0u);
        if (pb) praw = *reinterpret_cast<const uint4*>(pb + s * 64 + piece * 8);
        const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&praw);
        unsigned char* base = halo + st * P::stage_bytes;
        // a rectangular window is read whole: every pixel of this thread's
        auto needed = [&](int i) {
          return PHASES ? ((need >> i) & 1) != 0 : (t >> 3) + i * PER < P::halo_px;
        };
        auto piece_at = [&](int i) {
          const int off =
              PHASES ? poff[PHASES ? i : 0] : min((t >> 3) + i * PER, P::halo_px - 1) * 128;
          return reinterpret_cast<uint4*>(base + off + ((piece ^ ((off >> 7) & 7)) << 4));
        };
        if (act) {
          // Eleven pieces a round, without a branch: all their loads are in
          // flight together. One load at a time would make a slice's 33
          // passes 33 shared-memory round trips, each queued behind the
          // consumers' traffic, and the activation, not the multiply, would
          // set the pace. Packed bf16 math: the add and the multiply each
          // round once, as the fp32 forms do (their fp32 results are exact or
          // round the same way), and max is exact. A pixel in the padding
          // (already zero) or outside the gate (not zero) becomes 0.
          auto act_round = [&](int i0) {
            uint4 raw[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
              raw[u] = !PHASES || needed(i0 + u) ? *piece_at(i0 + u) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int u = 0; u < U; ++u) {
              __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw[u]);
              const bool alive = (live >> (i0 + u)) & 1;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const __nv_bfloat162 y = __hadd2(v[q], pv[q]);
                v[q] = alive ? __hmax2(y, __hmul2(y, slope)) : __float2bfloat162_rn(0.f);
              }
              if (i0 + u < IT && needed(i0 + u)) *piece_at(i0 + u) = raw[u];
            }
          };
          // unrolled only where the offsets sit in registers: unrolled, the
          // 3×3 plans' rounds spill at their 96 registers
          if constexpr (PHASES) {
#pragma unroll
            for (int i0 = 0; i0 < IT; i0 += U) act_round(i0);
          } else {
            for (int i0 = 0; i0 < IT; i0 += U) act_round(i0);
          }
        } else {
          // nothing to activate: only the dead pixels are zeroed
          auto zero = [&](int i) {
            if (!((live >> i) & 1) && needed(i)) *piece_at(i) = make_uint4(0u, 0u, 0u, 0u);
          };
          if constexpr (PHASES) {
#pragma unroll
            for (int i = 0; i < IT; ++i) zero(i);
          } else {
            for (int i = 0; i < IT; ++i) zero(i);
          }
        }
        fence_proxy_async();    // before a later TMA load overwrites these bytes
        mbar_arrive(full_h + st);
        CONV_ADD(t == 0, 5, CONV_NOW() - tb);
      }
    } else if (t == CONV_ACTIVATORS) {
      // one thread of warp 3 issues every copy, in the order the consumers
      // need them: the halo tile of slice g + HS − 1 goes out before the
      // last weight tile of slice g (or tile WS), whose ring keeps this
      // thread at most WS taps ahead of the consumers, so the stage it
      // reuses (slice g − 1's) is free by then or about to be
      constexpr int halo_tap = WS < P::taps - 1 ? WS : P::taps - 1;
      auto issue_halo = [&](int g) {
        const ConvTile c = tile_of(g);
        const int s = g % S, st = g % HS;
        const unsigned long long tw = CONV_NOW();
        mbar_wait(empty_h + st, ((g / HS) & 1) ^ 1);
        CONV_ADD(true, 6, CONV_NOW() - tw);
        mbar_arrive_expect_tx(landed_h + st, P::box_bytes);
        unsigned char* dst = halo + st * P::stage_bytes;
        if constexpr (PHASES) {
          for (int ph = 0; ph < 4; ++ph)
            // with tswap, phase (a, b) of the transposed grid is (b, a) of x
            tma_load_4d(dst + ph * P::phase_bytes, &xmap,
                        (tswap ? (ph & 1) * 2 + (ph >> 1) : ph) * cin + s * 64, window_x(c) / 2,
                        window_y(c) / 2, c.b, landed_h + st);
        } else {
          tma_load_4d(dst, &xmap, s * 64, window_x(c), window_y(c), c.b, landed_h + st);
        }
      };
      if (resident) {
        issue_halo(0);
        for (int j = 0; j < S * P::taps; ++j) {
          mbar_arrive_expect_tx(full_w + j, P::wtile * 2);
          bulk_copy_g2s(wtiles + j * P::wtile,
                        wp + (i64)wtile_of(j / P::taps, j % P::taps) * P::wtile, P::wtile * 2,
                        full_w + j);
        }
        for (int g = 1; g < nslices; ++g) issue_halo(g);
        return;
      }
      for (int g = 0; g < HS - 1 && g < nslices; ++g) issue_halo(g);
      int i = 0;
      for (int g = 0; g < nslices; ++g) {
        const int s = g % S;
        for (int tap = 0; tap < P::taps; ++tap, ++i) {
          if (tap == halo_tap && g + HS - 1 < nslices) issue_halo(g + HS - 1);
          const int st = i % WS;
          mbar_wait(empty_w + st, ((i / WS) & 1) ^ 1);
          mbar_arrive_expect_tx(full_w + st, P::wtile * 2);
          bulk_copy_g2s(wtiles + st * P::wtile, wp + (i64)wtile_of(s, tap) * P::wtile,
                        P::wtile * 2, full_w + st);
        }
      }
    }
  } else {
    // ============ consumer warpgroups ============
    const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
    const int r16 = lane & 15, hi = lane >> 4;
    int wst = 0;
    uint32_t wph = 0;
    const unsigned long long t_start = CONV_NOW();
    for (int g = 0; g < nslices;) {
      CONV_ADD(threadIdx.x == 0, 7, 1);
      const ConvTile c = tile_of(g);
      // this lane's ldmatrix row at tap (0,0): the window pixel of output
      // pixel 16·w4 + r16 of row wg
      const int ry0 = wg + c.y0 - pad_y - window_y(c);
      const int rx0 = w4 * 16 + r16 + c.x0 - pad_x - window_x(c);
      float acc[NOUT / 2];
#pragma unroll
      for (int i = 0; i < NOUT / 2; ++i) acc[i] = 0.f;
      for (int s = 0; s < S; ++s, ++g) {
        const int hst = g % HS;
        const unsigned long long t0 = CONV_NOW();
        mbar_wait(full_h + hst, (g / HS) & 1);
        const unsigned long long t1 = CONV_NOW();
        CONV_ADD(threadIdx.x == 0, 0, t1 - t0);
        const unsigned char* tile = halo + hst * P::stage_bytes;
        // a tap's fragments are loaded while the tap before it multiplies
        auto load_a = [&](uint32_t (&a)[4][4], int tap) {
          const int off = P::px_off(ry0 + tap / KT, rx0 + tap % KT);
          const bf16* row = reinterpret_cast<const bf16*>(tile + off);
          const int sw = (off >> 7) & 7;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], row + (((2 * kk + hi) ^ sw) << 3));
        };
        uint32_t a[2][4][4];
        load_a(a[0], 0);
#pragma unroll
        for (int tap = 0; tap < P::taps; ++tap) {
          // a resident tile stays in stage s·taps + tap; its barrier's one
          // phase has completed once it landed
          const int j = resident ? s * P::taps + tap : wst;
          mbar_wait(full_w + j, resident ? 0u : wph);
          const uint64_t desc = wgmma_desc_k128(wtiles + j * P::wtile);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs<NOUT>(acc, a[tap & 1][kk], desc + 2 * kk);
          wgmma_commit();
          if (tap < P::taps - 1) load_a(a[(tap + 1) & 1], tap + 1);
          wgmma_wait<0>();
          if (resident) continue;
          if (lane == 0) mbar_arrive(empty_w + wst);
          if (++wst == WS) {
            wst = 0;
            wph ^= 1;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_h + hst);
        CONV_ADD(threadIdx.x == 0, 1, CONV_NOW() - t1);
      }
      const unsigned long long t2 = CONV_NOW();

      // Scratch (an epilogue with Epi::kScratch > 0 runs one tile a block):
      // halo stage S % HS, which holds no slice any more. A warpgroup
      // gets here only after its last weight tile (taps·S − 1) has landed,
      // which the ring allows only once every consumer warp has released
      // tile taps·S − 1 − WS ≥ taps·(S − 2) − 1 (WS ≤ 2·taps), the
      // last of slice S − 3: so every warp has left slice S − 3 behind, the
      // activators are past it, and no later halo load uses its stage. The
      // stage is slice S − 3's, or one no slice used.
      unsigned char* scratch =
          halo + (S % HS) * P::stage_bytes + (wg * 4 + w4) * Epi::kScratch;
      static_assert(ROWS * 4 * Epi::kScratch <= P::stage_bytes,
                    "the consumers' scratch fits in one halo stage");
      epi(acc, c.y0 + wg, c.x0 + 16 * w4, c.b, lane, scratch);
      CONV_ADD(threadIdx.x == 0, 2, CONV_NOW() - t2);
    }
    CONV_ADD(threadIdx.x == 0, 3, CONV_NOW() - t_start);
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

// The tensor map of a bf16 input x as (c, x, y, b), innermost first, with
// element strides sh, sw, sb (channel stride 1): a box is one 64-channel
// slice of box_w × box_h pixels, its 128-byte pixel rows swizzled in shared
// memory. Returns a cudaError_t.
static int conv_tensor_map(CUtensorMap* map, const void* x, i64 sh, i64 sw, i64 sb, int c,
                           int w, int h, int B, int box_w, int box_h) {
  if (c % 64 != 0 || (sh | sw | sb) % 8 != 0 || ((uintptr_t)x & 15) != 0)
    return (int)cudaErrorInvalidValue;
  TensorMapEncode encode = tensor_map_encode();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sw * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Launch the conv for output rows [0, h) and columns [0, wout) over the
// input behind `map` (made by conv_tensor_map with the plan's box); cin: the
// input's channels (logical ones with PHASES); wp: the packed weights, pb:
// bf16 [cin] or null. persistent: one block an SM, each taking every
// gridDim.x-th tile; else one block a tile (always so for an epilogue that
// needs scratch). y_org: the first output row; tswap: x is read through a
// tensor map of its transpose (rows and columns swapped), so the taps'
// weights are too, and with PHASES phases (0, 1) and (1, 0). Returns a
// cudaError_t.
template <class P, class Epi>
static int conv_wgmma_run(const CUtensorMap& map, int B, int cin, int h, int wout, int pad_y,
                          int pad_x, int gate_h, int gate_w, int act, const void* wp,
                          const void* pb, Epi epi, bool persistent, cudaStream_t s,
                          int y_org = 0, int tswap = 0) {
  if (cin % 64 != 0 || (P::phases && (pad_y != 1 || pad_x != 1)))
    return (int)cudaErrorInvalidValue;
  auto kern = conv_wgmma_kernel<P, Epi>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       P::total);
  if (e != cudaSuccess) return (int)e;
  const int ncx = (wout + CONV_COLS - 1) / CONV_COLS, nry = (h + P::rows - 1) / P::rows;
  const long long ntiles = (long long)ncx * nry * B;
  if (ntiles <= 0) return 0;
  if (ntiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  long long grid = ntiles;
  if (persistent && Epi::kScratch == 0) {
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    grid = ntiles < sms ? ntiles : sms;
  }
  kern<<<(unsigned)grid, P::threads, P::total, s>>>(map, cin, pad_y, pad_x, gate_h, gate_w, act,
                                                    ncx, nry, (int)ntiles, y_org, tswap,
                                                    (const bf16*)wp,
                                                    (const bf16*)pb, epi);
  return (int)cudaGetLastError();
}

// The 3×3 conv over g4 [h + 1, wc, B, c4] (element strides sh, sw, sb,
// channel stride 1; multiples of 8, base 16-byte aligned) for output rows
// [0, h) and columns [0, wout), padding 1 above and left; activated when pb
// (bf16 [c4]) is given. Returns a cudaError_t.
template <int NOUT, class Epi>
static int conv3x3_wgmma_launch(const void* g4, i64 sh, i64 sw, i64 sb, int B, int c4, int h,
                                int wc, int wout, int gate_h, int gate_w, const void* wp,
                                const void* pb, Epi epi, cudaStream_t s) {
  typedef ConvPlan<NOUT, 3, false> P;
  CUtensorMap map;
  const int e = conv_tensor_map(&map, g4, sh, sw, sb, c4, wc, h + 1, B, P::hc, P::hr);
  if (e) return e;
  return conv_wgmma_run<P>(map, B, c4, h, wout, 1, 1, gate_h, gate_w, pb != nullptr, wp, pb,
                           epi, false, s);
}
