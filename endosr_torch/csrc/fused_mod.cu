// Fused SEAN modulation branches for Hopper.
//
// fused_o_branch replaces endosr/kernels/fused_obranch.py::fused_o_branch
// (pallas_call at :146). For every SEAN instance n of the trunk:
//   actv_n = relu(conv3x3(d; wm_n) + bm_n), zero outside the image,
//            rounded once to T
//   out[b,y,x, n·c2+c] = rnd(Σ_{tap,k} actv_n[tap-shifted, k]·w2_n[tap,k,c])
//                        + b2_n[c]
//
// fused_modulation replaces endosr/kernels/fused_mod.py::fused_modulation
// (pallas_call at :152): the same o-branch with pre-scaled w2, plus the
// style product Σ_{tap,k} mask[b, tap-shifted, k]·v[b,n,tap·K+k,c] into the
// same fp32 accumulators, plus bias_n[c], with one rounding at the end.
//
// Bound on the H100: operations. conv2 is 2·B·H·W·N·9·c2² ≈ 1.0 TFLOP at
// the flagship shape (B=8, 128², N=26, c2=128; ≈1.0 ms at the bf16
// tensor-core peak), the style product adds 8 %; the bytes are the output
// map written once (872 MB, 0.26 ms). What every route does about it: the
// N·c2-wide activation (another 872 MB written and read back nine-fold by
// a split lowering) never leaves the SM. Three kernels, picked by shape in
// kernels/fused_obranch.py and kernels/fused_mod.py:
//
// fused_mod_wgmma (route "wgmma": bf16, c2 = 64 or 128, K ≤ 16). A tile is
// 3 output rows × 64 columns × all c2 output channels of one image and one
// instance; one persistent block an SM walks its tiles in instance-major
// order (n, b, row tile, column tile), so the 132 blocks stream one
// instance's conv2 weights at a time and they stay in L2.
// - Three consumer warpgroups, one output row each, run conv2 as
//   wgmma.m64n{c2}k16 with fp32 accumulators in registers (64 a thread at
//   c2 = 128): per 64-channel slice of the activation nine taps of four
//   k-steps. A tap's A operand is the halo tile shifted by whole pixels,
//   loaded from shared memory with ldmatrix.x4 (128-byte pixel rows, the
//   16-byte piece c of pixel p at c ^ (p & 7): free of bank conflicts at
//   any shift); the next tap's fragments are loaded while this one's wgmma
//   run.
// - conv1 is produced on chip. Three warps of the fourth (producer)
//   warpgroup load the tile's (3+4) × 68 depth window once, then compute
//   relu(conv3x3(d; wm_n) + bm_n) for the 5 × 66 halo pixels one 64-channel
//   slice at a time as one mma.m16n8k16 k-step over the halo's patch
//   matrix: A's columns are the nine taps and a constant 1 (so bm_n rides
//   in B's tenth row and the sum includes it), zero-padded to 16, held in
//   registers for the whole tile (a halo pixel outside the image has an
//   all-zero row: relu(0) = 0 is conv2's zero padding, not relu(bm)); B is
//   the instance's wm_n and bm_n as fragments cached in shared memory when
//   the instance changes. One cvt.rn.relu.bf16x2 rounds and packs two
//   values, stmatrix.x4 stores four 16-byte pieces of the consumers'
//   swizzled layout a lane. Two halo stages (mbarriers full → empty): the
//   producers fill slice 0 of the next tile while the consumers multiply
//   slice 1 of this one. The producer shares the SM with three warpgroups
//   of wgmma, so its instruction count sets its pace: a first version that
//   added the bias, applied the ReLU by coordinate and stored 4 bytes at a
//   time took longer than the taps (on an H100, prof_conv: 30 K against
//   18 K cycles a tile) and the consumers waited for it; conv1 on the CUDA
//   cores (9 FMA a value) was slower still.
// - conv2's weights arrive through a ring: the wrapper packs w2 once per
//   call into the order the kernel streams, [n][slice][tap] tiles of c2 o
//   × 64 k (K-major, 16-byte pieces in the 128-byte swizzle), and one
//   thread of the producer warpgroup moves each 16 KB tile with one 1-D
//   bulk copy into a ring of mbarrier stages (full → empty), as far ahead
//   as the ring allows. A tile is used by all three consumer warpgroups
//   (192 output pixels), against 128 in the warp-mma kernel below. All of
//   an instance's tiles (295 KB at c2 = 128) stay in L2.
// - The style taps (fused_modulation): nine more k-steps, one a tap, after
//   the last slice's conv2 taps. A is the mask's halo tile (K zero-padded
//   to 16; rows 48 bytes apart, an odd multiple of 16, so ldmatrix is free
//   of bank conflicts), stored by the producers beside the last slice's
//   activation; B is v[b, n] packed by the wrapper as three more ring
//   tiles of c2 o × 64 k, four taps of 16 k each.
// - The epilogue adds the bias in each function's rounding order; a quad of
//   lanes trades words so that each lane holds 8 consecutive channels of a
//   pixel, written with one 16-byte store.
// - FM_PROFILE (python -m endosr_torch.tools.prof_conv --kernel fused_mod)
//   compiles in clock64 phase counters. What sets the pace: conv2's taps
//   (≈16 K cycles a tile against ≈13.8 K for its 216 wgmma at the
//   tensor-core rate), then the epilogue (≈3 K), which no wgmma overlaps:
//   the three consumer warpgroups reach it together. Keeping one tap's
//   wgmma group in flight across the next tap's ring wait made ptxas
//   serialise every wgmma (C7520) and doubled the taps.
//
// fused_mod_bf16 (route "mma": any other bf16 shape, c2 = 16 or 32). A
// block owns an 8×16-pixel tile of one image and one instance:
// - conv1 + bias + ReLU for the tile's 10×18 halo goes into shared memory
//   (one mma k-step over the halo's [192, 16] patch matrix of d);
// - conv2 is nine [128 px, c2] × [c2, c2] products whose A rows are shifted
//   windows of that tile (consecutive pixels of a halo row are consecutive
//   rows), so no im2col matrix exists;
// - the style product is nine more, one a tap: the mask's halo tile (K
//   zero-padded to 16) as A, that tap's K rows of this image's v as B.
// It runs warp-level mma.m16n8k16 with fp32 accumulation through ldmatrix:
// 4 warps, each 4 tile rows × 64 output channels (128 accumulators a
// thread), so a k-step's eight fragment loads feed 32 mma, and the next
// k-step's fragments are loaded before this one's mma issue; shared-memory
// rows are odd multiples of 16 bytes, which keeps the shifted windows free
// of bank conflicts; conv2's weights arrive half a tap at a time through
// cp.async into two buffers; the accumulators go straight from registers
// to the output.
//
// fused_mod_fp32 (route "fp32": float32 storage): the same tiles on the
// CUDA cores, an exact fp32 loop (a warp per tile row, 4 channels a lane),
// conv1 with a thread keeping the nine weights of its two channels in
// registers.

#include "common.cuh"
#include "conv_wgmma.cuh"
#include "hopper.cuh"

#define FM_TH 8
#define FM_TW 16
#define FM_PIX (FM_TH * FM_TW)
#define FM_HH (FM_TH + 2)
#define FM_HW (FM_TW + 2)
#define FM_HPIX (FM_HH * FM_HW)
#define FM_DW (FM_TW + 4)
#define FM_DPIX ((FM_TH + 4) * FM_DW)

// threads of a block: 4 warps for the mma kernel, 8 (one a tile row) for fp32
template <typename T>
__host__ __device__ constexpr int fm_threads() { return sizeof(T) == 2 ? 128 : 256; }

#define FM_KP 16  // conv1's nine taps and the mask's K bins, zero-padded to one k-step
#define FM_PROWS ((FM_HPIX + 15) / 16 * 16)  // the halo's pixels in mma row tiles

// Shared-memory plan of one block (element strides and byte offsets): the
// head (fp32: the depth tile; bf16: the halo's patch matrix [FM_PROWS, ldm],
// later the mask halo tile, and wm_n [FM_KP, ldw]), then region A (the
// activation halo tile [FM_HPIX, lda]; fp32: later the mask halo tile
// [FM_HPIX, ldm]), then for bf16 region W (two
// buffers of fm_kh(c2) weight rows [·, ldw], later v as [9·FM_KP, ldw]). The
// bf16 row strides
// are odd multiples of 16 bytes: the eight rows of an ldmatrix fall into
// eight different 16-byte bank groups, whatever window they start at.
struct FmLayout {
  int lda, ldm, ldw;
  size_t offWm, offA, offW, total;
};

// weight rows of one pipeline stage of the mma kernel: half a tap
__host__ __device__ inline int fm_kh(int c2) { return c2 >= 32 ? c2 / 2 : c2; }

template <typename T>
__host__ __device__ inline FmLayout fm_layout(int c2, bool style) {
  const bool tc = sizeof(T) == 2;
  FmLayout L;
  L.lda = c2 + (tc ? 8 : 4);
  L.ldm = FM_KP + (tc ? 8 : 4);
  L.ldw = c2 + 8;
  L.offWm = (size_t)FM_PROWS * L.ldm * sizeof(T);
  size_t head = tc ? L.offWm + (size_t)FM_KP * L.ldw * sizeof(T)
                   : FM_DPIX * sizeof(float);
  head = (head + 127) / 128 * 128;
  size_t a = ((size_t)FM_HPIX * L.lda * sizeof(T) + 127) / 128 * 128;
  const int wrows = style && 9 * FM_KP > 2 * fm_kh(c2) ? 9 * FM_KP : 2 * fm_kh(c2);
  L.offA = head;
  L.offW = head + a;
  L.total = head + a + (tc ? (size_t)wrows * L.ldw * sizeof(T) : 0);
  return L;
}

__device__ __forceinline__ void fm_store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void fm_store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The fp32 block's first phase: the depth tile with a 2-pixel ring (zero outside
// the image) into sd, then conv1 + bias + ReLU of instance n on the halo
// tile into as (row stride lda). A halo pixel outside the image is conv2's
// zero padding, not relu(bm). A thread owns two neighbouring channels.
__device__ __forceinline__ void fm_conv1(float* sd, float* as, int lda,
                                         const float* __restrict__ d,
                                         const float* __restrict__ wm,
                                         const float* __restrict__ bm, int b, int n,
                                         int H, int W, int c2, int ty0, int tx0) {
  typedef float T;
  constexpr int NT = fm_threads<T>();
  const int tid = threadIdx.x;
  for (int e = tid; e < FM_DPIX; e += NT) {
    const int y = ty0 - 2 + e / FM_DW, x = tx0 - 2 + e % FM_DW;
    sd[e] = (y >= 0 && y < H && x >= 0 && x < W)
                ? to_f<T>(d[((i64)b * H + y) * W + x]) : 0.f;
  }
  const int pairs = c2 >> 1;           // a power of two ≤ 64: divides NT
  const int c = (tid % pairs) * 2, pg = tid / pairs, npg = NT / pairs;
  float w0[9], w1[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    w0[t] = to_f<T>(wm[((i64)n * 9 + t) * c2 + c]);
    w1[t] = to_f<T>(wm[((i64)n * 9 + t) * c2 + c + 1]);
  }
  const float b0 = to_f<T>(bm[(i64)n * c2 + c]), b1 = to_f<T>(bm[(i64)n * c2 + c + 1]);
  __syncthreads();
  for (int p = pg; p < FM_HPIX; p += npg) {
    const int hr = p / FM_HW, hc = p - hr * FM_HW;
    const int y = ty0 - 1 + hr, x = tx0 - 1 + hc;
    float a0 = 0.f, a1 = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float dv = sd[(hr + t / 3) * FM_DW + hc + t % 3];
        s0 = fmaf(dv, w0[t], s0);
        s1 = fmaf(dv, w1[t], s1);
      }
      a0 = relu_f(s0 + b0);
      a1 = relu_f(s1 + b1);
    }
    fm_store2(as + (i64)p * lda + c, a0, a1);
  }
  __syncthreads();
}

// The mask's halo tile: ms[p·ldm + k] = mask[b, y, x, k] for the halo pixel p
// (zero outside the image and for FM_KP > k ≥ K). A thread first loads all
// its values, then stores them, so the loads' latencies overlap.
template <typename T>
__device__ __forceinline__ void fm_stage_mask(T* ms, int ldm,
                                              const T* __restrict__ mask, int b,
                                              int H, int W, int K, int ty0,
                                              int tx0) {
  constexpr int NT = fm_threads<T>();
  constexpr int IT = (FM_HPIX * FM_KP + NT - 1) / NT;
  T vals[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int p = e / FM_KP, k = e % FM_KP;
    const int y = ty0 - 1 + p / FM_HW, x = tx0 - 1 + p % FM_HW;
    vals[i] = from_f<T>(0.f);
    if (p < FM_HPIX && k < K && y >= 0 && y < H && x >= 0 && x < W)
      vals[i] = mask[(((i64)b * H + y) * W + x) * K + k];
  }
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int e = threadIdx.x + i * NT;
    if (e < FM_HPIX * FM_KP) ms[(i64)(e / FM_KP) * ldm + e % FM_KP] = vals[i];
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-level mma.m16n8k16 through ldmatrix
// ---------------------------------------------------------------------------

// One k-step's operands of a warp: four A fragments (16 pixels × 16 k each)
// and four B fragment pairs (16 k × 16 channels each).
struct FmFrag {
  uint32_t a[4][4], b[4][4];
};

// acc[i][j] += A_i · B_j over kdim (a multiple of 16). A_i: 16 rows (pixels)
// at a0 + i·a_rows, row stride lda; B: the [kdim, c2] matrix ws (row stride
// ldw), of which this warp takes the 8-column tiles j of its half (columns
// n0 + 8j < c2). The next k-step's fragments are loaded before this one's
// mma are issued, so the loads' latency hides behind them.
__device__ __forceinline__ void fm_mma(float (&acc)[4][8][4], const __nv_bfloat16* a0,
                                       int a_rows, int lda, const __nv_bfloat16* ws,
                                       int ldw, int kdim, int n0, int c2) {
  const int lane = threadIdx.x & 31;
  const int r16 = lane & 15, q8 = (lane >> 4) * 8;
  auto load = [&](FmFrag& f, int kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldsm_x4(f.a[i], a0 + (i64)i * a_rows + (i64)r16 * lda + kk + q8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (n0 + jj * 16 < c2)
        ldsm_x4_trans(f.b[jj], ws + (i64)(kk + r16) * ldw + n0 + jj * 16 + q8);
  };
  FmFrag cur, nxt;
  load(cur, 0);
  for (int kk = 0; kk < kdim; kk += 16) {
    const bool more = kk + 16 < kdim;
    if (more) load(nxt, kk + 16);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (n0 + jj * 16 >= c2) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma_bf16(acc[i][2 * jj], cur.a[i], cur.b[jj][0], cur.b[jj][1]);
        mma_bf16(acc[i][2 * jj + 1], cur.a[i], cur.b[jj][2], cur.b[jj][3]);
      }
    }
    if (more) cur = nxt;
  }
}

// rows of a [·, c2] bf16 matrix from device memory into ws (row stride ldw),
// asynchronously, as one committed group
__device__ __forceinline__ void fm_stage_async(__nv_bfloat16* ws, int ldw,
                                               const __nv_bfloat16* __restrict__ src,
                                               int rows, int c2) {
  const int vec = c2 >> 3;
  for (int e = threadIdx.x; e < rows * vec; e += 128) {
    const int k = e / vec, q = e - k * vec;
    cp_async16(ws + (i64)k * ldw + q * 8, src + (i64)k * c2 + q * 8);
  }
  cp_async_commit();
}

// A [rows, c2] bf16 matrix from device memory into ws (row stride ldw) in
// 16-byte pieces. With per > 0 the source has `per` rows a tap and each tap
// is zero-padded to FM_KP rows of ws.
__device__ __forceinline__ void fm_stage(__nv_bfloat16* ws, int ldw,
                                         const __nv_bfloat16* __restrict__ src,
                                         int rows, int c2, int per = 0) {
  const int vec = c2 >> 3;
  for (int e = threadIdx.x; e < rows * vec; e += 128) {
    const int k = e / vec, q = e - k * vec;
    int ksrc = k;
    if (per > 0) ksrc = (k % FM_KP < per) ? (k / FM_KP) * per + k % FM_KP : -1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (ksrc >= 0) val = *reinterpret_cast<const uint4*>(src + (i64)ksrc * c2 + q * 8);
    *reinterpret_cast<uint4*>(ws + (i64)k * ldw + q * 8) = val;
  }
}

// The bf16 block's first phase, on the tensor cores: the halo's patch matrix
// ps[p, tap] = d at halo pixel p shifted by the tap (zero outside the image
// and for tap ≥ 9) times wm_n [FM_KP, c2] (rows ≥ 9 zero), then + bm_n and
// ReLU into as (row stride lda), rounded once. A halo pixel outside the image
// is conv2's zero padding, not relu(bm).
__device__ __forceinline__ void fm_conv1_mma(
    __nv_bfloat16* ps, int ldm, __nv_bfloat16* wms, int ldw, __nv_bfloat16* as,
    int lda, const __nv_bfloat16* __restrict__ d, const __nv_bfloat16* __restrict__ wm,
    const __nv_bfloat16* __restrict__ bm, int b, int n, int H, int W, int c2,
    int ty0, int tx0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  fm_stage_async(wms, ldw, wm + (i64)n * 9 * c2, 9, c2);
  for (int e = tid; e < (FM_KP - 9) * (c2 >> 3); e += 128)   // rows 9..15: zero
    *reinterpret_cast<uint4*>(wms + (i64)(9 + e / (c2 >> 3)) * ldw +
                              e % (c2 >> 3) * 8) = make_uint4(0u, 0u, 0u, 0u);
  // all loads first, then the stores, so the loads' latencies overlap
  constexpr int IT = FM_PROWS * FM_KP / 128;
  __nv_bfloat16 vals[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int e = tid + i * 128;
    const int p = e / FM_KP, j = e % FM_KP;
    const int y = ty0 - 2 + p / FM_HW + j / 3, x = tx0 - 2 + p % FM_HW + j % 3;
    vals[i] = __float2bfloat16_rn(0.f);
    if (p < FM_HPIX && j < 9 && y >= 0 && y < H && x >= 0 && x < W)
      vals[i] = d[((i64)b * H + y) * W + x];
  }
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int e = tid + i * 128;
    ps[(i64)(e / FM_KP) * ldm + e % FM_KP] = vals[i];
  }
  cp_async_wait_all();
  __syncthreads();

  const int r16 = lane & 15, q8 = (lane >> 4) * 8, g = lane >> 2, cq = (lane & 3) * 2;
  uint32_t bf[8][4];
  float bmr[16][2];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (jj * 16 >= c2) continue;
    ldsm_x4_trans(bf[jj], wms + (i64)r16 * ldw + jj * 16 + q8);
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int col = jj * 16 + h8 * 8 + cq;
      bmr[2 * jj + h8][0] = __bfloat162float(bm[(i64)n * c2 + col]);
      bmr[2 * jj + h8][1] = __bfloat162float(bm[(i64)n * c2 + col + 1]);
    }
  }
  for (int mt = warp; mt < FM_PROWS / 16; mt += 4) {
    uint32_t a[4];
    ldsm_x4(a, ps + (i64)(mt * 16 + r16) * ldm + q8);
    int pix[2];
    bool inside[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      pix[hh] = mt * 16 + g + 8 * hh;
      const int y = ty0 - 1 + pix[hh] / FM_HW, x = tx0 - 1 + pix[hh] % FM_HW;
      inside[hh] = y >= 0 && y < H && x >= 0 && x < W;
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (jj * 16 >= c2) continue;
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(c4, a, bf[jj][2 * h8], bf[jj][2 * h8 + 1]);
        const float b0 = bmr[2 * jj + h8][0], b1 = bmr[2 * jj + h8][1];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (pix[hh] >= FM_HPIX) continue;
          fm_store2(as + (i64)pix[hh] * lda + jj * 16 + h8 * 8 + cq,
                    inside[hh] ? relu_f(c4[2 * hh] + b0) : 0.f,
                    inside[hh] ? relu_f(c4[2 * hh + 1] + b1) : 0.f);
        }
      }
    }
  }
  __syncthreads();
}

template <bool STYLE>
__global__ void __launch_bounds__(128)
fused_mod_bf16(const __nv_bfloat16* __restrict__ d, const __nv_bfloat16* __restrict__ mask,
               const __nv_bfloat16* __restrict__ wm, const __nv_bfloat16* __restrict__ bm,
               const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int H, int W, int N, int c2, int K) {
  typedef __nv_bfloat16 T;
  extern __shared__ __align__(128) unsigned char smem[];
  const FmLayout L = fm_layout<T>(c2, STYLE);
  T* Ps = reinterpret_cast<T*>(smem);
  T* As = reinterpret_cast<T*>(smem + L.offA);
  T* Ws = reinterpret_cast<T*>(smem + L.offW);
  const int tiles_x = (W + FM_TW - 1) / FM_TW;
  const int ty0 = (blockIdx.x / tiles_x) * FM_TH;
  const int tx0 = (blockIdx.x % tiles_x) * FM_TW;
  const int n = blockIdx.y, b = blockIdx.z;
  // conv2's weights [9·c2, c2] of instance n arrive in stages of kh rows
  const int kh = fm_kh(c2), spt = c2 / kh, nstage = 9 * spt;
  const T* w2n = w2 + (i64)n * 9 * c2 * c2;
  fm_stage_async(Ws, L.ldw, w2n, kh, c2);
  fm_conv1_mma(Ps, L.ldm, reinterpret_cast<T*>(smem + L.offWm), L.ldw, As, L.lda,
               d, wm, bm, b, n, H, W, c2, ty0, tx0);
  // the mask's halo tile takes the patch matrix's place
  if (STYLE) fm_stage_mask<T>(Ps, L.ldm, mask, b, H, W, K, ty0, tx0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp >> 1) * 4;     // the warp's 4 tile rows
  const int n0 = (warp & 1) * 64;       // and its 64 output channels
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int s = 0; s < nstage; ++s) {
    // stage s has landed and everyone is done with the buffer of stage s−1
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < nstage)
      fm_stage_async(Ws + (i64)((s + 1) & 1) * kh * L.ldw, L.ldw,
                     w2n + (i64)(s + 1) * kh * c2, kh, c2);
    const int t = s / spt, k0 = (s - t * spt) * kh;
    const int dy = t / 3, dx = t - dy * 3;
    fm_mma(acc, As + (i64)((row0 + dy) * FM_HW + dx) * L.lda + k0, FM_HW * L.lda,
           L.lda, Ws + (i64)(s & 1) * kh * L.ldw, L.ldw, kh, n0, c2);
  }
  if (STYLE) {
    __syncthreads();
    fm_stage(Ws, L.ldw, v + ((i64)b * N + n) * 9 * K * c2, 9 * FM_KP, c2, K);
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t - dy * 3;
      fm_mma(acc, Ps + (i64)((row0 + dy) * FM_HW + dx) * L.ldm, FM_HW * L.ldm,
             L.ldm, Ws + (i64)t * FM_KP * L.ldw, L.ldw, FM_KP, n0, c2);
    }
  }

  // accumulator (i, j, q): tile row row0+i, pixel lane/4 (+8 for q ≥ 2),
  // channel n0 + 8j + 2·(lane%4) + (q&1)
  const i64 out_c = (i64)N * c2;
  const int g = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + 8 * j + cq;
    if (c >= c2) continue;
    const float bv0 = __bfloat162float(bias[(i64)n * c2 + c]);
    const float bv1 = __bfloat162float(bias[(i64)n * c2 + c + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int y = ty0 + row0 + i;
      if (y >= H) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = tx0 + g + 8 * hh;
        if (x >= W) continue;
        const float a0 = acc[i][j][2 * hh], a1 = acc[i][j][2 * hh + 1];
        fm_store2(out + (((i64)b * H + y) * W + x) * out_c + (i64)n * c2 + c,
                  STYLE ? a0 + bv0 : rnd<T>(a0) + bv0,
                  STYLE ? a1 + bv1 : rnd<T>(a1) + bv1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

// acc[p][q] += Σ_k a0[p·lda + k] · b0[k·ldb + q] for the 16 pixels of a tile
// row and this lane's 4 channels; k runs to kdim (a multiple of 4, A
// zero-padded), rows k ≥ kreal of B read as zero.
__device__ __forceinline__ void fm_fma(float (&acc)[16][4], const float* a0, int lda,
                                       const float* __restrict__ b0, int ldb,
                                       int kdim, int kreal) {
  for (int k = 0; k < kdim; k += 4) {
    float4 a4[16];
#pragma unroll
    for (int p = 0; p < 16; ++p)
      a4[p] = *reinterpret_cast<const float4*>(a0 + (i64)p * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k + kk < kreal)
        w4 = *reinterpret_cast<const float4*>(b0 + (i64)(k + kk) * ldb);
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const float a = kk == 0 ? a4[p].x : kk == 1 ? a4[p].y : kk == 2 ? a4[p].z : a4[p].w;
        acc[p][0] = fmaf(a, w4.x, acc[p][0]);
        acc[p][1] = fmaf(a, w4.y, acc[p][1]);
        acc[p][2] = fmaf(a, w4.z, acc[p][2]);
        acc[p][3] = fmaf(a, w4.w, acc[p][3]);
      }
    }
  }
}

template <bool STYLE>
__global__ void __launch_bounds__(256)
fused_mod_fp32(const float* __restrict__ d, const float* __restrict__ mask,
               const float* __restrict__ wm, const float* __restrict__ bm,
               const float* __restrict__ w2, const float* __restrict__ v,
               const float* __restrict__ bias, float* __restrict__ out, int H,
               int W, int N, int c2, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FmLayout L = fm_layout<float>(c2, STYLE);
  float* sd = reinterpret_cast<float*>(smem);
  float* As = reinterpret_cast<float*>(smem + L.offA);
  const int tiles_x = (W + FM_TW - 1) / FM_TW;
  const int ty0 = (blockIdx.x / tiles_x) * FM_TH;
  const int tx0 = (blockIdx.x % tiles_x) * FM_TW;
  const int n = blockIdx.y, b = blockIdx.z;
  fm_conv1(sd, As, L.lda, d, wm, bm, b, n, H, W, c2, ty0, tx0);

  const int row = threadIdx.x >> 5, co = (threadIdx.x & 31) * 4;
  const bool active = co < c2;
  float acc[16][4];
#pragma unroll
  for (int p = 0; p < 16; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  if (active)
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t - dy * 3;
      fm_fma(acc, As + (i64)((row + dy) * FM_HW + dx) * L.lda, L.lda,
             w2 + ((i64)n * 9 + t) * c2 * c2 + co, c2, c2, c2);
    }
  if (STYLE) {
    __syncthreads();
    fm_stage_mask<float>(As, L.ldm, mask, b, H, W, K, ty0, tx0);
    __syncthreads();
    if (active)
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3, dx = t - dy * 3;
        fm_fma(acc, As + (i64)((row + dy) * FM_HW + dx) * L.ldm, L.ldm,
               v + (((i64)b * N + n) * 9 + t) * K * c2 + co, c2, (K + 3) / 4 * 4, K);
      }
  }
  const int y = ty0 + row;
  if (active && y < H) {
    const float4 b4 = *reinterpret_cast<const float4*>(bias + (i64)n * c2 + co);
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int x = tx0 + p;
      if (x >= W) continue;
      *reinterpret_cast<float4*>(
          out + (((i64)b * H + y) * W + x) * ((i64)N * c2) + (i64)n * c2 + co) =
          make_float4(acc[p][0] + b4.x, acc[p][1] + b4.y, acc[p][2] + b4.z,
                      acc[p][3] + b4.w);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, c2 = 64 or 128: wgmma, conv1 produced on chip, weights through a
// bulk-copy ring, persistent blocks (route "wgmma")
// ---------------------------------------------------------------------------

// Where a block's time goes, compiled in only with FM_PROFILE defined
// (python -m endosr_torch.tools.prof_conv --kernel fused_mod): cycles summed
// per block for the first consumer thread (0 waiting for halo stages, 1
// waiting for ring tiles, 2 in conv2's taps with their waits, 3 in the
// style taps with their waits, 4 in the epilogue, 5 from start to end, 6
// tiles), the first producer thread (7 waiting for a free halo stage, 10
// loading the depth window and building conv1's A fragments, 11 reading
// conv1's B fragments, 8 computing and storing conv1, 12 staging the mask)
// and the weight issuer (9 waiting for a free ring stage).
#ifdef FM_PROFILE
__device__ unsigned long long fm_prof[1024][16];
#define FM_NOW() clock64()
#define FM_ADD(cond, k, v)                                          \
  do {                                                              \
    if ((cond) && blockIdx.x < 1024) fm_prof[blockIdx.x][k] += (v); \
  } while (0)
#else
#define FM_NOW() 0ull
#define FM_ADD(cond, k, v) \
  do {                     \
  } while (0)
#endif

#define FW_ROWS 3          // output rows of a tile: one consumer warpgroup each
#define FW_COLS 64         // output columns of a tile
#define FW_PRODUCERS 96    // threads that compute conv1 (3 warps)

// The shared-memory plan of a block (byte offsets from a 1024-byte aligned
// base): the weight ring (WS tiles of NOUT o × 64 k), two halo stages (the
// activation of one 64-channel slice, 128 bytes a halo pixel, 336 rows: a
// whole number of conv1's m16 tiles; with STYLE the mask's halo tile after
// it, 48 bytes a pixel), the depth window, conv1's B fragments, the
// mbarriers.
template <int NOUT, bool STYLE, int WS>
struct FwPlan {
  static_assert(NOUT == 64 || NOUT == 128, "c2 = 64 or 128");
  static constexpr int nout = NOUT, ws = WS, hs = 2, rows = FW_ROWS;
  static constexpr bool style = STYLE;
  static constexpr int slices = NOUT / 64;
  static constexpr int hr = FW_ROWS + 2, hc = FW_COLS + 2;   // the halo
  static constexpr int halo_px = hr * hc;
  static constexpr int mtiles = (halo_px + 15) / 16;          // conv1's m16 tiles
  static constexpr int dr = FW_ROWS + 4, dc = FW_COLS + 4;   // the depth window
  static constexpr int mask_ld = 24;     // elements: 48 bytes, an odd multiple of 16
  static constexpr int wtile = NOUT * 64;                     // elements of a ring tile
  static constexpr int vtiles = STYLE ? 3 : 0;                // the style taps' B tiles
  static constexpr int tiles_per_tile = slices * 9 + vtiles;  // ring tiles a tile
  static constexpr int mask_off = (mtiles * 16 * 128 + 1023) / 1024 * 1024;
  static constexpr int stage_bytes =
      STYLE ? (mask_off + halo_px * mask_ld * 2 + 1023) / 1024 * 1024 : mask_off;
  static constexpr int off_halo = WS * wtile * 2;
  static constexpr int off_dwin = off_halo + hs * stage_bytes;
  static constexpr int off_cw = off_dwin + (dr * dc * 2 + 127) / 128 * 128;
  // conv1's B fragments of the block's current instance: [slice][8 nb][32
  // lanes] pairs of words
  static constexpr int cw_bytes = slices * 8 * 32 * 8;
  static constexpr int off_bar = off_cw + (cw_bytes + 127) / 128 * 128;
  static constexpr int total = off_bar + 8 * 2 * (hs + WS) + 1024;
  static constexpr int threads = (FW_ROWS + 1) * 128;
  static_assert(total <= 232448, "one block fits an SM's shared memory");
};

// Output tile t: columns fastest, then rows, then the image, then the
// instance
struct FwTile {
  int n, b, y0, x0;
};
__device__ __forceinline__ FwTile fw_tile(int t, int ncx, int nry, int B) {
  FwTile c;
  c.x0 = (t % ncx) * FW_COLS;
  t /= ncx;
  c.y0 = (t % nry) * FW_ROWS;
  t /= nry;
  c.b = t % B;
  c.n = t / B;
  return c;
}

// the producer warps' own barrier (named barrier 1)
__device__ __forceinline__ void fw_producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FW_PRODUCERS) : "memory");
}

__device__ __forceinline__ uint32_t fw_pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// relu(lo), relu(hi) rounded to bf16 and packed (lo in the low half)
__device__ __forceinline__ uint32_t fw_relu_pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// four 8×8 bf16 matrices to shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register i of lane l holds row l / 4, columns
// 2·(l % 4) and + 1 of matrix i (an mma accumulator's layout)
__device__ __forceinline__ void fw_stsm_x4(void* row, uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(row)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t fw_pick4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                             int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

template <class P>
__global__ void __launch_bounds__(P::threads, 1)
fused_mod_wgmma_kernel(const bf16* __restrict__ d, const bf16* __restrict__ mask,
                       const bf16* __restrict__ wm, const bf16* __restrict__ bm,
                       const bf16* __restrict__ w2p, const bf16* __restrict__ vp,
                       const bf16* __restrict__ bias, bf16* __restrict__ out, int B, int H,
                       int W, int N, int K, int ncx, int nry, int ntiles) {
  constexpr int NOUT = P::nout, S = P::slices, WS = P::ws, HS = P::hs, ROWS = P::rows;
  constexpr bool STYLE = P::style;
  constexpr int HC = P::hc, DC = P::dc;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled ring tiles need a 1024-byte aligned base
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  unsigned char* halo = smem + P::off_halo;
  bf16* dwin = reinterpret_cast<bf16*>(smem + P::off_dwin);
  uint2* cw = reinterpret_cast<uint2*>(smem + P::off_cw);
  uint64_t* full_h = reinterpret_cast<uint64_t*>(smem + P::off_bar);
  uint64_t* empty_h = full_h + HS;
  uint64_t* full_w = empty_h + HS;
  uint64_t* empty_w = full_w + WS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < HS; ++i) {
      mbar_init(full_h + i, FW_PRODUCERS);
      mbar_init(empty_h + i, ROWS * 4);     // one arrival a consumer warp
    }
    for (int i = 0; i < WS; ++i) {
      mbar_init(full_w + i, 1);             // the issuer's expect_tx arrival
      mbar_init(empty_w + i, ROWS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // this block's tiles: blockIdx.x, blockIdx.x + gridDim.x, ... (grid ≤ ntiles)
  const int my_tiles = (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  auto tile_of = [&](int j) {
    return fw_tile((int)blockIdx.x + j * (int)gridDim.x, ncx, nry, B);
  };
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;

  if (wg == ROWS) {
    // ============ producer warpgroup ============
    const int t = threadIdx.x - ROWS * 128;
    if (t < FW_PRODUCERS) {
      // warps 0-2: conv1 + bias + ReLU of each halo slice, the mask's halo
      // tile; lane (g, q) of warp `warp` holds mma fragments
      const int warp = t >> 5, g = lane >> 2, q = lane & 3;
      const bf16 zero = __float2bfloat16_rn(0.f), one = __float2bfloat16_rn(1.f);
      int cached_n = -1;
      for (int j = 0; j < my_tiles; ++j) {
        const FwTile c = tile_of(j);
        // the depth window of the tile, zero outside the image; the barrier
        // before keeps the last one until every producer warp is done with it
        fw_producer_sync();
        const unsigned long long t0 = FM_NOW();
        {
          constexpr int DIT = (P::dr * DC + FW_PRODUCERS - 1) / FW_PRODUCERS;
          bf16 dv[DIT];
#pragma unroll
          for (int i = 0; i < DIT; ++i) {
            const int e = t + i * FW_PRODUCERS;
            const int y = c.y0 - 2 + e / DC, x = c.x0 - 2 + e % DC;
            dv[i] = e < P::dr * DC && y >= 0 && y < H && x >= 0 && x < W
                        ? d[((i64)c.b * H + y) * W + x]
                        : zero;
          }
          if (c.n != cached_n) {
            // a new instance: wm_n and bm_n as the mma's B fragments, entry
            // (slice, nb, lane (g, q)) holding rows 2q, 2q + 1 and, for
            // q = 0, rows 8 (tap 8) and 9 (the bias) of column 8·nb + g;
            // rows 10..15 zero
            cached_n = c.n;
            for (int e = t; e < S * 8 * 32; e += FW_PRODUCERS) {
              const int ln = e & 31, ch = (e >> 5) * 8 + (ln >> 2), qq = ln & 3;
              const bf16* wmn = wm + (i64)c.n * 9 * NOUT + ch;
              cw[e] = make_uint2(fw_pack(wmn[(2 * qq) * NOUT], wmn[(2 * qq + 1) * NOUT]),
                                 qq == 0 ? fw_pack(wmn[8 * NOUT], bm[(i64)c.n * NOUT + ch]) : 0u);
            }
          }
#pragma unroll
          for (int i = 0; i < DIT; ++i)
            if (t + i * FW_PRODUCERS < P::dr * DC) dwin[t + i * FW_PRODUCERS] = dv[i];
        }
        fw_producer_sync();
        // this warp's m-tiles mt = warp + 3i of the halo's patch matrix as
        // mma A fragments, for every slice of the tile: rows (halo pixels)
        // mt·16 + g and + 8, columns 2q, 2q + 1 and 2q + 8, 2q + 9 (taps
        // 0..8 from the depth window, column 9 the bias's 1, zero beyond;
        // a row outside the image or past the halo all zero)
        constexpr int PW = FW_PRODUCERS / 32, MT = (P::mtiles + PW - 1) / PW;
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = (warp + PW * i) * 16 + g + 8 * h;
            const int pp = min(p, P::halo_px - 1);
            const int hy = pp / HC, hx = pp - hy * HC;
            const int y = c.y0 - 1 + hy, x = c.x0 - 1 + hx;
            const bool inside = p < P::halo_px && y >= 0 && y < H && x >= 0 && x < W;
            const bf16* dw = dwin + hy * DC + hx;
            const int j0 = 2 * q, j1 = 2 * q + 1;
            af[i][h] = inside ? fw_pack(dw[(j0 / 3) * DC + j0 % 3], dw[(j1 / 3) * DC + j1 % 3]) : 0u;
            af[i][2 + h] = q == 0 && inside ? fw_pack(dw[2 * DC + 2], one) : 0u;
          }
        FM_ADD(t == 0, 10, FM_NOW() - t0);
        for (int s = 0; s < S; ++s) {
          const int gs = j * S + s, st = gs % HS;
          const unsigned long long tw = FM_NOW();
          mbar_wait(empty_h + st, ((gs / HS) & 1) ^ 1);
          const unsigned long long tb = FM_NOW();
          FM_ADD(t == 0, 7, tb - tw);
          unsigned char* stage = halo + st * P::stage_bytes;
          uint32_t bw[8][2];
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const uint2 wv = cw[(s * 8 + nb) * 32 + lane];
            bw[nb][0] = wv.x;
            bw[nb][1] = wv.y;
          }
          const unsigned long long tc = FM_NOW();
          FM_ADD(t == 0, 11, tc - tb);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int mt = warp + PW * i;
            if (mt >= P::mtiles) break;
            float c4[8][4];
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
              c4[nb][0] = c4[nb][1] = c4[nb][2] = c4[nb][3] = 0.f;
              mma_bf16(c4[nb], af[i], bw[nb][0], bw[nb][1]);
            }
            // relu, one rounding, and stmatrix.x4 per pair of 8-channel
            // blocks: matrix r (lanes 8r .. 8r + 7 give its rows'
            // addresses) is rows 8·(r & 1) .. + 7 of block 2m + (r >> 1); a
            // row is one 16-byte piece of a pixel's 128
            const int sp = mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
            unsigned char* srow = stage + sp * 128;
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int nb = 2 * m + (lane >> 4);
              fw_stsm_x4(srow + ((nb ^ (sp & 7)) << 4),
                         fw_relu_pack(c4[2 * m][0], c4[2 * m][1]),
                         fw_relu_pack(c4[2 * m][2], c4[2 * m][3]),
                         fw_relu_pack(c4[2 * m + 1][0], c4[2 * m + 1][1]),
                         fw_relu_pack(c4[2 * m + 1][2], c4[2 * m + 1][3]));
            }
          }
          const unsigned long long tm = FM_NOW();
          FM_ADD(t == 0, 8, tm - tc);
          if (STYLE && s == S - 1) {
            // the mask's halo tile: 16 values a pixel (k ≥ K zero), zero
            // outside the image
            unsigned char* ms = stage + P::mask_off;
            for (int p = t; p < P::halo_px; p += FW_PRODUCERS) {
              const int hy = p / HC, hx = p - hy * HC;
              const int y = c.y0 - 1 + hy, x = c.x0 - 1 + hx;
              const bool in = y >= 0 && y < H && x >= 0 && x < W;
              const bf16* mp = mask + (((i64)c.b * H + (in ? y : 0)) * W + (in ? x : 0)) * K;
              bf16 vals[16];
#pragma unroll
              for (int k = 0; k < 16; ++k) vals[k] = in && k < K ? mp[k] : zero;
              uint4 lo, hi;
              lo.x = fw_pack(vals[0], vals[1]);
              lo.y = fw_pack(vals[2], vals[3]);
              lo.z = fw_pack(vals[4], vals[5]);
              lo.w = fw_pack(vals[6], vals[7]);
              hi.x = fw_pack(vals[8], vals[9]);
              hi.y = fw_pack(vals[10], vals[11]);
              hi.z = fw_pack(vals[12], vals[13]);
              hi.w = fw_pack(vals[14], vals[15]);
              *reinterpret_cast<uint4*>(ms + p * 48) = lo;
              *reinterpret_cast<uint4*>(ms + p * 48 + 16) = hi;
            }
          }
          mbar_arrive(full_h + st);
          FM_ADD(t == 0, 12, FM_NOW() - tm);
        }
      }
    } else if (t == FW_PRODUCERS) {
      // one thread of warp 3 moves every ring tile, in the order the
      // consumers take them: a tile's conv2 taps slice by slice, then its
      // style tiles
      int i = 0;
      for (int j = 0; j < my_tiles; ++j) {
        const FwTile c = tile_of(j);
        const bf16* wn = w2p + (i64)c.n * S * 9 * P::wtile;
        const bf16* vn = STYLE ? vp + ((i64)c.b * N + c.n) * P::vtiles * P::wtile : nullptr;
        for (int k = 0; k < P::tiles_per_tile; ++k, ++i) {
          const int st = i % WS;
          const unsigned long long tw = FM_NOW();
          mbar_wait(empty_w + st, ((i / WS) & 1) ^ 1);
          FM_ADD(true, 9, FM_NOW() - tw);
          mbar_arrive_expect_tx(full_w + st, P::wtile * 2);
          const bf16* src = k < S * 9 ? wn + (i64)k * P::wtile : vn + (i64)(k - S * 9) * P::wtile;
          bulk_copy_g2s(ring + st * P::wtile, src, P::wtile * 2, full_w + st);
        }
      }
    }
  } else {
    // ============ consumer warpgroups: output row wg of each tile ============
    const int w4 = (threadIdx.x >> 5) & 3;
    const int r16 = lane & 15, hi = lane >> 4;
    // this lane's ldmatrix row at tap (0, 0): halo pixel (wg, 16·w4 + r16)
    const int p0 = wg * HC + w4 * 16 + r16;
    const i64 cout = (i64)N * NOUT;
    int wst = 0;
    uint32_t wph = 0;
    auto next_w = [&]() {
      if (lane == 0) mbar_arrive(empty_w + wst);
      if (++wst == WS) {
        wst = 0;
        wph ^= 1;
      }
    };
    const unsigned long long t_start = FM_NOW();
    for (int j = 0; j < my_tiles; ++j) {
      FM_ADD(threadIdx.x == 0, 6, 1);
      const FwTile c = tile_of(j);
      float acc[NOUT / 2];
#pragma unroll
      for (int i = 0; i < NOUT / 2; ++i) acc[i] = 0.f;
      for (int s = 0; s < S; ++s) {
        const int gs = j * S + s, hst = gs % HS;
        const unsigned long long t0 = FM_NOW();
        mbar_wait(full_h + hst, (gs / HS) & 1);
        const unsigned long long t1 = FM_NOW();
        FM_ADD(threadIdx.x == 0, 0, t1 - t0);
        const unsigned char* tile = halo + hst * P::stage_bytes;
        auto load_a = [&](uint32_t (&a)[4][4], int tap) {
          const int p = p0 + (tap / 3) * HC + tap % 3;
          const bf16* row = reinterpret_cast<const bf16*>(tile + p * 128);
          const int sw = p & 7;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], row + (((2 * kk + hi) ^ sw) << 3));
        };
        uint32_t a[2][4][4];
        load_a(a[0], 0);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const unsigned long long tw = FM_NOW();
          mbar_wait(full_w + wst, wph);
          FM_ADD(threadIdx.x == 0, 1, FM_NOW() - tw);
          const uint64_t desc = wgmma_desc_k128(ring + wst * P::wtile);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs<NOUT>(acc, a[tap & 1][kk], desc + 2 * kk);
          wgmma_commit();
          if (tap < 8) load_a(a[(tap + 1) & 1], tap + 1);
          wgmma_wait<0>();
          next_w();
        }
        const unsigned long long t2 = FM_NOW();
        FM_ADD(threadIdx.x == 0, 2, t2 - t1);
        if (STYLE && s == S - 1) {
          // the style taps: A the mask's halo tile at the tap's shift, B
          // ring tile u holds taps 4u .. 4u + 3, one k-step each
          const unsigned char* ms = tile + P::mask_off;
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            uint32_t am[4][4];
#pragma unroll
            for (int k4 = 0; k4 < 4; ++k4) {
              const int tap = 4 * u + k4;
              if (tap < 9) ldsm_x4(am[k4], ms + (p0 + (tap / 3) * HC + tap % 3) * 48 + hi * 16);
            }
            const unsigned long long tw = FM_NOW();
            mbar_wait(full_w + wst, wph);
            FM_ADD(threadIdx.x == 0, 1, FM_NOW() - tw);
            const uint64_t desc = wgmma_desc_k128(ring + wst * P::wtile);
            wgmma_fence();
#pragma unroll
            for (int k4 = 0; k4 < 4; ++k4)
              if (4 * u + k4 < 9) wgmma_rs<NOUT>(acc, am[k4], desc + 2 * k4);
            wgmma_commit();
            wgmma_wait<0>();
            next_w();
          }
          FM_ADD(threadIdx.x == 0, 3, FM_NOW() - t2);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_h + hst);
      }

      // The epilogue: accumulator 4j + 2·half + e holds pixel
      // 16·w4 + lane/4 + 8·half, channel 8j + 2·(lane%4) + e. The bias is
      // added in the function's order (o-branch: the sum rounded, then b2
      // in bf16; modulation: the bias in fp32, one rounding), then within a
      // quad lane t gathers the 8-channel block 4m + t of its pixel for one
      // 16-byte store.
      const unsigned long long te = FM_NOW();
      const int y = c.y0 + wg;
      const int g = lane >> 2, tq = lane & 3;
      const bf16* bn = bias + (i64)c.n * NOUT;
#pragma unroll
      for (int m = 0; m < NOUT / 32; ++m) {
        uint32_t bw[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bw[jj] = *reinterpret_cast<const uint32_t*>(bn + 8 * (4 * m + jj) + 2 * tq);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t v[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int jb = 4 * m + jj;
            const float a0 = acc[4 * jb + 2 * half], a1 = acc[4 * jb + 2 * half + 1];
            const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(&bw[jj]);
            __nv_bfloat162 r2;
            if constexpr (STYLE)
              r2 = __floats2bfloat162_rn(a0 + __low2float(b2), a1 + __high2float(b2));
            else
              r2 = __hadd2(__floats2bfloat162_rn(a0, a1), b2);
            v[jj] = *reinterpret_cast<uint32_t*>(&r2);
          }
          // round r: lane u hands its word of block u^r to lane u^r
          uint32_t rc[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            rc[r] = __shfl_xor_sync(0xFFFFFFFFu, fw_pick4(v[0], v[1], v[2], v[3], tq ^ r), r);
          // rc[r] came from lane tq^r: channels 2·(tq^r), +1 of the block
          const uint4 o = make_uint4(fw_pick4(rc[0], rc[1], rc[2], rc[3], tq),
                                     fw_pick4(rc[0], rc[1], rc[2], rc[3], tq ^ 1),
                                     fw_pick4(rc[0], rc[1], rc[2], rc[3], tq ^ 2),
                                     fw_pick4(rc[0], rc[1], rc[2], rc[3], tq ^ 3));
          const int x = c.x0 + 16 * w4 + g + 8 * half;
          if (y < H && x < W)
            *reinterpret_cast<uint4*>(out + (((i64)c.b * H + y) * W + x) * cout +
                                      (i64)c.n * NOUT + (4 * m + tq) * 8) = o;
        }
      }
      FM_ADD(threadIdx.x == 0, 4, FM_NOW() - te);
    }
    FM_ADD(threadIdx.x == 0, 5, FM_NOW() - t_start);
  }
}

// The plans: the weight ring as deep as the shared memory allows beside two
// halo stages (16 KB tiles at c2 = 128, 8 KB at 64)
template <int NOUT, bool STYLE>
struct FwPick;
template <> struct FwPick<128, false> { typedef FwPlan<128, false, 8> P; };
template <> struct FwPick<128, true> { typedef FwPlan<128, true, 6> P; };
template <> struct FwPick<64, false> { typedef FwPlan<64, false, 16> P; };
template <> struct FwPick<64, true> { typedef FwPlan<64, true, 12> P; };

template <int NOUT, bool STYLE>
static int fw_launch(const void* d, const void* mask, const void* wm, const void* bm,
                     const void* w2p, const void* vp, const void* bias, void* out, int B, int H,
                     int W, int N, int K, cudaStream_t s) {
  typedef typename FwPick<NOUT, STYLE>::P P;
  auto kern = fused_mod_wgmma_kernel<P>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::total);
  if (e != cudaSuccess) return (int)e;
  const int ncx = (W + FW_COLS - 1) / FW_COLS, nry = (H + FW_ROWS - 1) / FW_ROWS;
  const long long ntiles = (long long)ncx * nry * B * N;
  if (ntiles <= 0) return 0;
  if (ntiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int grid = ntiles < sms ? (int)ntiles : sms;
  kern<<<grid, P::threads, P::total, s>>>(
      (const bf16*)d, (const bf16*)mask, (const bf16*)wm, (const bf16*)bm, (const bf16*)w2p,
      (const bf16*)vp, (const bf16*)bias, (bf16*)out, B, H, W, N, K, ncx, nry, (int)ntiles);
  return (int)cudaGetLastError();
}

template <typename T, bool STYLE, class Kern>
static int launch(Kern kern, const void* d, const void* mask, const void* wm,
                  const void* bm, const void* w2, const void* v, const void* bias,
                  void* out, int B, int H, int W, int N, int c2, int K,
                  cudaStream_t s) {
  const FmLayout L = fm_layout<T>(c2, STYLE);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((H + FM_TH - 1) / FM_TH) * ((W + FM_TW - 1) / FM_TW);
  dim3 grid(tiles, N, B);
  kern<<<grid, fm_threads<T>(), L.total, s>>>(
      (const T*)d, (const T*)mask, (const T*)wm, (const T*)bm, (const T*)w2,
      (const T*)v, (const T*)bias, (T*)out, H, W, N, c2, K);
  return (int)cudaGetLastError();
}

// 2C a power of two from 16 to 128 (a thread pair-owns channels in conv1, a
// warp half-owns 64 in the mma); the K bins within one k-step
static bool fm_ok(int c2, int K) {
  return (c2 == 16 || c2 == 32 || c2 == 64 || c2 == 128) && K <= FM_KP;
}

extern "C" {

// d [B,H,W,1]; mask [B,H,W,K]; wm [N,9,c2]; bm [N,c2]; w2 [N,9·c2,c2]
// (tap, in, out); v [B,N,9K,c2]; bias [N,c2]; out [B,H,W,N·c2]; all
// contiguous, of one type, 16-byte aligned. dtype: 0 float32, 1 bfloat16.
int fused_modulation(int dtype, const void* d, const void* mask, const void* wm,
                     const void* bm, const void* w2, const void* v,
                     const void* bias, void* out, int B, int H, int W, int N,
                     int c2, int K, void* stream) {
  if (!fm_ok(c2, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, true>(fused_mod_fp32<true>, d, mask, wm, bm, w2, v, bias, out,
                         B, H, W, N, c2, K, s);
  return launch<__nv_bfloat16, true>(fused_mod_bf16<true>, d, mask, wm, bm, w2, v, bias,
                               out, B, H, W, N, c2, K, s);
}

// The o-branch alone: w2 [N,9,c2,c2], b2 [N,c2]; the conv2 sum is rounded to
// the storage type before the bias add.
int fused_o_branch(int dtype, const void* d, const void* wm, const void* bm,
                   const void* w2, const void* b2, void* out, int B, int H,
                   int W, int N, int c2, void* stream) {
  if (!fm_ok(c2, 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, false>(fused_mod_fp32<false>, d, nullptr, wm, bm, w2, nullptr, b2,
                         out, B, H, W, N, c2, 0, s);
  return launch<__nv_bfloat16, false>(fused_mod_bf16<false>, d, nullptr, wm, bm, w2,
                               nullptr, b2, out, B, H, W, N, c2, 0, s);
}

// Route "wgmma": bf16, c2 = 64 or 128, with style (fused_modulation) 1 ≤ K
// ≤ 16. d, mask, wm, bm, bias and out as above (out 16-byte aligned, bias
// 4-byte aligned); w2p: w2 packed as [N][c2/64 slices][9 taps][c2 o][64 c]
// tiles, the 16-byte pieces of a row swizzled (piece ^ (o & 7)); vp (style
// only): v packed as [B][N][3][c2 o][64 kk] tiles, kk = 16·(tap % 4) + k
// for tap 4·tile + kk / 16, zero for k ≥ K and tap ≥ 9, swizzled alike;
// both 16-byte aligned. Without style the conv2 sum is rounded before
// bias (b2) is added, as fused_o_branch does. Returns a cudaError_t.
int fused_mod_wgmma(int style, const void* d, const void* mask, const void* wm,
                    const void* bm, const void* w2p, const void* vp, const void* bias,
                    void* out, int B, int H, int W, int N, int c2, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((c2 != 64 && c2 != 128) || (style && (K < 1 || K > 16)) ||
      ((uintptr_t)out & 15) != 0 || ((uintptr_t)w2p & 15) != 0 ||
      ((uintptr_t)bias & 3) != 0 || (style && ((uintptr_t)vp & 15) != 0))
    return (int)cudaErrorInvalidValue;
  if (style)
    return c2 == 128
               ? fw_launch<128, true>(d, mask, wm, bm, w2p, vp, bias, out, B, H, W, N, K, s)
               : fw_launch<64, true>(d, mask, wm, bm, w2p, vp, bias, out, B, H, W, N, K, s);
  return c2 == 128
             ? fw_launch<128, false>(d, nullptr, wm, bm, w2p, nullptr, bias, out, B, H, W, N, 0, s)
             : fw_launch<64, false>(d, nullptr, wm, bm, w2p, nullptr, bias, out, B, H, W, N, 0, s);
}

const char* fused_modulation_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
