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
// map written once (872 MB, 0.26 ms). What the design does about it: the
// N·c2-wide activation (another 872 MB written and read back nine-fold by
// a split lowering) never leaves the SM. A block owns an 8×16-pixel tile
// of one image and one instance:
// - conv1 + bias + ReLU for the tile's 10×18 halo goes into shared memory
//   (bf16: one mma k-step over the halo's [192, 16] patch matrix of d; fp32:
//   on the CUDA cores, a thread keeping the nine weights of its two channels
//   in registers);
// - conv2 is nine [128 px, c2] × [c2, c2] products whose A rows are shifted
//   windows of that tile (consecutive pixels of a halo row are consecutive
//   rows), so no im2col matrix exists;
// - the style product is nine more, one a tap: the mask's halo tile (K
//   zero-padded to 16) as A, that tap's K rows of this image's v as B.
// bf16 runs warp-level mma.m16n8k16 with fp32 accumulation through ldmatrix:
// 4 warps, each 4 tile rows × 64 output channels (128 accumulators a thread),
// so a k-step's eight fragment loads feed 32 mma, and the next k-step's
// fragments are loaded before this one's mma issue; shared-memory rows are
// odd multiples of 16 bytes, which keeps the shifted windows free of bank
// conflicts; conv2's weights arrive half a tap at a time through cp.async
// into two buffers, the next half in flight while this one multiplies; the
// accumulators go straight from registers to the output. fp32 storage runs
// an exact fp32 loop on the CUDA cores (a warp per tile row, 4 channels a
// lane). A wgmma/TMA pipeline is later work.

#include "common.cuh"
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

const char* fused_modulation_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
