// mid_shuffle for Hopper: PixelShuffle(r) of an NHWC tensor and its adjoint.
//
// Replaces endosr/kernels/shuffle_mid.py::mid_shuffle (pallas_call at :94)
// and its custom adjoint (:114-119):
//   shuffled[b, y·r+i, x·r+j, c] = packed[b, y, x, c·r² + i·r + j]
// The forward copies packed → shuffled, the adjoint (the op is a
// permutation, so its transpose is its inverse) shuffled → packed; each
// kernel takes the direction as a template flag. Elements move as 2- or
// 4-byte words, so any floating type is bit-exact.
//
// Bound on the H100: bytes, the tensor read once and written once (268 MB
// at [8,128,128,512] bf16, ≈0.08 ms at 3.35 TB/s).
//
// Two kernels, picked by shape in endosr_torch/kernels/shuffle_mid.py:
//
// mid_shuffle_vec16 (r = 2, V = 16 / element size channels dividing C,
// 16-byte aligned tensors): a thread owns V channels of one packed pixel.
// Their 4·V packed values are one contiguous run of 64 bytes, read as four
// 16-byte loads; in registers the run splits into the r² = 4 phases (value
// 4k + p of the run is channel k of phase p), and each phase is one
// 16-byte store to its shuffled pixel. Neighbouring threads own
// neighbouring channel groups of a pixel, so a warp reads 2 KB and writes
// four runs of 512 contiguous bytes. The adjoint does the same steps in
// reverse.
//
// mid_shuffle (any r and C): a block owns up to 16 pixels of one packed row
// and walks the r shuffled rows they feed, element by element, so the
// shuffled side moves as whole runs of channels and the packed side,
// strided by r², is fetched from device memory once and re-read from L1.

#include "common.cuh"

#define MS_XB 16  // packed pixels of one row per block

template <typename E, bool INVERSE>
__global__ void __launch_bounds__(256)
mid_shuffle_kernel(const E* __restrict__ src, E* __restrict__ dst, int H, int W,
                   int C, int r) {
  const int x0 = blockIdx.x * MS_XB, y = blockIdx.y, b = blockIdx.z;
  const int nx = min(MS_XB, W - x0);
  const int rr = r * r;
  const i64 crr = (i64)C * rr;
  const i64 pbase = (((i64)b * H + y) * W + x0) * crr;
  const i64 row = (i64)W * r * C;
  const i64 sbase = ((i64)b * H * r + (i64)y * r) * row + (i64)x0 * r * C;
  const int n = nx * r * C;  // elements of one shuffled row here
  for (int i = 0; i < r; ++i)
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int xs = e / C, c = e - xs * C;  // shuffled column, channel
      const int x = xs / r, j = xs - x * r;
      const i64 p = pbase + (i64)x * crr + (i64)c * rr + i * r + j;
      const i64 s = sbase + (i64)i * row + e;
      if (INVERSE) dst[p] = src[s];
      else dst[s] = src[p];
    }
}

template <typename E>
static int launch(const void* src, void* out, int B, int H, int W, int C, int r,
                  int inverse, cudaStream_t s) {
  dim3 grid((W + MS_XB - 1) / MS_XB, H, B);
  if (inverse)
    mid_shuffle_kernel<E, true><<<grid, 256, 0, s>>>((const E*)src, (E*)out, H, W, C, r);
  else
    mid_shuffle_kernel<E, false><<<grid, 256, 0, s>>>((const E*)src, (E*)out, H, W, C, r);
  return (int)cudaGetLastError();
}

// r = 2: thread (pixel, g) moves channels [V·g, V·g + V) of one packed pixel
template <typename E, bool INVERSE>
__global__ void __launch_bounds__(256)
mid_shuffle_vec16_kernel(const E* __restrict__ src, E* __restrict__ dst, int H, int W,
                         int C, i64 n) {
  constexpr int V = 16 / sizeof(E);
  const i64 id = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= n) return;
  const int G = C / V;
  const i64 pix = id / G;
  const int g = (int)(id - pix * G);
  const int x = (int)(pix % W);
  const i64 by = pix / W;                 // b·H + y
  // the packed run, and the group's first channel at shuffled pixel
  // (2y, 2x); phase (i, j) is i·(2W·C) + j·C further
  uint4* prun = reinterpret_cast<uint4*>(const_cast<E*>(INVERSE ? dst : src) +
                                         pix * 4 * C + (i64)g * 4 * V);
  const i64 srow = (i64)2 * W * C;
  E* shuf = const_cast<E*>(INVERSE ? src : dst) + 2 * by * srow + (i64)2 * x * C +
            (i64)g * V;
  union Run {
    uint4 q[4];
    E e[4 * V];
  } run;
  union Piece {
    uint4 q;
    E e[V];
  } ph[4];
  if (!INVERSE) {
#pragma unroll
    for (int k = 0; k < 4; ++k) run.q[k] = prun[k];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int k = 0; k < V; ++k) ph[p].e[k] = run.e[4 * k + p];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<uint4*>(shuf + (p >> 1) * srow + (p & 1) * C) = ph[p].q;
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      ph[p].q = *reinterpret_cast<const uint4*>(shuf + (p >> 1) * srow + (p & 1) * C);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int k = 0; k < V; ++k) run.e[4 * k + p] = ph[p].e[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) prun[k] = run.q[k];
  }
}

template <typename E>
static int launch_vec16(const void* src, void* out, int B, int H, int W, int C, int inverse,
                        cudaStream_t s) {
  constexpr int V = 16 / sizeof(E);
  if (C % V != 0 || (((uintptr_t)src | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const i64 n = (i64)B * H * W * (C / V);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (inverse)
    mid_shuffle_vec16_kernel<E, true><<<blocks, 256, 0, s>>>((const E*)src, (E*)out, H, W, C, n);
  else
    mid_shuffle_vec16_kernel<E, false><<<blocks, 256, 0, s>>>((const E*)src, (E*)out, H, W, C,
                                                              n);
  return (int)cudaGetLastError();
}

extern "C" {

// Packed side [B, H, W, C·r²], shuffled side [B, H·r, W·r, C], both
// contiguous, elements of esize = 2 or 4 bytes. inverse = 0: src is packed,
// out shuffled; 1: src is shuffled, out packed. H and B go on grid.y /
// grid.z (≤ 65535 each).
int mid_shuffle(int esize, const void* src, void* out, int B, int H, int W,
                int C, int r, int inverse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (esize == 2) return launch<uint16_t>(src, out, B, H, W, C, r, inverse, s);
  if (esize == 4) return launch<uint32_t>(src, out, B, H, W, C, r, inverse, s);
  return (int)cudaErrorInvalidValue;
}

// r = 2 on 16-byte accesses: as mid_shuffle, with C a multiple of 16 /
// esize and both tensors 16-byte aligned.
int mid_shuffle_vec16(int esize, const void* src, void* out, int B, int H, int W, int C,
                      int inverse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (esize == 2) return launch_vec16<uint16_t>(src, out, B, H, W, C, inverse, s);
  if (esize == 4) return launch_vec16<uint32_t>(src, out, B, H, W, C, inverse, s);
  return (int)cudaErrorInvalidValue;
}

const char* mid_shuffle_error(int e) { return cudaGetErrorString((cudaError_t)e); }
}
