// mid_shuffle for Hopper: PixelShuffle(r) of an NHWC tensor and its adjoint.
//
// Replaces endosr/kernels/shuffle_mid.py::mid_shuffle (pallas_call at :94)
// and its custom adjoint (:114-119):
//   shuffled[b, y·r+i, x·r+j, c] = packed[b, y, x, c·r² + i·r + j]
// The forward copies packed → shuffled, the adjoint (the op is a
// permutation, so its transpose is its inverse) shuffled → packed; one
// kernel with the direction as a template flag serves both.
//
// Bound on the H100: bytes, the tensor read once and written once (268 MB
// at [8,128,128,512] bf16, ≈0.08 ms at 3.35 TB/s). A block owns up to 16
// pixels of one packed row and walks the r shuffled rows they feed, so the
// shuffled side moves as whole runs of channels with neighbouring threads
// on neighbouring addresses, and the packed side, strided by r², is
// fetched from device memory once and re-read from L1. Elements move as
// 2- or 4-byte words, so any floating type is bit-exact.

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

const char* mid_shuffle_error(int e) { return cudaGetErrorString((cudaError_t)e); }
}
