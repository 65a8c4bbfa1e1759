// packed_g123 for Hopper: one phase-packed conv stage per launch.
//
// Replaces endosr/kernels/packed_chain.py::packed_g123 (pallas_call at
// :438). The wrapper (endosr_torch/kernels/packed_chain.py) runs the three
// stages as three launches of this kernel:
//   g1 = gate1(lrelu(x ⊛ K1 + b1))        pads (1,1)  — x read with the
//        producer's deferred bias + leaky_relu and, with `phases`, the
//        fine-grid interleave of the packed producer tensor, at load time
//   g2 = gate0(relu(g1 ⊛ K2 + b2))        pads (0,1)
//   g3 = gate1(relu(g1 + g2 ⊛ K3 + b3))   pads (1,0)
// Each stage is a [2,2,Cin,C4] conv: an implicit GEMM (common.cuh) with
// fp32 accumulation, then the storage-type epilogue of the JAX twin.
//
// Bound on the H100: operations. The tail chain is ~210 GFLOP and the up1
// chain ~70 GFLOP per forward; the bytes (x, g1, g2, g3, each once) are
// a few hundred MB. The products run as warp-level bf16 mma for bf16
// storage (the CUDA cores for fp32), and g1/g2 go through device memory;
// a wgmma pipeline and keeping g1/g2 on chip are later work.

#include "common.cuh"

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

template <typename T>
struct StageEpi {
  T* out;
  i64 oh, ow, ob;     // output strides
  const T* bias;      // [C4]
  const T* res;       // residual (g1) with the output's geometry, or null
  i64 rh, rw, rb;
  int act;            // 0 relu, 1 leaky_relu(0.2)
  int gate_s;         // packed gate shift (0 or 1)
  int nrow, ncol;     // true grid sizes: packed extent − 1
  int cg;             // channels per phase group (C4 / 4)
  __device__ __forceinline__ void operator()(int oy, int ox, int b, int o,
                                             float acc) const {
    float g = rnd<T>(rnd<T>(acc) + to_f<T>(bias[o]));
    if (res) g = rnd<T>(to_f<T>(res[oy * rh + ox * rw + b * rb + o]) + g);
    g = act ? lrelu_t<T>(g, 0.2f) : relu_f(g);
    int grp = o / cg, a = grp >> 1, bb = grp & 1;
    bool dead_r = gate_s ? ((a == 0 && oy == nrow) || (a == 1 && oy == 0))
                         : oy == nrow;
    bool dead_c = gate_s ? ((bb == 0 && ox == ncol) || (bb == 1 && ox == 0))
                         : ox == ncol;
    if (dead_r || dead_c) g = 0.f;
    out[(i64)oy * oh + (i64)ox * ow + (i64)b * ob + o] = from_f<T>(g);
  }
};

template <typename T>
static int launch(const void* x, i64 sh, i64 sw, i64 sb, int nx, int mx,
                  int hout, int wout, int B, int cin, int phases, const void* pb, int pre_act,
                  const void* w, const void* bias, int pad_y, int pad_x,
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

const char* packed_stage_error(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
}
