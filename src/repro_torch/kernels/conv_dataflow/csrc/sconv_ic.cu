// SconvIC (SSconv-IP-CR, the ShiDianNao archetype): output-stationary
// convolution over output-row bands, for Hopper (sm_90a), fp32 on CUDA
// cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/conv_dataflow/sconv_ic.py  _kernel (body, line 43),
//   launched by sconv_ic through pl.pallas_call (line 85).
// The TPU kernel gives each grid step (n, band) one band of row_tile output
// rows, DMAs the band's row_tile + kh - 1 halo-row window of the ifmap into
// VMEM, and adds every (di, dj, ci) tap x channel product into the band.
//
// Here one block owns one band of ROW_TILE = 8 output rows (the JAX
// wrapper's row_tile; SSconv: part of a 2D convolution), cut further into
// a column tile of TW = 16 output columns and a tile of TCO = 32 output
// channels so that the band's window fits shared memory at every width.
// The band's halo window - (ROW_TILE - 1) * s + KH input rows by
// (TW - 1) * s + KW columns - is staged into shared memory with cp.async
// (IP: the ifmap window is read at KH * KW shifted offsets, the shift
// register of the PE array), one chunk of cc input channels at a time,
// next to that chunk's filter taps.  The outputs are the stationary
// operand (CR): each thread owns 4 pixels x 4 output channels in
// registers for the whole walk over channel chunks and taps, and writes
// them once.  Window cells past the ifmap (the tail band when ROW_TILE
// does not divide Ho, the right edge, the channels past Cin in the last
// chunk) are zero; outputs past Ho or Wo are never stored.
//
// The window is stored plane by plane ([cc][rows][cols]) so that
// neighbouring output columns read neighbouring shared-memory banks at any
// stride.  cc is the largest of 32, 16, ... (at most Cin) whose window and
// taps fit SMEM_BUDGET, so two blocks can share an SM.
//
// bf16 inputs are widened into the fp32 window; the output is rounded
// once.  No TF32: the reference tolerance is 1e-4.
//
// Bound on the H100: FLOPs (2 * N*Ho*Wo * KH*KW*Cin * Cout) at 67 TFLOP/s
// fp32 against the bytes of x, w and out at 3.35 TB/s; the path's large
// layers are bound by the FLOPs (chip_smoke.py prints both).

#include "conv_common.cuh"

namespace {

constexpr int ROW_TILE = 8;    // output rows per band
constexpr int TW = 16;         // output columns per block
constexpr int PIX = ROW_TILE * TW;   // 128 output pixels per block
constexpr int TCO = 32;        // output channels per block
constexpr int THREADS = 256;   // 32 pixel lanes x 8 channel lanes
constexpr int SMEM_BUDGET = 100 * 1024;

struct Plan {
  int wr, wc, cc, win_floats;
  size_t smem;
};

Plan plan(const conv::Shape& s) {
  Plan p;
  p.wr = (ROW_TILE - 1) * s.stride + s.KH;
  p.wc = (TW - 1) * s.stride + s.KW;
  for (p.cc = s.Cin < 32 ? s.Cin : 32;; p.cc = (p.cc + 1) / 2) {
    p.win_floats = (p.cc * p.wr * p.wc + 3) / 4 * 4;   // taps stay 16B-aligned
    p.smem = sizeof(float) *
             (static_cast<size_t>(p.win_floats) + s.KH * s.KW * p.cc * TCO);
    if (p.smem <= SMEM_BUDGET || p.cc == 1) break;
  }
  return p;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sconv_ic_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, conv::Shape s, Plan p) {
  extern __shared__ __align__(16) float smem[];
  float* win = smem;                    // [cc][wr][wc] halo window
  float* taps = smem + p.win_floats;    // [KH*KW][cc][TCO] filter taps

  const int n_wt = (s.Wo + TW - 1) / TW;
  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * ROW_TILE;
  const int ow0 = (blockIdx.x % n_wt) * TW;
  const int co0 = (blockIdx.x / n_wt) * TCO;
  const int ih0 = oh0 * s.stride;
  const int iw0 = ow0 * s.stride;
  const int tid = threadIdx.x;
  const int pl = tid / 8;   // pixels pl + 32 i of the band
  const int cl = tid % 8;   // output channels co0 + cl*4 .. +3
  const int plane = p.wr * p.wc;
  const int ntaps = s.KH * s.KW;

  int woff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = pl + 32 * i;
    woff[i] = (q / TW) * s.stride * p.wc + (q % TW) * s.stride;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < s.Cin; c0 += p.cc) {
    // the band's halo window for channels c0 .. c0+cc-1 (channel fastest,
    // so consecutive threads read consecutive bytes of x)
    const int nwin = plane * p.cc;
    for (int e = tid; e < nwin; e += THREADS) {
      const int ci = e % p.cc;
      const int rc = e / p.cc;
      const int c = rc % p.wc;
      const int r = rc / p.wc;
      const int gr = ih0 + r, gc = iw0 + c, gci = c0 + ci;
      float* dst = win + ci * plane + r * p.wc + c;
      if (gr < s.H && gc < s.W && gci < s.Cin)
        conv::stage(dst, x + ((static_cast<long long>(n) * s.H + gr) * s.W +
                              gc) * s.Cin + gci);
      else
        *dst = 0.f;
    }
    // the chunk's taps, output channel fastest
    const int ntap_el = ntaps * p.cc * TCO;
    for (int e = tid; e < ntap_el; e += THREADS) {
      const int co = e % TCO;
      const int t = e / TCO;
      const int ci = t % p.cc;
      const int tap = t / p.cc;
      const int gci = c0 + ci, gco = co0 + co;
      if (gci < s.Cin && gco < s.Cout)
        conv::stage(taps + e, w + (static_cast<long long>(tap) * s.Cin + gci) *
                                      s.Cout + gco);
      else
        taps[e] = 0.f;
    }
    conv::stage_wait();
    __syncthreads();

    for (int di = 0; di < s.KH; ++di) {
      for (int dj = 0; dj < s.KW; ++dj) {
        const float* tp = taps + ((di * s.KW + dj) * p.cc) * TCO + cl * 4;
        const float* wp = win + di * p.wc + dj;
        for (int ci = 0; ci < p.cc; ++ci) {
          const float4 b = *reinterpret_cast<const float4*>(tp + ci * TCO);
          const float* pp = wp + ci * plane;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = pp[woff[i]];
            acc[i][0] = fmaf(a, b.x, acc[i][0]);
            acc[i][1] = fmaf(a, b.y, acc[i][1]);
            acc[i][2] = fmaf(a, b.z, acc[i][2]);
            acc[i][3] = fmaf(a, b.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = pl + 32 * i;
    const int oh = oh0 + q / TW;
    const int ow = ow0 + q % TW;
    if (oh >= s.Ho || ow >= s.Wo) continue;
    const long long o = ((static_cast<long long>(n) * s.Ho + oh) * s.Wo + ow) *
                        s.Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + cl * 4 + j;
      if (co < s.Cout) out[o + co] = conv::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, const conv::Shape& s,
           cudaStream_t stream) {
  const Plan p = plan(s);
  if (p.smem > conv::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = reinterpret_cast<const void*>(&sconv_ic_kernel<T>);
  cudaError_t e = conv::allow_smem(kern, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long bx = static_cast<long long>(conv::ceil_div(s.Wo, TW)) *
                       conv::ceil_div(s.Cout, TCO);
  const dim3 grid(static_cast<unsigned>(bx), conv::ceil_div(s.Ho, ROW_TILE),
                  s.N);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  sconv_ic_kernel<T><<<grid, THREADS, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), s, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* sconv_ic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, w, out: device pointers (fp32, or bf16 when bf16 != 0).  Launches on
// `stream` and returns the launch's CUDA error code (0 on success).
int sconv_ic_launch(const void* x, const void* w, void* out, int N, int H,
                    int W, int Cin, int KH, int KW, int Cout, int stride,
                    int bf16, void* stream) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, out, s, st)
              : launch<float>(x, w, out, s, st);
}

}  // extern "C"
