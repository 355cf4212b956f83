// SconvOD (Sconv-OP-DR, the NeuFlow archetype): weight-stationary
// shifted-plane convolution, for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/conv_dataflow/sconv_od.py  _kernel (body, line 31),
//   launched by sconv_od through pl.pallas_call (line 74).
// The TPU kernel walks a grid (N, Cin tiles) with the channel tiles
// sequential: per input channel of the tile, each of the KH x KW taps
// multiplies the whole shifted ifmap plane and adds it into a VMEM partial
// sum (Sconv: one whole 2D convolution per step; no GEMM), which is carried
// across the channel tiles (OP: the psums propagate) and written at the
// end.  Cin is zero-padded up to a whole tile.
//
// Here one block owns a tile of 128 output pixels x TCO = 32 output
// channels and walks the input channels in tiles of CIN_TILE = 8 (the JAX
// wrapper's cin_tile).  Per channel tile, the tile's filter taps
// [CIN_TILE][KH*KW][TCO] are staged into shared memory and stay resident
// (DR: the weights are the stationary operand) while, channel by channel
// and tap by tap, each thread reads its pixels' shifted ifmap values
// straight from device memory (the ifmap streams through L1/L2; nothing of
// it is staged) and multiply-adds them into its partial sums.  The partial
// sums - 4 pixels x 4 output channels per thread - are carried in
// registers across the sequential channel tiles and written once.  The
// last tile stops at Cin, so a Cin that is not a multiple of CIN_TILE adds
// exactly nothing from pad channels (none is read).
//
// bf16 inputs are widened on load; the output is rounded once.  No TF32:
// the reference tolerance is 1e-4.
//
// Bound on the H100: FLOPs (2 * N*Ho*Wo * KH*KW*Cin * Cout) at 67 TFLOP/s
// fp32 against the bytes of x, w and out at 3.35 TB/s; the path's large
// layers are bound by the FLOPs.  This dataflow does four device-memory
// (L1) loads per 16 FMAs, so it is expected to sit furthest from that
// bound of the three.

#include "conv_common.cuh"

namespace {

constexpr int PIX = 128;       // output pixels per block
constexpr int TCO = 32;        // output channels per block
constexpr int THREADS = 256;   // 32 pixel lanes x 8 channel lanes
constexpr int CIN_TILE = 8;    // input channels per resident filter block

size_t smem_bytes(const conv::Shape& s) {
  return sizeof(float) * static_cast<size_t>(CIN_TILE) * s.KH * s.KW * TCO;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sconv_od_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, conv::Shape s) {
  extern __shared__ __align__(16) float taps[];   // [CIN_TILE][KH*KW][TCO]

  const int M = s.N * s.Ho * s.Wo;
  const int ntaps = s.KH * s.KW;
  const int m0 = blockIdx.x * PIX;
  const int co0 = blockIdx.y * TCO;
  const int tid = threadIdx.x;
  const int pl = tid / 8;   // pixels m0 + pl + 32 i
  const int cl = tid % 8;   // output channels co0 + cl*4 .. +3

  // Pixels past M read pixel 0 (in bounds) and are never stored.
  long long base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + pl + 32 * i;
    base[i] = 0;
    if (m < M) {
      const int n = m / (s.Ho * s.Wo);
      const int r = m - n * s.Ho * s.Wo;
      const int oh = r / s.Wo;
      const int ow = r - oh * s.Wo;
      base[i] = ((static_cast<long long>(n) * s.H + oh * s.stride) * s.W +
                 ow * s.stride) * s.Cin;
    }
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < s.Cin; c0 += CIN_TILE) {
    const int ct = min(CIN_TILE, s.Cin - c0);
    const int nel = ct * ntaps * TCO;
    for (int e = tid; e < nel; e += THREADS) {
      const int co = e % TCO;
      const int t = e / TCO;
      const int tap = t % ntaps;
      const int ci = t / ntaps;
      const int gco = co0 + co;
      if (gco < s.Cout)
        conv::stage(taps + e, w + (static_cast<long long>(tap) * s.Cin + c0 +
                                   ci) * s.Cout + gco);
      else
        taps[e] = 0.f;
    }
    conv::stage_wait();
    __syncthreads();

    for (int ci = 0; ci < ct; ++ci) {
      for (int di = 0; di < s.KH; ++di) {
        for (int dj = 0; dj < s.KW; ++dj) {
          const float4 b = *reinterpret_cast<const float4*>(
              taps + (ci * ntaps + di * s.KW + dj) * TCO + cl * 4);
          const long long off =
              (static_cast<long long>(di) * s.W + dj) * s.Cin + c0 + ci;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = conv::to_f32(x[base[i] + off]);
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
    const int m = m0 + pl + 32 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + cl * 4 + j;
      if (co < s.Cout)
        out[static_cast<long long>(m) * s.Cout + co] =
            conv::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, const conv::Shape& s,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(s);
  if (smem > conv::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = reinterpret_cast<const void*>(&sconv_od_kernel<T>);
  cudaError_t e = conv::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long M = static_cast<long long>(s.N) * s.Ho * s.Wo;
  const dim3 grid(conv::ceil_div(M, PIX), conv::ceil_div(s.Cout, TCO));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  sconv_od_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* sconv_od_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, w, out: device pointers (fp32, or bf16 when bf16 != 0).  Launches on
// `stream` and returns the launch's CUDA error code (0 on success).
int sconv_od_launch(const void* x, const void* w, void* out, int N, int H,
                    int W, int Cin, int KH, int KW, int Cout, int stride,
                    int bf16, void* stream) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, out, s, st)
              : launch<float>(x, w, out, s, st);
}

}  // extern "C"
