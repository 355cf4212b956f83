// MconvMC (Mconv-MP-CR, the Origami archetype): convolution as an
// im2col GEMM, for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/conv_dataflow/mconv_mc.py  _kernel (body, line 27),
//   launched by mconv_mc through pl.pallas_call (line 66).
// The TPU kernel walks a grid (N, Cout tiles, Cin tiles) with Cin
// sequential, and per tap adds a [Ho*Wo, Tc] @ [Tc, Tm] product into a VMEM
// fp32 accumulator.  Here the same reduction is one implicit GEMM:
//   out[M = N*Ho*Wo, Cout] = A[M, K] @ B[K, Cout],  K = KH*KW*Cin,
// where row m of A is output pixel m's receptive field in (di, dj, ci)
// order (gathered from x on the fly, never materialised) and B is w
// itself, read as the [K, Cout] matrix it already is in [KH, KW, Cin, Cout]
// layout.  The K axis is walked in tiles of BK in (tap, channel) order, so
// a tile may span the end of one tap's channels and the start of the next:
// layers with few input channels (3 in the first layer) waste no MACs on
// padding, and the TPU's rule that the tile divides Cin (ops._tile) does
// not apply.  Both operands stream through shared memory every K step
// (MP, multiple propagation); the partial sums stay in registers for the
// whole K walk (CR) - the Mconv "multiple MACs per PE" is the 4 x 4 outer
// product each thread does per K step.
//
// Block: a BM x BN = 64 pixels x 64 output channels tile, 256 threads,
// each owning a 4 x 4 register tile.  Rows past M and columns past Cout
// are computed on clamped or zero operands and never stored; K entries
// past K are zero in both operands, so they add exactly nothing.
//
// Accumulation is fp32 FMAs on CUDA cores, in bf16 runs too (inputs are
// widened on the way into shared memory, the output is rounded once).
// TF32 tensor cores are not used: they keep about three decimal digits,
// and the reference tolerance is 1e-4.
//
// Bound on the H100: 2*M*K*Cout FLOPs at 67 TFLOP/s fp32 against the bytes
// of x, w and out at 3.35 TB/s.  At the path's largest layers (YOLO's 3x3
// 409 -> 819 stride 2 at 13x13 output, SSD's 3x3 435 -> 870 stride 2 at
// 32x32) the FLOPs bound it (chip_smoke.py prints both bounds and the
// measured time).

#include "conv_common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
mconv_mc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, conv::Shape s) {
  __shared__ __align__(16) float As[BK][BM + 4];   // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];       // B tile

  const int tid = threadIdx.x;
  const int M = s.N * s.Ho * s.Wo;
  const int K = s.KH * s.KW * s.Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loads: column ka of the tile for pixels pa + 16 i (consecutive
  // threads read consecutive channels of one pixel).  Pixels past M read
  // pixel 0 (in bounds; their rows are never stored).
  const int ka = tid % BK;
  const int pa = tid / BK;
  long long base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + pa + 16 * i;
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
  // B loads: row kb, columns cb .. cb+3 (coalesced along Cout)
  const int kb = tid / 16;
  const int cb = (tid % 16) * 4;
  // compute: rows ty*4 .. +3, columns tx*4 .. +3
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int k = k0 + ka;
      if (k < K) {
        const int tap = k / s.Cin;
        const int ci = k - tap * s.Cin;
        const int di = tap / s.KW;
        const int dj = tap - di * s.KW;
        const long long off =
            (static_cast<long long>(di) * s.W + dj) * s.Cin + ci;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          As[ka][pa + 16 * i] = conv::to_f32(x[base[i] + off]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) As[ka][pa + 16 * i] = 0.f;
      }
    }
    {
      const int k = k0 + kb;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + cb + j;
        Bs[kb][cb + j] = (k < K && co < s.Cout)
            ? conv::to_f32(w[static_cast<long long>(k) * s.Cout + co]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < s.Cout)
        out[static_cast<long long>(m) * s.Cout + co] =
            conv::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, const conv::Shape& s,
           cudaStream_t stream) {
  const long long M = static_cast<long long>(s.N) * s.Ho * s.Wo;
  const dim3 grid(conv::ceil_div(M, BM), conv::ceil_div(s.Cout, BN));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  mconv_mc_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mconv_mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, w, out: device pointers (fp32, or bf16 when bf16 != 0).  Launches on
// `stream` and returns the launch's CUDA error code (0 on success).
int mconv_mc_launch(const void* x, const void* w, void* out, int N, int H,
                    int W, int Cin, int KH, int KW, int Cout, int stride,
                    int bf16, void* stream) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, out, s, st)
              : launch<float>(x, w, out, s, st);
}

}  // extern "C"
