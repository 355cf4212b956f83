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
// layout.  The K axis is walked in steps of BK in (tap, channel) order, so
// a step may span the end of one tap's channels and the start of the next:
// layers with few input channels (3 in the first layer) waste no MACs on
// padding, and the TPU's rule that the tile divides Cin (ops._tile) does
// not apply.  Both operands stream through shared memory every K step
// (MP, multiple propagation); the partial sums stay in registers for the
// block's whole K walk (CR): the Mconv "multiple MACs per PE" is the
// 8 x 8 (4 x 4 in a small conv) outer product each thread does per k.
//
// Bound on the H100: 2*M*K*Cout FLOPs at 67 TFLOP/s fp32 against the bytes
// of x, w and out at 3.35 TB/s.  The path's largest layers are bound by
// the FLOPs: YOLO's 3x3 409 -> 819 stride 2 at 13 x 13 (1.02 GFLOP,
// 0.0152 ms) and SSD's 3x3 435 -> 870 stride 2 at 32 x 32 (0.104 ms).
// What held the first kernel (64 x 64 tiles, 4 x 4 a thread) far from it,
// and what this design does:
//  * too few blocks: 39 at YOLO's layer on 132 SMs.  plan() (a function
//    of the shape alone) takes BM = 64 or 128 rows by the work on the
//    busiest SM, M waste included, and splits the K walk into G
//    contiguous parts over gridDim.z by the busiest-SM rule
//    (conv::split_count) with the residency the kernel's registers and
//    shared memory allow; the parts go to an fp32 workspace that
//    conv::sum_splits adds in split order (no atomics: two calls, the same
//    bits).  YOLO's layer: 64 x 128 tiles, 3 x 7 = 21, and with the 2
//    blocks an SM holds, G = 12 (252 blocks); SSD's: 128 x 128 tiles,
//    8 x 7 = 56, G = 4;
//  * shared-memory loads setting the pace (2 float4 loads per 16 FMAs): a
//    thread now owns 8 x 8 outputs (rows ty*4 + {0..3} and BM/2 + ty*4 +
//    {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}): 4 float4 loads
//    per 64 FMAs;
//  * copies global -> register -> shared, single-buffered, two barriers a
//    step: operands now go by cp.async into a ring of STAGES buffers, so
//    the copies of steps i+1 and i+2 are in flight while step i
//    multiplies, one barrier a step.  B rows go by 16-, 8- or 4-byte
//    copies as Cout's alignment allows; A is written transposed (k-major,
//    for float4 reads along M) by 4-byte copies, lanes along k so that a
//    warp reads two pixels' contiguous channel runs.  bf16 goes through a
//    register, because cp.async cannot widen;
//  * two integer divisions per A element per step: a thread's k column is
//    fixed, so its (tap, channel) position is found once per block and
//    carried by BK per step, and its pixels' base offsets are found once;
//  * a small conv (under conv::MIN_SPLIT_MACS, one launch, G = 1) is
//    bound by each thread's chain of FMAs over all of K, not by the card's
//    rate: at the width-0.1 pools' M = 16 one 64 x 128 block of 8 x 8 a
//    thread did the whole conv.  There the tile is 64 x 64 at 4 x 4 a
//    thread (256 threads): a quarter of the chain, twice the blocks.
// Rows past M and columns past Cout are computed on zero operands and
// never stored; K entries past K are zero in both operands, so they add
// exactly nothing.
//
// Accumulation is fp32 FMAs on CUDA cores, in bf16 runs too (inputs are
// widened on the way into shared memory, the output is rounded once).
// TF32 tensor cores are not used: they keep about three decimal digits,
// and the reference tolerance is 1e-4.

#include <cstdio>

#include "conv_common.cuh"

namespace {

constexpr int BK = 16;       // K per step
constexpr int STAGES = 3;    // buffers of the copy ring
constexpr int APAD = 4;      // A's row pitch is BM + 4 floats

// A block tile of BM output rows (pixels) x BN output channels, TM x TM
// outputs a thread: 64 x 128 or 128 x 128 at 8 x 8 for the convs the plan
// may split, 64 x 64 at 4 x 4 for the small ones (conv::MIN_SPLIT_MACS).
// A thread's rows are h * BM / (TM/4) + ty*4 + {0..3} and its columns
// h * BN / (TM/4) + tx*4 + {0..3}, h < TM/4: float4 reads along M and Cout.
template <int BM_, int BN_, int TM_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_;
  static constexpr int H = TM / 4;               // float4s a row of outputs
  static constexpr int TX = BN / TM;             // threads along Cout
  static constexpr int THREADS = (BM / TM) * TX;
  static constexpr int AP = BM + APAD;
  static constexpr int A_FLOATS = BK * AP;       // A [BK][AP], k-major
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * BN;   // + B [BK][BN]
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE_FLOATS;
  static constexpr int AROWS = THREADS / BK;     // pixels a pass of A copies
  static constexpr int ACOPIES = BM / AROWS;     // A copies a thread a step
};
using Wide = Tile<64, 128, 8>;
using Big = Tile<128, 128, 8>;
using Small = Tile<64, 64, 4>;

struct Args {
  conv::Shape s;
  int M, K, ksteps, G;
  int vec_w;   // floats a copy of w's Cout rows may take: 4, 2 or 1
};

// Stage B rows k0 .. k0+BK-1, columns n0 .. n0+BN-1, V floats a copy
// (T = float when V > 1).
template <int BN, int THREADS, int V, typename T>
__device__ __forceinline__ void stage_b(float* Bs, const T* __restrict__ w,
                                        const Args& a, int k0, int n0) {
  constexpr int Q = BN / V;   // copies a row
  static_assert((BK * Q) % THREADS == 0, "B copies must divide evenly");
#pragma unroll
  for (int i = 0; i < BK * Q / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / Q, q = e % Q;
    const int k = k0 + r, co = n0 + V * q;
    const bool in = k < a.K && co < a.s.Cout;
    const T* src = w + (in ? static_cast<long long>(k) * a.s.Cout + co : 0);
    float* dst = Bs + r * BN + V * q;
    if (V == 4)
      conv::cp16(dst, reinterpret_cast<const float*>(src), in ? 16 : 0);
    else if (V == 2)
      conv::cp8(dst, reinterpret_cast<const float*>(src), in ? 8 : 0);
    else
      conv::put(dst, src, in);
  }
}

template <typename TL, typename T>
__global__ void __launch_bounds__(TL::THREADS)
mconv_mc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, float* __restrict__ ws, Args a) {
  constexpr int BM = TL::BM, BN = TL::BN, TM = TL::TM, H = TL::H;
  constexpr int THREADS = TL::THREADS;
  constexpr int AP = TL::AP;
  extern __shared__ __align__(16) float smem[];   // STAGES x [A | B]
  const conv::Shape& s = a.s;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int z = blockIdx.z;
  const int kt_begin = static_cast<int>(static_cast<long long>(z) *
                                        a.ksteps / a.G);
  const int kt_end = static_cast<int>(static_cast<long long>(z + 1) *
                                      a.ksteps / a.G);
  const int steps = kt_end - kt_begin;

  // A copies: k column ka of the step, pixels pa + AROWS * i; lanes run
  // along k, so a warp reads two pixels' 16 consecutive K entries
  const int ka = tid % BK;
  const int pa = tid / BK;
  int base[TL::ACOPIES];   // x offset of each pixel's window (-1: past M)
  {
    const int hw = s.Ho * s.Wo;
#pragma unroll
    for (int i = 0; i < TL::ACOPIES; ++i) {
      const int m = m0 + pa + TL::AROWS * i;
      base[i] = -1;
      if (m < a.M) {
        const int n = m / hw;
        const int r = m - n * hw;
        const int oh = r / s.Wo;
        const int ow = r - oh * s.Wo;
        base[i] = ((n * s.H + oh * s.stride) * s.W + ow * s.stride) * s.Cin;
      }
    }
  }
  // the thread's K entry k = (di, dj, ci), carried by BK per staged step
  int k = kt_begin * BK + ka;
  int ci, di, dj;
  {
    const int tap = k / s.Cin;
    ci = k - tap * s.Cin;
    di = tap / s.KW;
    dj = tap - di * s.KW;
  }

  auto stage = [&](int kt, float* buf) {
    float* As = buf;
    const bool kin = k < a.K;
    const int off = (di * s.W + dj) * s.Cin + ci;
#pragma unroll
    for (int i = 0; i < TL::ACOPIES; ++i) {
      const bool in = kin && base[i] >= 0;
      conv::put(As + ka * AP + pa + TL::AROWS * i,
                x + (in ? base[i] + off : 0), in);
    }
    k += BK;
    for (ci += BK; ci >= s.Cin;) {
      ci -= s.Cin;
      if (++dj == s.KW) {
        dj = 0;
        ++di;
      }
    }
    float* Bs = buf + TL::A_FLOATS;
    const int k0 = kt * BK;
    if (sizeof(T) == 4 && a.vec_w == 4)
      stage_b<BN, THREADS, 4>(Bs, reinterpret_cast<const float*>(w), a, k0,
                              n0);
    else if (sizeof(T) == 4 && a.vec_w == 2)
      stage_b<BN, THREADS, 2>(Bs, reinterpret_cast<const float*>(w), a, k0,
                              n0);
    else
      stage_b<BN, THREADS, 1>(Bs, w, a, k0, n0);
  };

  const int tx = tid % TL::TX;
  const int ty = tid / TL::TX;
  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) stage(kt_begin + i, smem + i * TL::STAGE_FLOATS);
    conv::commit();
  }
  for (int st = 0; st < steps; ++st) {
    // step st has landed for this thread, then for every thread; the
    // buffer staged next was consumed at step st - 1
    conv::wait_pending<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < steps)
      stage(kt_begin + st + STAGES - 1,
            smem + ((st + STAGES - 1) % STAGES) * TL::STAGE_FLOATS);
    conv::commit();
    const float* As = smem + (st % STAGES) * TL::STAGE_FLOATS;
    const float* Bs = As + TL::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TM];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 ah = *reinterpret_cast<const float4*>(
            As + kk * AP + h * (BM / H) + ty * 4);
        const float4 bh = *reinterpret_cast<const float4*>(
            Bs + kk * BN + h * (BN / H) + tx * 4);
        av[4 * h] = ah.x;
        av[4 * h + 1] = ah.y;
        av[4 * h + 2] = ah.z;
        av[4 * h + 3] = ah.w;
        bv[4 * h] = bh.x;
        bv[4 * h + 1] = bh.y;
        bv[4 * h + 2] = bh.z;
        bv[4 * h + 3] = bh.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM / H) + ty * 4 + i % 4;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int co = n0 + (j / 4) * (BN / H) + tx * 4 + j % 4;
      if (co >= s.Cout) continue;
      const long long o = static_cast<long long>(m) * s.Cout + co;
      if (a.G == 1)
        out[o] = conv::from_f32<T>(acc[i][j]);
      else
        ws[static_cast<long long>(z) * a.M * s.Cout + o] = acc[i][j];
    }
  }
}

struct Plan {
  int BM, BN, TM;  // the tile (0: the shape is not taken)
  int threads;
  int resident;    // blocks an SM holds at once (fp32 kernel, occupancy)
  int m_tiles, n_tiles, ksteps, G, sms;
  size_t smem;
};

template <typename TL>
Plan plan_for(const conv::Shape& s, int sms, bool split) {
  Plan p{};
  p.BM = TL::BM;
  p.BN = TL::BN;
  p.TM = TL::TM;
  p.threads = TL::THREADS;
  p.smem = TL::SMEM;
  p.sms = sms;
  p.resident = conv::resident_blocks(
      reinterpret_cast<const void*>(&mconv_mc_kernel<TL, float>),
      reinterpret_cast<const void*>(&mconv_mc_kernel<TL, __nv_bfloat16>),
      p.threads, p.smem);
  const long long M = static_cast<long long>(s.N) * s.Ho * s.Wo;
  p.m_tiles = conv::ceil_div(M, TL::BM);
  p.n_tiles = conv::ceil_div(s.Cout, TL::BN);
  p.ksteps = conv::ceil_div(static_cast<long long>(s.KH) * s.KW * s.Cin, BK);
  const long long tiles = static_cast<long long>(p.m_tiles) * p.n_tiles;
  p.G = split ? conv::split_count(tiles, p.ksteps, p.resident, sms) : 1;
  if (p.resident < 1) p.BM = 0;
  return p;
}

// The MACs the busiest SM does under plan p, padding included:
// ceil(tiles * G / sms) blocks of BM x BN x (K / G).
double busiest(const Plan& p) {
  const long long blocks = static_cast<long long>(p.m_tiles) * p.n_tiles * p.G;
  return static_cast<double>(conv::ceil_div(blocks, p.sms)) * p.BM * p.BN *
         BK * (static_cast<double>(p.ksteps) / p.G);
}

// A function of the shape and the device; bf16 runs take the fp32
// kernel's plan.  Below conv::MIN_SPLIT_MACS: the 64 x 64 tile at 4 x 4 a
// thread, one launch (each thread's FMA chain a quarter of the 8 x 8
// tiles', twice their blocks).  Otherwise BM = 64 or 128 rows at 8 x 8 a
// thread, whichever gives the busiest SM fewer MACs with its split (M
// waste counted: at M = 169, 64-row tiles keep 88 % of their rows,
// 128-row tiles 66 %); ties go to 128 (half the B traffic).
Plan make_plan(const conv::Shape& s) {
  const int sms = conv::sm_count();
  if (sms < 1) return Plan{};
  if (conv::macs(s) < conv::MIN_SPLIT_MACS)
    return plan_for<Small>(s, sms, false);
  const Plan p64 = plan_for<Wide>(s, sms, true);
  const Plan p128 = plan_for<Big>(s, sms, true);
  if (p64.BM == 0 || p128.BM == 0) return Plan{};
  return busiest(p128) <= busiest(p64) * (1 + 1e-9) ? p128 : p64;
}

Plan plan(const conv::Shape& s) { return conv::memoized(s, make_plan); }

bool takes(const Plan& p) {
  return p.BM > 0 && p.n_tiles <= 65535 && p.G <= 65535;
}

template <typename TL, typename T>
int launch_tile(const T* x, const T* w, T* out, float* ws, const Plan& p,
                const Args& a, cudaStream_t stream) {
  const dim3 grid(p.m_tiles, p.n_tiles, p.G);
  mconv_mc_kernel<TL, T><<<grid, TL::THREADS, TL::SMEM, stream>>>(
      x, w, out, ws, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xv, const void* wv, void* outv, void* wsv,
           long long ws_floats, const conv::Shape& s, cudaStream_t stream) {
  const Plan p = plan(s);
  if (!takes(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.G > 1 && (wsv == nullptr || ws_floats < conv::split_floats(s, p.G)))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* out = static_cast<T*>(outv);
  float* ws = static_cast<float*>(wsv);
  const bool al = reinterpret_cast<unsigned long long>(wv) % 16 == 0;
  const Args a{s, s.N * s.Ho * s.Wo, s.KH * s.KW * s.Cin, p.ksteps, p.G,
               !al ? 1 : s.Cout % 4 == 0 ? 4 : s.Cout % 2 == 0 ? 2 : 1};
  const int rc =
      p.TM == 4    ? launch_tile<Small>(x, w, out, ws, p, a, stream)
      : p.BM == 64 ? launch_tile<Wide>(x, w, out, ws, p, a, stream)
                   : launch_tile<Big>(x, w, out, ws, p, a, stream);
  if (rc != 0 || p.G == 1) return rc;
  const long long count = static_cast<long long>(a.M) * s.Cout;
  return static_cast<int>(
      conv::launch_sum_splits(ws, out, count, p.G, p.sms, stream));
}

}  // namespace

extern "C" {

const char* mconv_mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of splits G of the K walk for this shape (1: no split).  0
// for a shape the kernel does not take.
int mconv_mc_splits(int N, int H, int W, int Cin, int KH, int KW, int Cout,
                    int stride) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return 0;
  const Plan p = plan(s);
  return takes(p) ? p.G : 0;
}

// Floats of the fp32 workspace launch needs for this shape (0: none; -1
// for a shape the kernel does not take).
long long mconv_mc_workspace(int N, int H, int W, int Cin, int KH, int KW,
                            int Cout, int stride) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return -1;
  const Plan p = plan(s);
  return takes(p) ? conv::split_floats(s, p.G) : -1;
}

// The plan for this shape as text into buf (len bytes); returns G as
// mconv_mc_splits does.
int mconv_mc_describe(int N, int H, int W, int Cin, int KH, int KW, int Cout,
                      int stride, char* buf, int len) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return 0;
  const Plan p = plan(s);
  snprintf(buf, len, "tile %d x %d, %d x %d a thread, %d threads, %d x %d "
           "tiles, %d K steps of %d, %d resident by occupancy (the split "
           "rule counts at most %d), %d SMs, G = %d", p.BM, p.BN, p.TM, p.TM,
           p.threads, p.m_tiles, p.n_tiles, p.ksteps, BK, p.resident,
           conv::MAX_RESIDENT, p.sms, p.G);
  return takes(p) ? p.G : 0;
}

// x, w, out: device pointers (fp32, or bf16 when bf16 != 0); ws: an fp32
// workspace of ws_floats floats, at least mconv_mc_workspace(...) (unused
// when that is 0; a shorter one is refused).  Launches on `stream` (two
// kernels when G > 1) and returns the launches' CUDA error code (0 on
// success).
int mconv_mc_launch(const void* x, const void* w, void* out, void* ws,
                    long long ws_floats, int N, int H, int W, int Cin,
                    int KH, int KW, int Cout, int stride, int bf16,
                    void* stream) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, out, ws, ws_floats, s, st)
              : launch<float>(x, w, out, ws, ws_floats, s, st);
}

}  // extern "C"
