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
// What keeps it SconvOD here: there is no im2col.  The filter taps are the
// stationary operand (DR), each tap multiplies the ifmap window shifted by
// (di, dj), and the partial sums are carried in registers across the
// channel tiles (OP).  That is what keeps its rate distinct from
// MconvMC's im2col GEMM in the virtual-accelerator pools.
//
// Bound on the H100: FLOPs (2 * N*Ho*Wo * KH*KW*Cin * Cout) at 67 TFLOP/s
// fp32 against the bytes of x, w and out at 3.35 TB/s; the path's large
// layers are bound by the FLOPs (YOLO's 3x3 409 -> 819 at 13 x 13: 1.0
// GFLOP, 0.0152 ms).  What held the first kernel far from it: 52 blocks on
// 132 SMs at that layer, a serial chain of 3,681 steps a thread, and
// four uncoalesced device-memory loads per 16 FMAs.  The design:
//  * a block owns a PH x PW = 16 x 8 patch of output pixels of one image x
//    TCO = 64 output channels, 128 threads; each thread holds one patch
//    row of 8 pixels x 8 output channels (4 + 4, 32 apart, so a warp's
//    weight reads are conflict-free) in 64 fp32 registers;
//  * per step, the patch's ifmap window, ((PH-1)*s + KH) x ((PW-1)*s + KW)
//    x CT channels, is staged into shared memory ([row][col][channel],
//    rows padded so the 4 patch rows a warp reads fall in distinct banks),
//    and so are the weights [CT][taps][64].  The tap loop reads the window
//    shifted by (di, dj): each ifmap value comes from device memory once
//    per block and channel tile.  A tap is 8 float4 window loads (8 pixels
//    x 4 channels) and 8 float4 weight loads for 256 FMAs;
//  * window and weights are double-buffered: the copies of step i+1 are
//    in flight (cp.async, 16 bytes where the channel rows are 16-byte
//    aligned, 8 for weight rows 8-byte aligned, else 4 bytes) while step
//    i multiplies (a third buffer
//    measured slower: fewer blocks fit an SM).  bf16 goes through a
//    register, because cp.async cannot widen;
//  * a step is a channel tile (CT = 8, or 4 where a window of 8 channels
//    does not fit) and, for kernels too large for one buffer (GOTURN's
//    11 x 11), a chunk of taps with its window staged again;
//  * the Cin chain is split across gridDim.z when patches x Cout tiles
//    leave SMs idle or unevenly loaded: G splits, each over its own
//    contiguous channel tiles, so the OP chain is cut into G chains.  G
//    minimises the channel tiles on the busiest SM with every block
//    resident (plan(), below; a function of the shape and the device:
//    the SM count and the residency its occupancy calculator gives,
//    capped at conv::MAX_RESIDENT).  The splits
//    write an fp32 workspace [G, M, Cout] and a second kernel sums them in
//    split order and casts: no atomics, so two calls give the same bits.
//    YOLO's layer: 2 patches x 13 Cout tiles = 26 tiles, G = 15 (390
//    blocks, 3 an SM); SSD's (435 -> 870 at 32 x 32): 8 x 14 = 112, G = 3.
// Outputs in the ragged part of a patch are computed on zero-filled
// window entries (never read out of bounds) and never stored; channels
// past Cin are zero in both operands and add exactly nothing.
//
// bf16 inputs are widened as they are staged; the output is rounded once.
// No TF32: the reference tolerance is 1e-4.

#include <cstdio>

#include "conv_common.cuh"

namespace {

constexpr int PH = 16;          // output rows per patch
constexpr int PW = 8;           // output columns per patch (a thread's row)
constexpr int TCO = 64;         // output channels per block
constexpr int THREADS = PH * 8; // one patch row x 8 channel groups each
constexpr int BUF_BYTES = 32 * 1024;   // one buffer's target (window + taps)
constexpr int STAGES = 2;       // buffers: step i+1 copies while step i runs

struct Plan {
  int CT;      // channels per tile (8 or 4)
  int taps;    // taps per step (all of KH*KW unless they do not fit)
  int WR, WC;  // window rows and columns
  int RP;      // window row pitch in floats (= 4 mod 32)
  int n_ct;    // channel tiles
  int G;       // splits of the channel tiles
  int patches_h, patches_w, cout_tiles;
  int resident;  // blocks an SM holds at once (fp32 kernel, occupancy)
  int sms;     // SMs of the device
  size_t buf_floats, smem;
};

struct Args {
  conv::Shape s;
  int CT, taps, WR, WC, RP, n_ct, G, patches_h, patches_w;
  int buf_floats;
  int vec_x;   // 16-byte copies of x's channel rows allowed
  int vec_w;   // floats a copy of w's Cout rows may take: 4, 2 or 1
};

using conv::cp16;
using conv::cp4;
using conv::cp8;
using conv::put;

// Stage the taps [ct][nt] x TCO of one step, V floats a copy (T = float
// when V > 1).
template <int V, typename T>
__device__ __forceinline__ void stage_taps(float* tap, const T* __restrict__ w,
                                           const Args& a, int co0, int c0,
                                           int t0, int nt, int cv) {
  const conv::Shape& s = a.s;
  constexpr int Q = TCO / V;              // copies a row
  const int q = threadIdx.x % Q;
  const int co = co0 + V * q;
  const int rstep = THREADS / Q;
  int r = threadIdx.x / Q, ci = r / nt, t = r - ci * nt;
  for (; r < a.CT * nt; r += rstep) {
    const bool in = ci < cv && co < s.Cout;
    const T* src = w + (in ? (static_cast<long long>(t0 + t) * s.Cin + c0 +
                              ci) * s.Cout + co : 0);
    float* dst = tap + (ci * a.taps + t) * TCO + V * q;
    if (V == 4)
      cp16(dst, reinterpret_cast<const float*>(src), in ? 16 : 0);
    else if (V == 2)
      cp8(dst, reinterpret_cast<const float*>(src), in ? 8 : 0);
    else
      put(dst, src, in);
    for (t += rstep; t >= nt; t -= nt) ++ci;
  }
}

// Stage step (channel tile c0.., taps t0..t0+nt-1) of the block's patch
// into one buffer: the window [WR][RP] (channel innermost) and the taps
// [CT][taps][TCO].  A thread copies whole window pixels (its CT channels
// are contiguous in x; one pixel per thread measured faster than lanes
// along the channels), and weight rows are read coalesced along Cout,
// their indices advanced by counters.
template <typename T>
__device__ __forceinline__ void stage(float* buf, const T* __restrict__ x,
                                      const T* __restrict__ w,
                                      const Args& a, int n, int ih0,
                                      int iw0, int co0, int c0, int t0,
                                      int nt) {
  const conv::Shape& s = a.s;
  float* win = buf;
  float* tap = buf + a.WR * a.RP;
  const int ct = a.CT;
  const int cv = min(ct, s.Cin - c0);   // channels of the tile inside Cin
  const long long xn = static_cast<long long>(n) * s.H;
  for (int px = threadIdx.x; px < a.WR * a.WC; px += THREADS) {
    const int wr = px / a.WC, wc = px - wr * a.WC;
    const int ih = ih0 + wr, iw = iw0 + wc;
    const bool in = ih < s.H && iw < s.W;
    const T* src = x + (in ? ((xn + ih) * s.W + iw) * s.Cin + c0 : 0);
    float* dst = win + wr * a.RP + wc * ct;
    if (sizeof(T) == 4 && a.vec_x) {
      for (int q = 0; q < ct; q += 4)
        cp16(dst + q, reinterpret_cast<const float*>(src) + (in ? q : 0),
             in && q < cv ? 16 : 0);
    } else {
      for (int q = 0; q < ct; ++q)
        put(dst + q, src + (in ? q : 0), in && q < cv);
    }
  }
  // taps: rows r = ci * nt + t advanced by counters, V consecutive output
  // channels a copy: 16 or 8 bytes where Cout keeps the rows aligned
  if (sizeof(T) == 4 && a.vec_w == 4)
    stage_taps<4>(tap, reinterpret_cast<const float*>(w), a, co0, c0, t0,
                  nt, cv);
  else if (sizeof(T) == 4 && a.vec_w == 2)
    stage_taps<2>(tap, reinterpret_cast<const float*>(w), a, co0, c0, t0,
                  nt, cv);
  else
    stage_taps<1>(tap, w, a, co0, c0, t0, nt, cv);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sconv_od_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, float* __restrict__ ws, Args a) {
  extern __shared__ __align__(16) float smem[];   // 2 x [window | taps]
  const conv::Shape& s = a.s;
  const int tid = threadIdx.x;
  const int cg = tid % 8;    // channels co0 + cg*4 + {0..3} and + 32
  const int pr = tid / 8;    // patch row
  int pidx = blockIdx.x;
  const int pw = pidx % a.patches_w;
  pidx /= a.patches_w;
  const int ph = pidx % a.patches_h;
  const int n = pidx / a.patches_h;
  const int oh0 = ph * PH, ow0 = pw * PW;
  const int ih0 = oh0 * s.stride, iw0 = ow0 * s.stride;
  const int co0 = blockIdx.y * TCO;
  const int z = blockIdx.z;
  const int ct_begin = static_cast<int>(static_cast<long long>(z) * a.n_ct /
                                        a.G);
  const int ct_end = static_cast<int>(static_cast<long long>(z + 1) *
                                      a.n_ct / a.G);
  const int ntaps = s.KH * s.KW;
  const int chunks = (ntaps + a.taps - 1) / a.taps;
  const int steps = (ct_end - ct_begin) * chunks;

  float acc[PW][8];
#pragma unroll
  for (int j = 0; j < PW; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;

  auto step_at = [&](int st, float* buf) {
    const int ctile = ct_begin + st / chunks;
    const int t0 = (st % chunks) * a.taps;
    stage<T>(buf, x, w, a, n, ih0, iw0, co0, ctile * a.CT, t0,
             min(a.taps, ntaps - t0));
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) step_at(i, smem + i * a.buf_floats);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int st = 0; st < steps; ++st) {
    // step st has landed for this thread, then for every thread; the
    // buffer staged next was consumed at step st - 1
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
    __syncthreads();
    if (st + STAGES - 1 < steps)
      step_at(st + STAGES - 1,
              smem + ((st + STAGES - 1) % STAGES) * a.buf_floats);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* win = smem + (st % STAGES) * a.buf_floats;
    const float* tap = win + a.WR * a.RP;
    const int t0 = (st % chunks) * a.taps;
    const int nt = min(a.taps, ntaps - t0);
    for (int t = 0; t < nt; ++t) {
      const int di = (t0 + t) / s.KW, dj = (t0 + t) - di * s.KW;
      const float* wrow = win + (pr * s.stride + di) * a.RP + dj * a.CT;
      const int jstep = s.stride * a.CT;
      for (int c4 = 0; c4 < a.CT; c4 += 4) {
        float4 v[PW];
#pragma unroll
        for (int j = 0; j < PW; ++j)
          v[j] = *reinterpret_cast<const float4*>(wrow + j * jstep + c4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* tp = tap + ((c4 + c) * a.taps + t) * TCO + cg * 4;
          const float4 b0 = *reinterpret_cast<const float4*>(tp);
          const float4 b1 = *reinterpret_cast<const float4*>(tp + 32);
#pragma unroll
          for (int j = 0; j < PW; ++j) {
            const float xv = c == 0 ? v[j].x : c == 1 ? v[j].y
                           : c == 2 ? v[j].z : v[j].w;
            acc[j][0] = fmaf(xv, b0.x, acc[j][0]);
            acc[j][1] = fmaf(xv, b0.y, acc[j][1]);
            acc[j][2] = fmaf(xv, b0.z, acc[j][2]);
            acc[j][3] = fmaf(xv, b0.w, acc[j][3]);
            acc[j][4] = fmaf(xv, b1.x, acc[j][4]);
            acc[j][5] = fmaf(xv, b1.y, acc[j][5]);
            acc[j][6] = fmaf(xv, b1.z, acc[j][6]);
            acc[j][7] = fmaf(xv, b1.w, acc[j][7]);
          }
        }
      }
    }
  }

  const int oh = oh0 + pr;
  if (oh >= s.Ho) return;
  const long long M = static_cast<long long>(s.N) * s.Ho * s.Wo;
#pragma unroll
  for (int j = 0; j < PW; ++j) {
    const int ow = ow0 + j;
    if (ow >= s.Wo) continue;
    const long long m = (static_cast<long long>(n) * s.Ho + oh) * s.Wo + ow;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int co = co0 + cg * 4 + (c & 3) + (c >> 2) * 32;
      if (co >= s.Cout) continue;
      if (a.G == 1)
        out[m * s.Cout + co] = conv::from_f32<T>(acc[j][c]);
      else
        ws[(z * M + m) * s.Cout + co] = acc[j][c];
    }
  }
}

Plan make_plan(const conv::Shape& s) {
  Plan p{};
  p.WR = (PH - 1) * s.stride + s.KH;
  p.WC = (PW - 1) * s.stride + s.KW;
  const int ntaps = s.KH * s.KW;
  auto pitch = [&](int ct) {
    const int rp = p.WC * ct;
    return rp + ((4 - rp % 32) + 32) % 32;
  };
  auto fit = [&](int ct, int budget) {   // taps per step within budget
    const long long win = 4LL * p.WR * pitch(ct);
    return static_cast<int>((budget - win) / (4LL * ct * TCO));
  };
  p.CT = 8;
  if (s.Cin <= 4 || fit(8, BUF_BYTES) < ntaps) p.CT = 4;
  p.taps = fit(p.CT, BUF_BYTES);
  if (p.taps < ntaps) p.taps = fit(p.CT, conv::SMEM_LIMIT / STAGES);
  p.taps = p.taps < ntaps ? p.taps : ntaps;
  p.RP = pitch(p.CT);
  p.n_ct = conv::ceil_div(s.Cin, p.CT);
  p.patches_h = conv::ceil_div(s.Ho, PH);
  p.patches_w = conv::ceil_div(s.Wo, PW);
  p.cout_tiles = conv::ceil_div(s.Cout, TCO);
  const long long tiles =
      static_cast<long long>(s.N) * p.patches_h * p.patches_w * p.cout_tiles;
  p.buf_floats = static_cast<size_t>(p.WR) * p.RP +
                 static_cast<size_t>(p.CT) * (p.taps > 0 ? p.taps : 0) * TCO;
  p.smem = STAGES * sizeof(float) * p.buf_floats;
  p.sms = conv::sm_count();
  if (p.taps < 1 || p.smem > conv::SMEM_LIMIT || p.sms < 1) return p;
  p.resident = conv::resident_blocks(
      reinterpret_cast<const void*>(&sconv_od_kernel<float>),
      reinterpret_cast<const void*>(&sconv_od_kernel<__nv_bfloat16>),
      THREADS, p.smem);
  // G: the fewest channel tiles on the busiest SM (conv::split_count)
  p.G = conv::split_count(tiles, p.n_ct, p.resident, p.sms);
  return p;
}

Plan plan(const conv::Shape& s) { return conv::memoized(s, make_plan); }

bool takes(const Plan& p) {
  return p.resident >= 1 && p.G >= 1;
}

template <typename T>
int launch(const void* x, const void* w, void* out, void* ws,
           long long ws_floats, const conv::Shape& s, cudaStream_t stream) {
  const Plan p = plan(s);
  if (!takes(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.G > 1 && (ws == nullptr || ws_floats < conv::split_floats(s, p.G)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto al = [](const void* ptr) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  };
  const Args a{s, p.CT, p.taps, p.WR, p.WC, p.RP, p.n_ct, p.G, p.patches_h,
               p.patches_w, static_cast<int>(p.buf_floats),
               s.Cin % 4 == 0 && al(x),
               !al(w) ? 1 : s.Cout % 4 == 0 ? 4 : s.Cout % 2 == 0 ? 2 : 1};
  const long long blocks =
      static_cast<long long>(s.N) * p.patches_h * p.patches_w;
  if (blocks > 0x7fffffffLL || p.cout_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), p.cout_tiles, p.G);
  sconv_od_kernel<T><<<grid, THREADS, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<float*>(ws), a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.G == 1) return static_cast<int>(e);
  const long long count = static_cast<long long>(s.N) * s.Ho * s.Wo * s.Cout;
  return static_cast<int>(conv::launch_sum_splits(
      static_cast<const float*>(ws), static_cast<T*>(out), count, p.G, p.sms,
      stream));
}

}  // namespace

extern "C" {

const char* sconv_od_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of splits G of the Cin chain for this shape (1: no split).
// 0 for a shape the kernel does not take.
int sconv_od_splits(int N, int H, int W, int Cin, int KH, int KW, int Cout,
                    int stride) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return 0;
  const Plan p = plan(s);
  return takes(p) ? p.G : 0;
}

// Floats of the fp32 workspace launch needs for this shape (0: none; -1
// for a shape the kernel does not take).
long long sconv_od_workspace(int N, int H, int W, int Cin, int KH, int KW,
                            int Cout, int stride) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return -1;
  const Plan p = plan(s);
  return takes(p) ? conv::split_floats(s, p.G) : -1;
}

// The plan for this shape as text into buf (len bytes); returns G as
// sconv_od_splits does.
int sconv_od_describe(int N, int H, int W, int Cin, int KH, int KW, int Cout,
                      int stride, char* buf, int len) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return 0;
  const Plan p = plan(s);
  snprintf(buf, len, "patch %dx%d x %d Cout, %d threads, %d channels x %d "
           "taps a step, %d resident by occupancy (the split rule counts at "
           "most %d), %d SMs, G = %d", PH, PW, TCO, THREADS, p.CT, p.taps,
           p.resident, conv::MAX_RESIDENT, p.sms, p.G);
  return takes(p) ? p.G : 0;
}

// x, w, out: device pointers (fp32, or bf16 when bf16 != 0); ws: an fp32
// workspace of ws_floats floats, at least sconv_od_workspace(...) (unused
// when that is 0; a shorter one is refused).  Launches on `stream` (two
// kernels when G > 1) and returns the launches' CUDA error code (0 on
// success).
int sconv_od_launch(const void* x, const void* w, void* out, void* ws,
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
