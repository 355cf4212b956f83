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
// What keeps it SconvIC here: one block owns one band of ROW_TILE = 8
// output rows (the JAX wrapper's row_tile; SSconv: part of a 2D
// convolution), cut into column tiles of at most 16 output columns (4 for
// a small conv, below) and tiles of TCO = 64 output channels.  It stages the band's halo
// window - (rows - 1) * s + KH input rows by (cols - 1) * s + KW columns -
// into shared memory and reads it at the KH x KW shifted offsets (IP, the
// shift register of the PE array); no im2col row is ever built.  The
// outputs are the stationary operand (CR): each thread holds 8 pixels (2
// in a small conv) x 8 output channels in registers for its whole walk
// over channels and taps, and writes them once.
//
// Bound on the H100: FLOPs (2 * N*Ho*Wo * KH*KW*Cin * Cout) at 67 TFLOP/s
// fp32 against the bytes of x, w and out at 3.35 TB/s; the path's large
// layers are bound by the FLOPs (YOLO's 3x3 409 -> 819 at 13 x 13: 0.0152
// ms; SSD's 435 -> 870 at 32 x 32: 0.104 ms).  What held the first kernel
// (8 x 16 pixels x 32 Cout a block, 4 x 4 a thread, the whole chunk's
// window copied and waited for before any multiply) far from it, and what
// this design does:
//  * too few blocks (52 at YOLO's layer on 132 SMs): the Cin walk is split
//    over gridDim.z into G contiguous runs of channel tiles by the
//    busiest-SM rule (conv::split_count, plan() below, a function of the
//    shape alone), with the residency the kernel's registers and shared
//    memory allow; the splits write an fp32 workspace that conv::sum_splits
//    adds in split order (no atomics: two calls, the same bits).  YOLO's
//    layer: 2 bands x 13 Cout tiles = 26 tiles, G = 15 (3 blocks an SM);
//    SSD's: 4 bands x 2 column tiles x 14 = 112, G = 3;
//  * no copy overlapping compute: window and taps go by cp.async into two
//    buffers, so step i+1's copies are in flight while step i multiplies.
//    A warp copies whole channel runs (lanes along the channels, 16 bytes
//    a lane where Cin keeps rows 16-byte aligned, else 4), and weight rows
//    go by 16-, 8- or 4-byte copies as Cout's alignment allows.  4-byte
//    copies of the window's unaligned rows (Cin 409, 435) took about a
//    quarter of SSD's layer, so a large conv with Cin not a multiple of 4
//    first copies x once into the workspace with its channel rows padded
//    to a multiple of 4 (conv::pad_channels, a third launch) and stages the
//    window from there by 16-byte copies;
//  * 4 scalar window loads and one float4 load per 16 FMAs, in a channel
//    loop bounded at run time: the window is [row][col][channel] (rows
//    padded to 4 mod 32 floats, so the pitch keeps float4 alignment at any
//    stride), the taps are [tap][channel][Cout] (so a tap's channel
//    offsets are constants), the channel tile CT (8, or 4 where 8 channels
//    of window and taps do not fit a buffer) is a template parameter, and
//    a (tap, 4 channels) step is 8 float4 window loads and 8 float4 weight
//    loads for 256 FMAs;
//  * computing 16 columns of a 13-wide band: a block's rows x cols output
//    pixels are numbered row by row and dealt to 16 slots of 8 pixels, so
//    a 13-wide band fills 13 slots; slots with no pixel (whole warps in a
//    narrow or ragged tile) skip the multiplies;
//  * a small conv (under conv::MIN_SPLIT_MACS, one launch, G = 1) is
//    bound by each thread's chain of FMAs, not by the card's rate: at the
//    width-0.1 pools' 2 x 2 outputs one slot of 8 pixels did all of a
//    block's work.  There a slot holds 2 pixels and a tile at most 8 x 4
//    of them: a quarter of the chain, and up to four times the blocks.
// A step is one channel tile and, for kernels too large for one buffer
// (GOTURN's 11 x 11), a chunk of taps with its window staged again.
// Channels past Cin are zero in both operands and add exactly nothing;
// slots past the tile's pixels compute on stale window entries and are
// never stored.
//
// bf16 inputs are widened as they are staged (through a register: cp.async
// cannot widen; or by the padding pass); the output is rounded once.  No
// TF32: the reference tolerance is 1e-4.

#include <cstdio>

#include "conv_common.cuh"

namespace {

constexpr int ROW_TILE = 8;          // output rows a band
constexpr int SLOTS = 16;            // pixel slots a block
// PX output pixels a thread (a slot): 8 for the convs the plan may
// split, 2 for the small ones (conv::MIN_SPLIT_MACS); a tile is then at
// most TW(PX) = 16 or 4 output columns
constexpr int TW(int px) { return SLOTS * px / ROW_TILE; }
constexpr int TCO = 64;              // output channels a block
constexpr int THREADS = SLOTS * 8;   // a slot x 8 groups of 4 + 4 channels
constexpr int BUF_BYTES = 40 * 1024; // one buffer's target (window + taps)
constexpr int STAGES = 2;            // step i+1 copies while step i runs

struct Plan {
  int px;      // output pixels a thread: 8 or 2
  int tw;      // output columns a tile (the last one may be narrower)
  int CT;      // channels a step (8 or 4)
  int taps;    // taps a step (all of KH*KW unless they do not fit)
  int WR, WC;  // window rows and columns of a full tile
  int RP;      // window row pitch in floats (= 4 mod 32)
  int n_ct, chunks, G;
  int bands, col_tiles, cout_tiles;
  int resident;  // blocks an SM holds at once (fp32 kernel, occupancy)
  int sms;
  bool pad;    // stage the window from a copy of x padded to cs channels
  int cs;
  size_t buf_floats, smem;
};

struct Args {
  conv::Shape s;
  int tw, taps, RP, n_ct, chunks, G, bands, col_tiles;
  int win_floats, buf_floats;
  int pad;     // the window comes from x's padded copy
  int cs;      // channels a row of the window's source: Cin, or Cin padded
  int vec_x;   // 16-byte copies of x's channel rows allowed
  int vec_w;   // floats a copy of w's Cout rows may take: 4, 2 or 1
};

// Stage the window of one channel tile (channels c0 .. c0+CT-1) of a
// tile's band: wr x wc pixels, V floats a copy (T = float when V == 4),
// from x or its padded copy (rows of a.cs channels).  Lanes run along the
// channels, so a warp copies whole channel runs; a thread's channel is
// fixed and its pixel advances by counters.
template <int CT, int V, typename T>
__device__ __forceinline__ void stage_window(float* win,
                                             const T* __restrict__ x,
                                             const Args& a, long long row0,
                                             int wr, int wc, int c0) {
  const int W = a.s.W;
  constexpr int L = CT / V;            // copies a pixel
  constexpr int PSTEP = THREADS / L;   // pixels a pass
  const int q = (threadIdx.x % L) * V;
  const bool in = c0 + q < a.cs;
  int pr = 0, pc = threadIdx.x / L;
  for (; pc >= wc; pc -= wc) ++pr;
  for (; pr < wr;) {
    const T* src = x + (in ? (row0 + pr * static_cast<long long>(W) + pc) *
                                 a.cs + c0 + q : 0);
    float* dst = win + pr * a.RP + pc * CT + q;
    if (V == 4)
      conv::cp16(dst, reinterpret_cast<const float*>(src), in ? 16 : 0);
    else
      conv::put(dst, src, in);
    for (pc += PSTEP; pc >= wc; pc -= wc) ++pr;
  }
}

// Stage the taps [nt][CT] x TCO of one step, V floats a copy (T = float
// when V > 1): row r = t * CT + ci, so a tap's channel offsets are
// constants in the multiply loop.
template <int CT, int V, typename T>
__device__ __forceinline__ void stage_taps(float* tap,
                                           const T* __restrict__ w,
                                           const Args& a, int co0, int c0,
                                           int t0, int nt) {
  const conv::Shape& s = a.s;
  constexpr int Q = TCO / V;          // copies a row
  constexpr int RSTEP = THREADS / Q;  // rows a pass
  const int cv = min(CT, s.Cin - c0);
  const int qv = threadIdx.x % Q;
  const int co = co0 + V * qv;
  for (int r = threadIdx.x / Q; r < CT * nt; r += RSTEP) {
    const int t = r / CT, ci = r % CT;
    const bool in = ci < cv && co < s.Cout;
    const T* src = w + (in ? (static_cast<long long>(t0 + t) * s.Cin + c0 +
                              ci) * s.Cout + co : 0);
    float* dst = tap + r * TCO + V * qv;
    if (V == 4)
      conv::cp16(dst, reinterpret_cast<const float*>(src), in ? 16 : 0);
    else if (V == 2)
      conv::cp8(dst, reinterpret_cast<const float*>(src), in ? 8 : 0);
    else
      conv::put(dst, src, in);
  }
}

template <int CT, int PX, typename T>
__global__ void __launch_bounds__(THREADS)
sconv_ic_kernel(const T* __restrict__ x, const float* __restrict__ xp,
                const T* __restrict__ w, T* __restrict__ out,
                float* __restrict__ ws, Args a) {
  extern __shared__ __align__(16) float smem[];   // 2 x [window | taps]
  const conv::Shape& s = a.s;
  const int tid = threadIdx.x;
  int b = blockIdx.x;
  const int col_tile = b % a.col_tiles;
  b /= a.col_tiles;
  const int band = b % a.bands;
  const int n = b / a.bands;
  const int oh0 = band * ROW_TILE, ow0 = col_tile * a.tw;
  const int rows = min(ROW_TILE, s.Ho - oh0);   // output rows of the band
  const int cols = min(a.tw, s.Wo - ow0);       // output columns of the tile
  const int npix = rows * cols;
  // the halo window these pixels read: always inside the ifmap
  const int wr = (rows - 1) * s.stride + s.KH;
  const int wc = (cols - 1) * s.stride + s.KW;
  const long long row0 =
      (static_cast<long long>(n) * s.H + oh0 * s.stride) * s.W +
      ow0 * s.stride;
  const int co0 = blockIdx.y * TCO;
  const int z = blockIdx.z;
  const int ct_begin = static_cast<int>(static_cast<long long>(z) * a.n_ct /
                                        a.G);
  const int ct_end = static_cast<int>(static_cast<long long>(z + 1) *
                                      a.n_ct / a.G);
  const int ntaps = s.KH * s.KW;
  const int steps = (ct_end - ct_begin) * a.chunks;

  // slot's pixels slot * PX + j, numbered row by row over rows x cols
  const int cg = tid % 8;    // channels co0 + cg*4 + {0..3} and + 32
  const int slot = tid / 8;
  const bool active = slot * PX < npix;
  int woff[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int q = slot * PX + j;
    const int r = q / cols, c = q - r * cols;
    woff[j] = q < npix ? (r * a.RP + c * CT) * s.stride : 0;
  }
  float acc[PX][8];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;

  auto step_at = [&](int st, float* buf) {
    const int c0 = (ct_begin + st / a.chunks) * CT;
    const int t0 = (st % a.chunks) * a.taps;
    const int nt = min(a.taps, ntaps - t0);
    if (a.pad)
      stage_window<CT, 4>(buf, xp, a, row0, wr, wc, c0);
    else if (sizeof(T) == 4 && a.vec_x)
      stage_window<CT, 4>(buf, reinterpret_cast<const float*>(x), a, row0,
                          wr, wc, c0);
    else
      stage_window<CT, 1>(buf, x, a, row0, wr, wc, c0);
    float* tap = buf + a.win_floats;
    if (sizeof(T) == 4 && a.vec_w == 4)
      stage_taps<CT, 4>(tap, reinterpret_cast<const float*>(w), a, co0, c0,
                        t0, nt);
    else if (sizeof(T) == 4 && a.vec_w == 2)
      stage_taps<CT, 2>(tap, reinterpret_cast<const float*>(w), a, co0, c0,
                        t0, nt);
    else
      stage_taps<CT, 1>(tap, w, a, co0, c0, t0, nt);
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) step_at(i, smem + i * a.buf_floats);
    conv::commit();
  }
  for (int st = 0; st < steps; ++st) {
    // step st has landed for this thread, then for every thread; the
    // buffer staged next was consumed at step st - 1
    conv::wait_pending<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < steps)
      step_at(st + STAGES - 1,
              smem + ((st + STAGES - 1) % STAGES) * a.buf_floats);
    conv::commit();
    if (!active) continue;
    const float* win = smem + (st % STAGES) * a.buf_floats;
    const float* tap = win + a.win_floats;
    const int t0 = (st % a.chunks) * a.taps;
    const int nt = min(a.taps, ntaps - t0);
    for (int t = 0; t < nt; ++t) {
      const int di = (t0 + t) / s.KW, dj = (t0 + t) - di * s.KW;
      const float* wp = win + di * a.RP + dj * CT;
      const float* tp = tap + t * CT * TCO + cg * 4;
#pragma unroll
      for (int c4 = 0; c4 < CT; c4 += 4) {
        float4 v[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j)
          v[j] = *reinterpret_cast<const float4*>(wp + woff[j] + c4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* tc = tp + (c4 + c) * TCO;
          const float4 b0 = *reinterpret_cast<const float4*>(tc);
          const float4 b1 = *reinterpret_cast<const float4*>(tc + 32);
#pragma unroll
          for (int j = 0; j < PX; ++j) {
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

  if (!active) return;
  const long long M = static_cast<long long>(s.N) * s.Ho * s.Wo;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int q = slot * PX + j;
    if (q >= npix) continue;
    const int r = q / cols, c = q - r * cols;
    const long long m =
        (static_cast<long long>(n) * s.Ho + oh0 + r) * s.Wo + ow0 + c;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int co = co0 + cg * 4 + (k & 3) + (k >> 2) * 32;
      if (co >= s.Cout) continue;
      if (a.G == 1)
        out[m * s.Cout + co] = conv::from_f32<T>(acc[j][k]);
      else
        ws[(z * M + m) * s.Cout + co] = acc[j][k];
    }
  }
}

template <int CT, int PX>
const void* kernel_of(bool bf16) {
  return bf16 ? reinterpret_cast<const void*>(
                    &sconv_ic_kernel<CT, PX, __nv_bfloat16>)
              : reinterpret_cast<const void*>(
                    &sconv_ic_kernel<CT, PX, float>);
}

const void* kernel_of(int CT, int px, bool bf16) {
  if (px == 8) return CT == 8 ? kernel_of<8, 8>(bf16) : kernel_of<4, 8>(bf16);
  return CT == 8 ? kernel_of<8, 2>(bf16) : kernel_of<4, 2>(bf16);
}

// The tile, channel tile, taps a step and split count for a shape.  A
// function of the shape and the device; bf16 runs take the fp32 kernel's
// plan.  Below conv::MIN_SPLIT_MACS: 2 pixels a thread in tiles of at most
// 8 x 4 pixels, one launch (each thread's FMA chain a quarter of the
// 8-pixel slots', up to four times the blocks); otherwise 8 pixels a
// thread in tiles of up to 8 x 16 and the busiest-SM split.
Plan make_plan(const conv::Shape& s) {
  Plan p{};
  p.sms = conv::sm_count();
  const bool small = conv::macs(s) < conv::MIN_SPLIT_MACS;
  p.px = small ? 2 : 8;
  p.tw = s.Wo < TW(p.px) ? s.Wo : TW(p.px);
  p.WR = (ROW_TILE - 1) * s.stride + s.KH;
  p.WC = (p.tw - 1) * s.stride + s.KW;
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
  p.chunks = p.taps > 0 ? conv::ceil_div(ntaps, p.taps) : 0;
  p.bands = conv::ceil_div(s.Ho, ROW_TILE);
  p.col_tiles = conv::ceil_div(s.Wo, p.tw);
  p.cout_tiles = conv::ceil_div(s.Cout, TCO);
  // x's channel rows unaligned (Cin 409, 435): copy x once, padded to a
  // multiple of 4 channels, so the window goes by 16-byte copies (4-byte
  // copies of unaligned rows cost a fifth of SSD's layer); only where a
  // second launch pays (MIN_SPLIT_MACS)
  p.pad = s.Cin % 4 != 0 && !small;
  p.cs = p.pad ? (s.Cin + 3) / 4 * 4 : s.Cin;
  p.buf_floats = static_cast<size_t>(p.WR) * p.RP +
                 static_cast<size_t>(p.CT) * (p.taps > 0 ? p.taps : 0) * TCO;
  p.smem = STAGES * sizeof(float) * p.buf_floats;
  if (p.taps < 1 || p.smem > conv::SMEM_LIMIT || p.sms < 1) return p;
  p.resident = conv::resident_blocks(kernel_of(p.CT, p.px, false),
                                     kernel_of(p.CT, p.px, true), THREADS,
                                     p.smem);
  const long long tiles = static_cast<long long>(s.N) * p.bands *
                          p.col_tiles * p.cout_tiles;
  p.G = small ? 1 : conv::split_count(tiles, p.n_ct, p.resident, p.sms);
  return p;
}

Plan plan(const conv::Shape& s) { return conv::memoized(s, make_plan); }

bool takes(const Plan& p) {
  return p.resident >= 1 && p.cout_tiles <= 65535 && p.G <= 65535;
}

// Floats of the fp32 workspace of plan p: the splits' partial sums, then
// x's padded copy.
long long workspace_floats(const conv::Shape& s, const Plan& p) {
  return conv::split_floats(s, p.G) +
         (p.pad ? static_cast<long long>(s.N) * s.H * s.W * p.cs : 0);
}

template <int CT, int PX, typename T>
void launch_kernel(const dim3& grid, const Plan& p, const T* x,
                   const float* xp, const T* w, T* out, float* ws,
                   const Args& a, cudaStream_t stream) {
  sconv_ic_kernel<CT, PX, T><<<grid, THREADS, p.smem, stream>>>(x, xp, w,
                                                                out, ws, a);
}

template <typename T>
int launch(const void* x, const void* w, void* out, void* ws,
           long long ws_floats, const conv::Shape& s, cudaStream_t stream) {
  const Plan p = plan(s);
  if (!takes(p)) return static_cast<int>(cudaErrorInvalidValue);
  const long long need = workspace_floats(s, p);
  if (need > 0 && (ws == nullptr || ws_floats < need))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto al = [](const void* ptr) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  };
  const Args a{s, p.tw, p.taps, p.RP, p.n_ct, p.chunks, p.G, p.bands,
               p.col_tiles, p.WR * p.RP, static_cast<int>(p.buf_floats),
               p.pad, p.cs, s.Cin % 4 == 0 && al(x),
               !al(w) ? 1 : s.Cout % 4 == 0 ? 4 : s.Cout % 2 == 0 ? 2 : 1};
  const long long blocks =
      static_cast<long long>(s.N) * p.bands * p.col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), p.cout_tiles, p.G);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  float* wst = static_cast<float*>(ws);
  float* xp = wst + conv::split_floats(s, p.G);   // after the splits
  if (p.pad) {
    const cudaError_t e = conv::launch_pad_channels(
        xt, xp, static_cast<long long>(s.N) * s.H * s.W, s.Cin, p.cs, p.sms,
        stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.px == 8 && p.CT == 8)
    launch_kernel<8, 8>(grid, p, xt, xp, wt, ot, wst, a, stream);
  else if (p.px == 8)
    launch_kernel<4, 8>(grid, p, xt, xp, wt, ot, wst, a, stream);
  else if (p.CT == 8)
    launch_kernel<8, 2>(grid, p, xt, xp, wt, ot, wst, a, stream);
  else
    launch_kernel<4, 2>(grid, p, xt, xp, wt, ot, wst, a, stream);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.G == 1) return static_cast<int>(e);
  const long long count = static_cast<long long>(s.N) * s.Ho * s.Wo * s.Cout;
  return static_cast<int>(
      conv::launch_sum_splits(wst, ot, count, p.G, p.sms, stream));
}

}  // namespace

extern "C" {

const char* sconv_ic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of splits G of the Cin walk for this shape (1: no split).  0
// for a shape the kernel does not take.
int sconv_ic_splits(int N, int H, int W, int Cin, int KH, int KW, int Cout,
                    int stride) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return 0;
  const Plan p = plan(s);
  return takes(p) ? p.G : 0;
}

// Floats of the fp32 workspace launch needs for this shape: the splits'
// partial sums, then x's padded copy (0: none; -1 for a shape the kernel
// does not take).
long long sconv_ic_workspace(int N, int H, int W, int Cin, int KH, int KW,
                             int Cout, int stride) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return -1;
  const Plan p = plan(s);
  return takes(p) ? workspace_floats(s, p) : -1;
}

// The plan for this shape as text into buf (len bytes); returns G as
// sconv_ic_splits does.
int sconv_ic_describe(int N, int H, int W, int Cin, int KH, int KW, int Cout,
                      int stride, char* buf, int len) {
  const conv::Shape s = conv::make_shape(N, H, W, Cin, KH, KW, Cout, stride);
  if (!conv::valid(s)) return 0;
  const Plan p = plan(s);
  snprintf(buf, len, "band %d x %d x %d Cout, %d px x 8 Cout a thread, %d "
           "threads, %d bands x %d column tiles x %d Cout tiles, %d "
           "channels x %d taps a step%s, %d resident by occupancy (the "
           "split rule counts at most %d), %d SMs, G = %d", ROW_TILE, p.tw,
           TCO, p.px, THREADS, p.bands, p.col_tiles, p.cout_tiles, p.CT,
           p.taps, p.pad ? ", x padded to 4-channel rows" : "", p.resident,
           conv::MAX_RESIDENT, p.sms, p.G);
  return takes(p) ? p.G : 0;
}

// x, w, out: device pointers (fp32, or bf16 when bf16 != 0); ws: an fp32
// workspace of ws_floats floats, at least sconv_ic_workspace(...) (unused
// when that is 0; a shorter one is refused).  Launches on `stream` (up to
// three kernels: the padded copy of x, the convolution, the sum of the
// splits) and returns the launches' CUDA error code (0 on success).
int sconv_ic_launch(const void* x, const void* w, void* out, void* ws,
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
