// Mamba-2 SSD chunked scan for Hopper (sm_90a): a chunk-parallel,
// state-passing scan in three kernels, bf16 products on the tensor cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/ssd_scan/kernel.py  _kernel (body, line 23),
//   launched by ssd_scan_flat through pl.pallas_call (line 81).
// What the TPU kernel was: a grid (B*H, chunks) with the chunk axis
// sequential, the [N, P] state carried in VMEM scratch from chunk to
// chunk, every product of a chunk an MXU matmul.
//
// Per chunk of Q rows, with a_cum the chunk's running sum of a:
//   y[i]  = sum_{j <= i} (C[i].B[j]) exp(a_cum[i] - a_cum[j]) u[j]    (diagonal)
//         + exp(a_cum[i]) C[i] S_prev                                  (off-diagonal)
//   S_new = exp(a_cum[Q-1]) S_prev + sum_j B[j]^T exp(a_cum[Q-1] - a_cum[j]) u[j]
// and the final state is returned.  B and C are shared by the H heads of a
// batch row.
//
// What bounds the card: at B 4, S 1024, H 24, P 64, N 128, chunk 256 the
// function needs 5.0 GFLOP (C.B^T over the causal pairs once per batch row;
// per head the masked product with u, the chunk state and C S_prev): 0.005
// ms at the bf16 tensor-core peak, 0.074 ms at the fp32 CUDA-core rate;
// its bytes (u, y in bf16, a, B, C, the fp32 state: 30.8 MB) take 0.0092 ms
// at 3.35 TB/s, so the bytes bound it.  The first port walked the chunks
// serially in one block per (batch, head), 96 blocks on 132 SMs, with fp32
// FMAs on CUDA cores and C.B^T recomputed for every head (0.74 ms).
//
// Design: the state-passing split, so the grid scales with B x chunks x H.
//  1. chunk_state (grid B*chunks x H): a_cum of the chunk (written to the
//     workspace) and the chunk's own state s_c = B^T (decay_end o u),
//     decay_end[j] = exp(a_cum[Q-1] - a_cum[j]).
//  2. carry (grid B*H x N*P/256): S_c = exp(a_cum_c[Q-1]) S_{c-1} + s_c,
//     sequential over chunks, one thread per state element; writes each
//     chunk's S_prev and the final state.
//  3. chunk_out (grid B*chunks*query tiles*head groups): a block owns 64
//     query rows of one (batch, chunk) and a group of heads.  It computes
//     the causal score tiles C_i.B_j^T once and keeps them in shared memory
//     (up to 4 key tiles: a whole 256-row chunk), then for each head of the
//     group adds y = exp(a_cum[i]) (C_i S_prev) + sum_j (scores o L) u_j.
//     Its 8 warps each own 16 query rows and half of each reduction (state
//     rows, keys), so a warp masks and splits only its own scores.  The
//     diagonal term is computed here, beside the off-diagonal one, so y is
//     rounded once and no fp32 y_diag round-trips device memory.
// A call runs the three kernels, one launch of each, on one stream.  The
// head group is the fewest heads that still give about three blocks per SM
// (5 at mamba2's 1,491-token serving wave, 4 at the timing shape; targets
// of 1, 2 and 4 blocks per SM measured slower), so the score tiles of a
// (batch, chunk) query tile are computed once per group; blocks of the last
// query tiles, which have the most key tiles, are launched first.
//
// Tensor cores (bf16 path): mma.sync m16n8k16 bf16 -> fp32.  C.B^T takes
// the exact bf16 inputs.  An operand the kernel computes is never rounded
// once to bf16: the masked scores (scores o L), decay_end o u and the fp32
// S_prev go to the tensor cores as a bf16 pair hi + lo (lo = the bf16
// rounding of x - hi, 2^-16 of x), two products each, as flash attention
// does with P.  exp(a_cum[i]) multiplies the C S_prev product's output
// rows.  Tiles are staged by 16-byte cp.async (rows padded by 16 bytes so
// ldmatrix reads no bank twice), u and B double-buffered.  The fp32 path
// keeps fp32 FMAs on CUDA cores (TF32 would break its 1e-4 gate) in the
// same three kernels; its chunk_out recomputes the score tile per head.
//
// Ragged shapes: rows past S or past the chunk load as u = 0, a = 0,
// B = C = 0 and are never stored: zero u adds nothing and zero a decays
// nothing, so the state is the same as at S.  Chunks need not be
// multiples of 64 either: a tile's rows past the chunk are masked the same
// way.  Workspace (fp32 words, allocated by the caller; the launch refuses
// a shorter one): a_cum B*H*chunks*Qp, chunk states and S_prev
// B*H*chunks*N*P8 each (Qp = Q rounded up to 64, P8 = P to 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int T = 64;            // rows of a query or key tile
constexpr int PMAX = 64;         // head dim P the tiles are compiled for
constexpr int NMAX = 128;        // state dim N the tiles are compiled for
constexpr int QMAX = 4096;       // longest chunk
constexpr int LDN = NMAX + 8;    // bf16 row pitch of C / B tiles (272 bytes)
constexpr int LDP = PMAX + 8;    // bf16 row pitch of u / W / S_prev tiles
constexpr int KC = 4;            // key tiles of scores kept per block
constexpr int TC_THREADS = 256;  // 8 warps
constexpr int F_THREADS = 256;   // fp32 CUDA-core kernels
constexpr int CARRY_THREADS = 256;
constexpr int MAX_DEVICES = 64;

struct Shape {
  int B, S, H, P, N, Q;
  int nc, nqt, Qp, P8;  // chunks, query tiles a chunk, padded Q, padded P
  int HG, G;            // heads a group, groups
};

struct Work {
  float* acum;    // [B][H][nc][Qp]
  float* schunk;  // [B][H][nc][N][P]
  float* sprev;   // fp32 [B][H][nc][N][P], or bf16 hi then lo [B][H][nc][N][P8]
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy; src_bytes 0 fills the chunk with zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x as a bf16 pair hi + lo (packed two values a word: lo half = x0)
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                                 x1 - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

template <typename U> __device__ __forceinline__ U from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// A [ROWS][cols] tile of U at pitch ld: row r is src + (row0 + r) * stride,
// element (r, c) = src[...] for row0 + r < nrows and c < ncols, else 0.
// 16-byte cp.async where the rows allow it (vec), else scalar copies.
template <typename U, int NT>
__device__ __forceinline__ void stage(U* tile, int ld, int cols, int rows,
                                      const U* src, long long stride,
                                      int row0, int nrows, int ncols,
                                      bool vec) {
  constexpr int E = 16 / sizeof(U);
  if (vec) {
    const int cpr = cols / E;
    for (int idx = threadIdx.x; idx < rows * cpr; idx += NT) {
      const int r = idx / cpr, c = (idx - r * cpr) * E;
      const bool in = row0 + r < nrows && c < ncols;
      const U* p = in ? src + (row0 + r) * stride + c : src;
      cp16(tile + r * ld + c, p, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += NT) {
      const int r = idx / cols, c = idx - r * cols;
      const bool in = row0 + r < nrows && c < ncols;
      tile[r * ld + c] = in ? src[(row0 + r) * stride + c] : from_f32<U>(0.f);
    }
  }
}

// out[r] = sum_{r' <= r} a[r'] over r < Qp (a = 0 at r >= valid), by the
// NT threads of the block; red holds NT / 32 + 1 floats.
template <int NT>
__device__ void chunk_cumsum(const float* a, long long stride, int valid,
                             int Qp, float* out, float* red) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (Qp + NT - 1) / NT;
  const int lo = min(tid * per, Qp), hi = min(lo + per, Qp);
  float run = 0.f;
  for (int r = lo; r < hi; ++r) {
    run += r < valid ? a[r * stride] : 0.f;
    out[r] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float before = incl - run;
  for (int w = 0; w < warp; ++w) before += red[w];
  for (int r = lo; r < hi; ++r) out[r] += before;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Pass 1 (bf16): a_cum and the chunk state of one (batch, chunk, head).
// Warp w owns state rows n in [16w, 16w + 16): 8 m16n8 tiles over P.
// ---------------------------------------------------------------------------
size_t state_tc_smem(int Qp) {
  return sizeof(bf16) * (2 * T * LDN + 2 * T * LDP + 2 * T * LDP) +
         sizeof(float) * (Qp + 8);
}

__global__ void __launch_bounds__(TC_THREADS, 3)
chunk_state_tc(const bf16* __restrict__ u, const float* __restrict__ a,
               const bf16* __restrict__ Bm, Work w, Shape s, int vecB,
               int vecU) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);   // [2][T][LDN]
  bf16* Us = Bs + 2 * T * LDN;                     // [2][T][LDP]
  bf16* Wh = Us + 2 * T * LDP;                     // [T][LDP]
  bf16* Wl = Wh + T * LDP;
  float* acum = reinterpret_cast<float*>(Wl + T * LDP);  // [Qp]
  float* red = acum + s.Qp;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int b = blockIdx.x / s.nc, c = blockIdx.x % s.nc, h = blockIdx.y;
  const int c0 = c * s.Q;
  const int valid = min(s.Q, s.S - c0);   // rows of this chunk inside S
  const long long bh = static_cast<long long>(b) * s.H + h;
  const bf16* Bb = Bm + (static_cast<long long>(b) * s.S + c0) * s.N;
  const bf16* ub = u + ((static_cast<long long>(b) * s.S + c0) * s.H + h) * s.P;
  const long long row_u = static_cast<long long>(s.H) * s.P;

  auto issue = [&](int jt) {
    const int buf = jt & 1;
    stage<bf16, TC_THREADS>(Bs + buf * T * LDN, LDN, NMAX, T, Bb, s.N, jt * T,
                            valid, s.N, vecB);
    stage<bf16, TC_THREADS>(Us + buf * T * LDP, LDP, PMAX, T, ub, row_u, jt * T,
                            valid, s.P, vecU);
    cp_commit();
  };
  issue(0);
  chunk_cumsum<TC_THREADS>(a + (static_cast<long long>(b) * s.S + c0) * s.H + h,
                           s.H, valid, s.Qp, acum, red);
  float* acum_w = w.acum + (bh * s.nc + c) * s.Qp;
  for (int r = tid; r < s.Qp; r += TC_THREADS) acum_w[r] = acum[r];
  const float a_last = acum[s.Q - 1];

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int jt = 0; jt < s.nqt; ++jt) {
    const int buf = jt & 1;
    if (jt + 1 < s.nqt) {
      issue(jt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // W = decay_end o u as a bf16 pair, one exp a row
    const bf16* ut = Us + buf * T * LDP;
    {
      const int r = tid / 4, p0 = (tid % 4) * (PMAX / 4);
      const float d = __expf(a_last - acum[jt * T + r]);
#pragma unroll
      for (int p = p0; p < p0 + PMAX / 4; p += 2) {
        const __nv_bfloat162 x =
            *reinterpret_cast<const __nv_bfloat162*>(&ut[r * LDP + p]);
        unsigned hi, lo;
        split2(d * __low2float(x), d * __high2float(x), hi, lo);
        *reinterpret_cast<unsigned*>(&Wh[r * LDP + p]) = hi;
        *reinterpret_cast<unsigned*>(&Wl[r * LDP + p]) = lo;
      }
    }
    __syncthreads();
    const bf16* bt = Bs + buf * T * LDN;
    const int mi = lane / 8;
#pragma unroll
    for (int ks = 0; ks < T / 16; ++ks) {
      const int k0 = ks * 16;
      unsigned af[4];   // A = B_j^T: rows n, k = j
      ldsm4t(af, bt + (k0 + (lane % 8) + (mi / 2) * 8) * LDN + warp * 16 +
                     (mi % 2) * 8);
#pragma unroll
      for (int np = 0; np < PMAX / 16; ++np) {
        const int off = (k0 + (lane % 8) + (mi % 2) * 8) * LDP + np * 16 +
                        (mi / 2) * 8;
        unsigned fh[4], fl[4];
        ldsm4t(fh, Wh + off);
        ldsm4t(fl, Wl + off);
        mma(acc[2 * np], af, fh[0], fh[1]);
        mma(acc[2 * np + 1], af, fh[2], fh[3]);
        mma(acc[2 * np], af, fl[0], fl[1]);
        mma(acc[2 * np + 1], af, fl[2], fl[3]);
      }
    }
    __syncthreads();   // buffers free for the next prefetch
  }

  float* out = w.schunk + (bh * s.nc + c) * s.N * s.P;
  const bool pairs = s.P % 2 == 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = warp * 16 + gid + hf * 8;
      const int p = nt * 8 + tig * 2;
      if (n >= s.N) continue;
      float* dst = out + n * s.P + p;
      if (pairs && p + 1 < s.P) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      } else {
        if (p < s.P) dst[0] = acc[nt][2 * hf];
        if (p + 1 < s.P) dst[1] = acc[nt][2 * hf + 1];
      }
    }
}

// ---------------------------------------------------------------------------
// Pass 1 (fp32): the same on CUDA cores.  Thread (tn, tp) owns state rows
// tn*8 .. +8 and columns tp*4 .. +4.
// ---------------------------------------------------------------------------
size_t state_f32_smem(int Qp) {
  return sizeof(float) * (T * NMAX + T * PMAX + Qp + 16);
}

__global__ void __launch_bounds__(F_THREADS)
chunk_state_f32(const float* __restrict__ u, const float* __restrict__ a,
                const float* __restrict__ Bm, Work w, Shape s, int vecB,
                int vecU) {
  extern __shared__ __align__(16) float smem_f[];
  float* Bs = smem_f;               // [T][NMAX]
  float* Us = Bs + T * NMAX;        // [T][PMAX]
  float* acum = Us + T * PMAX;      // [Qp]
  float* red = acum + s.Qp;
  const int tid = threadIdx.x;
  const int tn = tid / 16, tp = tid % 16;
  const int b = blockIdx.x / s.nc, c = blockIdx.x % s.nc, h = blockIdx.y;
  const int c0 = c * s.Q;
  const int valid = min(s.Q, s.S - c0);
  const long long bh = static_cast<long long>(b) * s.H + h;
  const float* Bb = Bm + (static_cast<long long>(b) * s.S + c0) * s.N;
  const float* ub = u + ((static_cast<long long>(b) * s.S + c0) * s.H + h) * s.P;
  const long long row_u = static_cast<long long>(s.H) * s.P;

  chunk_cumsum<F_THREADS>(a + (static_cast<long long>(b) * s.S + c0) * s.H + h,
                          s.H, valid, s.Qp, acum, red);
  float* acum_w = w.acum + (bh * s.nc + c) * s.Qp;
  for (int r = tid; r < s.Qp; r += F_THREADS) acum_w[r] = acum[r];
  const float a_last = acum[s.Q - 1];

  float st[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) st[nn][pp] = 0.f;
  for (int jt = 0; jt < s.nqt; ++jt) {
    stage<float, F_THREADS>(Bs, NMAX, NMAX, T, Bb, s.N, jt * T, valid, s.N,
                            vecB);
    stage<float, F_THREADS>(Us, PMAX, PMAX, T, ub, row_u, jt * T, valid, s.P,
                            vecU);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int idx = tid; idx < T * PMAX; idx += F_THREADS) {
      const int r = idx / PMAX;
      Us[idx] *= expf(a_last - acum[jt * T + r]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[j * NMAX + tn * 8]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[j * NMAX + tn * 8 + 4]);
      const float4 uv = *reinterpret_cast<const float4*>(&Us[j * PMAX + tp * 4]);
      const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float u4[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
          st[nn][pp] = fmaf(b8[nn], u4[pp], st[nn][pp]);
    }
    __syncthreads();
  }
  float* out = w.schunk + (bh * s.nc + c) * s.N * s.P;
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int n = tn * 8 + nn, p = tp * 4 + pp;
      if (n < s.N && p < s.P) out[n * s.P + p] = st[nn][pp];
    }
}

// ---------------------------------------------------------------------------
// Pass 2: the carry over chunks, one thread per (batch, head, n, p).
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(CARRY_THREADS)
carry(Work w, float* __restrict__ sfin, Shape s) {
  const int bh = blockIdx.x;
  const int W = BF16 ? s.P8 : s.P;   // row width of S_prev
  const int e = blockIdx.y * CARRY_THREADS + threadIdx.x;
  if (e >= s.N * W) return;
  const int n = e / W, p = e % W;
  const long long per_bh = static_cast<long long>(s.nc) * s.N * W;
  const long long half = static_cast<long long>(s.B) * s.H * per_bh;
  float S = 0.f;
  for (int c = 0; c < s.nc; ++c) {
    const long long at = bh * per_bh + static_cast<long long>(c) * s.N * W + e;
    if (BF16) {
      bf16* sp = reinterpret_cast<bf16*>(w.sprev);
      const bf16 hi = __float2bfloat16(S);
      sp[at] = hi;
      sp[half + at] = __float2bfloat16(S - __bfloat162float(hi));
    } else {
      w.sprev[at] = S;
    }
    if (p < s.P) {
      const float dec = expf(w.acum[(static_cast<long long>(bh) * s.nc + c) *
                                        s.Qp + s.Q - 1]);
      S = fmaf(dec, S,
               w.schunk[(static_cast<long long>(bh) * s.nc + c) * s.N * s.P +
                        n * s.P + p]);
    }
  }
  if (p < s.P) sfin[static_cast<long long>(bh) * s.N * s.P + n * s.P + p] = S;
}

// ---------------------------------------------------------------------------
// Pass 3 (bf16): y for 64 query rows of one (batch, chunk) and a group of
// heads.  Warp w owns query rows [16 (w % 4), +16) and half kh = w / 4 of
// each reduction: state rows [64 kh, +64) of C S_prev and keys [32 kh, +32)
// of every key tile, so each warp masks only its own scores; the two halves
// are added through shared memory once per head.  A (head, key tile) step
// prefetches the next step's u (and B) tile, and a head the next head's
// S_prev, by cp.async.
// ---------------------------------------------------------------------------
inline int score_slots(int nqt) {
  return nqt < KC ? nqt : KC;
}

size_t out_tc_smem(int nqt) {
  return sizeof(bf16) * (3 * T * LDN + 2 * T * LDP + 4 * NMAX * LDP) +
         sizeof(float) * (score_slots(nqt) + 1) * T * T;
}

__global__ void __launch_bounds__(TC_THREADS, 1)
chunk_out_tc(const bf16* __restrict__ u, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, bf16* __restrict__ y, Work w,
             Shape s, int vecB, int vecU) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);   // [T][LDN]
  bf16* Bs = Cs + T * LDN;                         // [2][T][LDN]
  bf16* Us = Bs + 2 * T * LDN;                     // [2][T][LDP]
  bf16* SP = Us + 2 * T * LDP;                     // [2][hi, lo][NMAX][LDP]
  // the halves' partial y [row group][e][lane], then the score tiles
  // [slot][row group][half][n-tile][e][lane], each in fragment order
  float* part = reinterpret_cast<float*>(SP + 4 * NMAX * LDP);
  float* cache = part + T * T;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4, mi = lane / 8;
  const int rg = warp % 4, kh = warp / 4;   // row group, reduction half
  // the last query tiles (the most key tiles) are launched first
  const int nbc = s.B * s.nc;
  const int it = s.nqt - 1 - blockIdx.x / (nbc * s.G);
  const int grp = blockIdx.x / nbc % s.G;
  const int bc = blockIdx.x % nbc;
  const int b = bc / s.nc, c = bc % s.nc;
  const int h0 = grp * s.HG, h1 = min(s.H, h0 + s.HG);
  const int c0 = c * s.Q;
  const int valid = min(s.Q, s.S - c0);
  const int i0 = it * T, qrow = rg * 16;
  // key tiles whose scores stay in shared memory; past them one scratch
  // slot takes a tile recomputed for every head
  const int cached = s.nqt <= KC ? s.nqt : KC - 1;
  const bf16* Bb = Bm + (static_cast<long long>(b) * s.S + c0) * s.N;
  const bf16* Cb = Cm + (static_cast<long long>(b) * s.S + c0) * s.N;
  const long long row_u = static_cast<long long>(s.H) * s.P;
  const long long half = static_cast<long long>(s.B) * s.H * s.nc * s.N * s.P8;
  const bf16* sp = reinterpret_cast<const bf16*>(w.sprev);
  auto u_of = [&](int h) {
    return u + ((static_cast<long long>(b) * s.S + c0) * s.H + h) * s.P;
  };
  auto acum_of = [&](int h) {
    return w.acum + ((static_cast<long long>(b) * s.H + h) * s.nc + c) * s.Qp;
  };
  auto need_B = [&](int h, int jt) { return h == h0 || jt >= cached; };
  auto stage_sp = [&](int h, int buf) {
    const bf16* src =
        sp + ((static_cast<long long>(b) * s.H + h) * s.nc + c) * s.N * s.P8;
    bf16* dst = SP + buf * 2 * NMAX * LDP;
    stage<bf16, TC_THREADS>(dst, LDP, PMAX, NMAX, src, s.P8, 0, s.N, s.P8, true);
    stage<bf16, TC_THREADS>(dst + NMAX * LDP, LDP, PMAX, NMAX, src + half, s.P8,
                            0, s.N, s.P8, true);
  };
  auto stage_step = [&](int h, int jt, int buf) {
    stage<bf16, TC_THREADS>(Us + buf * T * LDP, LDP, PMAX, T, u_of(h), row_u,
                            jt * T, valid, s.P, vecU);
    if (need_B(h, jt))
      stage<bf16, TC_THREADS>(Bs + buf * T * LDN, LDN, NMAX, T, Bb, s.N, jt * T,
                              valid, s.N, vecB);
  };
  // a_cum in registers, loaded a step ahead of its use: the query rows' of
  // a head, and this warp's keys of a tile (lane L holds keys 32 kh + 2L and
  // 32 kh + 2L + 1 for L < 16)
  auto load_ak = [&](int h, int jt) {
    return *reinterpret_cast<const float2*>(
        &acum_of(h)[jt * T + kh * 32 + 2 * (lane % 16)]);
  };
  // y of head h: each half adds the other's partial sums of its 32 columns
  auto store_y = [&](int h, const float (&acc)[8][4]) {
    float* mine = part + rg * (T * 16) + lane;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(kh * 16 + nt * 4 + e) * 32] = kh ? acc[nt][e] : acc[4 + nt][e];
    __syncthreads();
    bf16* yb = y + ((static_cast<long long>(b) * s.S + c0) * s.H + h) * s.P;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = i0 + qrow + gid + hf * 8;
        const int p = kh * 32 + nt * 8 + tig * 2;
        const float* other = mine + ((1 - kh) * 16 + nt * 4 + 2 * hf) * 32;
        const float v0 = (kh ? acc[4 + nt][2 * hf] : acc[nt][2 * hf]) + other[0];
        const float v1 =
            (kh ? acc[4 + nt][2 * hf + 1] : acc[nt][2 * hf + 1]) + other[32];
        if (r >= valid) continue;
        bf16* dst = yb + r * row_u + p;
        if (p + 1 < s.P && (s.P % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (p < s.P) dst[0] = __float2bfloat16(v0);
          if (p + 1 < s.P) dst[1] = __float2bfloat16(v1);
        }
      }
  };

  stage<bf16, TC_THREADS>(Cs, LDN, NMAX, T, Cb, s.N, i0, valid, s.N, vecB);
  stage_sp(h0, 0);
  stage_step(h0, 0, 0);
  cp_commit();
  float ai0 = acum_of(h0)[i0 + qrow + gid];
  float ai1 = acum_of(h0)[i0 + qrow + gid + 8];
  float2 ak = load_ak(h0, 0);
  cp_wait<0>();
  __syncthreads();
  unsigned cf[NMAX / 16][4];   // C_i as A fragments
#pragma unroll
  for (int ks = 0; ks < NMAX / 16; ++ks)
    ldsm4(cf[ks], Cs + (qrow + (lane % 8) + (mi % 2) * 8) * LDN + ks * 16 +
                      (mi / 2) * 8);

  int step = 0;
  for (int h = h0; h < h1; ++h) {
    const int hb = (h - h0) & 1;
    if (h + 1 < h1) {   // the next head's S_prev
      stage_sp(h + 1, hb ^ 1);
      cp_commit();
    }

    // off-diagonal: exp(a_cum[i]) C[i] S_prev over this warp's half of the
    // state rows, S_prev as hi + lo
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    const bf16* sh = SP + hb * 2 * NMAX * LDP;
#pragma unroll
    for (int k4 = 0; k4 < NMAX / 32; ++k4) {
      const int ks = kh * (NMAX / 32) + k4;
      unsigned ca[4];   // cf[ks], selected without indexing by kh
#pragma unroll
      for (int e = 0; e < 4; ++e) ca[e] = kh ? cf[NMAX / 32 + k4][e] : cf[k4][e];
#pragma unroll
      for (int np = 0; np < PMAX / 16; ++np) {
        const int off = (ks * 16 + (lane % 8) + (mi % 2) * 8) * LDP + np * 16 +
                        (mi / 2) * 8;
        unsigned fh[4], fl[4];
        ldsm4t(fh, sh + off);
        ldsm4t(fl, sh + NMAX * LDP + off);
        mma(acc[2 * np], ca, fh[0], fh[1]);
        mma(acc[2 * np + 1], ca, fh[2], fh[3]);
        mma(acc[2 * np], ca, fl[0], fl[1]);
        mma(acc[2 * np + 1], ca, fl[2], fl[3]);
      }
    }
    {
      const float d0 = __expf(ai0), d1 = __expf(ai1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= d0; acc[nt][1] *= d0;
        acc[nt][2] *= d1; acc[nt][3] *= d1;
      }
    }

    // diagonal: key tiles 0 .. it, this warp's 32 keys of each
    float ai0_next = ai0, ai1_next = ai1;
    for (int jt = 0; jt <= it; ++jt, ++step) {
      const int buf = step & 1;
      float2 ak_next = ak;
      if (jt < it) {   // the next step's tiles and a_cum
        stage_step(h, jt + 1, buf ^ 1);
        cp_commit();
        ak_next = load_ak(h, jt + 1);
      } else if (h + 1 < h1) {
        stage_step(h + 1, 0, buf ^ 1);
        cp_commit();
        ak_next = load_ak(h + 1, 0);
        ai0_next = acum_of(h + 1)[i0 + qrow + gid];
        ai1_next = acum_of(h + 1)[i0 + qrow + gid + 8];
      }
      const int j0 = jt * T + kh * 32;   // this warp's first key
      float* slot = cache + (jt < cached ? jt : cached) * (T * T) +
                    (rg * 2 + kh) * (16 * 32) + lane;
      float sc[4][4];
      if (need_B(h, jt)) {   // scores of this warp's keys, kept for the group
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
        const bf16* bt = Bs + buf * T * LDN;
#pragma unroll
        for (int ks = 0; ks < NMAX / 16; ++ks) {
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            unsigned kf[4];
            ldsm4(kf, bt + (kh * 32 + np * 16 + (lane % 8) + (mi / 2) * 8) *
                               LDN + ks * 16 + (mi % 2) * 8);
            mma(sc[2 * np], cf[ks], kf[0], kf[1]);
            mma(sc[2 * np + 1], cf[ks], kf[2], kf[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) slot[(nt * 4 + e) * 32] = sc[nt][e];
      } else {   // each lane reads back what it wrote for the group's first head
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = slot[(nt * 4 + e) * 32];
      }
      // mask with L[i][j] = exp(a_cum[i] - a_cum[j]) for i >= j, as hi + lo
      unsigned ph[2][4], pl[2][4];
      const int ri0 = i0 + qrow + gid, ri1 = ri0 + 8;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float aj0 = __shfl_sync(0xffffffffu, ak.x, nt * 4 + tig);
        const float aj1 = __shfl_sync(0xffffffffu, ak.y, nt * 4 + tig);
        const int j = j0 + nt * 8 + tig * 2;
        const float m00 = ri0 >= j ? sc[nt][0] * __expf(ai0 - aj0) : 0.f;
        const float m01 = ri0 >= j + 1 ? sc[nt][1] * __expf(ai0 - aj1) : 0.f;
        const float m10 = ri1 >= j ? sc[nt][2] * __expf(ai1 - aj0) : 0.f;
        const float m11 = ri1 >= j + 1 ? sc[nt][3] * __expf(ai1 - aj1) : 0.f;
        const int kk = nt / 2, hk = (nt % 2) * 2;
        split2(m00, m01, ph[kk][hk], pl[kk][hk]);
        split2(m10, m11, ph[kk][hk + 1], pl[kk][hk + 1]);
      }
      const bf16* ut = Us + buf * T * LDP;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int np = 0; np < PMAX / 16; ++np) {
          unsigned vf[4];
          ldsm4t(vf, ut + (kh * 32 + kk * 16 + (lane % 8) + (mi % 2) * 8) * LDP +
                         np * 16 + (mi / 2) * 8);
          mma(acc[2 * np], ph[kk], vf[0], vf[1]);
          mma(acc[2 * np + 1], ph[kk], vf[2], vf[3]);
          mma(acc[2 * np], pl[kk], vf[0], vf[1]);
          mma(acc[2 * np + 1], pl[kk], vf[2], vf[3]);
        }
      }
      cp_wait<0>();
      __syncthreads();
      ak = ak_next;
    }
    store_y(h, acc);
    ai0 = ai0_next;
    ai1 = ai1_next;
  }
}

// ---------------------------------------------------------------------------
// Pass 3 (fp32): the same output on CUDA cores; 4 x 4 register tiles, C
// staged n-major once per block, the score tile recomputed per head.
// ---------------------------------------------------------------------------
constexpr int LDT = T + 4;

size_t out_f32_smem(int Qp) {
  return sizeof(float) * (static_cast<size_t>(NMAX) * PMAX + 2 * NMAX * LDT +
                          T * PMAX + T * LDT + Qp);
}

__global__ void __launch_bounds__(F_THREADS)
chunk_out_f32(const float* __restrict__ u, const float* __restrict__ Bm,
              const float* __restrict__ Cm, float* __restrict__ y, Work w,
              Shape s) {
  extern __shared__ __align__(16) float smem_f[];
  float* St = smem_f;                  // [NMAX][PMAX] S_prev
  float* Ct = St + NMAX * PMAX;        // [NMAX][LDT] C tile, n-major
  float* Bt = Ct + NMAX * LDT;         // [NMAX][LDT]
  float* Us = Bt + NMAX * LDT;         // [T][PMAX]
  float* Mt = Us + T * PMAX;           // [T][LDT] masked scores [j][i]
  float* acum = Mt + T * LDT;          // [Qp]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int nbc = s.B * s.nc;
  const int it = s.nqt - 1 - blockIdx.x / (nbc * s.G);
  const int grp = blockIdx.x / nbc % s.G;
  const int bc = blockIdx.x % nbc;
  const int b = bc / s.nc, c = bc % s.nc;
  const int h0 = grp * s.HG, h1 = min(s.H, h0 + s.HG);
  const int c0 = c * s.Q;
  const int valid = min(s.Q, s.S - c0);
  const int i0 = it * T;
  const float* Bb = Bm + (static_cast<long long>(b) * s.S + c0) * s.N;
  const float* Cb = Cm + (static_cast<long long>(b) * s.S + c0) * s.N;
  const long long row_u = static_cast<long long>(s.H) * s.P;

  for (int idx = tid; idx < T * NMAX; idx += F_THREADS) {
    const int i = idx / NMAX, n = idx % NMAX;
    Ct[n * LDT + i] = (i0 + i < valid && n < s.N)
        ? Cb[static_cast<long long>(i0 + i) * s.N + n] : 0.f;
  }
  for (int h = h0; h < h1; ++h) {
    const long long bh = static_cast<long long>(b) * s.H + h;
    const float* ub = u + ((static_cast<long long>(b) * s.S + c0) * s.H + h) * s.P;
    const float* spf = w.sprev + (bh * s.nc + c) * s.N * s.P;
    const float* acum_g = w.acum + (bh * s.nc + c) * s.Qp;
    __syncthreads();   // the previous head's reads are done
    for (int idx = tid; idx < NMAX * PMAX; idx += F_THREADS) {
      const int n = idx / PMAX, p = idx % PMAX;
      St[idx] = (n < s.N && p < s.P) ? spf[n * s.P + p] : 0.f;
    }
    for (int r = tid; r < i0 + T; r += F_THREADS) acum[r] = acum_g[r];
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) acc[ii][pp] = 0.f;
#pragma unroll 4
    for (int n = 0; n < NMAX; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * LDT + ty * 4]);
      const float4 sv = *reinterpret_cast<const float4*>(&St[n * PMAX + tx * 4]);
      const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
      const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
          acc[ii][pp] = fmaf(c4[ii], s4[pp], acc[ii][pp]);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const float dec = expf(acum[i0 + ty * 4 + ii]);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) acc[ii][pp] *= dec;
    }

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * T;
      __syncthreads();   // the previous key tile's Bt / Us / Mt reads are done
      for (int idx = tid; idx < T * NMAX; idx += F_THREADS) {
        const int j = idx / NMAX, n = idx % NMAX;
        Bt[n * LDT + j] = (j0 + j < valid && n < s.N)
            ? Bb[static_cast<long long>(j0 + j) * s.N + n] : 0.f;
      }
      for (int idx = tid; idx < T * PMAX; idx += F_THREADS) {
        const int j = idx / PMAX, p = idx % PMAX;
        Us[idx] = (j0 + j < valid && p < s.P) ? ub[(j0 + j) * row_u + p] : 0.f;
      }
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = 0.f;
#pragma unroll 4
      for (int n = 0; n < NMAX; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * LDT + ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bt[n * LDT + tx * 4]);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sc[ii][jj] = fmaf(c4[ii], b4[jj], sc[ii][jj]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int rj = j0 + tx * 4 + jj;
        float mcol[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int ri = i0 + ty * 4 + ii;
          mcol[ii] = ri >= rj ? sc[ii][jj] * expf(acum[ri] - acum[rj]) : 0.f;
        }
        *reinterpret_cast<float4*>(&Mt[(tx * 4 + jj) * LDT + ty * 4]) =
            make_float4(mcol[0], mcol[1], mcol[2], mcol[3]);
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < T; ++j) {
        const float4 mv = *reinterpret_cast<const float4*>(&Mt[j * LDT + ty * 4]);
        const float4 uv = *reinterpret_cast<const float4*>(&Us[j * PMAX + tx * 4]);
        const float m4[4] = {mv.x, mv.y, mv.z, mv.w};
        const float u4[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int pp = 0; pp < 4; ++pp)
            acc[ii][pp] = fmaf(m4[ii], u4[pp], acc[ii][pp]);
      }
    }

    float* yb = y + ((static_cast<long long>(b) * s.S + c0) * s.H + h) * s.P;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = i0 + ty * 4 + ii;
      if (r >= valid) continue;
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const int p = tx * 4 + pp;
        if (p < s.P) yb[r * row_u + p] = acc[ii][pp];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: plan, workspace, per-device memos.
// ---------------------------------------------------------------------------
int sm_count[MAX_DEVICES];              // 0 = not read yet
size_t smem_set[5][MAX_DEVICES];        // dynamic shared memory allowed

int device_sms(int dev) {
  if (sm_count[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = 132;
    sm_count[dev] = n;
  }
  return sm_count[dev];
}

Shape make_shape(int B, int S, int H, int P, int N, int chunk, int sms) {
  Shape s;
  s.B = B; s.S = S; s.H = H; s.P = P; s.N = N;
  s.Q = chunk < S ? chunk : S;
  s.nc = (S + s.Q - 1) / s.Q;
  s.nqt = (s.Q + T - 1) / T;
  s.Qp = s.nqt * T;
  s.P8 = (P + 7) / 8 * 8;
  // the fewest heads a group that still give about three blocks per SM
  // (the last query tiles, with the most key tiles, go first)
  const long long base = static_cast<long long>(B) * s.nc * s.nqt;
  long long g = (3LL * sms + base - 1) / base;
  if (g < 1) g = 1;
  if (g > H) g = H;
  s.HG = static_cast<int>((H + g - 1) / g);
  s.G = (H + s.HG - 1) / s.HG;
  return s;
}

long long workspace_floats(const Shape& s) {
  const long long bhc = static_cast<long long>(s.B) * s.H * s.nc;
  auto r4 = [](long long x) { return (x + 3) / 4 * 4; };
  return r4(bhc * s.Qp) + r4(bhc * s.N * s.P) + r4(bhc * s.N * s.P8);
}

template <typename K>
cudaError_t allow_smem(K kern, int slot, int dev, size_t bytes) {
  if (smem_set[slot][dev] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) smem_set[slot][dev] = bytes;
  return err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Workspace (fp32 words) a launch at this shape needs.
long long ssd_scan_workspace(int B, int S, int H, int P, int N, int chunk) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || chunk < 1) return 0;
  return workspace_floats(make_shape(B, S, H, P, N, chunk, 1));
}

// The plan on the current device: out = {kernels, pass-1 blocks, pass-2
// blocks, pass-3 blocks, heads a group, query tiles a chunk, chunks}.
int ssd_scan_plan(int B, int S, int H, int P, int N, int chunk, int* out) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const Shape s = make_shape(B, S, H, P, N, chunk, device_sms(dev));
  out[0] = 3;
  out[1] = B * s.nc * H;
  out[2] = B * H * ((N * s.P8 + CARRY_THREADS - 1) / CARRY_THREADS);
  out[3] = B * s.nc * s.nqt * s.G;
  out[4] = s.HG;
  out[5] = s.nqt;
  out[6] = s.nc;
  return 0;
}

// u [B, S, H, P], y [B, S, H, P] (fp32, or bf16 when is_bf16 != 0);
// a [B, S, H] fp32; Bm, Cm [B, S, N] in u's dtype; sfin [B, H, N, P] fp32;
// ws: ws_floats fp32 words of workspace, at least ssd_scan_workspace().
// Contiguous device pointers.  Chunks of Q = min(chunk, S) rows.  Launches
// the three kernels on `stream` and returns the first CUDA error code (0 on
// success); a short workspace is refused before any launch.
int ssd_scan_launch(const void* u, const void* a, const void* Bm,
                    const void* Cm, void* y, void* sfin, void* ws,
                    long long ws_floats, int B, int S, int H, int P, int N,
                    int chunk, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > PMAX || N < 1 || N > NMAX ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  const Shape s = make_shape(B, S, H, P, N, chunk, device_sms(dev));
  if (s.Q > QMAX) return static_cast<int>(cudaErrorInvalidValue);
  if (ws == nullptr || ws_floats < workspace_floats(s) || !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bhc = static_cast<long long>(B) * H * s.nc;
  auto r4 = [](long long x) { return (x + 3) / 4 * 4; };
  Work w;
  w.acum = static_cast<float*>(ws);
  w.schunk = w.acum + r4(bhc * s.Qp);
  w.sprev = w.schunk + r4(bhc * N * P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(sfin);
  const int E = is_bf16 ? 8 : 4;   // elements a 16-byte copy
  const int vecB = N % E == 0 && aligned16(Bm) && aligned16(Cm);
  const int vecU = P % E == 0 && (static_cast<long long>(H) * P) % E == 0 &&
                   aligned16(u);
  const dim3 g1(B * s.nc, H);
  const dim3 g2(B * H, (N * (is_bf16 ? s.P8 : P) + CARRY_THREADS - 1) /
                           CARRY_THREADS);
  const dim3 g3(B * s.nc * s.nqt * s.G);

  if (is_bf16) {
    const size_t m1 = state_tc_smem(s.Qp), m3 = out_tc_smem(s.nqt);
    if ((err = allow_smem(chunk_state_tc, 0, dev, m1)) != cudaSuccess ||
        (err = allow_smem(chunk_out_tc, 1, dev, m3)) != cudaSuccess)
      return static_cast<int>(err);
    const bf16* ub = static_cast<const bf16*>(u);
    const bf16* Bb = static_cast<const bf16*>(Bm);
    chunk_state_tc<<<g1, TC_THREADS, m1, st>>>(ub, af, Bb, w, s, vecB, vecU);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    carry<true><<<g2, CARRY_THREADS, 0, st>>>(w, sf, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    chunk_out_tc<<<g3, TC_THREADS, m3, st>>>(
        ub, Bb, static_cast<const bf16*>(Cm), static_cast<bf16*>(y), w, s, vecB,
        vecU);
  } else {
    const size_t m1 = state_f32_smem(s.Qp), m3 = out_f32_smem(s.Qp);
    if ((err = allow_smem(chunk_state_f32, 2, dev, m1)) != cudaSuccess ||
        (err = allow_smem(chunk_out_f32, 3, dev, m3)) != cudaSuccess)
      return static_cast<int>(err);
    const float* uf = static_cast<const float*>(u);
    const float* Bf = static_cast<const float*>(Bm);
    chunk_state_f32<<<g1, F_THREADS, m1, st>>>(uf, af, Bf, w, s, vecB, vecU);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    carry<false><<<g2, CARRY_THREADS, 0, st>>>(w, sf, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    chunk_out_f32<<<g3, F_THREADS, m3, st>>>(
        uf, Bf, static_cast<const float*>(Cm), static_cast<float*>(y), w, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
