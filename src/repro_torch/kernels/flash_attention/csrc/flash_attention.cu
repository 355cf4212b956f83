// Flash attention (block-wise online softmax) for Hopper (sm_90a): bf16
// inputs on the tensor cores (mma.sync m16n8k16, fp32 accumulators), fp32
// inputs on CUDA cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/kernel.py  _kernel (body, line 24),
//   launched by flash_attention_flat through pl.pallas_call (line 80).
// The TPU kernel walks a grid (B*H, Q blocks, KV blocks) with the KV axis
// sequential and carries the running max, normalizer and accumulator in
// VMEM scratch from one grid step to the next; causal KV blocks above the
// diagonal are skipped.  Here one block owns one (batch, head, query
// tile) and walks the KV tiles in a loop, so the running max m, the
// normalizer l and the accumulator stay in registers for the whole walk
// and never touch device memory.  The loop stops at the diagonal tile
// when causal, as the TPU kernel's pl.when skips those blocks, and the
// query tiles with the longest rows are scheduled first.
//
// Out = softmax(q k^T * scale) v per (batch, head), with the JAX
// package's masking: query position i sees key j when j < Skv and, if
// causal, i >= j (no offset, so Sq == Skv is self-attention).  Masked
// scores are -1e30, as in the reference (never -inf, so a row that has
// seen only masked keys rescales by exp2(-1e30 - m) = 0, not NaN).
//
// What the TPU kernel asserted away, both kernels handle themselves:
//  * ragged lengths: the engine left-pads a wave to its longest prompt, so
//    S is arbitrary (1,491, say).  Query rows past Sq are computed on zeros
//    and never stored; key columns past Skv are masked.
//  * GQA: q [B, Sq, H, D], k/v [B, Skv, K, D] with K dividing H.  The JAX
//    wrapper repeats K/V to H heads in device memory; here head h reads KV
//    head h / (H / K) in place: the same function without the copy.
//  * layout: the model's [B, S, H, D] is read with its own strides; no
//    transpose to [B*H, S, D] and back.
//  * head dims up to 128: the tiles are compiled for DP = 16 (bf16 only),
//    32, 64 or 128 columns and a head dim below DP is zero-padded in
//    shared memory (a zero column adds nothing to q.k, and padded output
//    columns are not stored).
//
// bf16 (the serving path), tc_kernel.  Bound on the H100: at the timing
// shape (B 4, S 1024, H 32, D 64, causal) the 4*D FLOPs per kept (query,
// key) pair take 0.017 ms at the bf16 tensor-core peak (989 TFLOP/s),
// under the 0.020 ms that reading q, k, v and writing o takes at 3.35
// TB/s; the first kernel, fp32 FMAs on CUDA cores, could not go below the
// 0.26 ms of the fp32 rate.  The design, FlashAttention-2's arrangement:
//  * a block is WARPS = 4 warps over a 64-row query tile, each warp owning
//    16 query rows; one 64-key tile of K and V at a time (8 warps over 128
//    rows, and two 16-row m-tiles a warp, were tried on the card and were
//    not faster at the timing shape);
//  * Q is staged once with 16-byte cp.async and held in registers as the
//    A fragments of S = Q K^T, read with ldmatrix;
//  * K and V tiles go through a STAGES = 3 ring of 16-byte cp.async
//    copies, so the next two tiles' copies overlap this tile's products.
//    Rows are XOR-swizzled in 16-byte chunks, so ldmatrix (K, the B
//    operand of Q K^T) and ldmatrix.trans (V, the B operand of P V) read
//    8 rows from 8 different bank groups;
//  * the online softmax runs on the S accumulators: a row's 64 scores
//    sit in the 4 lanes of a quad, so its max and sum are two xor
//    shuffles; exp2f with log2(e) folded into the scale; the mask is
//    applied only on the diagonal tile and the ragged last tile;
//  * P stays in registers: the C fragment of m16n8k16 is laid out as the
//    A fragment of the next product, so P is packed to bf16 in place and
//    fed to P V directly.  P is carried as a bf16 pair hi + lo (lo = the
//    bf16 rounding of p - hi) through two P V products: a single bf16 P
//    (2^-9 relative per weight) moves outputs of few-key rows past the
//    bf16 gate (1e-3 + 1e-2 |ref|), the pair (2^-17) does not.  V is bf16
//    already, so both products are exact up to the fp32 sums;
//  * the output is divided by l once, rounded to bf16 once, staged in the
//    warp's own rows of the Q tile and stored as 16-byte rows.
//  Rows whose bytes are not 16-byte aligned (D not a multiple of 8, or a
//  base pointer off 16 bytes) are staged and stored with scalar accesses.
//  Registers (ptxas -v, sm_90a): 196 a thread at DP 128 (the 64 fp32 of
//  the O accumulator, 32 of S, 32 of Q fragments), 160 at 64, no spills.
//  What keeps it above SDPA (0.149 against 0.063 ms at the timing shape,
//  chip_smoke.py): the hi + lo pair makes 1.5x the tensor-core products
//  of a single-P kernel, and mma.sync issues them at a lower rate than
//  the wgmma + TMA arrangement of FlashAttention-3.
//
// fp32, f32_kernel: fp32 FMAs on CUDA cores (TF32 would break the fp32
// gate of 1e-4), bounded by the fp32 rate.  Block: 128 threads, a 64 x 64
// score tile, each thread owning 4 query rows x 8 key columns of the
// scores and the same 4 rows x DP/8 columns of the accumulator; Q and K
// tiles are stored transposed in shared memory (d-major) so each step of
// the q.k loop is three 16-byte loads for 32 FMAs; P goes through shared
// memory between the two products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // key rows per tile
constexpr int THREADS = 128;
constexpr int LDT = BQ + 4;      // row stride of Qt, Kt and Ps (16-byte aligned)
constexpr float NEG_INF = -1e30f;

struct Shape {
  int B, Sq, Skv, H, K, D, causal;
  float scale;
};

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DP * LDT + BK * DP + BQ * LDT);
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [DP][LDT]  q tile, d-major
  float* Kt = Qt + DP * LDT;     // [DP][LDT]  k tile, d-major
  float* Vs = Kt + DP * LDT;     // [BK][DP]   v tile, row-major
  float* Ps = Vs + BK * DP;      // [BQ][LDT]  probabilities

  constexpr int DC = DP / 8;     // accumulator columns per thread
  const int tid = threadIdx.x;
  const int ty = tid / 8;        // rows ty*4 .. +3
  const int tx = tid % 8;        // score columns tx*8 .. +7, out columns tx*DC ..
  const int nq = (s.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;  // long rows first
  const int b = blockIdx.y / s.H;
  const int h = blockIdx.y % s.H;
  const int kvh = h / (s.H / s.K);
  const long long q_row = static_cast<long long>(s.H) * s.D;   // position stride
  const long long kv_row = static_cast<long long>(s.K) * s.D;
  const float* qb = q + (static_cast<long long>(b) * s.Sq * s.H + h) * s.D;
  const float* kb = k + (static_cast<long long>(b) * s.Skv * s.K + kvh) * s.D;
  const float* vb = v + (static_cast<long long>(b) * s.Skv * s.K + kvh) * s.D;
  float* ob = o + (static_cast<long long>(b) * s.Sq * s.H + h) * s.D;

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int i = idx / DP, d = idx % DP;
    Qt[d * LDT + i] = (q0 + i < s.Sq && d < s.D)
        ? qb[(q0 + i) * q_row + d] : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = NEG_INF;
    l[ii] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[ii][c] = 0.f;
  }

  int nk = (s.Skv + BK - 1) / BK;
  if (s.causal) {
    const int q_last = min(q0 + BQ, s.Sq) - 1;
    nk = min(nk, q_last / BK + 1);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's Kt / Vs / Ps reads are done
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int j = idx / DP, d = idx % DP;
      const bool in = k0 + j < s.Skv && d < s.D;
      const long long off = (k0 + j) * kv_row + d;
      Kt[d * LDT + j] = in ? kb[off] : 0.f;
      Vs[j * DP + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) sc[ii][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * LDT + ty * 4]);
      const float4 k0v = *reinterpret_cast<const float4*>(&Kt[d * LDT + tx * 8]);
      const float4 k1v =
          *reinterpret_cast<const float4*>(&Kt[d * LDT + tx * 8 + 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {k0v.x, k0v.y, k0v.z, k0v.w,
                           k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          sc[ii][jj] = fmaf(qv[ii], kv[jj], sc[ii][jj]);
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = q0 + ty * 4 + ii;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = k0 + tx * 8 + jj;
        const bool keep = j < s.Skv && (!s.causal || i >= j);
        sc[ii][jj] = keep ? sc[ii][jj] * s.scale : NEG_INF;
        mx = fmaxf(mx, sc[ii][jj]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[ii], mx);
      const float alpha = expf(m[ii] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        sc[ii][jj] = expf(sc[ii][jj] - m_new);
        sum += sc[ii][jj];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[ii] = l[ii] * alpha + sum;
      m[ii] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[ii][c] *= alpha;
      float* prow = &Ps[(ty * 4 + ii) * LDT + tx * 8];
      *reinterpret_cast<float4*>(prow) =
          make_float4(sc[ii][0], sc[ii][1], sc[ii][2], sc[ii][3]);
      *reinterpret_cast<float4*>(prow + 4) =
          make_float4(sc[ii][4], sc[ii][5], sc[ii][6], sc[ii][7]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 pr =
            *reinterpret_cast<const float4*>(&Ps[(ty * 4 + ii) * LDT + j]);
        p[ii][0] = pr.x; p[ii][1] = pr.y; p[ii][2] = pr.z; p[ii][3] = pr.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = &Vs[(j + jj) * DP + tx * DC];
#pragma unroll
        for (int c = 0; c < DC; c += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vrow[c]);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            acc[ii][c] = fmaf(p[ii][jj], vv.x, acc[ii][c]);
            acc[ii][c + 1] = fmaf(p[ii][jj], vv.y, acc[ii][c + 1]);
            acc[ii][c + 2] = fmaf(p[ii][jj], vv.z, acc[ii][c + 2]);
            acc[ii][c + 3] = fmaf(p[ii][jj], vv.w, acc[ii][c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = q0 + ty * 4 + ii;
    if (i >= s.Sq) continue;
    const float lsafe = fmaxf(l[ii], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx * DC + c;
      if (d < s.D) ob[i * q_row + d] = acc[ii][c] / lsafe;
    }
  }
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Shape& s, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.Sq + BQ - 1) / BQ, s.B * s.H);
  f32_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32_d(const void* q, const void* k, const void* v, void* o,
                 const Shape& s, cudaStream_t stream) {
  if (s.D <= 32) return launch_f32<32>(q, k, v, o, s, stream);
  if (s.D <= 64) return launch_f32<64>(q, k, v, o, s, stream);
  return launch_f32<128>(q, k, v, o, s, stream);
}


// ---- bf16: tensor cores -------------------------------------------------

namespace tc {

constexpr int WARPS = 4;             // 16 query rows each
constexpr int BQ = 16 * WARPS;       // query rows per block
constexpr int BK = 64;               // keys per tile (32 and 128 were slower)
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;            // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Element offset of 16-byte chunk c of row r in a [rows][DP] bf16 tile.
// Chunks are XOR-swizzled so the 8 rows an ldmatrix reads at one chunk
// index fall in 8 different 16-byte bank groups.
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = DP / 8;   // chunks per row
  const int f = C >= 8 ? (r & 7) : ((r * C / 8) & (C - 1));
  return r * DP + ((c ^ f) << 3);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills the chunk with zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Stage rows row0 .. row0+ROWS-1 of one head into a swizzled [ROWS][DP]
// tile: 16-byte cp.async where rows are aligned (vec), else scalar loads.
// Rows at or past nrows, and columns at or past D, are zeros (a cp.async
// of 0 source bytes fills its 16 bytes with zeros).
template <int DP, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* tile, const bf16* base,
                                           long long stride, int row0,
                                           int nrows, int D, bool vec) {
  constexpr int C = DP / 8;
  if (vec) {
    // a compile-time trip count and chunk arithmetic (C is a power of 2)
    constexpr int N = ROWS * C;
#pragma unroll
    for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (N % THREADS != 0 && idx >= N) break;
      const int r = idx / C, c = idx % C;
      const bool in = row0 + r < nrows && c * 8 < D;
      const bf16* src = in ? base + (row0 + r) * stride + c * 8 : base;
      cp16(tile + swz<DP>(r, c), src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += THREADS) {
      const int r = idx / DP, d = idx - r * DP;
      const bool in = row0 + r < nrows && d < D;
      tile[swz<DP>(r, d / 8) + (d & 7)] =
          in ? base[(row0 + r) * stride + d] : __float2bfloat16(0.f);
    }
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (BQ * DP + 2 * STAGES * BK * DP);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, Shape s,
          int vec) {
  constexpr int KS = DP / 16;      // k-steps of Q K^T
  constexpr int NO = DP / 8;       // 8-column tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][DP]
  bf16* Ks = Qs + BQ * DP;                        // [STAGES][BK][DP]
  bf16* Vs = Ks + STAGES * BK * DP;               // [STAGES][BK][DP]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;    // fragment row (and row + 8)
  const int t = lane & 3;     // fragment column pair
  const int nq = (s.Sq + BQ - 1) / BQ;
  // long rows first; this warp's rows are qw .. qw + 15
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int qw = q0 + warp * 16;
  const int b = blockIdx.y / s.H;
  const int h = blockIdx.y % s.H;
  const int kvh = h / (s.H / s.K);
  const long long q_row = static_cast<long long>(s.H) * s.D;
  const long long kv_row = static_cast<long long>(s.K) * s.D;
  const bf16* qb = q + (static_cast<long long>(b) * s.Sq * s.H + h) * s.D;
  const bf16* kb = k + (static_cast<long long>(b) * s.Skv * s.K + kvh) * s.D;
  const bf16* vb = v + (static_cast<long long>(b) * s.Skv * s.K + kvh) * s.D;
  bf16* ob = o + (static_cast<long long>(b) * s.Sq * s.H + h) * s.D;

  int nk = (s.Skv + BK - 1) / BK;
  if (s.causal) nk = min(nk, (min(q0 + BQ, s.Sq) - 1) / BK + 1);

  stage_rows<DP, BQ>(Qs, qb, q_row, q0, s.Sq, s.D, vec);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) {
      stage_rows<DP, BK>(Ks + st * BK * DP, kb, kv_row, st * BK, s.Skv, s.D,
                         vec);
      stage_rows<DP, BK>(Vs + st * BK * DP, vb, kv_row, st * BK, s.Skv, s.D,
                         vec);
    }
    cp_commit();
  }

  unsigned qf[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // rows g, g + 8 (log2 domain)
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
  const float sl2 = s.scale * LOG2E;

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();   // tile kt (and Q) has landed for this thread
    __syncthreads();         // ... for every thread; tile kt-1 is consumed
    {
      const int nt = kt + STAGES - 1;
      if (nt < nk) {
        const int st = nt % STAGES;
        stage_rows<DP, BK>(Ks + st * BK * DP, kb, kv_row, nt * BK, s.Skv,
                           s.D, vec);
        stage_rows<DP, BK>(Vs + st * BK * DP, vb, kv_row, nt * BK, s.Skv,
                           s.D, vec);
      }
      cp_commit();
    }
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm4(qf[ks], Qs + swz<DP>(warp * 16 + (lane & 15),
                                   2 * ks + (lane >> 4)));
    }
    const int k0 = kt * BK;
    // A warp whose rows all sit above this tile's first key, or past Sq,
    // has nothing to add (its block-mates may).
    if ((s.causal && k0 > qw + 15) || qw >= s.Sq) continue;
    const bf16* Kt = Ks + (kt % STAGES) * BK * DP;
    const bf16* Vt = Vs + (kt % STAGES) * BK * DP;

    // S = Q K^T: 16 rows x BK keys, n-tiles of 8 keys
    constexpr int NS = BK / 8;
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        unsigned kf[4];
        ldsm4(kf, Kt + swz<DP>(n * 8 + (lane & 7) + ((lane >> 4) << 3),
                               2 * ks + ((lane >> 3) & 1)));
        mma(sc[n], qf[ks], kf[0], kf[1]);
        mma(sc[n + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // online softmax on the fragments: lane holds rows g (e 0, 1) and
    // g + 8 (e 2, 3), keys n*8 + 2t + (e & 1); the raw max is scaled once
    const bool edge = k0 + BK > s.Skv || (s.causal && k0 + BK - 1 > qw);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int i = qw + g + (e >> 1) * 8;
          const int j = k0 + n * 8 + 2 * t + (e & 1);
          if (j >= s.Skv || (s.causal && i < j)) sc[n][e] = NEG_INF;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[n][e], sl2, -m[e >> 1]));
        sc[n][e] = p;
        l[e >> 1] += p;
      }

    // O += P V: BK/16 k-steps of 16 keys; P's A fragment is S tiles 2kk and
    // 2kk+1, packed to bf16 as hi, and the rounding rest as lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ph[4], plo[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* c = sc[2 * kk + hf];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x0 = c[2 * r], x1 = c[2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          ph[2 * hf + r] = *reinterpret_cast<const unsigned*>(&hi);
          plo[2 * hf + r] = pack(x0 - __low2float(hi), x1 - __high2float(hi));
        }
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned vf[4];
        ldsm4t(vf, Vt + swz<DP>(kk * 16 + (lane & 15), n + (lane >> 4)));
        mma(acc[n], ph, vf[0], vf[1]);
        mma(acc[n], plo, vf[0], vf[1]);
        mma(acc[n + 1], ph, vf[2], vf[3]);
        mma(acc[n + 1], plo, vf[2], vf[3]);
      }
    }
  }
  cp_wait<0>();

  // epilogue: l over the quad, divide once, round once, stage the warp's
  // 16 rows in its own rows of the Q tile, store 16-byte rows
  bf16* Os = Qs + warp * 16 * DP;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = 1.f / fmaxf(lr, 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<unsigned*>(Os + swz<DP>(g + 8 * r, n) + 2 * t) =
          pack(acc[n][2 * r] * lr, acc[n][2 * r + 1] * lr);
  }
  __syncwarp();
  if (vec) {
    const int cd = s.D / 8;
    for (int idx = lane; idx < 16 * cd; idx += 32) {
      const int r = idx / cd, c = idx - r * cd;
      if (qw + r < s.Sq)
        *reinterpret_cast<uint4*>(ob + (qw + r) * q_row + c * 8) =
            *reinterpret_cast<const uint4*>(Os + swz<DP>(r, c));
    }
  } else {
    for (int idx = lane; idx < 16 * s.D; idx += 32) {
      const int r = idx / s.D, d = idx - r * s.D;
      if (qw + r < s.Sq)
        ob[(qw + r) * q_row + d] = Os[swz<DP>(r, d / 8) + (d & 7)];
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           const Shape& s, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto al = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int vec = s.D % 8 == 0 && al(q) && al(k) && al(v) && al(o);
  const dim3 grid((s.Sq + BQ - 1) / BQ, s.B * s.H);
  tc_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), s, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const void* q, const void* k, const void* v, void* o,
             const Shape& s, cudaStream_t stream) {
  if (s.D <= 16) return launch<16>(q, k, v, o, s, stream);
  if (s.D <= 32) return launch<32>(q, k, v, o, s, stream);
  if (s.D <= 64) return launch<64>(q, k, v, o, s, stream);
  return launch<128>(q, k, v, o, s, stream);
}

}  // namespace tc
}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, Sq, H, D], k / v [B, Skv, K, D], o [B, Sq, H, D]: contiguous
// device pointers, fp32, or bf16 when bf16 != 0.  Launches on `stream` and
// returns the launch's CUDA error code (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Skv, int H, int K,
                           int D, int causal, float scale, int bf16,
                           void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || K < 1 || H < K || H % K != 0 ||
      D < 1 || D > 128 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, Sq, Skv, H, K, D, causal != 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? tc::launch_d(q, k, v, o, s, st)
              : launch_f32_d(q, k, v, o, s, st);
}

}  // extern "C"
