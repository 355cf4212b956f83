// Mamba-2 SSD chunked scan for Hopper (sm_90a), fp32 math on CUDA cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/ssd_scan/kernel.py  _kernel (body, line 23),
//   launched by ssd_scan_flat through pl.pallas_call (line 81).
// The TPU kernel walks a grid (B*H, chunks) with the chunk axis sequential
// and carries the [N, P] state in VMEM scratch between grid steps.  Here
// one block owns one (batch, head) and walks the chunks in a loop, so the
// fp32 state (128 x 64 = 32 KB at mamba2's widths) lives in shared memory
// for the whole sequence and never round-trips device memory.
//
// Per chunk of Q rows, with a_cum the chunk's running sum of a:
//   y[i]  = sum_{j <= i} (C[i].B[j]) exp(a_cum[i] - a_cum[j]) u[j]    (diagonal)
//         + exp(a_cum[i]) C[i] S_prev                                  (off-diagonal)
//   S_new = exp(a_cum[Q-1]) S_prev + sum_j B[j]^T exp(a_cum[Q-1] - a_cum[j]) u[j]
// and the final state is returned.  B and C are shared by the H heads of a
// batch row: head h reads B[b], C[b] in place (no repeat in memory).
//
// What the TPU kernel's VMEM made easy, and what this design does instead:
//  * the Q x Q decay/score block: at chunk 256 it is 256 KB of fp32, more
//    than a block's 227 KB of shared memory.  It is tiled by 64 query rows
//    x 64 key rows; a 64 x 64 tile (16 KB) lives in shared memory between
//    the C.B^T product and the product with u.  Key tiles above the
//    diagonal are skipped (their decay mask is zero), so the C.B^T work is
//    about half the TPU kernel's full Q x Q block.
//  * ragged lengths: the engine left-pads a wave to its longest prompt, so
//    S is arbitrary and the TPU kernel's `s % chunk == 0` does not hold.
//    Rows past S load as u = 0, a = 0, B = C = 0 and are never stored:
//    zero u adds nothing and zero a decays nothing, so the state is the
//    same as at S (the padding ssd_chunked does in the JAX model).  Chunks
//    need not be multiples of 64 either: a tile's rows past the chunk are
//    masked the same way.
//  * the sequential grid axis: blocks run in parallel and in no order, so
//    the chunk walk is a loop inside the block.
//
// Block: 256 threads.  Score and output tiles are 64 x 64, each thread
// owning a 4 x 4 register tile; the state update gives each thread 8 state
// rows x 4 columns.  C and B tiles are staged n-major so each step of the
// C.B^T loop is two 16-byte loads for 16 FMAs.  bf16 u, B, C are widened
// as they are staged; y is rounded once to u's dtype, the state stays fp32.
//
// Bound on the H100, counted as the function needs it: per chunk of Q
// rows, C.B^T over the Q(Q+1)/2 causal pairs once per batch row, and per
// head the masked scores times u over the same pairs plus 4QNP for the
// chunk state and the off-diagonal term.  At B 4, S 1024, H 24, P 64,
// N 128, chunk 256 that is 5.0 GFLOP: 0.005 ms at the bf16 tensor-core
// peak (989 TFLOP/s), 0.074 ms at the fp32 CUDA-core rate (67 TFLOP/s).
// The bytes (u, y in bf16, a, B, C, the fp32 state: 30.8 MB) take
// 0.0092 ms at 3.35 TB/s, so the bytes bound the function.  This first
// kernel does fp32 FMAs on CUDA cores, one block per (batch, head): 96
// blocks on 132 SMs at mamba2's serving shape, one block per SM for its
// 137 KB of shared memory.  C.B^T is the same for every head of a batch
// row and is recomputed per head (as the TPU kernel does); sharing it
// and moving the products to tensor cores are the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int T = 64;            // rows of a query or key tile
constexpr int LDT = T + 4;       // row stride of the n-major / j-major tiles
constexpr int PMAX = 64;         // head dim P the tiles are compiled for
constexpr int NMAX = 128;        // state dim N the tiles are compiled for
constexpr int QMAX = 4096;       // longest chunk
constexpr int THREADS = 256;

struct Shape {
  int B, S, H, P, N, Q;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename U> __device__ __forceinline__ U from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

size_t smem_bytes(int Q) {
  return sizeof(float) *
         (static_cast<size_t>(NMAX) * PMAX     // St: the state [N][P]
          + 2 * NMAX * LDT                     // Ct, Bt: n-major tiles
          + T * PMAX                           // Us: u tile [j][p]
          + T * LDT                            // Mt: masked scores [j][i]
          + Q);                                // acum: a_cum of the chunk
}

template <typename U>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const U* __restrict__ u, const float* __restrict__ a,
           const U* __restrict__ Bm, const U* __restrict__ Cm,
           U* __restrict__ y, float* __restrict__ sfin, Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* St = smem;                    // [NMAX][PMAX]
  float* Ct = St + NMAX * PMAX;        // [NMAX][LDT]; [T][NMAX] in the state pass
  float* Bt = Ct + NMAX * LDT;         // [NMAX][LDT]
  float* Us = Bt + NMAX * LDT;         // [T][PMAX]
  float* Mt = Us + T * PMAX;           // [T][LDT]
  float* acum = Mt + T * LDT;          // [Q]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;   // 4 x 4 tiles: rows ty*4, cols tx*4
  const int tn = tid / 16, tp = tid % 16;   // state: rows tn*8, cols tp*4
  const int b = blockIdx.x / s.H;
  const int h = blockIdx.x % s.H;
  const long long row_u = static_cast<long long>(s.H) * s.P;  // u / y position stride
  const U* ub = u + (static_cast<long long>(b) * s.S * s.H + h) * s.P;
  U* yb = y + (static_cast<long long>(b) * s.S * s.H + h) * s.P;
  const float* ab = a + static_cast<long long>(b) * s.S * s.H + h;
  const U* Bb = Bm + static_cast<long long>(b) * s.S * s.N;
  const U* Cb = Cm + static_cast<long long>(b) * s.S * s.N;

  for (int idx = tid; idx < NMAX * PMAX; idx += THREADS) St[idx] = 0.f;

  for (int c0 = 0; c0 < s.S; c0 += s.Q) {
    const int nt = (s.Q + T - 1) / T;   // tiles of this chunk
    __syncthreads();   // the previous chunk's state update is written
    // a_cum: warp 0, each lane a contiguous run, then a scan over lanes
    if (tid < 32) {
      const int per = (s.Q + 31) / 32;
      const int lo = min(lane * per, s.Q), hi = min(lo + per, s.Q);
      float run = 0.f;
      for (int r = lo; r < hi; ++r) {
        run += (c0 + r < s.S) ? ab[static_cast<long long>(c0 + r) * s.H] : 0.f;
        acum[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - run;
      for (int r = lo; r < hi; ++r) acum[r] += excl;
    }

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T;
      __syncthreads();   // acum written; Ct free
      for (int idx = tid; idx < T * NMAX; idx += THREADS) {
        const int i = idx / NMAX, n = idx % NMAX;
        const int r = i0 + i;
        Ct[n * LDT + i] = (r < s.Q && c0 + r < s.S && n < s.N)
            ? to_f32(Cb[static_cast<long long>(c0 + r) * s.N + n]) : 0.f;
      }
      __syncthreads();

      // off-diagonal: exp(a_cum[i]) C[i] S_prev
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) acc[ii][pp] = 0.f;
#pragma unroll 4
      for (int n = 0; n < s.N; ++n) {
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
        const int r = i0 + ty * 4 + ii;
        const float dec = r < s.Q ? expf(acum[r]) : 0.f;
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) acc[ii][pp] *= dec;
      }

      // diagonal: key tiles 0 .. it
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T;
        __syncthreads();   // the previous key tile's Bt / Us / Mt reads are done
        for (int idx = tid; idx < T * NMAX; idx += THREADS) {
          const int j = idx / NMAX, n = idx % NMAX;
          const int r = j0 + j;
          Bt[n * LDT + j] = (r < s.Q && c0 + r < s.S && n < s.N)
              ? to_f32(Bb[static_cast<long long>(c0 + r) * s.N + n]) : 0.f;
        }
        for (int idx = tid; idx < T * PMAX; idx += THREADS) {
          const int j = idx / PMAX, p = idx % PMAX;
          const int r = j0 + j;
          Us[idx] = (r < s.Q && c0 + r < s.S && p < s.P)
              ? to_f32(ub[(c0 + r) * row_u + p]) : 0.f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = 0.f;
#pragma unroll 4
        for (int n = 0; n < s.N; ++n) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&Ct[n * LDT + ty * 4]);
          const float4 bv =
              *reinterpret_cast<const float4*>(&Bt[n * LDT + tx * 4]);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              sc[ii][jj] = fmaf(c4[ii], b4[jj], sc[ii][jj]);
        }
        // decay mask L[i][j] = exp(a_cum[i] - a_cum[j]) for i >= j
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int rj = j0 + tx * 4 + jj;
          float mcol[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int ri = i0 + ty * 4 + ii;
            mcol[ii] = (ri >= rj && ri < s.Q)
                ? sc[ii][jj] * expf(acum[ri] - acum[rj]) : 0.f;
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

#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = i0 + ty * 4 + ii;
        if (r >= s.Q || c0 + r >= s.S) continue;
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const int p = tx * 4 + pp;
          if (p < s.P) yb[(c0 + r) * row_u + p] = from_f32<U>(acc[ii][pp]);
        }
      }
    }

    // state update: S = exp(a_cum[Q-1]) S + sum_j B[j]^T (exp(a_cum[Q-1] -
    // a_cum[j]) u[j]), B staged row-major in Ct's space
    const float a_last = acum[s.Q - 1];
    float st[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const float4 sv =
          *reinterpret_cast<const float4*>(&St[(tn * 8 + nn) * PMAX + tp * 4]);
      const float dec = expf(a_last);
      st[nn][0] = sv.x * dec; st[nn][1] = sv.y * dec;
      st[nn][2] = sv.z * dec; st[nn][3] = sv.w * dec;
    }
    float* Bs = Ct;   // [T][NMAX]
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * T;
      __syncthreads();   // Ct / Us / Mt reads of the previous pass are done
      for (int idx = tid; idx < T * NMAX; idx += THREADS) {
        const int j = idx / NMAX, n = idx % NMAX;
        const int r = j0 + j;
        Bs[idx] = (r < s.Q && c0 + r < s.S && n < s.N)
            ? to_f32(Bb[static_cast<long long>(c0 + r) * s.N + n]) : 0.f;
      }
      for (int idx = tid; idx < T * PMAX; idx += THREADS) {
        const int j = idx / PMAX, p = idx % PMAX;
        const int r = j0 + j;
        Us[idx] = (r < s.Q && c0 + r < s.S && p < s.P)
            ? to_f32(ub[(c0 + r) * row_u + p]) * expf(a_last - acum[r]) : 0.f;
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
    }
    __syncthreads();   // every thread has read St for this chunk
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
      *reinterpret_cast<float4*>(&St[(tn * 8 + nn) * PMAX + tp * 4]) =
          make_float4(st[nn][0], st[nn][1], st[nn][2], st[nn][3]);
  }

  __syncthreads();
  float* sb = sfin + static_cast<long long>(blockIdx.x) * s.N * s.P;
  for (int idx = tid; idx < s.N * s.P; idx += THREADS) {
    const int n = idx / s.P, p = idx % s.P;
    sb[idx] = St[n * PMAX + p];
  }
}

template <typename U>
int launch(const void* u, const float* a, const void* Bm, const void* Cm,
           void* y, float* sfin, const Shape& s, cudaStream_t stream) {
  const size_t smem = smem_bytes(s.Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<U><<<s.B * s.H, THREADS, smem, stream>>>(
      static_cast<const U*>(u), a, static_cast<const U*>(Bm),
      static_cast<const U*>(Cm), static_cast<U*>(y), sfin, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// u [B, S, H, P], y [B, S, H, P] (fp32, or bf16 when bf16 != 0);
// a [B, S, H] fp32; Bm, Cm [B, S, N] in u's dtype; sfin [B, H, N, P] fp32.
// Contiguous device pointers.  Chunks of Q = min(chunk, S) rows.  Launches
// on `stream` and returns the launch's CUDA error code (0 on success).
int ssd_scan_launch(const void* u, const void* a, const void* Bm,
                    const void* Cm, void* y, void* sfin, int B, int S, int H,
                    int P, int N, int chunk, int bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > PMAX || N < 1 || N > NMAX ||
      chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, S, H, P, N, min(chunk, S)};
  if (s.Q > QMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(sfin);
  return bf16 ? launch<__nv_bfloat16>(u, af, Bm, Cm, y, sf, s, st)
              : launch<float>(u, af, Bm, Cm, y, sf, s, st);
}

}  // extern "C"
