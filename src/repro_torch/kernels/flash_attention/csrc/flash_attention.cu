// Flash attention (block-wise online softmax) for Hopper (sm_90a), fp32
// math on CUDA cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/kernel.py  _kernel (body, line 24),
//   launched by flash_attention_flat through pl.pallas_call (line 80).
// The TPU kernel walks a grid (B*H, Q blocks, KV blocks) with the KV axis
// sequential and carries the running max, normalizer and accumulator in
// VMEM scratch from one grid step to the next; causal KV blocks above the
// diagonal are skipped.  Here one block owns one (batch, head, 64-row query
// tile) and walks the KV tiles in a loop, so the running max m, the
// normalizer l and the 64 x D accumulator stay in registers for the whole
// walk and never touch device memory.  The loop stops at the diagonal tile
// when causal, as the TPU kernel's pl.when skips those blocks.
//
// Out = softmax(q k^T * scale) v per (batch, head), with the JAX
// package's masking: query position i sees key j when j < Skv and, if
// causal, i >= j (no offset, so Sq == Skv is self-attention).  Masked
// scores are -1e30, as in the reference.
//
// What the TPU kernel asserted away, this kernel handles itself:
//  * ragged lengths: the engine left-pads a wave to its longest prompt, so
//    S is arbitrary (1,437, say).  Query rows past Sq are computed on zeros
//    and never stored; key columns past Skv are masked.
//  * GQA: q [B, Sq, H, D], k/v [B, Skv, K, D] with K dividing H.  The JAX
//    wrapper repeats K/V to H heads in device memory; here head h reads KV
//    head h / (H / K) in place: the same function without the copy.
//  * layout: the model's [B, S, H, D] is read with its own strides; no
//    transpose to [B*H, S, D] and back.
//  * head dims up to 128: the tiles are compiled for DP = 32, 64 or 128
//    columns and a head dim below DP is zero-padded in shared memory (a
//    zero column adds nothing to q.k, and padded output columns are not
//    stored).
//
// Block: 128 threads, a 64 x 64 score tile, each thread owning 4 query
// rows x 8 key columns of the scores and the same 4 rows x DP/8 columns
// of the accumulator, so a row's rescale factor is known to the threads
// that hold the row.  The 8 threads of a row group are neighbouring lanes
// of one warp: the row max and row sum are three xor-shuffles.  Q and K
// tiles are stored transposed in shared memory (d-major) so each step of
// the q.k loop is three 16-byte loads for 32 FMAs; P goes through shared
// memory between the two products.  bf16 inputs are widened as they are
// staged; the output is rounded once to q's dtype.
//
// Bound on the H100: at the timing shape (B 4, S 1024, H 32, D 64, bf16,
// causal) the 4*D FLOPs per kept (query, key) pair take 0.017 ms at the
// bf16 tensor-core peak (989 TFLOP/s), under the 0.020 ms that reading q,
// k, v and writing o takes at 3.35 TB/s; on CUDA cores at 67 TFLOP/s the
// arithmetic alone takes 0.26 ms.  This first kernel does fp32 FMAs on
// CUDA cores (the fp32 path's 1e-4 tolerance rules out TF32), so the
// operations bound it; mma/wgmma on bf16 tiles is the later redesign.

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DP * LDT + BK * DP + BQ * LDT);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Shape s) {
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
  const T* qb = q + (static_cast<long long>(b) * s.Sq * s.H + h) * s.D;
  const T* kb = k + (static_cast<long long>(b) * s.Skv * s.K + kvh) * s.D;
  const T* vb = v + (static_cast<long long>(b) * s.Skv * s.K + kvh) * s.D;
  T* ob = o + (static_cast<long long>(b) * s.Sq * s.H + h) * s.D;

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int i = idx / DP, d = idx % DP;
    Qt[d * LDT + i] = (q0 + i < s.Sq && d < s.D)
        ? to_f32(qb[(q0 + i) * q_row + d]) : 0.f;
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
      Kt[d * LDT + j] = in ? to_f32(kb[off]) : 0.f;
      Vs[j * DP + d] = in ? to_f32(vb[off]) : 0.f;
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
      if (d < s.D) ob[i * q_row + d] = from_f32<T>(acc[ii][c] / lsafe);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           const Shape& s, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.Sq + BQ - 1) / BQ, s.B * s.H);
  flash_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const Shape& s, cudaStream_t stream) {
  if (s.D <= 32) return launch<T, 32>(q, k, v, o, s, stream);
  if (s.D <= 64) return launch<T, 64>(q, k, v, o, s, stream);
  return launch<T, 128>(q, k, v, o, s, stream);
}

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
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, s, st)
              : launch_d<float>(q, k, v, o, s, st);
}

}  // extern "C"
