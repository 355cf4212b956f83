// Shared pieces of the three conv-dataflow kernels (mconv_mc.cu,
// sconv_ic.cu, sconv_od.cu): the problem shape, fp32/bf16 loads and
// stores, the 16/8/4-byte cp.async copies used to stage operands into
// shared memory, the split plan's busiest-SM rule, the ordered sum of the
// splits, and the host-side launch checks.
//
// Layouts are the JAX package's: x [N, H, W, Cin], w [KH, KW, Cin, Cout],
// out [N, Ho, Wo, Cout], all contiguous.  Every kernel computes the VALID
// convolution at stride s directly: output (oh, ow) reads input rows
// oh*s .. oh*s+KH-1 and columns ow*s .. ow*s+KW-1, so Ho = (H-KH)/s + 1.
// That equals the stride-1 VALID convolution subsampled by [::s], which is
// what the JAX wrapper computes, without the s*s-fold wasted outputs.
//
// Splits.  A kernel whose output tiles leave SMs idle or unevenly loaded
// cuts its reduction axis (Cin, or MconvMC's K) into G contiguous parts
// over gridDim.z.  Each part writes an fp32 workspace [G, M, Cout]
// (M = N*Ho*Wo), and sum_splits adds the parts in split order and casts
// once: no atomics, so two calls give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <array>
#include <initializer_list>
#include <map>
#include <mutex>

namespace conv {

constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may use (sm_90)

// MconvMC and SconvIC do not split a conv of fewer MACs than this.  A
// split adds a second launch (a few microseconds of the host's time and a
// gap of about two on the device) and a workspace round trip; 2^25 MACs
// take about 1 microsecond at the card's fp32 peak, so below it the split
// cannot pay.  It keeps the small convs of the width-0.1 pools, which are
// bound by the host, at one launch each.  Such a conv leaves most of the
// card idle and is bound by latency: the chain of FMAs one thread does
// over the whole reduction.  So below it both kernels take a tile with a
// quarter of the outputs a thread (and more blocks) instead of splitting.
constexpr long long MIN_SPLIT_MACS = 1LL << 25;

struct Shape {
  int N, H, W, Cin, KH, KW, Cout, stride, Ho, Wo;
};

inline Shape make_shape(int N, int H, int W, int Cin, int KH, int KW,
                        int Cout, int stride) {
  Shape s{N, H, W, Cin, KH, KW, Cout, stride, 0, 0};
  if (stride >= 1 && H >= KH && W >= KW) {
    s.Ho = (H - KH) / stride + 1;
    s.Wo = (W - KW) / stride + 1;
  }
  return s;
}

inline bool valid(const Shape& s) {
  return s.N >= 1 && s.Cin >= 1 && s.Cout >= 1 && s.KH >= 1 && s.KW >= 1 &&
         s.stride >= 1 && s.Ho >= 1 && s.Wo >= 1;
}

inline long long macs(const Shape& s) {
  return static_cast<long long>(s.N) * s.Ho * s.Wo * s.KH * s.KW * s.Cin *
         s.Cout;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// round to nearest even, as torch's and JAX's casts to bfloat16
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16-, 8- or 4-byte global -> shared copies without a register; n (the
// source bytes) 0 writes zeros.  src must be a valid address even then.
__device__ __forceinline__ void cp16(float* dst, const float* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp8(float* dst, const float* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}
// One element into shared memory as fp32, or a zero where !in: fp32 by a
// 4-byte cp.async; bf16 through a register, because cp.async copies bytes
// and cannot widen them.
__device__ __forceinline__ void put(float* dst, const float* src, bool in) {
  cp4(dst, src, in ? 4 : 0);
}
__device__ __forceinline__ void put(float* dst, const __nv_bfloat16* src,
                                    bool in) {
  *dst = in ? __bfloat162float(*src) : 0.f;
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed copy groups are still in
// flight (callers follow with __syncthreads() so every thread sees every
// copy).
template <int N> __device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// out = sum over the G splits of ws, in split order, cast once
template <typename T>
__global__ void sum_splits(const float* __restrict__ ws, T* __restrict__ out,
                           long long count, int G) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = ws[i];
    for (int z = 1; z < G; ++z) v += ws[z * count + i];
    out[i] = from_f32<T>(v);
  }
}

// xp = x [pixels, C] with its channel rows padded with zeros to Cp (a
// multiple of 4), as fp32: a copy whose rows are 16-byte aligned, so a
// kernel can stage them by 16-byte copies.  A warp copies a pixel's row at
// a time, lanes along the channels, 4 channels a lane.
template <typename T>
__global__ void pad_channels(const T* __restrict__ x, float* __restrict__ xp,
                             long long pixels, int C, int Cp) {
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * blockDim.x / 32;
  for (long long p = (blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x) / 32;
       p < pixels; p += warps) {
    const T* src = x + p * C;
    float* dst = xp + p * Cp;
    for (int c = 4 * lane; c < Cp; c += 128) {
      float4 v;
      v.x = c < C ? to_f32(src[c]) : 0.f;
      v.y = c + 1 < C ? to_f32(src[c + 1]) : 0.f;
      v.z = c + 2 < C ? to_f32(src[c + 2]) : 0.f;
      v.w = c + 3 < C ? to_f32(src[c + 3]) : 0.f;
      *reinterpret_cast<float4*>(dst + c) = v;
    }
  }
}

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// make(s), made once per device and shape and then looked up: the small
// convs of the pools are bound by the host.  make() reads the device
// (its SMs, a kernel's residency) and prepares it (each kernel's shared
// memory limit), so one plan per device is all that needs remembering.
template <typename Plan>
Plan memoized(const Shape& s, Plan (*make)(const Shape&)) {
  static std::mutex mu;
  static std::map<std::array<int, 9>, Plan> plans;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return make(s);
  const std::array<int, 9> key{dev, s.N, s.H, s.W, s.Cin, s.KH, s.KW,
                               s.Cout, s.stride};
  std::lock_guard<std::mutex> lock(mu);
  auto it = plans.find(key);
  if (it != plans.end()) return it->second;
  return plans[key] = make(s);
}

// The streaming multiprocessors of the current device (0 on an error).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// Blocks of a kernel that one SM of the current device holds at once with
// `threads` threads and `smem` bytes of dynamic shared memory, from the
// fp32 instantiation's registers and shared memory (0 on an error, or
// when one block does not fit).  It first allows both instantiations
// (f32, bf16) the whole SMEM_LIMIT on this device, which a launch above
// 48 KB needs: a plan is made on each device before any launch there.
inline int resident_blocks(const void* f32, const void* bf16, int threads,
                           size_t smem) {
  for (const void* f : {f32, bf16})
    if (cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT) != cudaSuccess)
      return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, f32, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return n;
}

// The split rule counts at most this many resident blocks an SM, whatever
// the occupancy calculator allows.  All three kernels' plans were tuned
// and timed with it (SconvOD's G = 15 / 3, SconvIC's 15 / 3 at YOLO's /
// SSD's largest layers); SconvOD's registers and shared memory would
// allow 4 at YOLO's layer, which would cut it into G = 20 splits, a plan
// never timed.
constexpr int MAX_RESIDENT = 3;

// The busiest-SM rule: the number of splits G (1 .. units) of a reduction
// of `units` steps over `tiles` output tiles that gives the busiest SM the
// least work, ceil(tiles * G / sms) blocks of units / G steps each, with
// every block resident at once (tiles * G <= resident * sms, resident
// capped at MAX_RESIDENT); ties go to the larger G, whose extra blocks
// hide latency.  1 where even G = 1 does not fit at once.
inline int split_count(long long tiles, int units, int resident, int sms) {
  if (resident > MAX_RESIDENT) resident = MAX_RESIDENT;
  int G = 1;
  double best = 1e30;
  for (int g = 1; g <= units && tiles * g <= 1LL * resident * sms; ++g) {
    const double cost = static_cast<double>(ceil_div(tiles * g, sms)) / g;
    if (cost <= best * (1 + 1e-9)) {
      best = cost;
      G = g;
    }
  }
  return G;
}

// Blocks of 256 threads for a grid-stride pass over `count` elements.
inline int pass_blocks(long long count, int sms) {
  const long long want = count / 256 + 1;
  return static_cast<int>(want < 4LL * sms ? want : 4LL * sms);
}

// Launch sum_splits for `count` outputs of G splits on `sms` SMs.
template <typename T>
cudaError_t launch_sum_splits(const float* ws, T* out, long long count, int G,
                              int sms, cudaStream_t stream) {
  sum_splits<T><<<pass_blocks(count, sms), 256, 0, stream>>>(ws, out, count,
                                                            G);
  return cudaGetLastError();
}

// Launch pad_channels for x [pixels, C] into xp [pixels, Cp].
template <typename T>
cudaError_t launch_pad_channels(const T* x, float* xp, long long pixels,
                                int C, int Cp, int sms, cudaStream_t stream) {
  pad_channels<T><<<pass_blocks(pixels * 32, sms), 256, 0, stream>>>(
      x, xp, pixels, C, Cp);
  return cudaGetLastError();
}

// Floats of the fp32 workspace [G, M, Cout] of G > 1 splits (0 for one),
// rounded up to a multiple of 4 so that what follows it stays 16-byte
// aligned.
inline long long split_floats(const Shape& s, int G) {
  if (G <= 1) return 0;
  const long long n = static_cast<long long>(G) * s.N * s.Ho * s.Wo * s.Cout;
  return (n + 3) / 4 * 4;
}

}  // namespace conv
