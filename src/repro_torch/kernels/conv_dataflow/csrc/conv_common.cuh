// Shared pieces of the three conv-dataflow kernels (mconv_mc.cu,
// sconv_ic.cu, sconv_od.cu): the problem shape, fp32/bf16 loads and
// stores, the 4-byte cp.async used to stage operands into shared memory,
// and the host-side launch checks.
//
// Layouts are the JAX package's: x [N, H, W, Cin], w [KH, KW, Cin, Cout],
// out [N, Ho, Wo, Cout], all contiguous.  Every kernel computes the VALID
// convolution at stride s directly: output (oh, ow) reads input rows
// oh*s .. oh*s+KH-1 and columns ow*s .. ow*s+KW-1, so Ho = (H-KH)/s + 1.
// That equals the stride-1 VALID convolution subsampled by [::s], which is
// what the JAX wrapper computes, without the s*s-fold wasted outputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace conv {

constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a block may use (sm_90)

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

// Stage one element into shared memory as fp32.  fp32 goes by a 4-byte
// cp.async (global -> shared without a register); bf16 goes through a
// register, because cp.async copies bytes and cannot widen them.
__device__ __forceinline__ void stage(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

// Wait for this thread's outstanding cp.async copies (callers follow with
// __syncthreads() so every thread sees every copy).
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
inline cudaError_t allow_smem(const void* func, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace conv
