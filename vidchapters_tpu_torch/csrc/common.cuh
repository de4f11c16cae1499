// Small helpers shared by the kernels of this package.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace vc {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA round
}

// Round a float through T and back: the value a T-typed tensor would hold.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Attention-probability dropout of the fused attention kernels, as
// vidchapters_tpu/ops/fused_attention.py::_keep_scale computes it: one
// murmur3 hash of x = row * (Lk/2) + col (row absolute, Lk the padded key
// length) gives two 16-bit decisions, the low half for key col < Lk/2 and
// the high half for key col + Lk/2. A kept element is scaled by inv.
struct Dropout {
  unsigned seed;    // uint32 seed of the call
  int on;           // 0: no dropout (keep_scale is never called)
  unsigned thresh;  // min(int(rate * 65536), 65535)
  float inv;        // float32(1 / (1 - rate))
  int h0;           // the model's index of the launch's head 0 (tensor parallelism)
};

// The mask of (example b, head h of the launch) is the one of head h0 + h of
// the whole model, so a rank holding heads [h0, h0 + H) keeps what one
// process keeps for them.
__device__ __forceinline__ unsigned dropout_mix(const Dropout& dr, int b, int h) {
  return dr.seed ^ ((unsigned)b * 0x9E3779B1u) ^ ((unsigned)(h + dr.h0) * 0x85EBCA6Bu);
}

// The hash of (row, col), col < half = Lk / 2: its low 16 bits decide key
// col, its high 16 bits key col + half.
__device__ __forceinline__ unsigned keep_hash(unsigned mixed, int row, unsigned col,
                                              unsigned half) {
  unsigned x = (unsigned)row * half + col;
  x ^= mixed;
  x *= 0xCC9E2D51u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The scale of one 16-bit decision: inv where kept, else 0.
__device__ __forceinline__ float keep_bits(const Dropout& dr, unsigned bits) {
  return bits >= dr.thresh ? dr.inv : 0.f;
}

__device__ __forceinline__ float keep_scale(const Dropout& dr, unsigned mixed, int row,
                                            int key, int Lk) {
  const unsigned half = (unsigned)Lk >> 1;
  const bool high = (unsigned)key >= half;
  const unsigned x = keep_hash(mixed, row, (unsigned)key - (high ? half : 0u), half);
  return keep_bits(dr, high ? (x >> 16) : (x & 0xFFFFu));
}

}  // namespace vc

// Entry points return the launch's error code; dtype codes: 0 = float32, 1 = bfloat16.
#define VC_DTYPE_F32 0
#define VC_DTYPE_BF16 1
