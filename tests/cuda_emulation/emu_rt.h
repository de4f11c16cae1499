// A CPU stand-in for the CUDA runtime and warp primitives that the fused
// attention, top-k and decode-attention kernels use, so that their sources
// compile with g++ and run on the CPU in tests
// (tests/test_torch_fused_attention_emulated.py,
// tests/test_torch_decode_kernels_emulated.py).
//
// Each CUDA thread is an OS thread; the blocks of a grid run one after
// another, so a block that counts arrivals with atomics meets every other
// block of the grid finished. __syncthreads is a barrier of the block's
// threads; atomics are the compiler's, and __threadfence a full fence. The warp
// collectives (shuffles, ldmatrix, mma.sync) post each lane's operands into
// the warp's exchange buffer, meet at the warp's barrier, compute every
// lane's result from all 32 posts by the PTX ISA's fragment layouts, and meet
// again before the buffer is reused. cp.async copies at once; its groups
// need no waiting. Shared memory is one static buffer, filled with 0xff
// bytes before each block, as uninitialised memory would be.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <stddef.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
// a static __shared__ array is one object for all threads: the block that runs owns it
#define __shared__ static
#define __restrict__
#define __align__(n)
#define __launch_bounds__(...)
#define CUDART_INF_F (__builtin_inff())

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class T> cudaError_t cudaFuncSetAttribute(T, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }

struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
using std::min;
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }

// the dynamic shared memory of the block that runs (227 KB, the H100's most)
alignas(16) inline unsigned char smem_raw[232448];
alignas(16) inline float smem[232448 / 4];

namespace emu {
struct Warp {
  std::unique_ptr<std::barrier<>> bar;
  alignas(16) unsigned char buf[32][128];
};
inline std::vector<Warp> warps;
inline std::unique_ptr<std::barrier<>> block_bar;
inline int lane() { return threadIdx.x & 31; }
inline Warp& warp() { return warps[threadIdx.x >> 5]; }
template <class T> inline void post(const T& v) {
  static_assert(sizeof(T) <= 128, "post");
  std::memcpy(warp().buf[lane()], &v, sizeof(T));
  warp().bar->arrive_and_wait();
}
inline void done() { warp().bar->arrive_and_wait(); }
template <class T> inline T at(int l) {
  T v;
  std::memcpy(&v, warp().buf[l], sizeof(T));
  return v;
}
}  // namespace emu

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp().bar->arrive_and_wait(); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int o) {
  emu::post(v);
  T r = emu::at<T>(emu::lane() ^ o);
  emu::done();
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  emu::post(v);
  T r = emu::at<T>(src & 31);
  emu::done();
  return r;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline size_t __cvta_generic_to_shared(const void*) { return 0; }

struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}

namespace emu {
inline float half(uint32_t r, int hi) {
  return __bfloat162float({(unsigned short)(hi ? r >> 16 : r & 0xffff)});
}
// ldmatrix .x4: lane 4 g + t receives (row g, cols 2t, 2t + 1) of matrix j,
// or with .trans (rows 2t, 2t + 1, col g); lane 8 j + i gave row i's address.
inline void ldmatrix(uint32_t r[4], const void* p, bool trans) {
  post(p);
  const int g = lane() >> 2, t = lane() & 3;
  for (int j = 0; j < 4; ++j) {
    unsigned short e[2];
    for (int i = 0; i < 2; ++i)
      e[i] = trans ? static_cast<const unsigned short*>(at<const void*>(8 * j + 2 * t + i))[g]
                   : static_cast<const unsigned short*>(at<const void*>(8 * j + g))[2 * t + i];
    r[j] = (uint32_t)e[0] | ((uint32_t)e[1] << 16);
  }
  done();
}
struct MmaIn { uint32_t a[4], b[2]; float c[4]; };
// mma.sync.m16n8k16 bf16 -> fp32: A, B and C gathered from all lanes.
inline void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  MmaIn in;
  std::memcpy(in.a, a, 16);
  in.b[0] = b0;
  in.b[1] = b1;
  std::memcpy(in.c, c, 16);
  post(in);
  float A[16][16], B[16][8], C[16][8];
  for (int l = 0; l < 32; ++l) {
    const MmaIn x = at<MmaIn>(l);
    const int g = l >> 2, t = l & 3;
    for (int i = 0; i < 2; ++i) {
      A[g][2 * t + i] = half(x.a[0], i);
      A[g + 8][2 * t + i] = half(x.a[1], i);
      A[g][2 * t + 8 + i] = half(x.a[2], i);
      A[g + 8][2 * t + 8 + i] = half(x.a[3], i);
      B[2 * t + i][g] = half(x.b[0], i);
      B[2 * t + 8 + i][g] = half(x.b[1], i);
      C[g][2 * t + i] = x.c[i];
      C[g + 8][2 * t + i] = x.c[2 + i];
    }
  }
  done();
  const int g = lane() >> 2, t = lane() & 3;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float s = C[row][col];
    for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
    c[e] = s;
  }
}
template <class F> void run_grid(dim3 g, dim3 b, F f) {
  gridDim = g;
  blockDim = b;
  const int nt = b.x * b.y * b.z;
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) {
        blockIdx = {x, y, z};
        warps = std::vector<Warp>((nt + 31) / 32);
        for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(32);
        block_bar = std::make_unique<std::barrier<>>(nt);
        std::memset(smem_raw, 0xff, sizeof(smem_raw));
        std::memset(smem, 0xff, sizeof(smem));
        std::vector<std::thread> threads;
        for (int i = 0; i < nt; ++i)
          threads.emplace_back([&, i] {
            threadIdx = {(unsigned)i, 0, 0};
            f();
          });
        for (auto& th : threads) th.join();
      }
}
}  // namespace emu

// kern<<<grid, block, smem, stream>>>(args) is rewritten as
// vc_bind(kern, grid, block, smem, stream)(args)
template <class K> auto vc_bind(K kern, dim3 g, dim3 b, size_t = 0, void* = nullptr) {
  return [=](auto... args) { emu::run_grid(g, b, [=]() { kern(args...); }); };
}
