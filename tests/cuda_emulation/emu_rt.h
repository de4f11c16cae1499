// A CPU stand-in for the CUDA runtime and warp primitives that the fused
// attention, top-k, decode-attention, Whisper and T5 decode, probe and
// deformable-attention kernels use, so that their sources compile with g++
// and run on the CPU in tests (tests/test_torch_*_emulated.py).
//
// Each CUDA thread is a fiber: its own stack, switched to and from by hand
// (x86-64; ucontext elsewhere) on the OS thread that launched the kernel,
// which runs the fibers of a launch round-robin. A fiber runs until it waits
// at a barrier (warp, block, cluster) or in __nanosleep, so a launch creates
// no OS thread, waits on no futex and takes one core; a kernel that spun on
// memory without __nanosleep would not end. The blocks of a grid launched
// with <<<>>> run one after another, so a block that counts arrivals with
// atomics meets every other block of the grid finished. A cooperative launch
// (cudaLaunchKernelEx with cudaLaunchAttributeCooperative) runs all its
// blocks at once, as a grid barrier needs; the SM count it reads is
// $EMU_SM_COUNT (default 2). A launch with a cluster dimension (x only) runs
// the blocks of one cluster at once, one cluster after another, and
// cooperative_groups::this_cluster() gives its barrier, the block's rank and
// map_shared_rank into another block's dynamic shared memory. Each block has
// its own blockIdx, warps, block barrier and dynamic shared memory; a static
// __shared__ array is one object for the whole grid, so a cooperative kernel
// keeps its shared memory dynamic. __syncthreads is a barrier of the block's
// threads; atomics are the compiler's (float ones through std::atomic_ref),
// and __threadfence a full fence. The warp collectives (shuffles, votes,
// ldmatrix, mma.sync) post each lane's operands into the warp's exchange
// buffer, meet at the warp's barrier, compute every lane's result from all
// 32 posts by the PTX ISA's fragment layouts, and meet again before the
// buffer is reused. cp.async copies at once; its groups need no waiting.
// Dynamic shared memory is filled with 0xff bytes before each block, as
// uninitialised memory would be.
#pragma once
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <type_traits>
#include <vector>
#include <stddef.h>
#include <sys/mman.h>
#if !defined(__x86_64__)
#include <ucontext.h>
#endif

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
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
inline thread_local uint3 blockIdx;
inline dim3 blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaLaunchAttributeID { cudaLaunchAttributeCooperative = 2,
                             cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  int cooperative;
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class T> cudaError_t cudaFuncSetAttribute(T, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t = nullptr) {
  std::memset(p, v, n);
  return 0;
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  const char* s = std::getenv("EMU_SM_COUNT");
  *v = s != nullptr ? std::atoi(s) : 2;
  return 0;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return 0;
}

struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct int2 { int x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// byte n of the result is byte (s >> 4n) & 7 of the 8 bytes {y, x}, x first
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
using std::max;
using std::min;
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline float __fsub_rn(float a, float b) { return a - b; }

namespace emu {
// ---- fibers ----
struct Block;
struct Fiber {
#if defined(__x86_64__)
  void* sp = nullptr;  // its saved stack pointer while it is not running
#else
  ucontext_t ctx;
#endif
  Block* blk = nullptr;
  uint3 bid{}, tid{};
  bool finished = false;
  unsigned cluster_gen = 0;  // the cluster barrier's generation at its arrive
};
struct Sched {
#if defined(__x86_64__)
  void* sp = nullptr;  // the launching thread's own context
#else
  ucontext_t ctx;
#endif
  Fiber* cur = nullptr;
  void (*body)(void*) = nullptr;
  void* arg = nullptr;
  std::vector<char*> stacks;  // reused by every launch of this OS thread
};
inline thread_local Sched sched;
constexpr size_t STACK_BYTES = size_t(1) << 19;  // reserved, not committed: pages on touch
constexpr size_t GUARD_BYTES = 4096;              // a PROT_NONE page under each stack

#if defined(__x86_64__)
// emu_fiber_switch(save, to): push the callee-saved registers and the SSE and
// x87 control words, store the stack pointer in *save, then pop them from
// the stack `to` and return into it.
asm(R"(
  .pushsection .text
  .p2align 4
  .globl emu_fiber_switch
  .hidden emu_fiber_switch
  .type emu_fiber_switch, @function
emu_fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  subq $8, %rsp
  stmxcsr (%rsp)
  fnstcw 4(%rsp)
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  ldmxcsr (%rsp)
  fldcw 4(%rsp)
  addq $8, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_fiber_switch, .-emu_fiber_switch
  .popsection
)");
extern "C" void emu_fiber_switch(void** save, void* to);
#endif

// From the running fiber back to the launching thread, which resumes the next.
inline void yield() {
#if defined(__x86_64__)
  emu_fiber_switch(&sched.cur->sp, sched.sp);
#else
  swapcontext(&sched.cur->ctx, &sched.ctx);
#endif
}
[[noreturn]] inline void fiber_main() {
  sched.body(sched.arg);
  sched.cur->finished = true;
  yield();
  __builtin_unreachable();
}
inline char* fiber_stack(size_t i) {
  while (sched.stacks.size() <= i) {
    void* p = mmap(nullptr, STACK_BYTES, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE | MAP_STACK, -1, 0);
    if (p == MAP_FAILED) std::abort();
    mprotect(p, GUARD_BYTES, PROT_NONE);
    sched.stacks.push_back(static_cast<char*>(p));
  }
  return sched.stacks[i];
}
// Fiber f, on stack i, to start at fiber_main when it is first resumed.
inline void fiber_start(Fiber& f, size_t i) {
  char* base = fiber_stack(i);
#if defined(__x86_64__)
  // the frame emu_fiber_switch pops: control words, r15 .. rbp, the return
  // address (fiber_main, entered with rsp = 8 mod 16 as after a call)
  uint64_t* top = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(base) + STACK_BYTES) & ~uintptr_t(15));
  top[-1] = 0;
  top[-2] = reinterpret_cast<uint64_t>(&fiber_main);
  for (int r = 3; r <= 8; ++r) top[-r] = 0;
  uint32_t mxcsr;
  uint16_t fpucw;
  asm volatile("stmxcsr %0" : "=m"(mxcsr));
  asm volatile("fnstcw %0" : "=m"(fpucw));
  top[-9] = 0;
  std::memcpy(&top[-9], &mxcsr, 4);
  std::memcpy(reinterpret_cast<char*>(&top[-9]) + 4, &fpucw, 2);
  f.sp = &top[-9];
#else
  getcontext(&f.ctx);
  f.ctx.uc_stack.ss_sp = base + GUARD_BYTES;
  f.ctx.uc_stack.ss_size = STACK_BYTES - GUARD_BYTES;
  f.ctx.uc_link = nullptr;
  makecontext(&f.ctx, reinterpret_cast<void (*)()>(&fiber_main), 0);
#endif
}
inline thread_local Block* block;
// Run fibers round-robin until every one has finished.
inline void run_fibers(std::vector<Fiber>& fs) {
  for (size_t live = fs.size(); live > 0;) {
    for (auto& f : fs) {
      if (f.finished) continue;
      sched.cur = &f;
      block = f.blk;
      blockIdx = f.bid;
      threadIdx = f.tid;
#if defined(__x86_64__)
      emu_fiber_switch(&sched.sp, f.sp);
#else
      swapcontext(&sched.ctx, &f.ctx);
#endif
      if (f.finished) --live;
    }
  }
  sched.cur = nullptr;
}
// A barrier of `expected` fibers; the last to arrive goes on at once, the
// others yield until its arrival has opened the next generation.
struct Barrier {
  explicit Barrier(std::ptrdiff_t n) : expected(n) {}
  std::ptrdiff_t expected, arrived = 0;
  unsigned gen = 0;
  unsigned arrive() {
    const unsigned g = gen;
    if (++arrived == expected) {
      arrived = 0;
      ++gen;
    }
    return g;
  }
  void wait(unsigned g) const {
    while (gen == g) yield();
  }
  void arrive_and_wait() { wait(arrive()); }
};

constexpr size_t SMEM_BYTES = 232448;  // a block's dynamic shared memory, the H100's most
struct Warp {
  std::unique_ptr<Barrier> bar;
  alignas(16) unsigned char buf[32][128];
};
struct Cluster;
struct Block {
  std::vector<Warp> warps;
  std::unique_ptr<Barrier> bar;
  std::unique_ptr<unsigned char[]> smem;  // operator new[]: 16-byte aligned
  Cluster* cluster = nullptr;             // the blocks launched with it, if any
  unsigned rank = 0;                      // its rank in the cluster
};
struct Cluster {
  std::vector<Block*> blocks;
  std::unique_ptr<Barrier> bar;  // every thread of every block
};
inline int lane() { return threadIdx.x & 31; }
inline Warp& warp() { return block->warps[threadIdx.x >> 5]; }
inline unsigned char* dyn_smem() { return block->smem.get(); }
inline unsigned long long now_ns() {
  return (unsigned long long)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
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

inline void __syncthreads() { emu::block->bar->arrive_and_wait(); }
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
inline unsigned __ballot_sync(unsigned, int pred) {
  emu::post(pred != 0);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= (unsigned)emu::at<bool>(l) << l;
  emu::done();
  return r;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }
inline unsigned __match_any_sync(unsigned, int v) {
  emu::post(v);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= (unsigned)(emu::at<int>(l) == v) << l;
  emu::done();
  return r;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}
inline void __nanosleep(unsigned) { emu::yield(); }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline T __ldg(const T* p) { return *p; }
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
inline std::unique_ptr<Block> new_block(int nt) {
  auto b = std::make_unique<Block>();
  b->warps = std::vector<Warp>((nt + 31) / 32);
  for (auto& w : b->warps) w.bar = std::make_unique<Barrier>(32);
  b->bar = std::make_unique<Barrier>(nt);
  b->smem.reset(new unsigned char[SMEM_BYTES]);
  std::memset(b->smem.get(), 0xff, SMEM_BYTES);
  return b;
}
// The blocks of grid g one after another, all at once when `together`, or
// `cluster` consecutive blocks along x at once (gridDim.x a multiple of it):
// each wave's threads are fibers run to their end before the next wave.
template <class F> void run_grid(dim3 g, dim3 b, F f, bool together = false,
                                 unsigned cluster = 1) {
  gridDim = g;
  blockDim = b;
  const int nt = b.x * b.y * b.z;
  std::vector<uint3> ids;
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) ids.push_back({x, y, z});
  if (cluster > 1 && g.x % cluster != 0) std::abort();
  const size_t wave = together ? ids.size() : cluster;
  sched.body = +[](void* p) { (*static_cast<F*>(p))(); };
  sched.arg = &f;
  std::vector<Fiber> fibers;
  for (size_t i0 = 0; i0 < ids.size(); i0 += wave) {
    std::vector<std::unique_ptr<Block>> blocks;
    Cluster cl;
    cl.bar = std::make_unique<Barrier>(nt * (std::ptrdiff_t)wave);
    for (size_t i = i0; i < i0 + wave; ++i) {
      blocks.push_back(new_block(nt));
      if (cluster > 1) {
        blocks.back()->cluster = &cl;
        blocks.back()->rank = (unsigned)(i - i0);
        cl.blocks.push_back(blocks.back().get());
      }
    }
    fibers.assign(wave * nt, Fiber{});
    for (size_t i = i0; i < i0 + wave; ++i)
      for (int t = 0; t < nt; ++t) {
        Fiber& fb = fibers[(i - i0) * nt + t];
        fb.blk = blocks[i - i0].get();
        fb.bid = ids[i];
        fb.tid = {(unsigned)t, 0, 0};
        fiber_start(fb, (i - i0) * nt + t);
      }
    run_fibers(fibers);
  }
}
}  // namespace emu

// kern<<<grid, block, smem, stream>>>(args) is rewritten as
// vc_bind(kern, grid, block, smem, stream)(args)
template <class K> auto vc_bind(K kern, dim3 g, dim3 b, size_t = 0, void* = nullptr) {
  return [=](auto... args) { emu::run_grid(g, b, [=]() { kern(args...); }); };
}

template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kern)(P...), A... args) {
  bool coop = false;
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i) {
    coop = coop || (cfg->attrs[i].id == cudaLaunchAttributeCooperative &&
                    cfg->attrs[i].val.cooperative != 0);
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      if (cfg->attrs[i].val.clusterDim.y != 1 || cfg->attrs[i].val.clusterDim.z != 1)
        std::abort();
      cluster = cfg->attrs[i].val.clusterDim.x;
    }
  }
  emu::run_grid(cfg->gridDim, cfg->blockDim, [&]() { kern(args...); }, coop, cluster);
  return 0;
}

namespace emu {
// barrier.cluster.arrive / wait: the two halves of the cluster's barrier
inline void cluster_arrive() {
  if (block->cluster != nullptr) sched.cur->cluster_gen = block->cluster->bar->arrive();
  else __syncthreads();
}
inline void cluster_wait() {
  if (block->cluster != nullptr) block->cluster->bar->wait(sched.cur->cluster_gen);
}
}  // namespace emu

namespace cooperative_groups {
// The cluster of the running block (the block alone when it was launched
// without one).
struct cluster_group {
  void sync() const {
    if (emu::block->cluster != nullptr) emu::block->cluster->bar->arrive_and_wait();
    else __syncthreads();
  }
  unsigned block_rank() const { return emu::block->rank; }
  unsigned num_blocks() const {
    return emu::block->cluster != nullptr ? (unsigned)emu::block->cluster->blocks.size() : 1;
  }
  // p, an address in this block's dynamic shared memory, in block r's
  template <class T> T* map_shared_rank(T* p, unsigned r) const {
    if (emu::block->cluster == nullptr) return p;
    const auto off = reinterpret_cast<unsigned char*>(const_cast<std::remove_cv_t<T>*>(p)) -
                     emu::block->smem.get();
    return reinterpret_cast<T*>(emu::block->cluster->blocks[r]->smem.get() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
