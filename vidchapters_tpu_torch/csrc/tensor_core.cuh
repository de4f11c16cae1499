// Tensor-core building blocks of the bf16 fused-attention kernels: the
// warp-level mma.sync.m16n8k16 (bf16 in, fp32 accumulate), ldmatrix to feed
// it from shared memory, and cp.async to fill shared memory.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"); in a warp,
// lane = 4 g + t:
//   A (16 x 16, row-major)  reg0 (g, 2t..2t+1)  reg1 (g+8, 2t..)
//                           reg2 (g, 2t+8..)    reg3 (g+8, 2t+8..)
//   B (16 x 8, k x n)       reg0 (k 2t..2t+1, n g)   reg1 (k 2t+8.., n g)
//   C (16 x 8, fp32)        c0, c1 (g, 2t..2t+1)     c2, c3 (g+8, 2t..2t+1)
// So the C tiles of two neighbouring n-tiles, rounded to bf16 in pairs, are
// the A fragment of the next product (P after Q K^T, dS after dO V^T) with no
// trip through shared memory. ldmatrix hands lane 4 g + t the pair (g, 2t) of
// each 8 x 8 matrix, or (2t, g) with .trans, which is the same layout.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vc {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously. `bytes` < 16 fills
// the rest with zeros; 0 reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b on the tensor cores: a 16 x 16, b 16 x 8 (two registers), c 16 x 8 fp32.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even, as torch rounds), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// The A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a row-major
// shared tile (row stride ld). Read as C-layout pairs, the same registers are
// the two 16 x 8 C tiles of that block: {r0, r1} = (c0/c1, c2/c3) of the
// n-tile at c0, {r2, r3} those of the n-tile at c0 + 8.
__device__ __forceinline__ void load_a(uint32_t r[4], const bf16* s, int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, s + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles from a tile stored n-major ([n][k], row stride
// ld): n [n0, n0 + 16), k [k0, k0 + 16). {r0, r1} is n-tile n0, {r2, r3} n0 + 8.
__device__ __forceinline__ void load_b(uint32_t r[4], const bf16* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The C-layout pairs of the transpose of the stored block rows [r0, r0 + 16)
// x cols [c0, c0 + 16): the 16 x 16 block T[c][r], as two C tiles ordered as
// load_a orders them ({r0, r1} the n-tile of stored rows r0.., {r2, r3} r0 + 8..).
__device__ __forceinline__ void load_ct(uint32_t r[4], const bf16* s, int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, s + (r0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles from a tile stored k-major ([k][n], row stride
// ld, as V is for P V): k [k0, k0 + 16), n [n0, n0 + 16).
__device__ __forceinline__ void load_b_kn(uint32_t r[4], const bf16* s, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, s + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// Rows [r0, r0 + ROWS) x COLS of a row-major bf16 matrix (row stride src_ld)
// into shared memory (row stride dst_ld) with cp.async; rows at or past
// `rows` become zeros. COLS * 2 bytes is a multiple of 16, and so is every
// row's address.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, int dst_ld, const bf16* src, long src_ld,
                                          int r0, int rows) {
  constexpr int CPR = COLS / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * dst_ld + cc, ok ? src + (long)(r0 + r) * src_ld + cc : src,
               ok ? 16 : 0);
  }
}

}  // namespace tc
}  // namespace vc
