// Fused bias-aware attention, backward: dq, dk, dv (float32) and, with a bias,
// dbias = sum over the batch of dS (float32 [1,H,Lq,Lk]), for the forward
//   out = dropout(softmax(q k^T + bias + (mask - 1) * 1e9)) v.
//
// Replaces: vidchapters_tpu/ops/fused_attention.py::_fused_backward_impl /
// _bwd_kernel (the pl.pallas_call at line 320), with the same hashed keep
// mask as the forward (vc::keep_scale in common.cuh).
//
// Arithmetic, as the TPU kernel's: p is rebuilt from the scores and the
// forward's per-row log-sum-exp, p = exp(s - lse) (the TPU kernel recomputed
// the whole row's softmax; lse makes that O(L) here);
// delta = rowsum(dout * out) with out as stored; dp = dout v^T;
// ds = p (dp keep - delta); ds and p keep are rounded to the input dtype
// before their products, dbias takes ds unrounded.
//
// Two routes, by dtype:
// - bfloat16, the compute dtype of every main path: the tensor-core kernels
//   fused_attention_bwd_dkdv_tc, fused_attention_bwd_dq_tc and
//   fused_attention_bwd_dbias_sum (mma.sync.m16n8k16, bf16 in, fp32
//   accumulate).
// - float32: dkdv_kernel and dq_kernel, the first version on the fp32 CUDA
//   cores, unchanged. Only the checks that hold the card against the CPU at
//   1e-4 run fp32, and TF32 tensor cores (10-bit mantissa) would break them.
// Both start with delta_kernel (one warp per query row).
//
// What bounds it on the H100: at the T5-base encoder's shape (B=8, H=12,
// L=1024, D=64, bf16) the backward needs five L x L x D products per (b, h),
// 10*B*H*L^2*D = 64 GFLOP, and moves q, k, v, out, dout, the bias (88 MB in
// bf16) plus dq, dk, dv and dbias in fp32 (126 MB): ~65 us of tensor-core
// FLOPs against ~64 us of bytes. The tensor-core route does seven products
// (dq's kernel recomputes S and dP), 90 GFLOP, and with a bias writes and
// reads an fp32 dS partial per example: 2 * B * H * L^2 * 4 = 805 MB more
// traffic at L = 1024 (0.24 ms at 3.35 TB/s), the price of a dbias sum with
// no float atomics.
//
// Design of the tensor-core route. Hopper runs blocks in no order, and two
// runs must give the same bits, so there are no float atomics:
//   1. delta: one warp per query row.
//   2. dk/dv: one block of 4 warps per (64-key tile, h, b); each warp owns
//      16 keys. It streams query tiles (Q, dO, the bias tile, lse, delta)
//      through a two-stage cp.async ring and computes, per tile, S^T = K Q^T
//      and dP^T = V dO^T into registers, then P and dS elementwise, then
//      dV += (P keep)^T dO and dK += dS^T Q with P keep and dS rounded to
//      bf16 in registers as the A operands; Q and dO are read transposed by
//      ldmatrix.trans. dk and dv are written once. With a bias, each block
//      writes its unrounded fp32 dS once into a partial [b, h, :, key tile]
//      that no other block touches. No block walks the batch: the grid is
//      1536 blocks at L = 1024, against 192 in the fp32 route.
//   3. dq: one block of 4 warps per (64-row query tile, h, b), streaming key
//      tiles (K, V, bias, mask): S = Q K^T and dP = dO V^T, dS, dQ += dS K.
//      With dropout a tile pairs keys with their partners Lk/2 further on,
//      as the forward's SPLIT walk does, and hashes once for both.
//   4. dbias (with a bias and B > 1): dbias = sum_b partial[b], summed in
//      example order by each thread, four floats at a time. With B = 1 the
//      dk/dv kernel writes dbias itself.
// Tiles along the walked length are 64 for D <= 64 and 32 for D = 128, so
// the accumulators fit the registers.
//
// The fp32 route: the TPU grid is (h, b) with b running in order, and it
// carries dbias across b in VMEM; here dk/dv is one block of 256 threads
// per (64-key tile, h), which walks b in order and, for each b, every
// 64-row query tile. It keeps dk and dv of its key tile in registers and
// writes them once per b; it adds each b's dS into the dbias column
// [h, :, key tile], which no other block touches, so the sum over b runs in
// the TPU kernel's order. Without a bias there is nothing to carry across b,
// and the grid also splits b. dq is one block per (64-row query tile, h, b),
// walking the key tiles. Both recompute the 64 x 64 score tile from q and k
// in shared memory (converted to fp32); each thread owns 4 x 4 of it.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads: 16 x 16

template <int D>
constexpr size_t dkdv_smem_bytes() {  // Ks, Vs, Qs, Gs, Ps, Ss, lse, delta
  return sizeof(float) * (size_t)(4 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {  // Qs, Gs, Ks, Vs, Ss, lse, delta
  return sizeof(float) * (size_t)(4 * BQ * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}

template <typename T, int D>
__global__ void delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                             float* __restrict__ delta, long rows) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += vc::to_f(g[d]) * vc::to_f(o[d]);
  s = vc::warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// Rows [r0, r0 + 64) of a [L, D] matrix into fp32 shared memory [64][D + 1];
// rows at or past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int L) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = (r0 + r < L) ? vc::to_f(src[(long)(r0 + r) * D + d]) : 0.f;
  }
}

// s = A B^T and t = C E^T over one 64 x 64 tile: thread (ty, tx) owns rows
// ty + 16 i of A / C and rows tx + 16 j of B / E.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B, const float* C,
                                             const float* E, float s[4][4], float t[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], c[4], b[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * (D + 1) + d];
      c[i] = C[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = B[(tx + 16 * j) * (D + 1) + d];
      e[j] = E[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        t[i][j] = fmaf(c[i], e[j], t[i][j]);
      }
  }
}

// ds (and the dropped p) of one element from its score s and dp.
struct Grad {
  float ds, pd;
};

__device__ __forceinline__ Grad element_grad(float s, float dp, float lse, float delta,
                                             const vc::Dropout& dr, unsigned mixed, int row,
                                             int key, int Lk) {
  const float p = expf(s - lse);
  const float keep = dr.on ? vc::keep_scale(dr, mixed, row, key, Lk) : 1.f;
  return {p * (dp * keep - delta), p * keep};
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bias, const int* __restrict__ key_mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dbias, int B, int H, int Lq, int Lk, vc::Dropout dr) {
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D + 1]
  float* Qs = Vs + BK * (D + 1);     // [BQ][D + 1]
  float* Gs = Qs + BQ * (D + 1);     // dout [BQ][D + 1]
  float* Ps = Gs + BQ * (D + 1);     // p keep, rounded to T [BQ][BK + 1]
  float* Ss = Ps + BQ * (BK + 1);    // ds, rounded to T [BQ][BK + 1]
  float* Ls = Ss + BQ * (BK + 1);    // lse [BQ]
  float* Ds = Ls + BQ;               // delta [BQ]
  constexpr int CD = D / 16;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y;
  // with a bias one block walks every example, in order, for dbias's sum
  const int b_begin = bias != nullptr ? 0 : blockIdx.z;
  const int b_end = bias != nullptr ? B : blockIdx.z + 1;

  for (int b = b_begin; b < b_end; ++b) {
    const long bh = (long)b * H + h;
    const unsigned mixed = vc::dropout_mix(dr, b, h);
    __syncthreads();  // the previous example's tiles are no longer read
    load_tile<T, D>(Ks, k + bh * Lk * D, k0, Lk);
    load_tile<T, D>(Vs, v + bh * Lk * D, k0, Lk);
    float madd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      madd[j] = ((float)key_mask[(long)b * Lk + k0 + tx + 16 * j] - 1.f) * 1e9f;
    float dka[4][CD], dva[4][CD];  // key rows ty + 16 i, columns tx + 16 c
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) dka[i][c] = dva[i][c] = 0.f;

    for (int q0 = 0; q0 < Lq; q0 += BQ) {
      __syncthreads();  // the previous query tile is no longer read
      load_tile<T, D>(Qs, q + bh * Lq * D, q0, Lq);
      load_tile<T, D>(Gs, dout + bh * Lq * D, q0, Lq);
      if (tid < BQ) {
        const bool ok = q0 + tid < Lq;
        Ls[tid] = ok ? lse[bh * Lq + q0 + tid] : 0.f;
        Ds[tid] = ok ? delta[bh * Lq + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      two_products<D>(Qs, Ks, Gs, Vs, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          Grad g{0.f, 0.f};
          if (row < Lq) {
            float sc = s[i][j];
            if (bias != nullptr) sc += vc::to_f(bias[((long)h * Lq + row) * Lk + key]);
            sc += madd[j];
            g = element_grad(sc, dp[i][j], Ls[r], Ds[r], dr, mixed, row, key, Lk);
            if (dbias != nullptr) {
              float* db = dbias + ((long)h * Lq + row) * Lk + key;
              *db = (b == 0) ? g.ds : *db + g.ds;
            }
          }
          Ps[r * (BK + 1) + tx + 16 * j] = vc::rnd<T>(g.pd);
          Ss[r * (BK + 1) + tx + 16 * j] = vc::rnd<T>(g.ds);
        }
      }
      __syncthreads();

      // dv[key] += sum_r (p keep)[r][key] dout[r]; dk[key] += sum_r ds[r][key] q[r]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float gc[CD], qc[CD];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          gc[c] = Gs[r * (D + 1) + tx + 16 * c];
          qc[c] = Qs[r * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk = Ps[r * (BK + 1) + ty + 16 * i];
          const float sk = Ss[r * (BK + 1) + ty + 16 * i];
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dva[i][c] = fmaf(pk, gc[c], dva[i][c]);
            dka[i][c] = fmaf(sk, qc[c], dka[i][c]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long o = (bh * Lk + k0 + ty + 16 * i) * D;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dk[o + tx + 16 * c] = dka[i][c];
        dv[o + tx + 16 * c] = dva[i][c];
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bias, const int* __restrict__ key_mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int Lq, int Lk,
    vc::Dropout dr) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D + 1]
  float* Gs = Qs + BQ * (D + 1);     // dout [BQ][D + 1]
  float* Ks = Gs + BQ * (D + 1);     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D + 1]
  float* Ss = Vs + BK * (D + 1);     // ds, rounded to T [BQ][BK + 1]
  float* Ls = Ss + BQ * (BK + 1);    // lse [BQ]
  float* Ds = Ls + BQ;               // delta [BQ]
  constexpr int CD = D / 16;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * H + h;
  const unsigned mixed = vc::dropout_mix(dr, b, h);
  load_tile<T, D>(Qs, q + bh * Lq * D, q0, Lq);
  load_tile<T, D>(Gs, dout + bh * Lq * D, q0, Lq);
  if (tid < BQ) {
    const bool ok = q0 + tid < Lq;
    Ls[tid] = ok ? lse[bh * Lq + q0 + tid] : 0.f;
    Ds[tid] = ok ? delta[bh * Lq + q0 + tid] : 0.f;
  }
  float dqa[4][CD];  // query rows ty + 16 i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dqa[i][c] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<T, D>(Ks, k + bh * Lk * D, k0, Lk);
    load_tile<T, D>(Vs, v + bh * Lk * D, k0, Lk);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, Gs, Vs, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const float madd = ((float)key_mask[(long)b * Lk + key] - 1.f) * 1e9f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, row = q0 + r;
        float ds = 0.f;
        if (row < Lq) {
          float sc = s[i][j];
          if (bias != nullptr) sc += vc::to_f(bias[((long)h * Lq + row) * Lk + key]);
          sc += madd;
          ds = element_grad(sc, dp[i][j], Ls[r], Ds[r], dr, mixed, row, key, Lk).ds;
        }
        Ss[r * (BK + 1) + tx + 16 * j] = vc::rnd<T>(ds);
      }
    }
    __syncthreads();

    // dq[r] += sum_key ds[r][key] k[key]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kc[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) kc[c] = Ks[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sv = Ss[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) dqa[i][c] = fmaf(sv, kc[c], dqa[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) dq[(bh * Lq + row) * D + tx + 16 * c] = dqa[i][c];
  }
}

struct Args {
  const void *q, *k, *v, *bias, *key_mask, *out, *dout, *lse;
  void *dq, *dk, *dv, *dbias, *delta, *dbias_part;
  int B, H, Lq, Lk;
  vc::Dropout dr;
};

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* bias = static_cast<const T*>(a.bias);
  const int* mask = static_cast<const int*>(a.key_mask);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);

  const long rows = (long)a.B * a.H * a.Lq;
  delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(a.out), dout, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kv = dkdv_kernel<T, D>;
  const size_t kv_smem = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 kv_grid(a.Lk / BK, a.H, bias != nullptr ? 1 : a.B);
  kv<<<kv_grid, NT, kv_smem, stream>>>(q, k, v, bias, mask, dout, lse, delta,
                                       static_cast<float*>(a.dk), static_cast<float*>(a.dv),
                                       static_cast<float*>(a.dbias), a.B, a.H, a.Lq, a.Lk,
                                       a.dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto qk = dq_kernel<T, D>;
  const size_t q_smem = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 q_grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  qk<<<q_grid, NT, q_smem, stream>>>(q, k, v, bias, mask, dout, lse, delta,
                                     static_cast<float*>(a.dq), a.H, a.Lq, a.Lk, a.dr);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core route
// ---------------------------------------------------------------------------

namespace tcbwd {

using vc::tc::bf16;
constexpr int NT = 128;  // 4 warps, 16 rows (keys or queries) each
constexpr int BR = 64;   // the block's own rows: keys (dk/dv) or queries (dq)

// ds = p (dp keep - delta) with the plain version's three roundings (no
// fused multiply-add): dS is rounded to bf16 before its products, and an
// element whose fp32 value differs from the plain version's by an ulp can
// round to the neighbouring bf16 value, which moves a product term by one
// bf16 ulp of |dS|. Matching the order keeps such flips rare.
__device__ __forceinline__ float plain_ds(float p, float dp, float keep, float delta) {
  return __fmul_rn(p, __fsub_rn(__fmul_rn(dp, keep), delta));
}

// the tile along the walked length (queries for dk/dv, keys for dq)
template <int D>
constexpr int walk_tile() { return D <= 64 ? 64 : 32; }

template <int D>
struct DkdvLayout {
  static constexpr int W = walk_tile<D>();
  static constexpr int LD = D + 8, LB = BR + 8;
  static constexpr int K = 0;                 // [BR][LD]
  static constexpr int V = K + BR * LD;       // [BR][LD]
  static constexpr int Q = V + BR * LD;       // [2][W][LD]
  static constexpr int G = Q + 2 * W * LD;    // dout [2][W][LD]
  static constexpr int B = G + 2 * W * LD;    // bias [2][W][LB] (queries x keys)
  static constexpr int END = B + 2 * W * LB;  // then lse, delta [2][W] float each
  static constexpr size_t bytes = 2 * (size_t)END + 4 * W * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(NT) fused_attention_bwd_dkdv_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ bias, const int* __restrict__ key_mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ ds_part, int H, int Lq, int Lk, vc::Dropout dr) {
  using L = DkdvLayout<D>;
  constexpr int W = L::W, LD = L::LD, LB = L::LB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const bf16* Ks = sm + L::K;
  const bf16* Vs = sm + L::V;
  float* Ls = reinterpret_cast<float*>(sm + L::END);  // [2][W]
  float* Ds = Ls + 2 * W;                              // [2][W]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * H + h;
  const bf16* qp = q + bh * Lq * D;
  const bf16* gp = dout + bh * Lq * D;
  const bf16* bp = bias ? bias + (long)h * Lq * Lk + k0 : nullptr;
  const float* lp = lse + bh * Lq;
  const float* dlp = delta + bh * Lq;
  const unsigned mixed = vc::dropout_mix(dr, b, h);
  const int wk = warp * 16;  // the warp's first key in the tile
  const int nq = (Lq + W - 1) / W;
  float madd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    madd[r] = ((float)key_mask[(long)b * Lk + k0 + wk + g + 8 * r] - 1.f) * 1e9f;

  auto load_stage = [&](int st, int qt) {
    const int q0 = qt * W;
    vc::tc::load_tile<W, D, NT>(sm + L::Q + st * W * LD, LD, qp, D, q0, Lq);
    vc::tc::load_tile<W, D, NT>(sm + L::G + st * W * LD, LD, gp, D, q0, Lq);
    if (bp != nullptr)
      vc::tc::load_tile<W, BR, NT>(sm + L::B + st * W * LB, LB, bp, Lk, q0, Lq);
  };
  // lse and delta of a query tile: thread i < W fetches lse of row i, W + i
  // delta of row i (rows past Lq: 0, and their p is forced to 0)
  auto fetch_rows = [&](int qt) {
    const int i = tid % W, row = qt * W + i;
    if (tid >= 2 * W || row >= Lq) return 0.f;
    return tid < W ? lp[row] : dlp[row];
  };
  auto stash_rows = [&](int st, float x) {
    if (tid < 2 * W) (tid < W ? Ls : Ds)[st * W + tid % W] = x;
  };
  vc::tc::load_tile<BR, D, NT>(sm + L::K, LD, k + bh * Lk * D, D, k0, Lk);
  vc::tc::load_tile<BR, D, NT>(sm + L::V, LD, v + bh * Lk * D, D, k0, Lk);
  load_stage(0, 0);
  vc::tc::cp_async_commit();
  stash_rows(0, fetch_rows(0));

  float dka[D / 8][4], dva[D / 8][4];  // keys wk + g (+8) x columns j*8 + 2t (+1)
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int qt = 0; qt < nq; ++qt) {
    const int st = qt & 1, q0 = qt * W;
    float next = 0.f;
    if (qt + 1 < nq) {
      load_stage(st ^ 1, qt + 1);
      vc::tc::cp_async_commit();
      next = fetch_rows(qt + 1);
      vc::tc::cp_async_wait<1>();
    } else {
      vc::tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qs = sm + L::Q + st * W * LD;
    const bf16* Gs = sm + L::G + st * W * LD;
    const float* Lt = Ls + st * W;
    const float* Dt = Ds + st * W;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x W queries
    float s[W / 8][4], dp[W / 8][4];
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t ak[4], av[4];
      vc::tc::load_a(ak, Ks, LD, wk, ks * 16);
      vc::tc::load_a(av, Vs, LD, wk, ks * 16);
#pragma unroll
      for (int np = 0; np < W / 16; ++np) {
        uint32_t bq[4], bg[4];
        vc::tc::load_b(bq, Qs, LD, np * 16, ks * 16);
        vc::tc::load_b(bg, Gs, LD, np * 16, ks * 16);
        vc::tc::mma(s[2 * np], ak, bq[0], bq[1]);
        vc::tc::mma(s[2 * np + 1], ak, bq[2], bq[3]);
        vc::tc::mma(dp[2 * np], av, bg[0], bg[1]);
        vc::tc::mma(dp[2 * np + 1], av, bg[2], bg[3]);
      }
    }
    if (bp != nullptr) {  // + bias^T, read transposed into the accumulator layout
      const bf16* Bs = sm + L::B + st * W * LB;
#pragma unroll
      for (int np = 0; np < W / 16; ++np) {
        uint32_t bb[4];
        vc::tc::load_ct(bb, Bs, LB, np * 16, wk);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 lo = vc::tc::unpack(bb[2 * half]), hi = vc::tc::unpack(bb[2 * half + 1]);
          float* c = s[2 * np + half];
          c[0] += lo.x;
          c[1] += lo.y;
          c[2] += hi.x;
          c[3] += hi.y;
        }
      }
    }
    // p, ds; element e of n-tile n: key wk + g + 8 (e >> 1), query n*8 + 2t + (e & 1)
    float* part = ds_part != nullptr ? ds_part + bh * Lq * Lk + k0 : nullptr;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1), row = q0 + qi;
        const int kl = wk + g + 8 * (e >> 1);
        const float sc = s[n][e] + madd[e >> 1];
        const float p = row < Lq ? expf(sc - Lt[qi]) : 0.f;
        const float keep = dr.on ? vc::keep_scale(dr, mixed, row, k0 + kl, Lk) : 1.f;
        const float ds = plain_ds(p, dp[n][e], keep, Dt[qi]);
        if (part != nullptr && row < Lq) part[(long)row * Lk + kl] = ds;
        s[n][e] = p * keep;
        dp[n][e] = ds;
      }
    }
    // dV += (P keep)^T dO and dK += dS^T Q, rounded to bf16 as A operands
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      const uint32_t ap[4] = {vc::tc::pack(s[2 * kk][0], s[2 * kk][1]),
                              vc::tc::pack(s[2 * kk][2], s[2 * kk][3]),
                              vc::tc::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              vc::tc::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t as[4] = {vc::tc::pack(dp[2 * kk][0], dp[2 * kk][1]),
                              vc::tc::pack(dp[2 * kk][2], dp[2 * kk][3]),
                              vc::tc::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              vc::tc::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dj = 0; dj < D / 16; ++dj) {
        uint32_t bg[4], bq[4];
        vc::tc::load_b_kn(bg, Gs, LD, kk * 16, dj * 16);
        vc::tc::load_b_kn(bq, Qs, LD, kk * 16, dj * 16);
        vc::tc::mma(dva[2 * dj], ap, bg[0], bg[1]);
        vc::tc::mma(dva[2 * dj + 1], ap, bg[2], bg[3]);
        vc::tc::mma(dka[2 * dj], as, bq[0], bq[1]);
        vc::tc::mma(dka[2 * dj + 1], as, bq[2], bq[3]);
      }
    }
    if (qt + 1 < nq) stash_rows(st ^ 1, next);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long o = (bh * Lk + k0 + wk + g + 8 * r) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(dk + o + j * 8) = make_float2(dka[j][2 * r], dka[j][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + o + j * 8) = make_float2(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

template <int D>
struct DqLayout {
  static constexpr int W = walk_tile<D>();
  static constexpr int LD = D + 8, LB = W + 8;
  static constexpr int Q = 0;                 // [BR][LD]
  static constexpr int G = Q + BR * LD;       // dout [BR][LD]
  static constexpr int K = G + BR * LD;       // [2][W][LD]
  static constexpr int V = K + 2 * W * LD;    // [2][W][LD]
  static constexpr int B = V + 2 * W * LD;    // bias [2][BR][LB] (queries x keys)
  static constexpr int END = B + 2 * BR * LB;  // then the key mask [2][W] int32
  static constexpr size_t bytes = 2 * (size_t)END + 2 * W * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(NT) fused_attention_bwd_dq_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ bias, const int* __restrict__ key_mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int Lq, int Lk,
    vc::Dropout dr) {
  using L = DqLayout<D>;
  constexpr int W = L::W, LD = L::LD, LB = L::LB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const bf16* Qs = sm + L::Q;
  const bf16* Gs = sm + L::G;
  int* Ms = reinterpret_cast<int*>(sm + L::END);  // [2][W]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * H + h;
  const bf16* kp = k + bh * Lk * D;
  const bf16* vp = v + bh * Lk * D;
  const bf16* bp = bias ? bias + (long)h * Lq * Lk : nullptr;
  const int* mp = key_mask + (long)b * Lk;
  const unsigned mixed = vc::dropout_mix(dr, b, h);
  const int wr = warp * 16;  // the warp's first row in the tile
  const int nk = Lk / W;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    lse_r[r] = row < Lq ? lse[bh * Lq + row] : 0.f;
    delta_r[r] = row < Lq ? delta[bh * Lq + row] : 0.f;
  }

  // As in the forward, with dropout tile kt holds keys [kt * W/2, (kt + 1) *
  // W/2) and the same span of the upper half of Lk, so one hash decides both.
  const int lk_half = Lk >> 1;
  const int kstep = dr.on ? W / 2 : W, hoff = dr.on ? lk_half : W / 2;
  auto load_stage = [&](int st, int kt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int k0 = kt * kstep + hf * hoff, c0 = hf * (W / 2);
      vc::tc::load_tile<W / 2, D, NT>(sm + L::K + (st * W + c0) * LD, LD, kp, D, k0, Lk);
      vc::tc::load_tile<W / 2, D, NT>(sm + L::V + (st * W + c0) * LD, LD, vp, D, k0, Lk);
      if (bp != nullptr)
        vc::tc::load_tile<BR, W / 2, NT>(sm + L::B + st * BR * LB + c0, LB, bp + k0, Lk, q0,
                                         Lq);
      if (tid < W / 8) vc::tc::cp_async16(Ms + st * W + c0 + 4 * tid, mp + k0 + 4 * tid, 16);
    }
  };
  vc::tc::load_tile<BR, D, NT>(sm + L::Q, LD, q + bh * Lq * D, D, q0, Lq);
  vc::tc::load_tile<BR, D, NT>(sm + L::G, LD, dout + bh * Lq * D, D, q0, Lq);
  load_stage(0, 0);
  vc::tc::cp_async_commit();

  float dqa[D / 8][4];  // rows wr + g (+8) x columns j*8 + 2t (+1)
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kstep;  // the tile's first key
    if (kt + 1 < nk) {
      load_stage(st ^ 1, kt + 1);
      vc::tc::cp_async_commit();
      vc::tc::cp_async_wait<1>();
    } else {
      vc::tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = sm + L::K + st * W * LD;
    const bf16* Vs = sm + L::V + st * W * LD;
    const int* Mt = Ms + st * W;

    // S = Q K^T and dP = dO V^T: the warp's 16 rows x W keys
    float s[W / 8][4], dp[W / 8][4];
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t aq[4], ag[4];
      vc::tc::load_a(aq, Qs, LD, wr, ks * 16);
      vc::tc::load_a(ag, Gs, LD, wr, ks * 16);
#pragma unroll
      for (int np = 0; np < W / 16; ++np) {
        uint32_t bk[4], bv[4];
        vc::tc::load_b(bk, Ks, LD, np * 16, ks * 16);
        vc::tc::load_b(bv, Vs, LD, np * 16, ks * 16);
        vc::tc::mma(s[2 * np], aq, bk[0], bk[1]);
        vc::tc::mma(s[2 * np + 1], aq, bk[2], bk[3]);
        vc::tc::mma(dp[2 * np], ag, bv[0], bv[1]);
        vc::tc::mma(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }
    if (bp != nullptr) {
      const bf16* Bs = sm + L::B + st * BR * LB;
#pragma unroll
      for (int np = 0; np < W / 16; ++np) {
        uint32_t bb[4];
        vc::tc::load_a(bb, Bs, LB, wr, np * 16);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 lo = vc::tc::unpack(bb[2 * half]), hi = vc::tc::unpack(bb[2 * half + 1]);
          float* c = s[2 * np + half];
          c[0] += lo.x;
          c[1] += lo.y;
          c[2] += hi.x;
          c[3] += hi.y;
        }
      }
    }
    // element e of n-tile n: row wr + g + 8 (e >> 1), tile column n*8 + 2t +
    // (e & 1); n-tile n + W/16 holds the partners Lk/2 further on
#pragma unroll
    for (int n = 0; n < W / 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, row = q0 + wr + g + 8 * r, c = n * 8 + 2 * t + (e & 1);
        unsigned x = 0;
        if (dr.on) x = vc::keep_hash(mixed, row, k0 + c, lk_half);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& el = dp[n + hf * (W / 16)][e];
          const float sc = s[n + hf * (W / 16)][e] + ((float)Mt[c + hf * (W / 2)] - 1.f) * 1e9f;
          const float p = row < Lq ? expf(sc - lse_r[r]) : 0.f;
          const float keep = dr.on ? vc::keep_bits(dr, hf ? x >> 16 : x & 0xFFFFu) : 1.f;
          el = plain_ds(p, el, keep, delta_r[r]);
        }
      }
    }
    // dQ += dS K, dS rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      const uint32_t as[4] = {vc::tc::pack(dp[2 * kk][0], dp[2 * kk][1]),
                              vc::tc::pack(dp[2 * kk][2], dp[2 * kk][3]),
                              vc::tc::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              vc::tc::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dj = 0; dj < D / 16; ++dj) {
        uint32_t bk[4];
        vc::tc::load_b_kn(bk, Ks, LD, kk * 16, dj * 16);
        vc::tc::mma(dqa[2 * dj], as, bk[0], bk[1]);
        vc::tc::mma(dqa[2 * dj + 1], as, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= Lq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dq + (bh * Lq + row) * D + j * 8 + 2 * t) =
          make_float2(dqa[j][2 * r], dqa[j][2 * r + 1]);
  }
}

// dbias = sum over b of part[b] ([B][n4] float4), in example order.
__global__ void fused_attention_bwd_dbias_sum(const float4* __restrict__ part,
                                              float4* __restrict__ dbias, long n4, int B) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    float4 acc = part[i];
    for (int b = 1; b < B; ++b) {
      const float4 x = part[(long)b * n4 + i];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    dbias[i] = acc;
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* bias = static_cast<const bf16*>(a.bias);
  const int* mask = static_cast<const int*>(a.key_mask);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  // with B = 1 the dk/dv kernel's partial is dbias itself
  float* part = bias == nullptr ? nullptr
                                : static_cast<float*>(a.B > 1 ? a.dbias_part : a.dbias);
  if (bias != nullptr && part == nullptr) return (int)cudaErrorInvalidValue;

  const long rows = (long)a.B * a.H * a.Lq;
  delta_kernel<bf16, D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(a.out), dout, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kv = fused_attention_bwd_dkdv_tc<D>;
  if ((err = allow_smem(kv, DkdvLayout<D>::bytes)) != cudaSuccess) return (int)err;
  kv<<<dim3(a.Lk / BR, a.H, a.B), NT, DkdvLayout<D>::bytes, stream>>>(
      q, k, v, bias, mask, dout, lse, delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), part, a.H, a.Lq, a.Lk, a.dr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto qk = fused_attention_bwd_dq_tc<D>;
  if ((err = allow_smem(qk, DqLayout<D>::bytes)) != cudaSuccess) return (int)err;
  qk<<<dim3((a.Lq + BR - 1) / BR, a.H, a.B), NT, DqLayout<D>::bytes, stream>>>(
      q, k, v, bias, mask, dout, lse, delta, static_cast<float*>(a.dq), a.H, a.Lq, a.Lk,
      a.dr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (bias != nullptr && a.B > 1) {
    const long n4 = (long)a.H * a.Lq * a.Lk / 4;
    const long blocks = (n4 + 255) / 256;
    fused_attention_bwd_dbias_sum<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                                    stream>>>(static_cast<const float4*>(a.dbias_part),
                                              static_cast<float4*>(a.dbias), n4, a.B);
    err = cudaGetLastError();
  }
  return (int)err;
}

int dispatch_d(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tcbwd

}  // namespace

// q [B,H,Lq,D], k/v [B,H,Lk,D], bias [1,H,Lq,Lk] or null, key_mask [B,Lk] int32,
// out/dout [B,H,Lq,D] (the forward's output and its gradient, q's dtype),
// lse [B,H,Lq] float32 from the forward; writes dq/dk/dv (float32, the shapes
// of q/k/v), dbias [1,H,Lq,Lk] float32 when bias is given, and uses delta
// [B,H,Lq] float32 as scratch. dbias_part [B,H,Lq,Lk] float32 is the bf16
// route's scratch for the per-example dS when bias is given and B > 1 (else
// null). All contiguous and 16-byte aligned, Lk a multiple of 64, D in
// {32, 64, 128}. Dropout arguments (and h0) as in fused_attention_fwd.
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* key_mask, const void* out,
                                   const void* dout, const void* lse, void* dq, void* dk,
                                   void* dv, void* dbias, void* delta, void* dbias_part, int B,
                                   int H, int Lq, int Lk, int D, int dtype, unsigned seed,
                                   int use_dropout, int thresh, float inv, int h0,
                                   void* stream) {
  if (Lk % BK != 0 || Lq <= 0 || B <= 0 || H <= 0 || h0 < 0)
    return (int)cudaErrorInvalidValue;
  if ((bias == nullptr) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, bias, key_mask, out, dout, lse, dq, dk, dv, dbias, delta, dbias_part,
               B, H, Lq, Lk, vc::Dropout{seed, use_dropout, (unsigned)thresh, inv, h0}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VC_DTYPE_F32) return dispatch_d<float>(a, D, s);
  if (dtype == VC_DTYPE_BF16) return tcbwd::dispatch_d(a, D, s);
  return (int)cudaErrorInvalidValue;
}
